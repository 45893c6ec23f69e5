"""Measured single-core CPU witness baseline (VERDICT r4 task #7).

The reference's witness path is a native single-core-per-component C++
binary (x86-64 ffiasm field asm, /root/reference/tools/helpers/
actions.js:114-124,132-146). It ships no recorded throughput numbers
(BASELINE.md `published` = {}), so the honest measured stand-in is this
engine's OWN single-core CPU witness run — the XLA:CPU path with the
native fr_ffi custom calls (native/fr_ffi.cpp: __int128 CIOS Montgomery,
whole-Poseidon / whole-SHA256 kernels), pinned to one core — on the same
(B, 32, 64) lane step bench.py times.

Writes BASELINE_CPU.json at the repo root; bench.py divides by this
measured number for vs_baseline instead of the former 1k tx/s estimate.

Usage: python scripts/measure_cpu_baseline.py [B]   (default 512)
"""

import json
import os
import platform
import sys
import time
from functools import partial
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# pin to ONE core before jax spins up its thread pools
os.sched_setaffinity(0, {0})

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from circuits_tpu.utils.compile_opts import enable_persistent_cache  # noqa: E402

enable_persistent_cache(jax)

from circuits_tpu.models.rollup_main import rollup_main_lanes  # noqa: E402
from circuits_tpu.r1cs import constraints as cc  # noqa: E402
from bench import build_tiled_inputs  # noqa: E402

B = int(sys.argv[1]) if len(sys.argv) > 1 else 512
NLEV, MFT, REPS = 32, 64, 3

from circuits_tpu.field import fr_ffi  # noqa: E402

print(f"platform={jax.devices()[0].platform} fr_ffi={fr_ffi.enabled()} "
      f"affinity={sorted(os.sched_getaffinity(0))} B={B}", flush=True)

tiled, tiled_chains = build_tiled_inputs(B, NLEV, MFT, jnp)
fn = jax.jit(partial(rollup_main_lanes, n_tx=B, n_levels=NLEV,
                     max_fee_tx=MFT))

t0 = time.time()
lanes0, ok0 = fn(tiled, tiled_chains)
ok_host = bool(np.asarray(ok0).all())
root0 = np.asarray(lanes0["new_state_root"][0, 0])
print(f"compile+first run: {time.time() - t0:.1f}s ok={ok_host}",
      flush=True)
assert ok_host

times = []
for _ in range(REPS):
    t0 = time.time()
    lanes, ok = fn(tiled, tiled_chains)
    np.asarray(ok)
    np.asarray(lanes["new_state_root"][0, 0])
    times.append(time.time() - t0)
blocked = float(np.median(times))
tx_per_sec = B / blocked
lane_constraints = cc.decode_tx(NLEV) + cc.rollup_tx(NLEV, MFT)

result = {
    "metric": "cpu_single_core_witness_per_sec",
    "value": round(tx_per_sec, 2),
    "unit": "tx/s",
    "blocked_median_s": round(blocked, 3),
    "batch": B,
    "n_levels": NLEV,
    "max_fee_tx": MFT,
    "constraints_per_sec": round(tx_per_sec * lane_constraints),
    "cpu": platform.processor() or platform.machine(),
    "note": ("engine's own XLA:CPU + native fr_ffi witness path, "
             "pinned to 1 core — the measured stand-in for the "
             "reference's single-core native witness calculator "
             "(actions.js:114-146); reference publishes no numbers"),
}
print(json.dumps(result, indent=1), flush=True)
Path(ROOT, "BASELINE_CPU.json").write_text(json.dumps(result, indent=1))
print("wrote BASELINE_CPU.json", flush=True)
