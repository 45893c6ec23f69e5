"""Headline benchmark: rollup-tx witness lanes/sec on one chip.

Metric (BASELINE.json): witnesses/sec/chip for rollup-tx at a
production-shape parametrization (nLevels=32, maxFeeTx=64). A valid
L2-transfer lane (EdDSA verify + 2 SMT processors + 6 Poseidons + balance
update — the full RollupTx phase A–K pipeline plus DecodeTx) is tiled
across the batch axis; per-lane device work is identical to a real batch.

Methodology:
  * runs only where JAX finds a GPU, and prints the platform, device
    kind and count, and the card's name and power limit;
  * the verdict `ok` is asserted every rep — a run that fails constraint
    checks reports ok=false instead of a throughput;
  * every timed rep ends in `block_until_ready` on the whole output;
  * two measurements — median of individually blocked reps, and wall
    clock over a pipelined window — are both reported;
  * compile time is reported as set-up time.

vs_baseline divides by this engine's own single-core CPU witness run
(XLA:CPU + native fr_ffi custom calls, the same lane step,
scripts/measure_cpu_baseline.py, committed as BASELINE_CPU.json).

Prints ONE JSON line.
"""

import json
import os
import sys
import time
from functools import partial

import numpy as np


def build_tiled_inputs(B, NLEV, MFT, jnp):
    """Host: build a small valid batch, then tile its L2-transfer lane
    across B lanes. Returns (tiled, tiled_chains, seed params)."""
    from circuits_tpu.builder.rollup_db import RollupDB
    from circuits_tpu.builder.account import HermezAccount
    from circuits_tpu.builder import float40
    from circuits_tpu.engine.witness import pack_rollup_inputs
    from circuits_tpu.models.rollup_main import build_chains
    from circuits_tpu.parallel.sharding import _LANE_DIM, _CHAIN_LANE_DIM

    SEED_TX, ML1 = 4, 2
    a1, a2 = HermezAccount(1), HermezAccount(2)
    db = RollupDB()
    bb = db.build_batch(SEED_TX, NLEV, ML1, MFT)
    for acc, amt in [(a1, 10_000_000), (a2, 20_000_000)]:
        bb.add_tx(dict(fromIdx=0, loadAmountF=float40.fix2float(amt),
                       tokenID=1, fromBjjCompressed=acc.bjjCompressed,
                       fromEthAddr=acc.ethAddr, toIdx=0, onChain=True))
    bb.build()
    db.consolidate(bb)
    bb2 = db.build_batch(SEED_TX, NLEV, ML1, MFT)
    bb2.add_token(1)
    tx = dict(fromIdx=256, toIdx=257, tokenID=1, amount=1000, userFee=126,
              nonce=0, onChain=0)
    a1.sign_tx(tx)
    bb2.add_tx(tx)
    bb2.build()
    packed = pack_rollup_inputs(bb2.get_input(), SEED_TX, NLEV, ML1, MFT)
    chains = build_chains(packed, SEED_TX, MFT)

    lane = 0  # the L2 transfer lane (slot 0 of batch 2)

    def tile(x, dim):
        idx = [slice(None)] * x.ndim
        idx[dim] = slice(lane, lane + 1)
        sl = np.asarray(x[tuple(idx)])
        return jnp.asarray(np.repeat(sl, B, axis=dim))

    tiled = {k: (tile(v, _LANE_DIM[k]) if k in _LANE_DIM else jnp.asarray(v))
             for k, v in packed.items()}
    tiled_chains = {k: tile(v, _CHAIN_LANE_DIM[k]) for k, v in
                    chains.items()}
    return tiled, tiled_chains


def main():
    import subprocess

    import jax

    from circuits_tpu.utils.compile_opts import enable_persistent_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: needs a GPU; JAX found {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    enable_persistent_cache(jax)
    import jax.numpy as jnp

    from circuits_tpu.models.rollup_main import rollup_main_lanes
    from circuits_tpu.r1cs import constraints as cc

    B = int(os.environ.get("BENCH_NTX", "512"))
    NLEV = int(os.environ.get("BENCH_NLEVELS", "32"))
    MFT = int(os.environ.get("BENCH_MAXFEETX", "64"))
    REPS = int(os.environ.get("BENCH_REPS", "10"))
    WINDOW = int(os.environ.get("BENCH_WINDOW", "10"))

    tiled, tiled_chains = build_tiled_inputs(B, NLEV, MFT, jnp)

    fn = jax.jit(partial(rollup_main_lanes, n_tx=B, n_levels=NLEV,
                         max_fee_tx=MFT))

    # warmup + verification: compile, run, assert the verdict
    t0 = time.time()
    lanes0, ok0 = fn(tiled, tiled_chains)
    root0 = np.asarray(lanes0["new_state_root"])
    ok0 = np.asarray(ok0)
    compile_time = time.time() - t0
    all_ok = bool(ok0.all())

    # 1) individually blocked reps
    blocked = []
    last = None
    for _ in range(REPS):
        t0 = time.time()
        last = fn(tiled, tiled_chains)
        jax.block_until_ready(last)
        blocked.append(time.time() - t0)
    blocked_med = float(np.median(blocked))
    lanesN, okN = last
    all_ok = all_ok and bool(np.asarray(okN).all())
    if not np.array_equal(np.asarray(lanesN["new_state_root"]), root0):
        all_ok = False  # nondeterminism would invalidate the run

    # 2) pipelined window: dispatch WINDOW reps back-to-back, block once
    t0 = time.time()
    outs = [fn(tiled, tiled_chains) for _ in range(WINDOW)]
    jax.block_until_ready(outs)
    pipelined = (time.time() - t0) / WINDOW

    tx_per_sec = B / blocked_med
    lane_constraints = cc.decode_tx(NLEV) + cc.rollup_tx(NLEV, MFT)
    constraints_per_sec = tx_per_sec * lane_constraints

    # measured single-core CPU baseline (scripts/measure_cpu_baseline.py)
    baseline_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "BASELINE_CPU.json")
    baseline_cpu = float(json.loads(open(baseline_path).read())["value"])

    print(json.dumps({
        "metric": "rollup_tx_witness_per_sec",
        "value": round(tx_per_sec, 2),
        "unit": "tx/s",
        "vs_baseline": round(tx_per_sec / baseline_cpu, 3),
        "baseline_cpu_tx_per_sec": baseline_cpu,
        "ok": all_ok,
        "blocked_median_s": round(blocked_med, 4),
        "pipelined_s": round(pipelined, 4),
        "constraints_per_sec": round(constraints_per_sec),
        "compile_s": round(compile_time, 1),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card,
        "batch": B,
        "reps": REPS,
        "scope": ("per-lane witness phases (DecodeTx + RollupTx A-K); "
                  "the batch-global SHA256 tail is excluded here and "
                  "timed on the full batch by chip_smoke.py"),
    }))
    print(f"# B={B} nLevels={NLEV} maxFeeTx={MFT} ok={all_ok} "
          f"blocked_med={blocked_med:.4f}s pipelined={pipelined:.4f}s "
          f"compile={compile_time:.1f}s lane_constraints={lane_constraints} "
          f"device={dev.device_kind} card={card}", file=sys.stderr)


if __name__ == "__main__":
    main()
