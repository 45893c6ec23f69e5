"""Virtual-mesh scaling: the sharded witness step at 1/2/4/8 devices.

The 8 virtual CPU devices share one host's cores, so the numbers
measure SPMD/collective overhead and correctness of the scaling path,
NOT multi-card speedup (`chip_smoke.py --cards 4` runs the real mesh).
nTx is fixed; the per-device lane slice shrinks as the
mesh grows, so flat wall-time = perfect weak-scaling overhead profile.

Usage: python scripts/exp_mesh_scaling.py [nTx]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_TX = int(sys.argv[1]) if len(sys.argv) > 1 else 32

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8")
from circuits_tpu.utils.compile_opts import (enable_cpu_fast_compile,
                                             enable_persistent_cache)

enable_cpu_fast_compile()
import jax

jax.config.update("jax_platforms", "cpu")
enable_persistent_cache(jax)

import numpy as np
from __graft_entry__ import _build_packed
from circuits_tpu.parallel.sharding import (make_tx_mesh,
                                            make_sharded_rollup_main)

params = (N_TX, 16, 2, 2)
packed = _build_packed(*params)

print(f"nTx={N_TX} (fixed); virtual CPU devices share 2 cores", flush=True)
results = {}
for n_dev in (1, 2, 4, 8):
    mesh = make_tx_mesh(n_dev)
    run = make_sharded_rollup_main(mesh, *params)
    t0 = time.time()
    out, ok = run(packed)
    jax.block_until_ready(out["hash_global_inputs"])
    compile_s = time.time() - t0
    assert bool(ok)
    reps = 5
    times = []
    for _ in range(reps):
        t0 = time.time()
        out, ok = run(packed)
        jax.block_until_ready((out, ok))
        times.append(time.time() - t0)
    med = float(np.median(times))
    results[n_dev] = med
    print(f"devices={n_dev}: compile+1st={compile_s:6.1f}s "
          f"steady={med * 1e3:7.1f} ms/step "
          f"(lanes/device={N_TX // n_dev})", flush=True)

base = results[1]
for n_dev, med in results.items():
    print(f"devices={n_dev}: step-time ratio vs 1-dev = {med / base:.2f} "
          f"(1.0 = zero sharding overhead at fixed nTx)", flush=True)
