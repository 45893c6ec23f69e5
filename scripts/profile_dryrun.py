"""Instrumented dryrun_multichip: where does the wall-clock go?

Usage: python scripts/profile_dryrun.py [n_devices]
Uses a throwaway compile cache (cold) unless PROF_CACHE=1.
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N = int(sys.argv[1]) if len(sys.argv) > 1 else 8

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={N}").strip()

from circuits_tpu.utils.compile_opts import enable_cpu_fast_compile

enable_cpu_fast_compile()
import jax

jax.config.update("jax_platforms", "cpu")
if os.environ.get("PROF_CACHE") == "1":
    from circuits_tpu.utils.compile_opts import enable_persistent_cache
    enable_persistent_cache(jax)
else:
    jax.config.update("jax_compilation_cache_dir", tempfile.mkdtemp())

t0 = time.time()


def mark(name):
    global t0
    t1 = time.time()
    print(f"[{t1 - t0:7.2f}s] {name}", flush=True)
    t0 = t1


from circuits_tpu.field import fr_ffi

assert fr_ffi.enabled()
mark("imports + ffi build")

from __graft_entry__ import _build_packed
from circuits_tpu.parallel.sharding import (make_tx_mesh,
                                            make_sharded_rollup_main)

n_tx = max(N, 4)
params = (n_tx, 16, 2, 2)
packed = _build_packed(*params)
mark("build_packed (host builder)")

mesh = make_tx_mesh(N)
run = make_sharded_rollup_main(mesh, *params)
mark("mesh + closure")

# split run() into place/trace/compile/execute
from functools import partial
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from circuits_tpu.models import rollup_main as rm
from circuits_tpu.parallel import sharding as sh

chains = rm.build_chains(packed, n_tx, 2)
in_specs = (
    {k: sh._spec(sh._LANE_DIM.get(k), v.ndim) for k, v in packed.items()},
    {k: sh._spec(sh._CHAIN_LANE_DIM[k], v.ndim) for k, v in chains.items()},
)
out_specs = (dict(hash_global_inputs=P(), new_state_root=P(),
                  new_exit_root=P(), new_last_idx=P(), acc_fee_out=P()), P())
fn = partial(sh._sharded_step, n_tx=n_tx, t_loc=n_tx // N, n_levels=16,
             max_l1_tx=2, max_fee_tx=2)
sharded = jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                        out_specs=out_specs, check_vma=False)
placed = {k: jax.device_put(
    v, NamedSharding(mesh, sh._spec(sh._LANE_DIM.get(k), v.ndim)))
    for k, v in packed.items()}
chains_placed = {k: jax.device_put(
    v, NamedSharding(mesh, sh._spec(sh._CHAIN_LANE_DIM[k], v.ndim)))
    for k, v in chains.items()}
mark("device_put")

lowered = jax.jit(sharded).lower(placed, chains_placed)
hlo = lowered.as_text()
mark(f"trace+lower (hlo_lines={len(hlo.splitlines())})")

compiled = lowered.compile()
mark("compile")

out, ok = compiled(placed, chains_placed)
jax.block_until_ready(out["hash_global_inputs"])
mark(f"execute (ok={bool(ok)})")
