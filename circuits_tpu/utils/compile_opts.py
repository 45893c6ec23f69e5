"""Compile-time controls: XLA:CPU flags and the persistent cache.

The witness models trace to large HLO graphs (hundreds of Montgomery-mul
call sites); XLA:CPU compile cost is superlinear in module size. On the
CPU correctness paths (unit tests, the virtual-mesh multichip dry run)
we trade generated-code quality for compile latency — measured on
RollupMain pieces this is a 2.5-3x compile-time win with no observable
runtime regression at test shapes. The GPU path is unaffected: the flags
are set only by the CPU entry points.
"""

import os
from pathlib import Path

# used where JAX_COMPILATION_CACHE_DIR is unset; listed in .gitignore
CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"

CPU_FAST_COMPILE_FLAGS = (
    "--xla_backend_optimization_level=0 "
    "--xla_llvm_disable_expensive_passes=true "
    "--xla_llvm_enable_alias_scope_metadata=false "
    "--xla_llvm_enable_noalias_metadata=false "
    "--xla_llvm_enable_invariant_load_metadata=false"
)


def enable_cpu_fast_compile() -> None:
    """Append the fast-compile flags to XLA_FLAGS (idempotent). Must run
    before the XLA CPU client is initialized (i.e. before first jit)."""
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_backend_optimization_level" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " " + CPU_FAST_COMPILE_FLAGS).strip()


def enable_persistent_cache(jax) -> str:
    """Turn on the persistent compile cache (idempotent) and return its
    directory: $JAX_COMPILATION_CACHE_DIR where set (JAX reads it itself),
    else CACHE_DIR inside the checkout.

    NOTE: `jax_persistent_cache_enable_xla_caches` must stay "none".
    XLA:CPU AOT cache entries are keyed to the *compiling* machine's CPU
    features; loading them on a host with different features fails
    ("Machine type used for XLA:CPU compilation doesn't match...") and
    every nominal cache hit degrades to a failed load + full recompile —
    this poisoned the round-2 multichip dryrun.
    """
    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = str(CACHE_DIR)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_enable_xla_caches", "none")
    return cache_dir
