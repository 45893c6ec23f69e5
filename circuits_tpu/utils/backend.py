"""Which native library runs the hot primitives on this platform.

One table, keyed by `jax.default_backend()`, replaces per-op switches.
On both platforms every Fr add, sub, Montgomery multiply and
fixed-exponent power, the whole Poseidon permutation and the SHA-256
digest each lower to one native custom call (field/fr_ffi.py):

  cpu  native/fr_ffi.cpp, built with g++;
  gpu  native/fr_cuda.cu, built with nvcc for Hopper.

On an H100 the XLA limb graph of the full batch had not finished
compiling after 1,180 s with the compact multiply, nor after about
880 s with the straight-line one (971,288 StableHLO ops). The
limb graphs of field/fr.py stay as the plain reference the native
kernels are checked against, and `xla_reference()` runs them instead.
Any other platform raises: there is no silent default.
"""

from __future__ import annotations

import contextlib
import functools

_NATIVE = {"cpu": "cpu", "gpu": "cuda"}

_use_xla = False


def for_platform(platform: str) -> str:
    """The native custom-call library that runs on `platform`."""
    if platform not in _NATIVE:
        raise ValueError(f"no backend for platform {platform!r}; "
                         f"supported: {sorted(_NATIVE)}")
    return _NATIVE[platform]


@functools.cache
def _platform_native() -> str:
    import jax

    return for_platform(jax.default_backend())


def native() -> str | None:
    """This process's native library, or None inside `xla_reference()`."""
    return None if _use_xla else _platform_native()


@contextlib.contextmanager
def xla_reference():
    """Trace the plain XLA limb graphs instead of the native custom calls.
    Only tracing reads this: jit a fresh function inside the block."""
    global _use_xla
    prev, _use_xla = _use_xla, True
    try:
        yield
    finally:
        _use_xla = prev
