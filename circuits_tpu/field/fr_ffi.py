"""Native FFI backend for Fr field ops: one custom call per field op.

Every Montgomery multiply / modular add / sub / fixed-exponent power,
every whole Poseidon permutation and every SHA-256 digest lowers to ONE
custom-call instruction instead of a 16-bit limb graph of tens to
thousands of HLO ops. This is a compile-time weapon first: XLA:CPU's
compile cost is superlinear in graph size, and on an H100 XLA's GPU
compiler had not finished the limb graph of the full RollupMain batch,
with the compact multiply, after 1,180 s. The limb graphs in fr.py stay
as the plain reference.

Two libraries register the same targets, built from tracked sources at
first use into gitignored shared objects:
  cpu   native/fr_ffi.cpp with g++;
  cuda  native/fr_cuda.cu with nvcc, for sm_90a (Hopper).
Both run the per-lane code of native/fr_device.h. `enabled()` follows
utils/backend.py; a library that fails to build raises.

Native equivalent of the reference's ffiasm field library
(reference: tools/helpers/actions.js:207-229).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_NATIVE = Path(__file__).resolve().parents[2] / "native"
_HEADER = _NATIVE / "fr_device.h"
_LIBS = {
    # platform: (source, shared object, XLA platform name)
    "cpu": (_NATIVE / "fr_ffi.cpp", _NATIVE / "libfr_ffi.so", "cpu"),
    "cuda": (_NATIVE / "fr_cuda.cu", _NATIVE / "libfr_cuda.so", "CUDA"),
}

_SYMBOLS = {
    "fr_mont_mul": "FrMontMul",
    "fr_add": "FrAdd",
    "fr_sub": "FrSub",
    "fr_pow": "FrPow",
    "fr_poseidon": "FrPoseidon",
    "sha256_blocks": "Sha256Blocks",
}

# Targets whose every operand carries the batch dim on axis 0. fr_poseidon /
# sha256_blocks take broadcast constants operands (round constants, MDS)
# without a batch axis — marking those batch-partitionable would let an
# auto-SPMD partitioner slice the constants and silently corrupt results.
_BATCH_PARTITIONABLE = {"fr_mont_mul", "fr_add", "fr_sub", "fr_pow"}

_registered: dict[str, str | None] = {}   # lib -> None, or why it failed


def _compiler(lib: str, src: Path, out: Path) -> list[str]:
    import jax.ffi

    inc = ["-I", jax.ffi.include_dir(), "-I", str(_NATIVE)]
    if lib == "cpu":
        return ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", *inc,
                "-o", str(out), str(src)]
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", *inc, "-o", str(out),
            str(src)]


def _build(lib: str) -> str | None:
    """Build the library if it is missing or older than its sources.
    Returns None on success, else the reason it failed."""
    src, so, _ = _LIBS[lib]
    newest = max(src.stat().st_mtime, _HEADER.stat().st_mtime)
    if so.exists() and so.stat().st_mtime >= newest:
        return None
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(_compiler(lib, src, tmp), check=True,
                       capture_output=True, timeout=600)
        os.replace(tmp, so)   # atomic: concurrent builders never see half
        return None
    except subprocess.CalledProcessError as e:  # keep the compiler output
        return f"build failed: {e.stderr.decode(errors='replace')[-2000:]}"
    except Exception as e:
        return f"{type(e).__name__}: {e}"
    finally:
        tmp.unlink(missing_ok=True)


def _register(lib: str) -> None:
    if lib in _registered:
        return
    error = _build(lib)
    if error is None:
        import jax.ffi

        _, so, platform = _LIBS[lib]
        try:
            handle = ctypes.CDLL(str(so))
            for name, sym in _SYMBOLS.items():
                jax.ffi.register_ffi_target(
                    name, jax.ffi.pycapsule(getattr(handle, sym)),
                    platform=platform)
                if name in _BATCH_PARTITIONABLE:
                    try:
                        jax.ffi.register_ffi_target_as_batch_partitionable(
                            name)
                    except Exception:
                        pass  # an optimization, not required
        except (OSError, AttributeError) as e:
            error = f"load failed: {e}"
    _registered[lib] = error


def enabled() -> bool:
    """True iff Fr ops lower to the native custom calls in this process
    (builds and registers the platform's library on first use)."""
    from ..utils import backend

    lib = backend.native()
    if lib is None:
        return False
    _register(lib)
    if _registered[lib] is not None:
        raise RuntimeError(f"native {lib} library unavailable: "
                           f"{_registered[lib]}")
    return True


def _call(target: str, n_limbs: int, a, b):
    """Invoke a binary (N,16)-layout kernel on limb-major (16, *batch)
    operands, broadcasting batch dims."""
    import jax
    import jax.numpy as jnp

    bshape = jnp.broadcast_shapes(a.shape[1:], b.shape[1:])
    a = jnp.broadcast_to(a, (n_limbs,) + bshape)
    b = jnp.broadcast_to(b, (n_limbs,) + bshape)
    n = int(np.prod(bshape, dtype=np.int64)) if bshape else 1
    at = a.reshape(n_limbs, n).T
    bt = b.reshape(n_limbs, n).T
    out = jax.ffi.ffi_call(
        target, jax.ShapeDtypeStruct((n, n_limbs), jnp.uint32))(at, bt)
    return out.T.reshape((n_limbs,) + bshape)


def mont_mul(a, b):
    return _call("fr_mont_mul", a.shape[0], a, b)


def add(a, b):
    return _call("fr_add", a.shape[0], a, b)


def sub(a, b):
    return _call("fr_sub", a.shape[0], a, b)


def poseidon_permute_mont(state_m, c_flat: np.ndarray, m_flat: np.ndarray):
    """Whole Poseidon permutation as ONE custom call.

    state_m: (16, t, *batch) Montgomery limbs; c_flat ((RF+rp)*t, 16) and
    m_flat (t*t, 16) are host numpy Montgomery constants (t and rp are
    inferred by the handler from their sizes)."""
    import jax
    import jax.numpy as jnp

    n_limbs, t = state_m.shape[0], state_m.shape[1]
    bshape = state_m.shape[2:]
    n = int(np.prod(bshape, dtype=np.int64)) if bshape else 1
    # (16, t, B) -> (B, t, 16)
    st = jnp.transpose(state_m.reshape(n_limbs, t, n), (2, 1, 0))
    out = jax.ffi.ffi_call(
        "fr_poseidon", jax.ShapeDtypeStruct((n, t, n_limbs), jnp.uint32))(
        st, jnp.asarray(c_flat), jnp.asarray(m_flat))
    return jnp.transpose(out, (2, 1, 0)).reshape(state_m.shape)


def sha256_blocks(words):
    """SHA-256 digests as ONE custom call. words: (nwords, *batch) u32
    big-endian message words, pre-padded to whole 512-bit blocks
    (nwords % 16 == 0). Returns (8, *batch) digest words."""
    import jax
    import jax.numpy as jnp

    nwords = words.shape[0]
    bshape = words.shape[1:]
    n = int(np.prod(bshape, dtype=np.int64)) if bshape else 1
    wt = words.reshape(nwords, n).T  # (N, nwords)
    out = jax.ffi.ffi_call(
        "sha256_blocks", jax.ShapeDtypeStruct((n, 8), jnp.uint32))(wt)
    return out.T.reshape((8,) + bshape)


def pow_const_mont(a_mont, e: int):
    """a^e (Montgomery in/out) with a fixed exponent — one custom call
    replaces the 2-mul-per-bit fori ladder."""
    import jax
    import jax.numpy as jnp

    n_limbs = a_mont.shape[0]
    bshape = a_mont.shape[1:]
    n = int(np.prod(bshape, dtype=np.int64)) if bshape else 1
    ebits = jnp.asarray(
        np.array([(e >> i) & 1 for i in range(e.bit_length())],
                 dtype=np.uint32))
    at = a_mont.reshape(n_limbs, n).T
    out = jax.ffi.ffi_call(
        "fr_pow", jax.ShapeDtypeStruct((n, n_limbs), jnp.uint32))(at, ebits)
    return out.T.reshape((n_limbs,) + bshape)
