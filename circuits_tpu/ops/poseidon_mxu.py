"""Poseidon permutation with matmul limb arithmetic — not on the main path.

The jaxite-style trick scaled to BN254: field elements as 32 8-bit limbs;
every multiply-by-constant becomes a banded matmul with bf16 operands
(integers <= 255 are exact in bf16) and f32 accumulation (column sums
<= t*32*255^2 < 2^24 stay exact), so the mix runs on the matrix units.
Montgomery reduction is two more banded matmuls (by N' = -p^-1 mod 2^256
and by p) plus log-convergent carry passes. Only the S-box (variable x
variable) stays on the 16-bit-limb CIOS path.

Per round the MDS mix of ALL t outputs is ONE (B, t*32) @ (t*32, t*63)
matmul; reductions batch as (B*t, 32) matmuls. Op counts per t=3
permutation: elementwise multiplies drop from ~828 field muls to ~243
(S-boxes only) — the mix mass moves to the matrix units.

Bit-exact vs the scan path (tests/test_poseidon_mxu.py runs the whole
permutation against poseidon_py on CPU — the arithmetic is exact on
every backend). Nothing selects it; whether it stays is decided by
measuring it on the card in the Poseidon layer.

Reference context: replaces the ffiasm x86 field inner loop
(/root/reference/tools/helpers/actions.js:207-229) for the hash that
carries ~77% of the reference's constraint mass (SURVEY.md §6).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp

from ..field.scalar import P, R as MONT_R, N_LIMBS
from ..field import fr
from .poseidon_constants import constants, N_ROUNDS_F, N_ROUNDS_P

NL8 = 32                      # 8-bit limbs per element
R256 = 1 << 256
N_PRIME = (-pow(P, -1, R256)) % R256
_P8 = np.array([(P >> (8 * i)) & 0xFF for i in range(NL8)], np.int32)


def _limbs8(x: int, n: int = NL8) -> list[int]:
    return [(x >> (8 * i)) & 0xFF for i in range(n)]


def _banded(c: int, n_in: int, n_out: int) -> np.ndarray:
    """W[i, i+j] = limb8(c)[j] — x @ W gives the product's lazy columns
    (truncated at n_out)."""
    W = np.zeros((n_in, n_out), np.float32)
    for i in range(n_in):
        for j, cj in enumerate(_limbs8(c)):
            if i + j < n_out:
                W[i, i + j] += cj
    return W


@lru_cache(maxsize=None)
def _np_mxu_constants(t: int):
    C, M = constants(t)
    rf, rp = N_ROUNDS_F, N_ROUNDS_P[t - 2]
    nr = rf + rp
    # MDS mix for all t outputs in one matmul: block (j, i) band of
    # limbs8(M[i][j] * R mod p)  (Montgomery-form constants keep the
    # state's Montgomery domain through the q-reduction)
    Wm = np.zeros((t * NL8, t * (2 * NL8)), np.float32)
    for i in range(t):
        for j in range(t):
            Wm[j * NL8:(j + 1) * NL8,
               i * 2 * NL8:(i + 1) * 2 * NL8] += _banded(
                   (M[i][j] * MONT_R) % P, NL8, 2 * NL8)
    Wn = _banded(N_PRIME, NL8, NL8)
    Wp = _banded(P, NL8, 2 * NL8 + 1)
    # round constants as normalized 8-bit limb rows (Montgomery form)
    C8 = np.zeros((nr, t, NL8), np.int32)
    for r in range(nr):
        for i in range(t):
            C8[r, i] = _limbs8((C[r * t + i] * MONT_R) % P)
    return Wm, Wn, Wp, C8, rf, rp


def _normalize(cols, n_out: int, passes: int = 2):
    """Exact carry normalization, radix 2^8: `passes` vectorized
    log-convergent passes shrink entries (< 2^24 -> < ~2^9), then one
    exact sequential scan guarantees every limb < 256 (the heuristic
    passes alone can leave a 255+carry ripple alive — correctness here
    is load-bearing, the q-reduction divides by 2^256 exactly)."""
    c = cols.astype(jnp.int32)
    if c.shape[-1] < n_out:
        pad = [(0, 0)] * (c.ndim - 1) + [(0, n_out - c.shape[-1])]
        c = jnp.pad(c, pad)
    c = c[..., :n_out]
    for _ in range(passes):
        lo = c & 255
        hi = c >> 8
        pad = [(0, 0)] * (c.ndim - 1) + [(1, 0)]
        c = lo + jnp.pad(hi[..., :-1], pad)
    cm = jnp.moveaxis(c, -1, 0)  # (n_out, ...)

    def step(carry, v):
        s = v + carry
        return s >> 8, s & 255

    _, out = jax.lax.scan(step, jnp.zeros_like(cm[0]), cm)
    return jnp.moveaxis(out, 0, -1)


def _cond_sub_p(x8, k: int = 1):
    """x8 (..., 32) limbs, value < (k+1)*p: subtract p up to k times."""
    for _ in range(k):
        borrow = jnp.zeros_like(x8[..., 0])
        diff = []
        for i in range(NL8):
            d = x8[..., i] - _P8[i] - borrow
            borrow = (d >> 31) & 1
            diff.append(d & 255)
        diff = jnp.stack(diff, axis=-1)
        x8 = jnp.where((borrow == 1)[..., None], x8, diff)
    return x8


def _dot(a8, W):
    return jax.lax.dot_general(
        a8.astype(jnp.bfloat16), jnp.asarray(W, jnp.bfloat16),
        (((a8.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32)


def _mont_reduce8(T, t: int, Wn, Wp):
    """T (..., 2*NL8+1) int columns of a (sum of) Montgomery products;
    returns (..., 32) limbs of T*R^-1 mod p (canonical)."""
    Tn = _normalize(T, 2 * NL8 + 1)
    lo = Tn[..., :NL8]
    q = _normalize(_dot(lo, Wn), NL8)        # q = lo * N' mod 2^256
    S = Tn + _dot(q, Wp).astype(jnp.int32)
    Sn = _normalize(S, 2 * NL8 + 2)
    hi = Sn[..., NL8:2 * NL8]                # (T + q*p) / 2^256
    # value < p + T/2^256; for T < t*p^2: < p(1 + t/4) -> <= 2 subs
    return _cond_sub_p(hi, k=2 if t > 3 else 1)


def _to16(x8):
    """(..., 32) 8-bit -> (16, ...) 16-bit limb-major (fr layout)."""
    x16 = x8[..., 0::2] + (x8[..., 1::2] << 8)
    return jnp.moveaxis(x16, -1, 0).astype(jnp.uint32)


def _to8(x16):
    """(16, ...) fr layout -> (..., 32) 8-bit limbs."""
    x = jnp.moveaxis(x16.astype(jnp.int32), 0, -1)
    lo = x & 255
    hi = x >> 8
    return jnp.stack([lo, hi], axis=-1).reshape(x.shape[:-1] + (NL8,))


def _pow5_16(x16):
    """x^5 in the Montgomery domain on the 16-bit-limb path."""
    x2 = fr.mont_mul_compact(x16, x16)
    x4 = fr.mont_mul_compact(x2, x2)
    return fr.mont_mul_compact(x4, x16)


def permute_mont_mxu(state_m: jnp.ndarray) -> jnp.ndarray:
    """Drop-in for poseidon.permute_mont: (16, t, B) Montgomery in/out."""
    t = state_m.shape[1]
    Wm, Wn, Wp, C8, rf, rp = _np_mxu_constants(t)
    half = rf // 2
    B = state_m.shape[2]

    x8 = _to8(state_m)  # (t, B, 32)... careful: moveaxis gives (t, B, 32)

    def ark(s8, c8):
        s = s8 + c8[:, None, :]
        return _cond_sub_p(_normalize(s, NL8))

    def mix(s8):
        flat = jnp.moveaxis(s8, 0, -2).reshape(B, t * NL8)
        T = _dot(flat, Wm).reshape(B, t, 2 * NL8).astype(jnp.int32)
        pad = [(0, 0), (0, 0), (0, 1)]
        out = _mont_reduce8(jnp.pad(T, pad), t, Wn, Wp)  # (B, t, 32)
        return jnp.moveaxis(out, 1, 0)

    nr = rf + rp
    is_full = np.zeros((nr,), np.int32)
    is_full[:half] = 1
    is_full[half + rp:] = 1

    def round_fn(s8, xs):
        c8, full = xs
        s8 = ark(s8, c8)
        sboxed = _to8(_pow5_16(_to16(s8)))
        keep_first = jnp.concatenate([sboxed[0:1], s8[1:]], axis=0)
        s8 = jnp.where(full != 0, sboxed, keep_first)
        return mix(s8), None

    x8, _ = jax.lax.scan(round_fn, x8,
                         (jnp.asarray(C8), jnp.asarray(is_full)))
    return _to16(x8)


jpermute_mont_mxu = jax.jit(permute_mont_mxu)
