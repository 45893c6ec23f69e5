"""Batched Poseidon permutation over BN254 Fr (circomlib-compatible).

This is hot kernel #1 of the witness engine (SURVEY.md §2.2): RollupTx uses
4 direct Poseidon(4) state hashes + ~2 per SMT level + Poseidon(6) per
DecodeTx + Poseidon(5) inside EdDSA.

Layout: state is (16, t, B) — limb axis leading (the fr convention), t the
Poseidon width, B the witness-lane batch. Rounds run under ``lax.scan`` so
the trace stays small; all round constants / MDS entries live on device in
Montgomery form.

Replicates circomlib 0.5.x `Poseidon(nInputs)` semantics
(reference usage: /root/reference/src/lib/hash-state.circom:1,
 src/decode-tx.circom:1): state=[0, inputs...], per round ark->sbox->mix,
output state[0].
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp

from ..field import fr
from ..field.scalar import P, R as MONT_R, N_LIMBS, to_limbs
from .poseidon_constants import constants, N_ROUNDS_F, N_ROUNDS_P


def _limbs_mont(x: int) -> np.ndarray:
    return np.array(to_limbs((x * MONT_R) % P), dtype=np.uint32)


@lru_cache(maxsize=None)
def _device_constants(t: int):
    C, M = constants(t)
    rf, rp = N_ROUNDS_F, N_ROUNDS_P[t - 2]
    nrounds = rf + rp
    Cm = np.zeros((nrounds, N_LIMBS, t, 1), dtype=np.uint32)
    for r in range(nrounds):
        for i in range(t):
            Cm[r, :, i, 0] = _limbs_mont(C[r * t + i])
    Mm = np.zeros((N_LIMBS, t, t, 1), dtype=np.uint32)
    for i in range(t):
        for j in range(t):
            Mm[:, i, j, 0] = _limbs_mont(M[i][j])
    half = rf // 2
    # per-round full/partial mask: one scan over ALL rounds (a single
    # compiled while-loop instead of three — compile time matters when
    # poseidon nests inside the SMT level scan)
    is_full = np.zeros((nrounds,), dtype=np.uint32)
    is_full[:half] = 1
    is_full[half + rp:] = 1
    # NOTE: return plain numpy — jnp constants materialized inside a jit
    # trace would leak tracers through the lru_cache.
    return (Cm, is_full, Mm)


def _pow5(x):
    x2 = fr.mont_mul(x, x)
    x4 = fr.mont_mul(x2, x2)
    return fr.mont_mul(x4, x)


def _mix(state, Mm, t):
    # new[i] = sum_j M[i][j] * state[j]
    prod = fr.mont_mul(Mm, state[:, None])  # (16, t_out, t_in, B)
    return fr.sum_list([prod[:, :, j] for j in range(t)])


def permute_mont_xla(state_m: jnp.ndarray) -> jnp.ndarray:
    """Full Poseidon permutation; state (16, t, B) in Montgomery form.

    One scan over all RF+RP rounds; partial rounds apply the S-box to
    lane 0 only via a mask (the extra pow5 work on masked lanes runs in
    parallel with lane 0's and keeps the compiled loop singular)."""
    t = state_m.shape[1]
    Cm, is_full, Mm = _device_constants(t)

    def round_fn(state, xs):
        Cr, full = xs
        state = fr.add(state, Cr)
        sboxed = _pow5(state)
        keep_first = jnp.concatenate(
            [sboxed[:, 0:1], state[:, 1:]], axis=1)
        state = fr.select(full, sboxed, keep_first)
        return _mix(state, Mm, t), None

    state_m, _ = jax.lax.scan(round_fn, state_m, (Cm, is_full))
    return state_m


@lru_cache(maxsize=None)
def _ffi_constants(t: int):
    """Flat Montgomery constant layouts for the whole-permutation FFI
    call: C ((RF+rp)*t, 16) and M (t*t, 16) uint32."""
    C, M = constants(t)
    nrounds = N_ROUNDS_F + N_ROUNDS_P[t - 2]
    c_flat = np.stack([_limbs_mont(C[i]) for i in range(nrounds * t)])
    m_flat = np.stack([_limbs_mont(M[i][j])
                       for i in range(t) for j in range(t)])
    return c_flat, m_flat


def permute_mont(state_m: jnp.ndarray) -> jnp.ndarray:
    """Poseidon permutation, (16, t, B) Montgomery in/out, by the
    implementation utils/backend.py picks for this platform."""
    from ..field import fr_ffi
    if fr_ffi.enabled():
        # the whole permutation is ONE custom call — the compile-mass
        # collapse that keeps the full batch's compile inside budget
        t = state_m.shape[1]
        return fr_ffi.poseidon_permute_mont(state_m, *_ffi_constants(t))
    return permute_mont_xla(state_m)


def poseidon(inputs: list[jnp.ndarray]) -> jnp.ndarray:
    """Poseidon hash of n canonical (16, *batch) elements -> (16, *batch).

    Equivalent to circomlib `Poseidon(n)` (out signal)."""
    n = len(inputs)
    t = n + 1
    bshape = jnp.broadcast_shapes(*[x.shape[1:] for x in inputs])
    flat = [jnp.broadcast_to(x, (N_LIMBS,) + bshape).reshape(N_LIMBS, -1)
            for x in inputs]
    zero = jnp.zeros_like(flat[0])
    state = jnp.stack([zero] + flat, axis=1)  # (16, t, B)
    state = fr.to_mont(state)
    state = permute_mont(state)
    out = fr.from_mont(state[:, 0])
    return out.reshape((N_LIMBS,) + bshape)


jposeidon = jax.jit(poseidon)
