"""Poseidon: circomlib-compatibility vectors + batched kernel vs oracle."""

import random

import jax
import numpy as np
import pytest

from circuits_tpu.field import fr
from circuits_tpu.field.scalar import P
from circuits_tpu.ops.poseidon_constants import poseidon_py, constants
from circuits_tpu.ops.poseidon import jposeidon, poseidon

rng = random.Random(7)

# Public circomlib/circomlibjs & go-iden3-crypto test vectors.
VECTORS = {
    (1,): 18586133768512220936620570745912940619677854269274689475585506675881198879027,
    (1, 2): 7853200120776062878684798364095072458815029376092732009249414926327459813530,
    (1, 2, 3, 4): 18821383157269793795438455681495246036402687001665670618754263018637548127333,
    (1, 2, 0, 0, 0): 1018317224307729531995786483840663576608797660851238720571059489595066344487,
    (1, 2, 3, 4, 5, 6): 20400040500897583745843009878988256314335038853985262692600694741116813247201,
}


def test_host_poseidon_vectors():
    for inp, want in VECTORS.items():
        assert poseidon_py(list(inp)) == want, f"t={len(inp)+1}"


def test_constants_shapes():
    for t in (3, 4, 5, 6, 7):
        c, m = constants(t)
        from circuits_tpu.ops.poseidon_constants import N_ROUNDS_F, N_ROUNDS_P
        assert len(c) == (N_ROUNDS_F + N_ROUNDS_P[t - 2]) * t
        assert len(m) == t and len(m[0]) == t
        assert all(0 < v < P for row in m for v in row)


def test_device_poseidon_vectors():
    for inp, want in VECTORS.items():
        arrs = [fr.pack([v]) for v in inp]
        got = fr.unpack_int(jposeidon(arrs))
        assert got == want, f"t={len(inp)+1}"


def test_device_poseidon_batch_random():
    # the widths the rollup circuits actually use: t=3,4,5,6,7
    for n in (2, 3, 4, 5, 6):
        B = 8
        cols = [[rng.randint(0, P - 1) for _ in range(B)] for _ in range(n)]
        arrs = [fr.pack(c) for c in cols]
        got = [int(v) for v in fr.unpack_np(jposeidon(arrs))]
        want = [poseidon_py([cols[i][b] for i in range(n)]) for b in range(B)]
        assert got == want, f"n={n}"


@pytest.mark.parametrize("t", [3, 4, 5, 6, 7])
def test_xla_poseidon_vs_host(xla_backend, t):
    """The plain XLA reference permutation (no native custom call),
    reached through utils/backend.xla_reference, against the host
    Poseidon."""
    B = 4
    cols = [[rng.randint(0, P - 1) for _ in range(B)] for _ in range(t - 1)]
    got = jax.jit(lambda xs: poseidon(xs))([fr.pack(c) for c in cols])
    want = [poseidon_py([cols[i][b] for i in range(t - 1)])
            for b in range(B)]
    assert [int(v) for v in fr.unpack_np(got)] == want


def test_optimized_schedule_bit_exact():
    """The sparse partial-round schedule must equal
    the naive circomlib order for every width — checked here in pure
    Python so the transformation is CI-visible off the card."""
    from circuits_tpu.ops.poseidon_constants import optimized_constants

    def sbox(x):
        return pow(x, 5, P)

    for t in (3, 4, 5, 6, 7):
        oc = optimized_constants(t)
        from circuits_tpu.ops.poseidon_constants import (N_ROUNDS_F,
                                                         N_ROUNDS_P)
        rf, rp = N_ROUNDS_F, N_ROUNDS_P[t - 2]
        half = rf // 2
        state = [rng.randrange(P) for _ in range(t)]
        want_in = [0] + state[1:]  # exercise a zero lane too
        want_in[0] = state[0]

        def mat_vec(A, v):
            return [sum(A[i][k] * v[k] for k in range(t)) % P
                    for i in range(t)]

        # naive
        from circuits_tpu.ops.poseidon_constants import constants
        C, M = constants(t)
        s = list(want_in)
        for r in range(rf + rp):
            s = [(s[i] + C[r * t + i]) % P for i in range(t)]
            if r < half or r >= half + rp:
                s = [sbox(x) for x in s]
            else:
                s[0] = sbox(s[0])
            s = mat_vec(M, s)
        want = s

        # optimized
        s = list(want_in)
        for r in range(half):
            s = [(s[i] + oc["full_c"][r][i]) % P for i in range(t)]
            s = [sbox(x) for x in s]
            s = mat_vec(oc["m"] if r < half - 1 else oc["pre_sparse"], s)
        for r in range(rp):
            if r == 0:
                s = [(s[i] + oc["d"][i]) % P for i in range(t)]
            s[0] = (sbox(s[0]) + oc["e"][r]) % P
            row0, col = oc["sparse_row"][r], oc["sparse_col"][r]
            out0 = sum(row0[j] * s[j] for j in range(t)) % P
            s = [out0] + [(s[i] + col[i - 1] * s[0]) % P
                          for i in range(1, t)]
        for r in range(half, rf):
            s = [(s[i] + oc["full_c"][r][i]) % P for i in range(t)]
            s = [sbox(x) for x in s]
            s = mat_vec(oc["m"], s)
        assert s == want, f"t={t} optimized schedule mismatch"
