"""Matmul-limb Poseidon (ops/poseidon_mxu.py) vs the host oracle — bit-exact.

Its arithmetic is exact on every backend (bf16 inputs, f32
accumulation, all values < 2^24), so CPU CI pins its correctness."""

import random

import numpy as np
import jax

from circuits_tpu.field import fr
from circuits_tpu.field.scalar import P
from circuits_tpu.ops.poseidon_constants import poseidon_py
from circuits_tpu.ops.poseidon_mxu import jpermute_mont_mxu

rng = random.Random(31)


def test_mxu_permutation_matches_oracle():
    for t in (3, 5):
        B = 4
        rows = [[rng.randrange(P) for _ in range(t - 1)] for _ in range(B)]
        state = [[0] * B] + [[r[i] for r in rows] for i in range(t - 1)]
        st = fr.to_mont(fr.pack(state))          # (16, t, B) mont
        out = jpermute_mont_mxu(st)
        h = fr.unpack_np(np.asarray(fr.from_mont(out[:, 0])))
        want = [poseidon_py(r) for r in rows]
        assert [int(v) for v in h] == want, f"t={t}"


def test_mxu_matches_xla_scan_path():
    from circuits_tpu.ops.poseidon import permute_mont_xla

    t, B = 4, 3
    vals = [[rng.randrange(P) for _ in range(B)] for _ in range(t)]
    st = fr.to_mont(fr.pack(vals))
    got = np.asarray(jpermute_mont_mxu(st))
    want = np.asarray(jax.jit(permute_mont_xla)(st))
    assert np.array_equal(got, want)
