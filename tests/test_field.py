"""Field-core tests: limb kernels vs Python bigint oracle."""

import random

import jax
import numpy as np
import pytest

from circuits_tpu.field import fr, scalar
from circuits_tpu.field.scalar import P

rng = random.Random(0xC1BC)


def rand_elems(n, lo=0, hi=P - 1):
    return [rng.randint(lo, hi) for _ in range(n)]


def test_pack_roundtrip():
    xs = rand_elems(17) + [0, 1, P - 1]
    arr = fr.pack(xs)
    back = fr.unpack_np(arr)
    assert [int(v) for v in back] == xs


def test_add_sub_neg():
    n = 64
    a = rand_elems(n)
    b = rand_elems(n)
    A, B = fr.pack(a), fr.pack(b)
    got = fr.unpack_np(fr.jadd(A, B))
    assert [int(v) for v in got] == [(x + y) % P for x, y in zip(a, b)]
    got = fr.unpack_np(fr.jsub(A, B))
    assert [int(v) for v in got] == [(x - y) % P for x, y in zip(a, b)]
    got = fr.unpack_np(fr.jneg(A))
    assert [int(v) for v in got] == [(-x) % P for x in a]


def test_add_edge_cases():
    cases = [(0, 0), (P - 1, 1), (P - 1, P - 1), (1, 0), (P // 2, P // 2 + 1)]
    a = [c[0] for c in cases]
    b = [c[1] for c in cases]
    got = fr.unpack_np(fr.jadd(fr.pack(a), fr.pack(b)))
    assert [int(v) for v in got] == [(x + y) % P for x, y in zip(a, b)]


def test_mont_mul():
    n = 64
    a = rand_elems(n) + [0, 1, P - 1, 2**255 % P]
    b = rand_elems(n) + [P - 1, 0, P - 1, 2**254 % P]
    A, B = fr.pack(a), fr.pack(b)
    got = fr.unpack_np(fr.jmont_mul(A, B))
    Rinv = pow(scalar.R, -1, P)
    want = [(x * y * Rinv) % P for x, y in zip(a, b)]
    assert [int(v) for v in got] == want


@pytest.mark.parametrize("form", ["unrolled", "compact"])
def test_mont_mul_xla_forms(form):
    """Both plain XLA multiply forms (the reference; both platforms run
    the native custom call) against the Python big-int field."""
    f = {"unrolled": fr.mont_mul_unrolled, "compact": fr.mont_mul_compact}
    a = rand_elems(14) + [0, P - 1]
    b = rand_elems(14) + [P - 1, P - 1]
    got = fr.unpack_np(jax.jit(f[form])(fr.pack(a), fr.pack(b)))
    Rinv = pow(scalar.R, -1, P)
    assert [int(v) for v in got] == [(x * y * Rinv) % P
                                     for x, y in zip(a, b)]


def test_mul_canonical():
    n = 32
    a = rand_elems(n)
    b = rand_elems(n)
    got = fr.unpack_np(fr.jmul(fr.pack(a), fr.pack(b)))
    assert [int(v) for v in got] == [(x * y) % P for x, y in zip(a, b)]


def test_to_from_mont():
    xs = rand_elems(8) + [0, 1, P - 1]
    m = fr.jto_mont(fr.pack(xs))
    got = fr.unpack_np(m)
    assert [int(v) for v in got] == [(x * scalar.R) % P for x in xs]
    back = fr.unpack_np(fr.jfrom_mont(m))
    assert [int(v) for v in back] == xs


def test_sum_list():
    k, n = 7, 16
    rows = [rand_elems(n) for _ in range(k)]
    elems = [fr.pack(r) for r in rows]
    got = fr.unpack_np(fr.jsum_list(elems))
    want = [sum(rows[j][i] for j in range(k)) % P for i in range(n)]
    assert [int(v) for v in got] == want


def test_predicates_select():
    a = [0, 5, P - 1, 5]
    b = [0, 5, 3, 6]
    A, B = fr.pack(a), fr.pack(b)
    assert list(np.asarray(fr.is_zero(A))) == [True, False, False, False]
    assert list(np.asarray(fr.eq(A, B))) == [True, True, False, False]
    sel = fr.select(fr.eq(A, B), A, B)
    assert [int(v) for v in fr.unpack_np(sel)] == [0, 5, 3, 6]
    assert list(np.asarray(fr.gt(A, B))) == [False, False, True, False]


def test_bits_roundtrip():
    xs = [0, 1, (1 << 40) - 1, 123456789, (1 << 253) + 12345]
    arr = fr.pack(xs)
    bits = fr.bits_le(arr, 254)
    want_bits = [[(x >> k) & 1 for x in xs] for k in range(254)]
    assert np.asarray(bits).tolist() == want_bits
    back = fr.unpack_np(fr.from_bits_le(bits))
    assert [int(v) for v in back] == xs


def test_pow_inv():
    xs = rand_elems(6) + [1, P - 1]
    A = fr.pack(xs)
    got = fr.unpack_np(fr.jpow_const(A, 5))
    assert [int(v) for v in got] == [pow(x, 5, P) for x in xs]
    inv = fr.unpack_np(fr.jinv(A))
    assert [int(v) for v in inv] == [pow(x, -1, P) for x in xs]
    # 0 -> 0 convention
    z = fr.unpack_np(fr.jinv(fr.pack([0])))
    assert int(z[0]) == 0


def test_sqrt():
    xs = [x * x % P for x in rand_elems(6)] + [0, 1, 4]
    A = fr.pack(xs)
    root, ok = fr.jsqrt(A)
    root = fr.unpack_np(root)
    ok = np.asarray(ok)
    for x, r, o in zip(xs, [int(v) for v in root], list(ok)):
        assert o
        assert (r * r) % P == x % P
        assert r <= P - r
    # non-residue
    nr = scalar.NONRESIDUE
    _, ok = fr.jsqrt(fr.pack([nr]))
    assert not bool(np.asarray(ok)[0])


def test_u32_helpers():
    xs = [0, 1, 0xFFFFFFFF, 12345678]
    A = fr.pack(xs)
    lo = np.asarray(fr.low_u32(A))
    assert list(lo) == xs
    back = fr.unpack_np(fr.from_u32(fr.low_u32(A)))
    assert [int(v) for v in back] == xs
