"""Batched BabyJubJub point arithmetic + EdDSA-Poseidon verification.

Replicates circomlib's in-circuit gadgets (`EdDSAPoseidonVerifier`,
`Bits2Point_Strict`; reference usage /root/reference/src/rollup-tx.circom:2,
src/lib/utils-bjj.circom:2) as batched limb kernels.

Points are projective (X:Y:Z) with coordinates in Montgomery form, shape
(16, *batch) each. The unified twisted-Edwards addition is complete on
BabyJubJub (a square, d non-square), so masked double-and-add ladders never
hit exceptional cases.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..field import fr
from ..field.scalar import P, R as MONT_R, N_LIMBS, to_limbs
from ..builder.babyjub import (A as BJJ_A, D as BJJ_D, BASE8, IDENTITY,
                               add_point)
from .poseidon import poseidon


def _mont_np(x: int) -> np.ndarray:
    return np.array(to_limbs((x * MONT_R) % P), dtype=np.uint32)


def _mc(x: int, ndim: int) -> jnp.ndarray:
    """Montgomery-form constant broadcast over batch dims."""
    return jnp.asarray(_mont_np(x).reshape((N_LIMBS,) + (1,) * (ndim - 1)))


def identity(bshape):
    """Projective identity (0 : 1 : 1), Montgomery form."""
    zero = fr.zeros(bshape)
    one = jnp.broadcast_to(
        jnp.asarray(_mont_np(1).reshape((N_LIMBS,) + (1,) * len(bshape))),
        (N_LIMBS,) + tuple(bshape))
    return (zero, one, one)


def from_affine_mont(x_m, y_m):
    one = jnp.broadcast_to(
        jnp.asarray(_mont_np(1).reshape((N_LIMBS,) + (1,) * (x_m.ndim - 1))),
        x_m.shape)
    return (x_m, y_m, one)


def _mm_batch(pairs):
    """One mont_mul over the concatenated batch of several independent
    (a, b) multiplies — curve-add bodies inline into the scalar-mul loop
    bodies, so fewer+wider multiplies cut both compile time and per-lane
    launch overhead."""
    n = len(pairs)
    bshape = jnp.broadcast_shapes(
        *[p[i].shape[1:] for p in pairs for i in (0, 1)])
    shape = (pairs[0][0].shape[0],) + bshape
    a = jnp.concatenate(
        [jnp.broadcast_to(p[0], shape).reshape(shape[0], -1)
         for p in pairs], axis=-1)
    b = jnp.concatenate(
        [jnp.broadcast_to(p[1], shape).reshape(shape[0], -1)
         for p in pairs], axis=-1)
    r = fr.mont_mul(a, b)
    sz = r.shape[-1] // n
    return [r[:, i * sz:(i + 1) * sz].reshape(shape) for i in range(n)]


def padd(p1, p2):
    """Unified projective twisted-Edwards addition (add-2008-bbjlp),
    restructured into 5 batched mont_mul stages (4+2+2+3+2 lanes)."""
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    a, c, d, t = _mm_batch([(z1, z2), (x1, x2), (y1, y2),
                            (fr.add(x1, y1), fr.add(x2, y2))])
    bb, cd = _mm_batch([(a, a), (c, d)])
    e, ac = _mm_batch([(_mc(BJJ_D, x1.ndim), cd),
                       (_mc(BJJ_A, x1.ndim), c)])
    f = fr.sub(bb, e)
    g = fr.add(bb, e)
    u = fr.sub(fr.sub(t, c), d)
    v = fr.sub(d, ac)
    af, ag, z3 = _mm_batch([(a, f), (a, g), (f, g)])
    x3, y3 = _mm_batch([(af, u), (ag, v)])
    return (x3, y3, z3)


def pdouble(p):
    """Dedicated projective doubling (dbl-2008-bbjlp): 8 Montgomery muls
    vs 13 for padd(p, p) — matters doubly, for runtime and for the size
    of the doubling-scan body XLA has to compile."""
    x, y, z = p
    xy = fr.add(x, y)
    b, c, d, h = _mm_batch([(xy, xy), (x, x), (y, y), (z, z)])
    e = _mm_batch([(_mc(BJJ_A, x.ndim), c)])[0]
    f = fr.add(e, d)
    j = fr.sub(fr.sub(f, h), h)
    x3, y3, z3 = _mm_batch([(fr.sub(fr.sub(b, c), d), j),
                            (f, fr.sub(e, d)), (f, j)])
    return (x3, y3, z3)


def pselect(cond, p1, p2):
    return tuple(fr.select(cond, u, v) for u, v in zip(p1, p2))


_WINDOW = 4
_NDIGITS = 256 // _WINDOW


def _digits(bits):
    """bits (nbits, *batch) 0/1 LSB-first -> (64, *batch) int32 radix-16
    digits, least-significant digit first."""
    nbits = bits.shape[0]
    bshape = bits.shape[1:]
    b = bits.astype(jnp.int32)
    if nbits < 256:
        b = jnp.concatenate(
            [b, jnp.zeros((256 - nbits,) + bshape, jnp.int32)], axis=0)
    grouped = b.reshape((_NDIGITS, _WINDOW) + bshape)
    weights = jnp.asarray(
        (1 << np.arange(_WINDOW, dtype=np.int32))
        .reshape((1, _WINDOW) + (1,) * len(bshape)))
    return jnp.sum(grouped * weights, axis=1)


def _pad_identity(x, y, z, n, m):
    """Pad the point axis (dim 1) from n to m with projective identities
    (0 : 1 : 1)."""
    if m == n:
        return (x, y, z)
    pad = [(0, 0)] * x.ndim
    pad[1] = (0, m - n)
    one = jnp.broadcast_to(
        jnp.asarray(_mont_np(1).reshape((N_LIMBS,) + (1,) * (x.ndim - 1))),
        x.shape[:1] + (m - n,) + x.shape[2:])
    x = jnp.pad(x, pad)
    y = jnp.concatenate([y, one], axis=1)
    z = jnp.concatenate([z, one], axis=1)
    return (x, y, z)


def _sum_points(pts, segments=8):
    """Sum N projective points (coords (16, N, *batch)) via a segmented
    two-scan reduction: S parallel accumulation chains of length ceil(N/S)
    (one scan, batch widened S×), then one S-step scan over the partials.

    Shaped for XLA CPU compile cost: compile time is superlinear in
    top-level HLO, so inline padd trees (13 mont_muls each) are out; two
    scans whose bodies hold ONE padd each compile in ~seconds and the add
    count stays optimal (N + S adds)."""
    n = pts[0].shape[1]
    bshape = pts[0].shape[2:]
    s = min(segments, n)
    k = -(-n // s)
    pts = _pad_identity(*pts, n, s * k)
    # (16, s, k, *batch) -> scan over k with carry batch (s, *batch)
    seg = tuple(c.reshape((N_LIMBS, s, k) + bshape) for c in pts)
    xs = tuple(jnp.moveaxis(c, 2, 0) for c in seg)  # (k, 16, s, *b)

    def seg_body(acc, x):
        return padd(acc, x), None

    partial, _ = jax.lax.scan(seg_body, identity((s,) + bshape), xs)

    def fold_body(acc, x):
        return padd(acc, x), None

    xs2 = tuple(jnp.moveaxis(c, 1, 0) for c in partial)  # (s, 16, *b)
    total, _ = jax.lax.scan(fold_body, identity(bshape), xs2)
    return total


def _var_points(bits, point):
    """Masked point stack for a variable-base multiply: returns coords
    (16, nbits, *batch) with entry i = bit_i ? 2^i*point : identity.

    Doubling scan (body = one 8-mul pdouble), then the mask is two cheap
    selects — (0 : Z : Z) is the identity, so no broadcast 1 is needed."""
    nbits = bits.shape[0]

    def dbl_body(p, _):
        return pdouble(p), p

    _, rows = jax.lax.scan(dbl_body, point, None, length=nbits)
    dx, dy, dz = (jnp.moveaxis(c, 0, 1) for c in rows)  # (16, nbits, *b)
    bb = bits[None].astype(jnp.bool_)  # (1, nbits, *batch)
    x = jnp.where(bb, dx, jnp.zeros_like(dx))
    y = jnp.where(bb, dy, dz)
    return (x, y, dz)


def scalar_mul_var(bits, point):
    """Variable-base scalar multiply: bits (nbits, *batch) 0/1 LSB-first,
    point projective Montgomery.

    sum_{bit_i=1} 2^i*point via _var_points + the segmented-scan sum (the
    windowed ladder's 25-mul scan body made XLA CPU compile superlinear —
    134s for this op alone); every lane does identical work."""
    return _sum_points(_var_points(bits, point))


_BASE8_WTABLE: np.ndarray | None = None


def _base8_window_table() -> np.ndarray:
    """Host-precomputed affine table: TAB[j][d] = d * 16^j * BASE8,
    Montgomery form, shape (64, 16, 2, 16limbs). d=0 row stores the
    affine identity (0, 1)."""
    global _BASE8_WTABLE
    if _BASE8_WTABLE is None:
        tab = np.zeros((_NDIGITS, 16, 2, N_LIMBS), dtype=np.uint32)
        base = BASE8
        for j in range(_NDIGITS):
            pt = IDENTITY
            for d in range(16):
                tab[j, d, 0] = _mont_np(pt[0])
                tab[j, d, 1] = _mont_np(pt[1])
                pt = add_point(pt, base)
            for _ in range(_WINDOW):
                base = add_point(base, base)
        _BASE8_WTABLE = tab
    return _BASE8_WTABLE


def _base8_points(bits):
    """Comb-selected point stack for the fixed-base multiply by BASE8:
    one top-level gather from the host-precomputed window table (a gather
    inside a scan body cost 27s of XLA CPU compile; at top level it is a
    single fused take). Returns coords (16, 64, *batch); summing them
    gives bits·BASE8 — no doublings at all on device."""
    bshape = bits.shape[1:]
    digits = _digits(bits)  # (64, *batch) LSB-first
    tab = jnp.asarray(
        _base8_window_table().reshape(_NDIGITS * 16, 2, N_LIMBS))
    offs = (np.arange(_NDIGITS, dtype=np.int32) * 16).reshape(
        (_NDIGITS,) + (1,) * len(bshape))
    sel = jnp.take(tab, digits + jnp.asarray(offs), axis=0)
    # sel: (64, *batch, 2, 16limbs); d=0 rows hold the affine identity
    px = jnp.moveaxis(sel[..., 0, :], -1, 0)  # (16, 64, *batch)
    py = jnp.moveaxis(sel[..., 1, :], -1, 0)
    one = jnp.broadcast_to(
        jnp.asarray(_mont_np(1).reshape((N_LIMBS,) + (1,) * (px.ndim - 1))),
        px.shape)
    return (px, py, one)


def scalar_mul_base8(bits):
    """Fixed-base multiply by BASE8 (comb table + segmented-scan sum)."""
    return _sum_points(_base8_points(bits))


def points_equal(p1, p2):
    """Projective equality: X1 Z2 == X2 Z1 and Y1 Z2 == Y2 Z1; (batch,) bool.
    One 4-wide batched mont_mul (one XLA call site, not four)."""
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    a, b, c, d = _mm_batch([(x1, z2), (x2, z1), (y1, z2), (y2, z1)])
    return fr.eq(a, b) & fr.eq(c, d)


def ay_sign_to_ax(ay, sign):
    """Batched `AySign2Ax` (src/lib/utils-bjj.circom:37-58 →
    circomlib Bits2Point_Strict): recover x from y and the sign bit.

    Returns (ax, on_curve): ax canonical; on_curve False marks invalid
    compressed points (a constraint failure in the reference circuit).
    sign convention: sign=1 <=> x > (p-1)/2 (circomlib packPoint).
    """
    # all in the Montgomery domain: 5 mont_mul call sites + 2 pow ladders
    # (the canonical-domain formulation cost 2x the multiplies)
    ym = fr.to_mont(ay)
    y2m = fr.mont_mul(ym, ym)                        # y^2 * R
    one_m = jnp.broadcast_to(_mc(1, ay.ndim), ay.shape)
    num_m = fr.sub(one_m, y2m)                       # (1 - y^2) R
    den_m = fr.sub(jnp.broadcast_to(_mc(BJJ_A, ay.ndim), ay.shape),
                   fr.mont_mul(_mc(BJJ_D, ay.ndim), y2m))  # (a - d y^2) R
    den_zero = fr.is_zero(den_m)
    safe_m = fr.select(den_zero, one_m, den_m)
    inv_m = fr._pow_const_mont(safe_m, fr.scalar.P - 2)  # den^-1 * R
    x2 = fr.from_mont(fr.mont_mul(num_m, inv_m))
    root, ok = fr.sqrt(x2)  # minimal root
    big = fr.neg(root)
    ax = fr.select(sign, big, root)
    return ax, ok & ~den_zero


def eddsa_poseidon_verify(enabled, ax, ay, s, r8x, r8y, msg):
    """Batched circomlib `EdDSAPoseidonVerifier`:
    checks S*B8 == R8 + Poseidon(R8x,R8y,Ax,Ay,M)*A when enabled.

    All field inputs canonical (16, *batch); enabled (batch,) bool/0-1.
    Returns ok (batch,) bool (True wherever disabled)."""
    hm = poseidon([r8x, r8y, ax, ay, msg])
    s_bits = fr.bits_le(s, 253)
    hm_bits = fr.bits_le(hm, 254)
    # one batched to_mont for all four affine coordinates (4x fewer
    # top-level mont_mul call sites — each costs ~1-2s of XLA CPU compile)
    coords = fr.to_mont(jnp.concatenate([ax, ay, r8x, r8y], axis=-1))
    n = ax.shape[-1]
    a_pt = from_affine_mont(coords[..., 0 * n:1 * n], coords[..., 1 * n:2 * n])
    r8_pt = from_affine_mont(coords[..., 2 * n:3 * n], coords[..., 3 * n:4 * n])
    # S*B8 - R8 - hm*A must be the identity: ONE 318-point sum (twisted
    # Edwards negation is just x -> -x, and (0 : λ : λ) is the identity,
    # so the check costs zero extra multiplies and halves the number of
    # compiled reduction scans vs two separate scalar-mul sums).
    lx, ly, lz = _base8_points(s_bits)            # (16,  64, *b)
    vx, vy, vz = _var_points(hm_bits, a_pt)       # (16, 254, *b)
    neg_x = fr.neg(jnp.concatenate([vx, r8_pt[0][:, None]], axis=1))
    x = jnp.concatenate([lx, neg_x], axis=1)
    y = jnp.concatenate([ly, vy, r8_pt[1][:, None]], axis=1)
    z = jnp.concatenate([lz, vz, r8_pt[2][:, None]], axis=1)
    tx, ty, tz = _sum_points((x, y, z))
    okp = fr.is_zero(tx) & fr.eq(ty, tz)
    return okp | ~enabled.astype(jnp.bool_)


jscalar_mul_base8 = jax.jit(scalar_mul_base8)
jscalar_mul_var = jax.jit(scalar_mul_var)
jay_sign_to_ax = jax.jit(ay_sign_to_ax)
jeddsa_poseidon_verify = jax.jit(eddsa_poseidon_verify)
