"""BN254 Fr arithmetic as batched 32-bit limb kernels.

Design (32-bit integer lanes only):
  * A field element batch is a ``uint32`` array of shape ``(16, *batch)``:
    16 little-endian limbs of 16 bits each, limb axis leading so the batch
    axes are the contiguous, vectorized ones.
  * Products of two 16-bit limbs fit exactly in uint32; sums of many such
    partial products stay below 2^32 (lazy-carry columns), so no 64-bit
    product is needed anywhere.
  * Multiplication is Montgomery (R = 2^256) using a vectorized CIOS-style
    reduction: one full schoolbook product into 32 lazy columns, then 16
    interleaved reduction steps.

This replaces the reference's x86-64 NASM field library generated by ffiasm
(reference: /root/reference/tools/helpers/actions.js:207-229) with a
batched, XLA-fusable formulation.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from . import scalar
from . import fr_ffi
from .scalar import P, N_LIMBS, LIMB_BITS, LIMB_MASK, N0, R, R2

_U32 = jnp.uint32
MASK = np.uint32(LIMB_MASK)

# ---------------------------------------------------------------------------
# Host <-> device conversion
# ---------------------------------------------------------------------------


def pack_np(values) -> np.ndarray:
    """Python ints (nested lists / 1-D) -> uint32 limb array (16, *shape)."""
    arr = np.asarray(values, dtype=object)
    out = np.zeros((N_LIMBS,) + arr.shape, dtype=np.uint32)
    flat = arr.reshape(-1)
    out_flat = out.reshape(N_LIMBS, -1)
    for idx, v in enumerate(flat):
        v = int(v) % P
        for i in range(N_LIMBS):
            out_flat[i, idx] = (v >> (LIMB_BITS * i)) & LIMB_MASK
    return out


def pack(values) -> jnp.ndarray:
    return jnp.asarray(pack_np(values))


def unpack_np(arr) -> np.ndarray:
    """uint32 limb array (16, *shape) -> object ndarray of Python ints."""
    arr = np.asarray(arr)
    assert arr.shape[0] == N_LIMBS
    flat = arr.reshape(N_LIMBS, -1)
    n = flat.shape[1]
    out = np.empty((n,), dtype=object)
    for idx in range(n):
        v = 0
        for i in range(N_LIMBS):
            v |= int(flat[i, idx]) << (LIMB_BITS * i)
        out[idx] = v
    return out.reshape(arr.shape[1:])


def unpack_int(arr) -> int:
    """Single element (16,) or (16,1...) -> Python int."""
    res = unpack_np(np.asarray(arr).reshape(N_LIMBS, -1))
    assert res.size == 1
    return int(res.reshape(-1)[0])


def const(x: int, batch_shape=()) -> jnp.ndarray:
    """Broadcastable device constant with shape (16, *[1]*len(batch_shape))."""
    limbs = np.array(scalar.to_limbs(x), dtype=np.uint32)
    limbs = limbs.reshape((N_LIMBS,) + (1,) * len(batch_shape))
    return jnp.asarray(limbs)


def zeros(batch_shape=()) -> jnp.ndarray:
    return jnp.zeros((N_LIMBS,) + tuple(batch_shape), dtype=_U32)


_P_LIMBS_NP = np.array(
    [(P >> (16 * i)) & 0xFFFF for i in range(N_LIMBS)], dtype=np.uint32)
_2P_LIMBS_NP = np.array(
    [((2 * P) >> (16 * i)) & 0xFFFF for i in range(17)], dtype=np.uint32
)


def _bcast_const(limbs_np: np.ndarray, ref: jnp.ndarray) -> jnp.ndarray:
    shape = (limbs_np.shape[0],) + (1,) * (ref.ndim - 1)
    return jnp.asarray(limbs_np.reshape(shape))


# ---------------------------------------------------------------------------
# Carry handling
# ---------------------------------------------------------------------------


def _carry_prop(cols: list) -> list:
    """Propagate carries over lazy uint32 columns; returns normalized limbs
    (< 2^16 each) with one extra top limb appended."""
    out = []
    carry = None
    for c in cols:
        v = c if carry is None else c + carry
        out.append(v & MASK)
        carry = v >> np.uint32(LIMB_BITS)
    out.append(carry)
    return out


def _sub_if_ge(limbs: list, mod_limbs: np.ndarray) -> list:
    """limbs: normalized list (len >= len(mod_limbs)), value < 2*mod.
    Subtract mod if limbs >= mod. Returns list of len(limbs)."""
    n = len(limbs)
    m = [np.uint32(mod_limbs[i]) if i < len(mod_limbs) else np.uint32(0)
         for i in range(n)]
    # subtract with borrow (work in uint32 wrap-around domain)
    diff = []
    borrow = jnp.zeros_like(limbs[0])
    for i in range(n):
        d = limbs[i] - m[i] - borrow
        borrow = (d >> np.uint32(31)) & np.uint32(1)  # wrapped => borrow
        diff.append(d & MASK)
    keep = borrow.astype(jnp.bool_)  # borrow out => limbs < mod => keep
    return [jnp.where(keep, limbs[i], diff[i]) for i in range(n)]


def _stack(limbs: list) -> jnp.ndarray:
    return jnp.stack(limbs[:N_LIMBS], axis=0)


# ---------------------------------------------------------------------------
# Add / sub / neg
# ---------------------------------------------------------------------------


def add(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(a + b) mod p; inputs canonical."""
    if fr_ffi.enabled():
        return fr_ffi.add(a, b)
    return add_xla(a, b)


def add_xla(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    cols = [a[i] + b[i] for i in range(N_LIMBS)]
    limbs = _carry_prop(cols)
    limbs = _sub_if_ge(limbs, _P_LIMBS_NP)
    return _stack(limbs)


def sum_list(elems: list) -> jnp.ndarray:
    """Sum of up to ~2^15 canonical elements, elementwise over the batch."""
    k = len(elems)
    assert k >= 1
    if k == 1:
        return elems[0]
    cols = [elems[0][i] for i in range(N_LIMBS)]
    for e in elems[1:]:
        for i in range(N_LIMBS):
            cols[i] = cols[i] + e[i]
    limbs = _carry_prop(cols)  # value < k*p
    # reduce by conditional subtraction of p * 2^j, largest first
    j = 0
    while (1 << j) < k:
        j += 1
    for shift in range(j - 1, -1, -1):
        mod = (P << shift)
        mod_limbs = np.array(
            [(mod >> (16 * i)) & 0xFFFF for i in range(len(limbs))],
            dtype=np.uint32)
        limbs = _sub_if_ge(limbs, mod_limbs)
    return _stack(limbs)


def neg(a: jnp.ndarray) -> jnp.ndarray:
    """(-a) mod p; input canonical."""
    pl = _P_LIMBS_NP
    diff = []
    borrow = jnp.zeros_like(a[0])
    for i in range(N_LIMBS):
        d = np.uint32(pl[i]) - a[i] - borrow
        borrow = (d >> np.uint32(31)) & np.uint32(1)
        diff.append(d & MASK)
    # a == 0 -> p - 0 = p must map back to 0
    z = is_zero(a)
    return jnp.where(z[None], jnp.zeros_like(a), jnp.stack(diff, axis=0))


def sub(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(a - b) mod p; inputs canonical."""
    if fr_ffi.enabled():
        return fr_ffi.sub(a, b)
    return sub_xla(a, b)


def sub_xla(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    pl = _P_LIMBS_NP
    # Column i = a_i + p_i + 2^16 - b_i never wraps (bias 2^16 > any b_i);
    # the accumulated bias sum(2^16 * 2^(16 i)) is stripped exactly below.
    cols = [a[i] + np.uint32(pl[i]) + np.uint32(0x10000) - b[i]
            for i in range(N_LIMBS)]
    limbs = _carry_prop(cols)
    bias = sum((1 << 16) << (16 * i) for i in range(N_LIMBS))
    # value = a + p - b + bias ; strip bias via exact subtraction
    bias_limbs = np.array(
        [(bias >> (16 * i)) & 0xFFFF for i in range(len(limbs))],
        dtype=np.uint32)
    limbs = _sub_exact(limbs, bias_limbs)
    limbs = _sub_if_ge(limbs, _P_LIMBS_NP)
    return _stack(limbs)


def _sub_exact(limbs: list, mod_limbs: np.ndarray) -> list:
    """Exact subtraction limbs - mod (guaranteed >= 0)."""
    n = len(limbs)
    out = []
    borrow = jnp.zeros_like(limbs[0])
    for i in range(n):
        m = np.uint32(mod_limbs[i]) if i < len(mod_limbs) else np.uint32(0)
        d = limbs[i] - m - borrow
        borrow = (d >> np.uint32(31)) & np.uint32(1)
        out.append(d & MASK)
    return out


# ---------------------------------------------------------------------------
# Montgomery multiplication
# ---------------------------------------------------------------------------


# constant gather indices for the anti-diagonal (convolution) sum:
# padded row i (width 33) flattened at stride 33 holds entry (i, k-i) at
# flat[32*i + k], so cols[k] = sum_i flat[32*i + k].
_DIAG_IDX = np.add.outer(32 * np.arange(N_LIMBS),
                         np.arange(2 * N_LIMBS + 1)).astype(np.int32)


def mont_mul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """a * b * R^{-1} mod p. Inputs canonical (< p), output canonical.
    Dispatches to the platform's native kernel (one custom-call
    instruction, see fr_ffi.py); the compact XLA limb graph is the
    reference."""
    if fr_ffi.enabled():
        return fr_ffi.mont_mul(a, b)
    return mont_mul_compact(a, b)


def mont_mul_unrolled(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Straight-line schoolbook + CIOS reduction over limb lists: no
    loop, so XLA fuses the whole multiply into one kernel."""
    bshape = jnp.broadcast_shapes(a.shape[1:], b.shape[1:])
    a = jnp.broadcast_to(a, (N_LIMBS,) + bshape)
    b = jnp.broadcast_to(b, (N_LIMBS,) + bshape)
    ncols = 2 * N_LIMBS + 1
    cl = [None] * ncols

    def acc(k, v):
        cl[k] = v if cl[k] is None else cl[k] + v

    for i in range(N_LIMBS):
        for j in range(N_LIMBS):
            p = a[i] * b[j]
            acc(i + j, p & MASK)
            acc(i + j + 1, p >> np.uint32(LIMB_BITS))
    cl = [jnp.zeros_like(cl[0]) if c is None else c for c in cl]
    n0 = np.uint32(N0)
    for i in range(N_LIMBS):
        m = (cl[i] * n0) & MASK
        for j in range(N_LIMBS):
            q = m * np.uint32(_P_LIMBS_NP[j])
            cl[i + j] = cl[i + j] + (q & MASK)
            cl[i + j + 1] = cl[i + j + 1] + (q >> np.uint32(LIMB_BITS))
        cl[i + 1] = cl[i + 1] + (cl[i] >> np.uint32(LIMB_BITS))
    limbs = _carry_prop(cl[N_LIMBS:2 * N_LIMBS + 1])
    limbs = _sub_if_ge(limbs, _P_LIMBS_NP)
    return _stack(limbs)


def mont_mul_compact(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Small-HLO form: one pad+gather+sum schoolbook and the 16
    interleaved Montgomery reduction steps under fori_loop."""
    bshape = jnp.broadcast_shapes(a.shape[1:], b.shape[1:])
    ncols = 2 * N_LIMBS + 1
    # 1) schoolbook product -> 33 lazy columns.
    prod = a[:, None] * b[None, :]  # (16, 16, *batch), exact in uint32
    lo = prod & MASK
    hi = prod >> np.uint32(LIMB_BITS)
    padw = [(0, 0)] * prod.ndim
    padw_lo = list(padw)
    padw_lo[1] = (0, ncols - N_LIMBS)       # row i: cols i..i+15
    padw_hi = list(padw)
    padw_hi[1] = (1, ncols - N_LIMBS - 1)   # row i: cols i+1..i+16
    rows = jnp.pad(lo, padw_lo) + jnp.pad(hi, padw_hi)  # (16, 33, *b)
    flat = rows.reshape((N_LIMBS * ncols,) + bshape)
    # 16 terms of < 2^16 lo + 16 of < 2^16 hi per column: max < 2^21
    cols = jnp.sum(jnp.take(flat, jnp.asarray(_DIAG_IDX), axis=0),
                   axis=0)  # (33, *batch)

    # 2) interleaved Montgomery reduction: 16 sequential steps.
    n0 = np.uint32(N0)
    pl = jnp.asarray(_P_LIMBS_NP.reshape((N_LIMBS,) + (1,) * len(bshape)))
    zrow = jnp.zeros((1,) + bshape, dtype=_U32)

    def red_step(i, cols):
        m = (jax.lax.dynamic_index_in_dim(cols, i, 0, keepdims=False)
             * n0) & MASK
        q = m[None] * pl  # (16, *batch)
        contrib = (jnp.concatenate([q & MASK, zrow], axis=0)
                   + jnp.concatenate([zrow, q >> np.uint32(LIMB_BITS)],
                                     axis=0))  # (17, *batch)
        seg = jax.lax.dynamic_slice_in_dim(cols, i, N_LIMBS + 1, 0)
        seg = seg + contrib
        carry = seg[0] >> np.uint32(LIMB_BITS)
        seg = seg.at[1].add(carry)
        return jax.lax.dynamic_update_slice_in_dim(cols, seg, i, 0)

    cols = jax.lax.fori_loop(0, N_LIMBS, red_step, cols)
    res_cols = [cols[N_LIMBS + k] for k in range(N_LIMBS + 1)]
    limbs = _carry_prop(res_cols)  # 18 limbs; value < 2p
    limbs = _sub_if_ge(limbs, _P_LIMBS_NP)
    return _stack(limbs)


_R2_NP = np.array(scalar.to_limbs(R2), dtype=np.uint32)
_ONE_NP = np.array(scalar.to_limbs(1), dtype=np.uint32)


def to_mont(a: jnp.ndarray) -> jnp.ndarray:
    return mont_mul(a, _bcast_const(_R2_NP, a))


def from_mont(a: jnp.ndarray) -> jnp.ndarray:
    return mont_mul(a, _bcast_const(_ONE_NP, a))


def mul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Canonical-domain modular multiply (2 Montgomery multiplies)."""
    return mont_mul(mont_mul(a, b), _bcast_const(_R2_NP, a))


def mont_const(x: int, ref_ndim: int = 2) -> jnp.ndarray:
    """Host: constant in Montgomery form, shape (16, 1, ...)."""
    limbs = np.array(scalar.to_limbs((x * R) % P), dtype=np.uint32)
    return jnp.asarray(limbs.reshape((N_LIMBS,) + (1,) * (ref_ndim - 1)))


# ---------------------------------------------------------------------------
# Predicates / selection
# ---------------------------------------------------------------------------


def is_zero(a: jnp.ndarray) -> jnp.ndarray:
    """(batch,) bool array."""
    acc = a[0]
    for i in range(1, N_LIMBS):
        acc = acc | a[i]
    return acc == 0


def eq(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    acc = a[0] ^ b[0]
    for i in range(1, N_LIMBS):
        acc = acc | (a[i] ^ b[i])
    return acc == 0


def select(cond: jnp.ndarray, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """cond ? a : b ; cond has batch shape (bool or 0/1)."""
    c = cond.astype(jnp.bool_)
    return jnp.where(c[None], a, b)


# ---------------------------------------------------------------------------
# Bit decomposition (canonical inputs)
# ---------------------------------------------------------------------------


_BIT_OFFS = np.arange(LIMB_BITS, dtype=np.uint32)


def bits_le(a: jnp.ndarray, nbits: int) -> jnp.ndarray:
    """Canonical input -> (nbits, *batch) uint32 bit array, little-endian.
    Caller must guarantee a < 2^nbits (use a range check residual else).
    Vectorized: one shift over a (16, 16, *batch) broadcast, then a
    reshape — keeps the jaxpr O(1) instead of O(nbits)."""
    offs = jnp.asarray(_BIT_OFFS).reshape((1, LIMB_BITS) +
                                          (1,) * (a.ndim - 1))
    allbits = (a[:, None] >> offs) & np.uint32(1)  # (16, 16, *batch)
    allbits = allbits.reshape((N_LIMBS * LIMB_BITS,) + a.shape[1:])
    return allbits[:nbits]


def from_bits_le(bits: jnp.ndarray) -> jnp.ndarray:
    """(nbits, *batch) 0/1 -> canonical field element, value reduced mod p
    (nbits <= 256; matches circom Bits2Num field semantics).
    Vectorized: pad to 256 bits, reshape (16, 16, *batch), weighted sum
    over the bit axis."""
    nbits = bits.shape[0]
    assert nbits <= 256
    bshape = bits.shape[1:]
    bits = bits.astype(_U32)
    if nbits < 256:
        bits = jnp.concatenate(
            [bits, jnp.zeros((256 - nbits,) + bshape, dtype=_U32)], axis=0)
    grouped = bits.reshape((N_LIMBS, LIMB_BITS) + bshape)
    offs = jnp.asarray(_BIT_OFFS).reshape((1, LIMB_BITS) +
                                          (1,) * len(bshape))
    cols_arr = jnp.sum(grouped << offs, axis=1)  # (16, *batch)
    limbs = _carry_prop([cols_arr[i] for i in range(N_LIMBS)])
    # value < 2^256 < 8p: reduce by conditional subtraction of 4p, 2p, p
    shifts = [2, 1, 0] if nbits > 254 else [0]
    for shift in shifts:
        mod = P << shift
        mod_limbs = np.array(
            [(mod >> (16 * i)) & 0xFFFF for i in range(len(limbs))],
            dtype=np.uint32)
        limbs = _sub_if_ge(limbs, mod_limbs)
    return _stack(limbs)


def shift_small(a: jnp.ndarray, k: int) -> jnp.ndarray:
    """a * 2^k for small values: caller guarantees a * 2^k < p (used for
    packing bit-fields, e.g. nonce*2^32 in HashState). No reduction."""
    whole, rem = divmod(k, LIMB_BITS)
    if rem == 0:
        shifted = [jnp.zeros_like(a[0])] * whole + [a[i] for i in
                                                    range(N_LIMBS - whole)]
        return jnp.stack(shifted, axis=0)
    lo = (a << np.uint32(rem)) & MASK
    hi = a >> np.uint32(LIMB_BITS - rem)
    out = [jnp.zeros_like(a[0])] * N_LIMBS
    for i in range(N_LIMBS - whole):
        j = i + whole
        out[j] = out[j] | lo[i]
        if j + 1 < N_LIMBS:
            out[j + 1] = out[j + 1] | hi[i]
    return jnp.stack(out, axis=0)


def low_u32(a: jnp.ndarray) -> jnp.ndarray:
    """Low 32 bits of a canonical element as a uint32 (batch,) array."""
    return a[0] | (a[1] << np.uint32(16))


def from_u32(x: jnp.ndarray) -> jnp.ndarray:
    """uint32 (batch,) -> field element."""
    x = x.astype(_U32)
    limbs = [x & MASK, x >> np.uint32(16)]
    limbs += [jnp.zeros_like(x) for _ in range(N_LIMBS - 2)]
    return jnp.stack(limbs, axis=0)


def from_bool(x: jnp.ndarray) -> jnp.ndarray:
    return from_u32(x.astype(_U32))


# ---------------------------------------------------------------------------
# Exponentiation / inversion / sqrt
# ---------------------------------------------------------------------------


def _pow_const_mont(a_mont: jnp.ndarray, e: int) -> jnp.ndarray:
    """a^e with fixed exponent; input/output in Montgomery form.
    Uses a fori_loop over exponent bits (LSB-first) to keep traces small;
    on CPU one FFI call runs the whole ladder natively."""
    if fr_ffi.enabled():
        return fr_ffi.pow_const_mont(a_mont, e)
    nbits = e.bit_length()
    ebits = jnp.asarray(
        np.array([(e >> i) & 1 for i in range(nbits)], dtype=np.uint32))
    one_m = _bcast_const(np.array(scalar.to_limbs(R % P), np.uint32), a_mont)
    one_m = jnp.broadcast_to(one_m, a_mont.shape)

    def body(i, carry):
        acc, base = carry
        bit = ebits[i]
        nacc = mont_mul(acc, base)
        acc = select(bit, nacc, acc)
        base = mont_mul(base, base)
        return (acc, base)

    acc, _ = jax.lax.fori_loop(0, nbits, body, (one_m, a_mont))
    return acc


def pow_const(a: jnp.ndarray, e: int) -> jnp.ndarray:
    """Canonical in/out fixed-exponent power."""
    return from_mont(_pow_const_mont(to_mont(a), e))


def inv(a: jnp.ndarray) -> jnp.ndarray:
    """Batched modular inverse (0 -> 0, matching circomlib's IsZero hint).

    Uses Fermat via the fori_loop ladder. For large batches this is
    compute-heavy but fully parallel; Montgomery-trick batching can be
    layered on top later if profiling demands it.
    """
    z = is_zero(a)
    safe = select(z, const(1, a.shape[1:]), a)
    r = from_mont(_pow_const_mont(to_mont(safe), P - 2))
    return select(z, zeros(a.shape[1:]), r)


def sqrt(a: jnp.ndarray):
    """Batched Tonelli-Shanks sqrt.

    Returns (root, ok): root^2 == a where ok; root == 0 where `a` is a
    non-residue (ok False) . Root returned is the "minimal" root
    min(r, p-r). Input canonical.
    """
    Q = scalar.Q_ODD
    K = scalar.TWO_ADICITY
    z = is_zero(a)
    safe = select(z, const(1, a.shape[1:]), a)
    am = to_mont(safe)
    t = _pow_const_mont(am, Q)                # a^Q (mont)
    r = _pow_const_mont(am, (Q + 1) // 2)     # a^((Q+1)/2) (mont)
    c = jnp.broadcast_to(
        _bcast_const(np.array(
            scalar.to_limbs((scalar.ROOT_OF_UNITY * R) % P), np.uint32), am),
        am.shape)
    one_m = jnp.broadcast_to(
        _bcast_const(np.array(scalar.to_limbs(R % P), np.uint32), am),
        am.shape)

    # Constant-structure main loop: for i in K..2 (27 outer iterations):
    #   b = t^(2^(i-2)) ; if b != 1: r *= c ; c = c^2 ; if b != 1: t *= c
    def outer(k, carry):
        r, c, t = carry
        i = K - k  # i goes K, K-1, ..., 2

        def inner(j, b):
            do = j < (i - 2)
            b2 = mont_mul(b, b)
            return select(do, b2, b)

        b = jax.lax.fori_loop(0, K - 2, inner, t)
        b_is_one = eq(b, one_m)
        r = select(b_is_one, r, mont_mul(r, c))
        c = mont_mul(c, c)
        t = select(b_is_one, t, mont_mul(t, c))
        return (r, c, t)

    r, c, t = jax.lax.fori_loop(0, K - 1, outer, (r, c, t))
    root = from_mont(r)
    # verify
    sqr = mul(root, root)
    ok = eq(sqr, safe) & ~z
    root = select(z | ~ok, zeros(a.shape[1:]), root)
    # canonicalize: min(r, p-r)
    other = neg(root)
    root = select(gt(root, other), other, root)
    return root, ok | z


def gt(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """a > b as integers (canonical); (batch,) bool."""
    gt_acc = jnp.zeros(a.shape[1:], dtype=jnp.bool_)
    decided = jnp.zeros(a.shape[1:], dtype=jnp.bool_)
    for i in range(N_LIMBS - 1, -1, -1):
        limb_gt = a[i] > b[i]
        limb_ne = a[i] != b[i]
        gt_acc = jnp.where(~decided & limb_ne, limb_gt, gt_acc)
        decided = decided | limb_ne
    return gt_acc


def geq_const(a: jnp.ndarray, x: int) -> jnp.ndarray:
    xb = jnp.broadcast_to(const(x, a.shape[1:]), a.shape)
    return ~gt(xb, a)


# ---------------------------------------------------------------------------
# Jitted entry points (for host-driven use; inside larger jitted models call
# the raw functions directly — jit-of-jit is inlined anyway).
# ---------------------------------------------------------------------------

jadd = jax.jit(add)
jsub = jax.jit(sub)
jneg = jax.jit(neg)
jmont_mul = jax.jit(mont_mul)
jmul = jax.jit(mul)
jto_mont = jax.jit(to_mont)
jfrom_mont = jax.jit(from_mont)
jinv = jax.jit(inv)
jsqrt = jax.jit(sqrt)
jsum_list = jax.jit(sum_list)
jpow_const = jax.jit(pow_const, static_argnums=1)
