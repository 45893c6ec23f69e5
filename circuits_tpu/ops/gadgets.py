"""Small batched gadget kernels: float40 decode, fee computation, ranges.

These replicate the reference's library gadgets as array programs:
  * DecodeFloatBin  — src/lib/decode-float.circom:12-44
  * ComputeFee      — src/compute-fee.circom:12-94 (+ feeShiftTable)
  * Mux256          — src/lib/mux256.circom:10-52 (a gather on the device)
  * BitsCompressed2AySign — src/lib/utils-bjj.circom:12-28
  * Num2Bits range semantics (a `bits_le` plus an explicit width check,
    the algebraic equivalent of circom's bit-decomposition constraints)
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..field import fr
from ..field.scalar import P, R as MONT_R, N_LIMBS, to_limbs
from ..builder.fee_table import TABLE_ADJUSTED_FEE, BITS_SHIFT


def fits_bits(a: jnp.ndarray, nbits: int) -> jnp.ndarray:
    """(batch,) bool: a < 2^nbits (canonical input). The residual form of
    circom's Num2Bits(n) padding constraints."""
    if nbits >= 254:
        return jnp.ones(a.shape[1:], dtype=bool)
    return ~fr.geq_const(a, 1 << nbits)


# 10^e for the 5-bit exponent, stored in R-form (x*R mod p) so a single
# mont_mul against the canonical mantissa yields the canonical product.
_POW10_R_NP = np.zeros((32, N_LIMBS), dtype=np.uint32)
for _e in range(32):
    _POW10_R_NP[_e] = np.array(
        to_limbs((pow(10, _e, P) * MONT_R) % P), dtype=np.uint32)


def decode_float_bin(bits40: jnp.ndarray) -> jnp.ndarray:
    """float40 bits (40, *batch) -> value (16, *batch).
    out = mantissa(bits 0..34) * 10^exponent(bits 35..39). The circuit
    builds 10^e from 5 conditional squarings for constraint economy
    (src/lib/decode-float.circom:29-34); the witness value is identical
    computed as one table gather + one Montgomery multiply (12x fewer
    mont_mul call sites — XLA CPU compile cost scales with those)."""
    m = fr.from_bits_le(bits40[:35])
    e = (bits40[35] + 2 * bits40[36] + 4 * bits40[37] + 8 * bits40[38]
         + 16 * bits40[39]).astype(jnp.int32)
    scale_r = jnp.moveaxis(jnp.take(jnp.asarray(_POW10_R_NP), e, axis=0),
                           -1, 0)  # (16, *batch)
    return fr.mont_mul(m, scale_r)


def decode_float(amount_f: jnp.ndarray):
    """float40 field value -> (value, ok): ok checks amountF < 2^40."""
    ok = fits_bits(amount_f, 40)
    bits = fr.bits_le(amount_f, 40)
    return decode_float_bin(bits), ok


# fee factors in R-form: one mont_mul against the canonical amount
_FEE_TABLE_R_NP = np.zeros((256, N_LIMBS), dtype=np.uint32)
for _i, _v in enumerate(TABLE_ADJUSTED_FEE):
    _FEE_TABLE_R_NP[_i] = np.array(
        to_limbs((_v * MONT_R) % P), dtype=np.uint32)


def compute_fee(fee_sel: jnp.ndarray, amount: jnp.ndarray,
                apply_fee: jnp.ndarray):
    """Batched ComputeFee.

    fee_sel: (batch,) uint32 (0..255); amount canonical (16, batch);
    apply_fee: (batch,) bool/0-1.
    Returns (fee_out, ok) — ok covers the 128-bit overflow constraints
    (src/compute-fee.circom:86-88)."""
    apply_b = apply_fee.astype(jnp.bool_)
    sel_eff = jnp.where(apply_b, fee_sel.astype(jnp.uint32), 0)
    factor_r = jnp.asarray(_FEE_TABLE_R_NP)[sel_eff]  # (batch, 16)
    factor_r = jnp.moveaxis(factor_r, -1, 0)  # (16, batch)
    fee_not_shifted = fr.mont_mul(factor_r, amount)
    # applyShift = 1 - bit6*bit7 of the raw selector
    b6 = (fee_sel >> 6) & 1
    b7 = (fee_sel >> 7) & 1
    apply_shift = ~((b6 & b7).astype(jnp.bool_))
    bits = fr.bits_le(fee_not_shifted, 253)
    lc_shifted = fr.from_bits_le(bits[BITS_SHIFT:BITS_SHIFT + 128])
    lc_not_shifted = fr.from_bits_le(bits[:128])
    ov_shifted = jnp.any(bits[BITS_SHIFT + 128:253].astype(bool), axis=0)
    ov_not_shifted = jnp.any(bits[128:253].astype(bool), axis=0)
    fee_out = fr.select(apply_shift, lc_shifted, lc_not_shifted)
    ok = jnp.where(apply_shift, ~ov_shifted, ~ov_not_shifted)
    # the 253-bit decomposition itself must be faithful
    ok = ok & fits_bits(fee_not_shifted, 253)
    return fee_out, ok


def mux256(sel: jnp.ndarray, table: jnp.ndarray) -> jnp.ndarray:
    """256-way select (src/lib/mux256.circom:10-52 builds this from 17
    Mux4s; on the device it is one gather). sel: (batch,) uint32 in 0..255;
    table: (256, 16) uint32 limb rows (host constants) or
    (256, 16, *batch). Returns (16, *batch)."""
    if table.ndim == 2:
        picked = jnp.take(table, sel.astype(jnp.int32), axis=0)
        return jnp.moveaxis(picked, -1, 0)
    idx = sel[None, None].astype(jnp.int32)
    return jnp.take_along_axis(
        jnp.moveaxis(table, 1, 0), idx, axis=1)[:, 0]


def bits_compressed_to_ay_sign(bjj_bits: jnp.ndarray):
    """BitsCompressed2AySign (src/lib/utils-bjj.circom:12-28): packed
    point bits (256, *batch) -> (ay (16, *batch), sign (*batch,)).
    No on-curve check (matching the reference's :7 note)."""
    ay = fr.from_bits_le(bjj_bits[:254])
    sign = bjj_bits[255].astype(jnp.bool_)
    return ay, sign


jdecode_float = jax.jit(decode_float)
jcompute_fee = jax.jit(compute_fee)
