"""Batched SHA-256 over bit-arrays (circomlib Sha256(nBits) semantics).

Used by HashInputs (src/hash-inputs.circom:111-177) and Withdraw
(src/withdraw.circom:132-175): one SHA-256 over the packed public-input
bitstring, out[0..255] MSB-first.

Formulation: bits are packed into uint32 words (32x fewer lanes of work
than circomlib's bit-level circuit) and the compression runs as a
`lax.scan` over 512-bit blocks, batched over the witness lanes.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..field import fr

_K = np.array([
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5,
    0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
    0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7,
    0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
    0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3,
    0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5,
    0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
], dtype=np.uint32)

_H0 = np.array([
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
], dtype=np.uint32)


def _rotr(x, n):
    return (x >> np.uint32(n)) | (x << np.uint32(32 - n))


def _compress_block(h, w16):
    """h: tuple of 8 (B,) uint32; w16: (16, B) uint32 message words."""
    w = [w16[i] for i in range(16)]
    for i in range(16, 64):
        s0 = _rotr(w[i - 15], 7) ^ _rotr(w[i - 15], 18) ^ (w[i - 15] >> np.uint32(3))
        s1 = _rotr(w[i - 2], 17) ^ _rotr(w[i - 2], 19) ^ (w[i - 2] >> np.uint32(10))
        w.append(w[i - 16] + s0 + w[i - 7] + s1)
    a, b, c, d, e, f, g, hh = h
    for i in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = hh + s1 + ch + np.uint32(_K[i]) + w[i]
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = s0 + maj
        hh, g, f, e, d, c, b, a = g, f, e, d + t1, c, b, a, t1 + t2
    return tuple(x + y for x, y in zip(h, (a, b, c, d, e, f, g, hh)))


def sha256_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """bits: (nBits, *batch) 0/1 uint32, MSB-first message bits.
    Returns digest bits (256, *batch) MSB-first (= circomlib Sha256 out[])."""
    nbits = bits.shape[0]
    bshape = bits.shape[1:]
    nblocks = (nbits + 65 + 511) // 512
    total = nblocks * 512
    # padded bit array: message bits + 1-bit + zeros + 64-bit length
    # (vectorized: one concatenate + one weighted reduction to words)
    pad_np = np.zeros((total - nbits,) + (1,) * len(bshape),
                      dtype=np.uint32)
    pad_np[0] = 1
    for i in range(64):
        pad_np[-64 + i] = (nbits >> (63 - i)) & 1
    allbits = jnp.concatenate(
        [bits.astype(jnp.uint32),
         jnp.broadcast_to(jnp.asarray(pad_np),
                          (total - nbits,) + bshape)], axis=0)
    weights = jnp.asarray(
        (np.uint32(1) << np.arange(31, -1, -1, dtype=np.uint32))
        .reshape((1, 32) + (1,) * len(bshape)))
    grouped = allbits.reshape((total // 32, 32) + bshape)
    words = jnp.sum(grouped * weights, axis=1, dtype=jnp.uint32)
    from ..field import fr_ffi
    if fr_ffi.enabled():
        # CPU: one custom call per digest — the XLA formulation lowers
        # to ~2000 unfused u32[1] thunks per block on XLA:CPU, which at
        # the measured ~0.2 ms/thunk dispatch cost was the execution
        # wall of the multichip dryrun (round-4 diagnosis)
        hstack = fr_ffi.sha256_blocks(words)
    else:
        warr = words.reshape((nblocks, 16) + bshape)
        h0 = tuple(jnp.full(bshape, v, dtype=jnp.uint32) for v in _H0)

        def body(h, w16):
            return _compress_block(h, w16), None

        hfin, _ = jax.lax.scan(body, h0, warr)
        hstack = jnp.stack(hfin, axis=0)  # (8, *batch)
    shifts = jnp.asarray(
        np.arange(31, -1, -1, dtype=np.uint32)
        .reshape((1, 32) + (1,) * len(bshape)))
    outbits = (hstack[:, None] >> shifts) & np.uint32(1)
    return outbits.reshape((256,) + bshape)


def digest_to_field(digest_bits: jnp.ndarray) -> jnp.ndarray:
    """256 MSB-first digest bits -> field element (Bits2Num of reversed
    bits, i.e. the 256-bit big-endian integer reduced mod p) — matching
    hash-inputs.circom:179-184."""
    return fr.from_bits_le(jnp.flip(digest_bits, axis=0))


jsha256_bits = jax.jit(sha256_bits)
