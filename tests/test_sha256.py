"""SHA-256 kernel vs hashlib — both backends.

The native custom call (what both platforms run) and the plain XLA
reference scan must agree with hashlib bit-for-bit.
"""

import hashlib
import random

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from circuits_tpu.field import fr_ffi
from circuits_tpu.ops.sha256 import sha256_bits, digest_to_field
from circuits_tpu.field.scalar import P

rng = random.Random(17)


def _digest_bits(bits_np):
    """Run sha256_bits on (nbits, B) numpy 0/1 and return digest ints."""
    out = np.asarray(jax.jit(sha256_bits)(jnp.asarray(bits_np)))
    return [int("".join(str(b) for b in out[:, k]), 2)
            for k in range(out.shape[1])]


def _oracle(msg_bits):
    nbits = len(msg_bits)
    byts = int("".join(str(b) for b in msg_bits), 2).to_bytes(
        (nbits + 7) // 8, "big") if nbits % 8 == 0 else None
    assert byts is not None, "test vectors must be byte-aligned"
    return int.from_bytes(hashlib.sha256(byts).digest(), "big")


@pytest.mark.parametrize("nbits", [8, 440, 512, 1024, 4096])
def test_sha256_ffi_vs_hashlib(nbits):
    assert fr_ffi.enabled(), "CPU suite must exercise the FFI fast path"
    msgs = [[rng.randrange(2) for _ in range(nbits)] for _ in range(3)]
    got = _digest_bits(np.array(msgs, dtype=np.uint32).T)
    assert got == [_oracle(m) for m in msgs]


@pytest.mark.parametrize("nbits", [384, 704])
def test_sha256_xla_vs_hashlib(xla_backend, nbits):
    """The plain XLA reference scan, at one and two blocks. Eager: the
    compiled scan runs ~2000 unfused u32 thunks per block on XLA:CPU
    (minutes per digest); op-by-op dispatch takes about a second."""
    assert not fr_ffi.enabled()
    msgs = [[rng.randrange(2) for _ in range(nbits)] for _ in range(2)]
    bits = jnp.asarray(np.array(msgs, dtype=np.uint32).T)
    with jax.disable_jit():
        out = np.asarray(sha256_bits(bits))
    got = [int("".join(str(b) for b in out[:, k]), 2)
           for k in range(out.shape[1])]
    assert got == [_oracle(m) for m in msgs]


def test_digest_to_field_reduces_mod_p():
    bits = np.ones((256, 1), dtype=np.uint32)  # 2^256 - 1
    out = digest_to_field(jnp.asarray(bits))
    from circuits_tpu.field import fr
    assert int(fr.unpack_np(np.asarray(out))[0]) == (2 ** 256 - 1) % P
