"""Matmul-based limb multiplication prototype (VERDICT r3 task 4).

Idea (the jaxite-style trick): split field elements into 8-bit limbs;
multiplication by a CONSTANT becomes a banded matmul whose weights are
the constant's limbs. bf16 inputs (integers <= 255 are exact in bf16)
with f32 accumulation (column sums <= 2^22 < 2^24 stay exact) run on
the matrix units; elementwise code only carries.

Montgomery const-mul c*x*R^-1 mod p as three banded matmuls:
  1. T = x @ W_c            (63 lazy cols, 8-bit spacing)
  2. q = (T mod 2^256) @ W_n  mod 2^256   (N' = -p^-1 mod 2^256)
  3. T += q @ W_p ; result = T >> 256 (exact: low 32 limbs cancel)
Carry normalization between steps is log-convergent vector passes, not
a serial chain.

Measures the elementwise fr.mont_mul path vs the matmul pipeline at
B=65536 on the first device JAX finds, and checks both bit-exact
against Python ints.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from circuits_tpu.field import fr
from circuits_tpu.field.scalar import P

R = 1 << 256
N_PRIME = (-pow(P, -1, R)) % R  # -p^{-1} mod 2^256
NL8 = 32  # 8-bit limbs


def limbs8(x: int, n=NL8) -> list[int]:
    return [(x >> (8 * i)) & 0xFF for i in range(n)]


def banded(c_limbs, n_in, n_out):
    """W[i, i+j] = c_j (mod-2^(8*n_out) truncation built in)."""
    W = np.zeros((n_in, n_out), dtype=np.float32)
    for i in range(n_in):
        for j, cj in enumerate(c_limbs):
            k = i + j
            if k < n_out:
                W[i, k] += cj
    return W


from circuits_tpu.ops.poseidon_mxu import _normalize as normalize  # noqa: E402
# (the module version ends with an exact sequential carry scan — the
# heuristic log-passes alone can leave a 255+carry ripple alive, which
# this script's first version learned the hard way)


def make_mont_const_mul(c: int):
    """Returns f(x_limbs8 (B, 32) uint32) -> (B, 32) uint32 limbs of
    c*x*R^-1 mod p (value possibly in [0, 2p): final cond-sub included)."""
    Wc = jnp.asarray(banded(limbs8((c) % P), NL8, 2 * NL8), jnp.bfloat16)
    Wn = jnp.asarray(banded(limbs8(N_PRIME), NL8, NL8), jnp.bfloat16)
    Wp = jnp.asarray(banded(limbs8(P), NL8, 2 * NL8 + 1), jnp.bfloat16)
    p_limbs = np.array(limbs8(P), dtype=np.int32)

    def f(x8):
        xb = x8.astype(jnp.bfloat16)
        T = jax.lax.dot_general(xb, Wc, (((1,), (0,)), ((), ())),
                                preferred_element_type=jnp.float32)
        Tn = normalize(T, 2 * NL8 + 1)              # exact limbs of x*c
        lo = Tn[:, :NL8]
        q = jax.lax.dot_general(lo.astype(jnp.bfloat16), Wn,
                                (((1,), (0,)), ((), ())),
                                preferred_element_type=jnp.float32)
        q = normalize(q, NL8)                        # q = lo*N' mod 2^256
        qp = jax.lax.dot_general(q.astype(jnp.bfloat16), Wp,
                                 (((1,), (0,)), ((), ())),
                                 preferred_element_type=jnp.float32)
        S = Tn.astype(jnp.int32) + qp.astype(jnp.int32)
        Sn = normalize(S, 2 * NL8 + 2)
        hi = Sn[:, NL8:NL8 + NL8 + 1]                # (T + q*p) / 2^256
        # conditional subtract p (value < 2p)
        r = hi[:, :NL8]
        top = hi[:, NL8]
        borrow = jnp.zeros_like(r[:, 0])
        diff = []
        for i in range(NL8):
            d = r[:, i] - p_limbs[i] - borrow
            borrow = (d >> 31) & 1
            diff.append(d & 255)
        diff = jnp.stack(diff, axis=1)
        keep = ((borrow == 1) & (top == 0))[:, None]
        return jnp.where(keep, r, diff).astype(jnp.uint32)

    return jax.jit(f)


def to_limbs8_np(vals):
    out = np.zeros((len(vals), NL8), dtype=np.uint32)
    for i, v in enumerate(vals):
        for j in range(NL8):
            out[i, j] = (v >> (8 * j)) & 0xFF
    return out


def from_limbs8_np(arr):
    return [sum(int(v) << (8 * j) for j, v in enumerate(row))
            for row in np.asarray(arr)]


def main():
    import random
    rng = random.Random(9)
    B = int(os.environ.get("MXU_B", "65536"))
    c = rng.randrange(P)
    vals = [rng.randrange(P) for _ in range(256)]

    f = make_mont_const_mul(c)

    # exactness on 256 samples
    x8 = jnp.asarray(to_limbs8_np(vals))
    got = from_limbs8_np(np.asarray(f(x8)))
    Rinv = pow(R, P - 2, P)
    want = [(c * v * Rinv) % P for v in vals]
    bad = sum(1 for g, w in zip(got, want) if g != w)
    print(f"exactness: {256 - bad}/256 correct", flush=True)
    assert bad == 0, "MXU const-mul mismatch"

    # --- timing: matmul pipeline ---
    xs = np.random.RandomState(0).randint(0, 256, size=(B, NL8))
    x8 = jnp.asarray(xs.astype(np.uint32))
    np.asarray(f(x8)[0, 0])
    reps = 20
    ts = []
    for _ in range(reps):
        t0 = time.time()
        jax.block_until_ready(f(x8))
        ts.append(time.time() - t0)
    t_mxu = min(ts)
    print(f"matmul const-mul: {t_mxu * 1e6:.1f} us / {B} lanes "
          f"({B / t_mxu / 1e6:.1f} M muls/s)", flush=True)

    # --- timing: elementwise fr.mont_mul (XLA limb path), same batch ---
    a16 = fr.pack([rng.randrange(P) for _ in range(64)] * (B // 64))
    c16 = fr.pack([c])
    g = jax.jit(fr.mont_mul)
    np.asarray(g(a16, c16)[0, 0])
    ts = []
    for _ in range(reps):
        t0 = time.time()
        jax.block_until_ready(g(a16, c16))
        ts.append(time.time() - t0)
    t_vpu = min(ts)
    print(f"limb mont_mul:  {t_vpu * 1e6:.1f} us / {B} lanes "
          f"({B / t_vpu / 1e6:.1f} M muls/s)", flush=True)
    print(f"matmul/limb speedup: {t_vpu / t_mxu:.2f}x", flush=True)


if __name__ == "__main__":
    main()
