"""Smoke run of the witness engine on NVIDIA GPUs.

    python chip_smoke.py               one card: phases 1-3 below
    python chip_smoke.py --cards 4     the tx-sharded batch over four cards

Phases (any failure exits non-zero before the last line is printed):

1. Device. JAX must report a GPU; there is no CPU fallback. Prints the
   device kind and count, and the card's name and power limit from
   nvidia-smi.
2. Kernel parity at real widths, on the card. The native CUDA kernels
   (native/fr_cuda.cu, built with nvcc here on first use) against the
   plain references: Montgomery multiply, add, sub and inverse against
   Python integers at B = 2048, with both XLA multiply forms
   (`fr.mont_mul_unrolled`, `fr.mont_mul_compact`) checked and all three
   multiplies timed at B = 6144; the Poseidon permutation against the
   host Poseidon for t = 3..7 and B in {1, 5, 130, 2049, 6144}; the
   SHA-256 digest, native and as the XLA block scan, against hashlib at
   the production preimage length (420,752 bits, 822 blocks).
3. The main path: a full RollupMain(2048, 32, 256, 64) batch (2,048
   signed L2 transfers over accounts created by L1 deposits) built by the
   golden-model builder and run through `engine.witness.RollupEngine`.
   `ok` must hold and hashGlobalInputs, newStateRoot and newExitRoot must
   equal the builder's; a batch with one lane's signature `s` tampered
   must give `ok` false. Prints host build and pack time, trace and
   compile time, the median of five blocked runs, the SHA-256 tail's own
   time, `memory_analysis()` and peak device memory. These are
   observations of one run, not benchmark results.

With --cards 4 only the sharded path runs (parallel/sharding.py) on the
same batch; its outputs must equal the builder's, which phase 3 checks
the one-card run against.

Everything on these paths is uint32/uint64 integer arithmetic, so every
comparison is exact equality with no tolerance. No float matrix product
is on the main path, so TF32 does not apply.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time

import numpy as np

PARAMS = (2048, 32, 256, 64)          # nTx, nLevels, maxL1Tx, maxFeeTx
POSEIDON_WIDTHS = (1, 5, 130, 2049, 6144)  # 6144: the SMT level hash
REPS = 5


def log(msg: str) -> None:
    print(msg, flush=True)


def device_phase(n_cards: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: needs a GPU; JAX found {devs[0].platform}")
    if len(devs) < n_cards:
        sys.exit(f"chip_smoke: needs {n_cards} GPUs; JAX found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log(f"device: {devs[0].device_kind}, count {len(devs)}")
    for line in smi.stdout.strip().splitlines():
        log(f"nvidia-smi: {line}")
    return devs


def random_elems(rng, shape) -> np.ndarray:
    """Canonical random field elements as (16, *shape) uint32 limbs: the
    top limb stays below p's, so every value is < p."""
    from circuits_tpu.field.scalar import P

    limbs = rng.integers(0, 1 << 16, size=(16,) + tuple(shape),
                         dtype=np.uint32)
    limbs[15] = rng.integers(0, P >> 240, size=shape, dtype=np.uint32)
    return limbs


def preimage_bits(n_tx, n_levels, max_l1_tx, max_fee_tx) -> int:
    """Length of the HashInputs SHA-256 preimage (hash_inputs.py)."""
    return (2 * 48 + 3 * 256 + max_l1_tx * 736
            + n_tx * (2 * n_levels + 48) + max_fee_tx * n_levels + 16 + 32)


def check_field(rng, b: int = 2048) -> None:
    """Native multiply, add, sub and inverse (the fixed-exponent power),
    and both XLA multiply forms, against Python integers; then the three
    multiplies timed at the SMT level-hash width."""
    import jax
    from circuits_tpu.field import fr
    from circuits_tpu.field.scalar import P, R

    x, y = random_elems(rng, (b,)), random_elems(rng, (b,))
    xs = [int(v) for v in fr.unpack_np(x)]
    ys = [int(v) for v in fr.unpack_np(y)]
    rinv = pow(R, -1, P)
    want = {
        "mont_mul": [u * v * rinv % P for u, v in zip(xs, ys)],
        "add": [(u + v) % P for u, v in zip(xs, ys)],
        "sub": [(u - v) % P for u, v in zip(xs, ys)],
        "inv": [pow(u, P - 2, P) for u in xs],
    }
    native = {"mont_mul": fr.mont_mul, "add": fr.add, "sub": fr.sub,
              "inv": lambda u, _: fr.inv(u)}
    forms = {"native": fr.mont_mul, "unrolled": fr.mont_mul_unrolled,
             "compact": fr.mont_mul_compact}
    for name, f in native.items():
        got = fr.unpack_np(np.asarray(jax.jit(f)(x, y)))
        assert [int(v) for v in got] == want[name], f"native {name}"
        log(f"  native {name} B={b}: exact vs Python integers")
    for name, f in forms.items():
        got = fr.unpack_np(np.asarray(jax.jit(f)(x, y)))
        assert [int(v) for v in got] == want["mont_mul"], name
        log(f"  mont_mul {name} B={b}: exact vs Python integers")
    wide = 6144
    x, y = random_elems(rng, (wide,)), random_elems(rng, (wide,))
    for name, f in forms.items():
        jf = jax.jit(f)
        jax.block_until_ready(jf(x, y))
        log(f"  mont_mul {name} B={wide}: "
            f"{median_run(jf, x, y) * 1e6:.1f} us (median of {REPS})")


def check_poseidon(rng) -> None:
    """The native permutation, through `poseidon.poseidon`, against the
    host Poseidon for every width the circuits use."""
    import jax
    from circuits_tpu.field import fr
    from circuits_tpu.ops import poseidon
    from circuits_tpu.ops.poseidon_constants import poseidon_py

    for t in range(3, 8):
        cols = [random_elems(rng, (max(POSEIDON_WIDTHS),))
                for _ in range(t - 1)]
        ints = [[int(v) for v in fr.unpack_np(c)] for c in cols]
        for b in POSEIDON_WIDTHS:
            got = fr.unpack_np(np.asarray(jax.jit(poseidon.poseidon)(
                [c[:, :b] for c in cols])))
            want = [poseidon_py([col[k] for col in ints]) for k in range(b)]
            assert [int(v) for v in got] == want, f"poseidon t={t} B={b}"
        log(f"  native poseidon t={t} B={POSEIDON_WIDTHS}: exact vs host")


def check_sha(rng, nbits: int) -> None:
    """The native digest and the XLA block scan against hashlib."""
    import jax
    from circuits_tpu.ops import sha256
    from circuits_tpu.utils.backend import xla_reference

    msg = rng.integers(0, 256, size=nbits // 8, dtype=np.uint8)
    bits = np.unpackbits(msg).reshape(nbits, 1).astype(np.uint32)
    want = np.unpackbits(np.frombuffer(hashlib.sha256(msg.tobytes())
                                       .digest(), dtype=np.uint8))
    got = np.asarray(jax.jit(sha256.sha256_bits)(bits))[:, 0]
    assert np.array_equal(got, want), "native sha256"
    with xla_reference():
        got = np.asarray(jax.jit(lambda v: sha256.sha256_bits(v))(bits))
    assert np.array_equal(got[:, 0], want), "xla sha256"
    log(f"  sha256 native and XLA scan, {nbits} bits "
        f"({(nbits + 65 + 511) // 512} blocks): exact vs hashlib")


def kernel_phase(rng) -> None:
    log("phase 2: kernel parity")
    t0 = time.perf_counter()
    from circuits_tpu.field import fr_ffi

    fr_ffi.enabled()  # builds the native library on first use
    log(f"  native library ready: {time.perf_counter() - t0:.1f} s")
    check_field(rng)
    check_poseidon(rng)
    check_sha(rng, preimage_bits(*PARAMS))


def build_batch():
    from circuits_tpu.builder.batches import transfer_batch

    t0 = time.perf_counter()
    bb = transfer_batch(*PARAMS)
    inp = bb.get_input()
    log(f"  host build: {time.perf_counter() - t0:.1f} s")
    want = dict(hash_global_inputs=bb.get_hash_inputs(),
                new_state_root=bb.get_new_state_root(),
                new_exit_root=bb.get_new_exit_root())
    return inp, want


def check_outputs(out: dict, want: dict, what: str) -> None:
    for k, v in want.items():
        assert out[k] == v, f"{what}: {k} differs from the builder's"


def median_run(fn, *args) -> float:
    import jax

    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def main_path_phase(inp: dict, want: dict) -> None:
    import jax
    from circuits_tpu.engine.witness import RollupEngine
    from circuits_tpu.field.scalar import P
    from circuits_tpu.ops import sha256

    log("phase 3: RollupMain%s (observations, not benchmark results)"
        % (PARAMS,))
    eng = RollupEngine(*PARAMS)
    t0 = time.perf_counter()
    packed = eng.pack(inp)
    jax.block_until_ready(packed)
    log(f"  pack: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lowered = eng._fn.lower(packed)
    t1 = time.perf_counter()
    compiled = lowered.compile()
    t2 = time.perf_counter()
    log(f"  trace+lower: {t1 - t0:.1f} s, cold compile: {t2 - t1:.1f} s")
    log(f"  memory_analysis: {compiled.memory_analysis()}")
    t0 = time.perf_counter()
    out, ok = eng.run(inp)
    log(f"  first engine.run: {time.perf_counter() - t0:.1f} s")
    assert ok, "verdict false on a valid batch"
    check_outputs(out, want, "engine")
    log("  ok=True; hashGlobalInputs, newStateRoot, newExitRoot equal the "
        "builder's")
    med = median_run(eng._fn, packed)
    log(f"  median of {REPS} blocked runs: {med:.4f} s "
        f"({PARAMS[0] / med:.0f} tx/s)")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"  peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")

    bits = jax.numpy.asarray(np.random.default_rng(1).integers(
        0, 2, size=(preimage_bits(*PARAMS), 1), dtype=np.uint32))
    sha = jax.jit(sha256.sha256_bits)
    jax.block_until_ready(sha(bits))
    log(f"  sha256 tail alone: {median_run(sha, bits) * 1e3:.3f} ms "
        f"(median of {REPS})")

    bad = dict(inp)
    bad["s"] = list(inp["s"])
    bad["s"][0] = (int(bad["s"][0]) + 1) % P
    _, ok = eng.run(bad)
    assert not ok, "tampered signature still verified"
    log("  tampered s on lane 0: ok=False")


def sharded_phase(inp: dict, want: dict, n_cards: int) -> None:
    import jax
    from circuits_tpu.engine.witness import RollupEngine, pack_rollup_inputs
    from circuits_tpu.parallel.sharding import (make_sharded_rollup_main,
                                                make_tx_mesh)

    log(f"sharded: RollupMain{PARAMS} over {n_cards} cards")
    packed = pack_rollup_inputs(inp, *PARAMS)
    run = make_sharded_rollup_main(make_tx_mesh(n_cards), *PARAMS)
    t0 = time.perf_counter()
    out, ok = run(packed)
    jax.block_until_ready(out)
    log(f"  first call (trace, compile, run): "
        f"{time.perf_counter() - t0:.1f} s")
    assert bool(ok), "sharded verdict false on a valid batch"
    check_outputs(RollupEngine.unpack_outputs(out), want, "sharded")
    log("  ok=True; hashGlobalInputs, newStateRoot, newExitRoot equal "
        "the builder's")
    med = median_run(run, packed)
    log(f"  median of {REPS} blocked runs: {med:.4f} s "
        f"({PARAMS[0] / med:.0f} tx/s)")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    args = ap.parse_args()

    log("phase 1: device")
    devs = device_phase(args.cards)

    import jax
    from circuits_tpu.utils import backend
    from circuits_tpu.utils.compile_opts import enable_persistent_cache

    enable_persistent_cache(jax)
    log(f"  native library: {backend.native()}")
    rng = np.random.default_rng(0)
    if args.cards == 1:
        kernel_phase(rng)
    inp, want = build_batch()
    if args.cards == 1:
        main_path_phase(inp, want)
    else:
        sharded_phase(inp, want, args.cards)
    log(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
