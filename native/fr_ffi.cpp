// BN254 Fr field kernels as XLA:CPU FFI custom calls.
//
// Role: the witness models trace to HLO graphs with hundreds of
// Montgomery-multiply call sites; XLA:CPU compile cost is superlinear in
// module size (measured: RollupTx alone ~250s / 93k HLO lines with the
// mul inlined as limb ops). On CPU each field op becomes ONE custom-call
// instruction backed by this library — compile collapses, and the 4x64
// CIOS is also faster at runtime than XLA's generated 16x16 limb code.
// fr_cuda.cu registers the same targets for the GPU; both run the
// per-lane code of fr_device.h. This is the CPU analogue of the
// reference's ffiasm-generated x86-64 field library
// (reference: tools/helpers/actions.js:207-229).
//
// Data layout: batch-major uint32 arrays of shape (N, 16) — 16
// little-endian 16-bit limbs per element, batch dim leading so the
// targets can be registered as batch-partitionable under GSPMD.

#include <cstddef>
#include <cstdint>

#include "fr_device.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;
using frdev::u32;
using frdev::u64;
using frdev::load_fe;
using frdev::store_fe;

typedef void (*binop4)(u64*, const u64*, const u64*);

static ffi::Error binop_impl(const ffi::Buffer<ffi::U32>& a,
                             const ffi::Buffer<ffi::U32>& b,
                             ffi::ResultBuffer<ffi::U32>& out, binop4 op) {
    const size_t n = a.element_count() / 16;
    const u32* ap = a.typed_data();
    const u32* bp = b.typed_data();
    u32* op_ = out->typed_data();
    for (size_t i = 0; i < n; ++i) {
        u64 av[4], bv[4], rv[4];
        load_fe(av, ap + 16 * i);
        load_fe(bv, bp + 16 * i);
        op(rv, av, bv);
        store_fe(op_ + 16 * i, rv);
    }
    return ffi::Error::Success();
}

static ffi::Error FrMontMulImpl(ffi::Buffer<ffi::U32> a,
                                ffi::Buffer<ffi::U32> b,
                                ffi::ResultBuffer<ffi::U32> out) {
    return binop_impl(a, b, out, frdev::mont_mul4);
}

static ffi::Error FrAddImpl(ffi::Buffer<ffi::U32> a, ffi::Buffer<ffi::U32> b,
                            ffi::ResultBuffer<ffi::U32> out) {
    return binop_impl(a, b, out, frdev::add_mod4);
}

static ffi::Error FrSubImpl(ffi::Buffer<ffi::U32> a, ffi::Buffer<ffi::U32> b,
                            ffi::ResultBuffer<ffi::U32> out) {
    return binop_impl(a, b, out, frdev::sub_mod4);
}

// a^e mod p for a fixed little-endian exponent passed as a u32 bit array
// (shared across the batch): one call replaces a 254-step fori_loop of
// custom calls. Input/output in the Montgomery domain.
static ffi::Error FrPowImpl(ffi::Buffer<ffi::U32> a,
                            ffi::Buffer<ffi::U32> ebits,
                            ffi::ResultBuffer<ffi::U32> out) {
    const size_t n = a.element_count() / 16;
    for (size_t i = 0; i < n; ++i)
        frdev::pow_lane(out->typed_data() + 16 * i, a.typed_data() + 16 * i,
                        ebits.typed_data(), ebits.element_count());
    return ffi::Error::Success();
}

// ---------------------------------------------------------------------
// Whole-Poseidon-permutation custom call.
//
// One call per permutation instead of ~65 rounds x (add + 3 muls +
// t^2 muls + limb sums) of HLO: the dominant compile-mass collapse for
// the CPU correctness paths (the multichip dryrun and the test suite).
// Constants arrive as operands (Montgomery form) so the handler stays
// stateless: C is ((RF+rp)*t, 16) and M is (t*t, 16); t and rp are
// inferred from the operand shapes (RF is fixed at 8, as in circomlib).
// state: (N, t, 16) u32 Montgomery, updated out-of-place.
// ---------------------------------------------------------------------

static ffi::Error FrPoseidonImpl(ffi::Buffer<ffi::U32> state,
                                 ffi::Buffer<ffi::U32> cbuf,
                                 ffi::Buffer<ffi::U32> mbuf,
                                 ffi::ResultBuffer<ffi::U32> out) {
    const size_t mcount = mbuf.element_count() / 16;  // t*t
    size_t t = 1;
    while (t * t < mcount) ++t;
    if (t * t != mcount || t < 2 || t > (size_t)frdev::kMaxT)
        return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                          "bad MDS operand size");
    const size_t nc = cbuf.element_count() / 16;      // (RF+rp)*t
    const size_t nrounds = nc / t;
    if (nrounds * t != nc || nrounds < (size_t)frdev::kRF || nrounds > 80)
        return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                          "bad round-constant operand size");
    const size_t n = state.element_count() / (16 * t);
    for (size_t k = 0; k < n; ++k)
        frdev::poseidon_lane(out->typed_data() + 16 * t * k,
                             state.typed_data() + 16 * t * k, (int)t,
                             (int)nrounds, cbuf.typed_data(),
                             mbuf.typed_data());
    return ffi::Error::Success();
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    FrPoseidon, FrPoseidonImpl,
    ffi::Ffi::Bind()
        .Arg<ffi::Buffer<ffi::U32>>()
        .Arg<ffi::Buffer<ffi::U32>>()
        .Arg<ffi::Buffer<ffi::U32>>()
        .Ret<ffi::Buffer<ffi::U32>>());

// ---------------------------------------------------------------------
// SHA-256 over packed 512-bit blocks (FIPS 180-4).
//
// The HashInputs tail hashes one multi-kilobit preimage per batch; the
// word-packed XLA formulation lowers to ~2000 unfused u32[1] thunks per
// block on XLA:CPU (measured ~0.2 ms/thunk on this host class -> ~3 s
// per block). One custom call per digest removes that wall from the
// multichip dryrun and the CPU test suite.
// words: (N, nblocks*16) u32 big-endian message words (pre-padded);
// out: (N, 8) u32 digest words.
// ---------------------------------------------------------------------

static ffi::Error Sha256BlocksImpl(ffi::Buffer<ffi::U32> words,
                                   ffi::ResultBuffer<ffi::U32> out) {
    const size_t total = words.element_count();
    const size_t n = out->element_count() / 8;
    if (n == 0 || total % (16 * n) != 0)
        return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                          "words must be (N, nblocks*16)");
    const size_t nblocks = total / (16 * n);
    for (size_t k = 0; k < n; ++k)
        frdev::sha256_lane(out->typed_data() + 8 * k,
                           words.typed_data() + 16 * nblocks * k, nblocks);
    return ffi::Error::Success();
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    Sha256Blocks, Sha256BlocksImpl,
    ffi::Ffi::Bind()
        .Arg<ffi::Buffer<ffi::U32>>()
        .Ret<ffi::Buffer<ffi::U32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    FrMontMul, FrMontMulImpl,
    ffi::Ffi::Bind()
        .Arg<ffi::Buffer<ffi::U32>>()
        .Arg<ffi::Buffer<ffi::U32>>()
        .Ret<ffi::Buffer<ffi::U32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    FrAdd, FrAddImpl,
    ffi::Ffi::Bind()
        .Arg<ffi::Buffer<ffi::U32>>()
        .Arg<ffi::Buffer<ffi::U32>>()
        .Ret<ffi::Buffer<ffi::U32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    FrSub, FrSubImpl,
    ffi::Ffi::Bind()
        .Arg<ffi::Buffer<ffi::U32>>()
        .Arg<ffi::Buffer<ffi::U32>>()
        .Ret<ffi::Buffer<ffi::U32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    FrPow, FrPowImpl,
    ffi::Ffi::Bind()
        .Arg<ffi::Buffer<ffi::U32>>()
        .Arg<ffi::Buffer<ffi::U32>>()
        .Ret<ffi::Buffer<ffi::U32>>());
