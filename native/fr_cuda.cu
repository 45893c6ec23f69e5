// BN254 Fr field kernels, the Poseidon permutation and SHA-256 as XLA FFI
// custom calls for NVIDIA GPUs (built for sm_90a by circuits_tpu/field/
// fr_ffi.py with nvcc at first use).
//
// Role: the witness models trace to HLO graphs with hundreds of field-op
// call sites. Inlined as 16-bit limb graphs, the full RollupMain graph is
// ~120k HLO ops and XLA's GPU compiler did not finish it in 18 minutes on
// an H100. Each field op here is ONE custom call instead, the same
// compile-mass collapse the CPU library (fr_ffi.cpp) gives XLA:CPU; both
// libraries run the per-lane code of fr_device.h.
//
// Same targets, operands and layouts as fr_ffi.cpp: batch-major uint32
// arrays with 16 little-endian 16-bit limbs per element. One thread per
// lane; every handler only enqueues work on XLA's stream.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "fr_device.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;
using frdev::u32;
using frdev::u64;

static const int kThreads = 128;

static unsigned blocks_for(size_t n) {
    return (unsigned)((n + kThreads - 1) / kThreads);
}

static ffi::Error launch_status() {
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess)
        return ffi::Error(ffi::ErrorCode::kInternal, cudaGetErrorString(e));
    return ffi::Error::Success();
}

__device__ __forceinline__ size_t lane_index() {
    return (size_t)blockIdx.x * blockDim.x + threadIdx.x;
}

// OP: 0 Montgomery multiply, 1 add, 2 sub
template <int OP>
__global__ void binop_kernel(const u32* a, const u32* b, u32* out, size_t n) {
    const size_t i = lane_index();
    if (i >= n) return;
    u64 av[4], bv[4], rv[4];
    frdev::load_fe(av, a + 16 * i);
    frdev::load_fe(bv, b + 16 * i);
    if (OP == 0) {
        frdev::mont_mul4(rv, av, bv);
    } else if (OP == 1) {
        frdev::add_mod4(rv, av, bv);
    } else {
        frdev::sub_mod4(rv, av, bv);
    }
    frdev::store_fe(out + 16 * i, rv);
}

template <int OP>
static ffi::Error BinopImpl(cudaStream_t stream, ffi::Buffer<ffi::U32> a,
                            ffi::Buffer<ffi::U32> b,
                            ffi::ResultBuffer<ffi::U32> out) {
    const size_t n = a.element_count() / 16;
    if (n == 0) return ffi::Error::Success();
    binop_kernel<OP><<<blocks_for(n), kThreads, 0, stream>>>(
        a.typed_data(), b.typed_data(), out->typed_data(), n);
    return launch_status();
}

__global__ void pow_kernel(const u32* a, const u32* ebits, size_t nbits,
                           u32* out, size_t n) {
    const size_t i = lane_index();
    if (i >= n) return;
    frdev::pow_lane(out + 16 * i, a + 16 * i, ebits, nbits);
}

static ffi::Error FrPowImpl(cudaStream_t stream, ffi::Buffer<ffi::U32> a,
                            ffi::Buffer<ffi::U32> ebits,
                            ffi::ResultBuffer<ffi::U32> out) {
    const size_t n = a.element_count() / 16;
    if (n == 0) return ffi::Error::Success();
    pow_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
        a.typed_data(), ebits.typed_data(), ebits.element_count(),
        out->typed_data(), n);
    return launch_status();
}

// state: (N, t, 16); C: ((RF + rp) * t, 16); M: (t * t, 16)
__global__ void poseidon_kernel(const u32* state, const u32* C, const u32* M,
                                int t, int nrounds, u32* out, size_t n) {
    const size_t i = lane_index();
    if (i >= n) return;
    frdev::poseidon_lane(out + 16 * t * i, state + 16 * t * i, t, nrounds, C,
                         M);
}

static ffi::Error FrPoseidonImpl(cudaStream_t stream,
                                 ffi::Buffer<ffi::U32> state,
                                 ffi::Buffer<ffi::U32> cbuf,
                                 ffi::Buffer<ffi::U32> mbuf,
                                 ffi::ResultBuffer<ffi::U32> out) {
    const size_t mcount = mbuf.element_count() / 16;  // t*t
    size_t t = 1;
    while (t * t < mcount) ++t;
    if (t * t != mcount || t < 2 || t > (size_t)frdev::kMaxT)
        return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                          "bad MDS operand size");
    const size_t nc = cbuf.element_count() / 16;  // (RF+rp)*t
    const size_t nrounds = nc / t;
    if (nrounds * t != nc || nrounds < (size_t)frdev::kRF || nrounds > 80)
        return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                          "bad round-constant operand size");
    const size_t n = state.element_count() / (16 * t);
    if (n == 0) return ffi::Error::Success();
    poseidon_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
        state.typed_data(), cbuf.typed_data(), mbuf.typed_data(), (int)t,
        (int)nrounds, out->typed_data(), n);
    return launch_status();
}

// words: (N, nblocks * 16) big-endian message words; out: (N, 8)
__global__ void sha256_kernel(const u32* words, size_t nblocks, u32* out,
                              size_t n) {
    const size_t i = lane_index();
    if (i >= n) return;
    frdev::sha256_lane(out + 8 * i, words + 16 * nblocks * i, nblocks);
}

static ffi::Error Sha256BlocksImpl(cudaStream_t stream,
                                   ffi::Buffer<ffi::U32> words,
                                   ffi::ResultBuffer<ffi::U32> out) {
    const size_t total = words.element_count();
    const size_t n = out->element_count() / 8;
    if (n == 0 || total % (16 * n) != 0)
        return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                          "words must be (N, nblocks*16)");
    sha256_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
        words.typed_data(), total / (16 * n), out->typed_data(), n);
    return launch_status();
}

#define FR_BINOP_BINDING                              \
    ffi::Ffi::Bind()                                  \
        .Ctx<ffi::PlatformStream<cudaStream_t>>()     \
        .Arg<ffi::Buffer<ffi::U32>>()                 \
        .Arg<ffi::Buffer<ffi::U32>>()                 \
        .Ret<ffi::Buffer<ffi::U32>>()

XLA_FFI_DEFINE_HANDLER_SYMBOL(FrMontMul, BinopImpl<0>, FR_BINOP_BINDING);
XLA_FFI_DEFINE_HANDLER_SYMBOL(FrAdd, BinopImpl<1>, FR_BINOP_BINDING);
XLA_FFI_DEFINE_HANDLER_SYMBOL(FrSub, BinopImpl<2>, FR_BINOP_BINDING);
XLA_FFI_DEFINE_HANDLER_SYMBOL(FrPow, FrPowImpl, FR_BINOP_BINDING);

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    FrPoseidon, FrPoseidonImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::U32>>()
        .Arg<ffi::Buffer<ffi::U32>>()
        .Arg<ffi::Buffer<ffi::U32>>()
        .Ret<ffi::Buffer<ffi::U32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    Sha256Blocks, Sha256BlocksImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::U32>>()
        .Ret<ffi::Buffer<ffi::U32>>());
