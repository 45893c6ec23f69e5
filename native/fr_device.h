// BN254 Fr arithmetic, the Poseidon permutation and SHA-256 for ONE lane,
// shared by the CPU library (fr_ffi.cpp, compiled by g++) and the CUDA
// library (fr_cuda.cu, compiled by nvcc): the CPU test suite runs the
// same per-lane code the GPU kernels run.
//
// Elements are 4 little-endian 64-bit words in Montgomery form
// (R = 2^256); the 64x64 -> 128-bit products use __umul64hi, a CUDA
// intrinsic that is defined here for the host.
//
// Buffer layout: batch-major uint32 arrays, 16 little-endian 16-bit
// limbs per element.

#ifndef CIRCUITS_FR_DEVICE_H_
#define CIRCUITS_FR_DEVICE_H_

#include <cstddef>
#include <cstdint>

#ifdef __CUDACC__
#define FR_FN __device__ __forceinline__
#define FR_TABLE __constant__ const
#else
#define FR_FN static inline
#define FR_TABLE static const
static inline uint64_t __umul64hi(uint64_t a, uint64_t b) {
    return (uint64_t)(((unsigned __int128)a * b) >> 64);
}
#endif

namespace frdev {

typedef uint64_t u64;
typedef uint32_t u32;

// p, -p^-1 mod 2^64, and R mod p (Montgomery one)
#define FR_P0 0x43e1f593f0000001ULL
#define FR_P1 0x2833e84879b97091ULL
#define FR_P2 0xb85045b68181585dULL
#define FR_P3 0x30644e72e131a029ULL
#define FR_N0 0xc2e1f593efffffffULL

FR_FN void p_words(u64* p) {
    p[0] = FR_P0; p[1] = FR_P1; p[2] = FR_P2; p[3] = FR_P3;
}

FR_FN void mont_one(u64* r) {
    r[0] = 0xac96341c4ffffffbULL; r[1] = 0x36fc76959f60cd29ULL;
    r[2] = 0x666ea36f7879462eULL; r[3] = 0x0e0a77c19a07df2fULL;
}

// lo + 2^64 * (returned hi) = a * b + c + d  (never overflows 128 bits)
FR_FN u64 mac(u64 a, u64 b, u64 c, u64 d, u64* lo) {
    u64 l = a * b;
    u64 h = __umul64hi(a, b);
    l += c;
    h += (l < c);
    l += d;
    h += (l < d);
    *lo = l;
    return h;
}

FR_FN bool geq4(const u64* a, const u64* b) {
    for (int i = 3; i >= 0; --i) {
        if (a[i] > b[i]) return true;
        if (a[i] < b[i]) return false;
    }
    return true;
}

// r = a - b mod 2^256
FR_FN void sub4(u64* r, const u64* a, const u64* b) {
    u64 borrow = 0;
    for (int i = 0; i < 4; ++i) {
        u64 d = a[i] - b[i];
        u64 b1 = a[i] < b[i];
        u64 d2 = d - borrow;
        u64 b2 = d < borrow;
        r[i] = d2;
        borrow = b1 | b2;
    }
}

FR_FN void copy4(u64* r, const u64* a) {
    for (int i = 0; i < 4; ++i) r[i] = a[i];
}

// CIOS Montgomery multiplication: r = a*b*R^-1 mod p (r may alias a, b)
FR_FN void mont_mul4(u64* r, const u64* a, const u64* b) {
    u64 p[4];
    p_words(p);
    u64 t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; ++i) {
        u64 carry = 0;
        for (int j = 0; j < 4; ++j) carry = mac(a[j], b[i], t[j], carry, &t[j]);
        u64 s = t[4] + carry;
        t[5] = s < carry;
        t[4] = s;

        u64 m = t[0] * FR_N0;
        u64 lo;
        carry = mac(m, p[0], t[0], 0, &lo);
        for (int j = 1; j < 4; ++j) carry = mac(m, p[j], t[j], carry, &t[j - 1]);
        s = t[4] + carry;
        t[3] = s;
        t[4] = t[5] + (s < carry);
    }
    if (t[4] || geq4(t, p)) {
        sub4(r, t, p);
    } else {
        copy4(r, t);
    }
}

FR_FN void add_mod4(u64* r, const u64* a, const u64* b) {
    u64 p[4];
    p_words(p);
    u64 t[4];
    u64 carry = 0;
    for (int i = 0; i < 4; ++i) {
        u64 s = a[i] + b[i];
        u64 c1 = s < a[i];
        u64 s2 = s + carry;
        u64 c2 = s2 < s;
        t[i] = s2;
        carry = c1 | c2;
    }
    if (carry || geq4(t, p)) {
        sub4(r, t, p);
    } else {
        copy4(r, t);
    }
}

FR_FN void sub_mod4(u64* r, const u64* a, const u64* b) {
    if (geq4(a, b)) {
        sub4(r, a, b);
        return;
    }
    u64 p[4], t[4];
    p_words(p);
    sub4(t, b, a);  // b - a, nonzero here
    sub4(r, p, t);  // p - (b - a)
}

FR_FN void load_fe(u64* v, const u32* limbs) {
    for (int j = 0; j < 4; ++j) {
        v[j] = (u64)limbs[4 * j] | ((u64)limbs[4 * j + 1] << 16) |
               ((u64)limbs[4 * j + 2] << 32) | ((u64)limbs[4 * j + 3] << 48);
    }
}

FR_FN void store_fe(u32* limbs, const u64* v) {
    for (int j = 0; j < 4; ++j) {
        limbs[4 * j] = (u32)(v[j] & 0xFFFF);
        limbs[4 * j + 1] = (u32)((v[j] >> 16) & 0xFFFF);
        limbs[4 * j + 2] = (u32)((v[j] >> 32) & 0xFFFF);
        limbs[4 * j + 3] = (u32)((v[j] >> 48) & 0xFFFF);
    }
}

// One lane of a^e for a fixed little-endian exponent bit array; in/out
// in Montgomery form.
FR_FN void pow_lane(u32* out, const u32* a, const u32* ebits, size_t nbits) {
    u64 base[4], acc[4];
    load_fe(base, a);
    mont_one(acc);
    for (size_t k = 0; k < nbits; ++k) {
        if (ebits[k]) mont_mul4(acc, acc, base);
        mont_mul4(base, base, base);
    }
    store_fe(out, acc);
}

// ---------------------------------------------------------------------
// Poseidon permutation (circomlib order: ARK, S-box, dense MDS mix).
// C: ((RF + rp) * t, 16) and M: (t * t, 16) Montgomery limbs.
// ---------------------------------------------------------------------

static const int kRF = 8;
static const int kMaxT = 8;

FR_FN void pow5_4(u64* r, const u64* a) {
    u64 a2[4], a4[4];
    mont_mul4(a2, a, a);
    mont_mul4(a4, a2, a2);
    mont_mul4(r, a4, a);
}

// state / out: t elements of 16 limbs each (may alias)
FR_FN void poseidon_lane(u32* out, const u32* state, int t, int nrounds,
                         const u32* C, const u32* M) {
    const int rp = nrounds - kRF;
    u64 st[kMaxT][4], ns[kMaxT][4];
    for (int i = 0; i < t; ++i) load_fe(st[i], state + 16 * i);
    for (int r = 0; r < nrounds; ++r) {
        for (int i = 0; i < t; ++i) {
            u64 c[4];
            load_fe(c, C + 16 * (r * t + i));
            add_mod4(st[i], st[i], c);
        }
        if (r < kRF / 2 || r >= kRF / 2 + rp) {
            for (int i = 0; i < t; ++i) pow5_4(st[i], st[i]);
        } else {
            pow5_4(st[0], st[0]);
        }
        for (int i = 0; i < t; ++i) {
            u64 acc[4] = {0, 0, 0, 0};
            for (int j = 0; j < t; ++j) {
                u64 m[4], prod[4];
                load_fe(m, M + 16 * (i * t + j));
                mont_mul4(prod, m, st[j]);
                add_mod4(acc, acc, prod);
            }
            copy4(ns[i], acc);
        }
        for (int i = 0; i < t; ++i) copy4(st[i], ns[i]);
    }
    for (int i = 0; i < t; ++i) store_fe(out + 16 * i, st[i]);
}

// ---------------------------------------------------------------------
// SHA-256 (FIPS 180-4) of one pre-padded message of nblocks 512-bit
// blocks given as big-endian u32 words; writes 8 digest words.
// ---------------------------------------------------------------------

FR_FN u32 rotr32(u32 x, int n) { return (x >> n) | (x << (32 - n)); }

FR_TABLE u32 kSha256K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

FR_FN void sha256_lane(u32* out, const u32* words, size_t nblocks) {
    u32 h[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
    for (size_t blk = 0; blk < nblocks; ++blk) {
        u32 w[64];
        for (int i = 0; i < 16; ++i) w[i] = words[blk * 16 + i];
        for (int i = 16; i < 64; ++i) {
            u32 s0 = rotr32(w[i - 15], 7) ^ rotr32(w[i - 15], 18) ^
                     (w[i - 15] >> 3);
            u32 s1 = rotr32(w[i - 2], 17) ^ rotr32(w[i - 2], 19) ^
                     (w[i - 2] >> 10);
            w[i] = w[i - 16] + s0 + w[i - 7] + s1;
        }
        u32 a = h[0], b = h[1], c = h[2], d = h[3];
        u32 e = h[4], f = h[5], g = h[6], hh = h[7];
        for (int i = 0; i < 64; ++i) {
            u32 s1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
            u32 ch = (e & f) ^ (~e & g);
            u32 t1 = hh + s1 + ch + kSha256K[i] + w[i];
            u32 s0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
            u32 maj = (a & b) ^ (a & c) ^ (b & c);
            u32 t2 = s0 + maj;
            hh = g; g = f; f = e; e = d + t1;
            d = c; c = b; b = a; a = t1 + t2;
        }
        h[0] += a; h[1] += b; h[2] += c; h[3] += d;
        h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
    }
    for (int i = 0; i < 8; ++i) out[i] = h[i];
}

}  // namespace frdev

#endif  // CIRCUITS_FR_DEVICE_H_
