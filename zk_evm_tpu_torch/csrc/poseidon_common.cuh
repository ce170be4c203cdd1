// Goldilocks field arithmetic, the Poseidon round structure and the
// limb-plane MDS shared by the CUDA Poseidon kernels (poseidon.cu,
// poseidon_pallas.cu). Width 12, rate 8, 4 + 22 + 4 rounds, S-box x^7,
// MDS = circulant(17,15,41,16,2,28,13,13,39,18,34,20) + diag(8,0,...,0);
// bit-identical to the plain PyTorch version in
// zk_evm_tpu_torch/hash/poseidon.py.
//
// The partial rounds run in their fast form (Poseidon paper, appendix B;
// constants derived in zk_evm_tpu_torch/hash/poseidon_fast.py, which has
// a python-int twin of this exact sequence): one constant layer, one dense
// 11x11 matrix, then 22 rounds of one S-box, one constant and a sparse
// layer of 22 general products.
//
// Inside a permutation a word is any u64 congruent to its value mod
// p = 2^64 - 2^32 + 1 ("lazy"): every consumer (a product, the limb
// split, a sum) takes any u64, and constants are canonical. A kernel
// canonicalises only the words it writes. A product is one 64x64-bit
// multiply into 128 bits, reduced with 2^64 = 2^32 - 1 and 2^96 = -1
// (mod p); sums of general products accumulate in 192 bits and reduce
// once a word.
//
// The round code takes its field arithmetic as a policy class F: F::mul,
// F::sqr, F::mul_add, F::reduce_small (lo + h0 2^64 for h0 < 2^32, the
// MDS's reduction) and F::Acc (a sum of general products). `U64Arith`
// below, 64-bit products with compare-and-select corrections, is the
// dense kernels' (poseidon.cu); the planes kernels pass their own
// (goldilocks32.cuh).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int W = 12;
constexpr int RATE = 8;
constexpr int HALF_FULL_ROUNDS = 4;
constexpr int N_PARTIAL_ROUNDS = 22;
constexpr int N_ROUNDS = 2 * HALF_FULL_ROUNDS + N_PARTIAL_ROUNDS;
constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPSILON = 0xFFFFFFFFull;  // 2^64 mod p
constexpr uint32_t MASK16 = 0xFFFFu;

// CONSTANTS: the round constants (N_ROUNDS x W), one zero row, then the
// fast partial-round constants in poseidon_fast.fast_constants_np()'s
// order. Each library that includes this header uploads its own copy.
constexpr int ZERO_ROW = N_ROUNDS * W;
constexpr int FAST_FIRST = ZERO_ROW + W;                    // 12
constexpr int FAST_INITIAL = FAST_FIRST + W;                // 11 x 11
constexpr int FAST_PARTIAL = FAST_INITIAL + (W - 1) * (W - 1);  // 22
constexpr int FAST_W_HATS = FAST_PARTIAL + N_PARTIAL_ROUNDS;    // 22 x 11
constexpr int FAST_VS = FAST_W_HATS + N_PARTIAL_ROUNDS * (W - 1);
constexpr int N_CONSTANTS = FAST_VS + N_PARTIAL_ROUNDS * (W - 1);
constexpr int N_FAST = N_CONSTANTS - FAST_FIRST;            // 639
__constant__ uint64_t CONSTANTS[N_CONSTANTS];

__host__ __device__ constexpr uint64_t mds_circ(int i) {
    return i == 0 ? 17 : i == 1 ? 15 : i == 2 ? 41 : i == 3 ? 16
         : i == 4 ? 2 : i == 5 ? 28 : i == 6 ? 13 : i == 7 ? 13
         : i == 8 ? 39 : i == 9 ? 18 : i == 10 ? 34 : 20;
}

constexpr uint64_t MDS_DIAG0 = 8;            // diag = (8, 0, ..., 0)
constexpr uint64_t MDS_00 = 17 + MDS_DIAG0;  // M[0][0]

// MDS coefficient M[r][j] = circ[(j - r) mod 12] + diag[r] * (j == r).
__host__ __device__ constexpr uint64_t mds_coef(int r, int j) {
    return mds_circ((j - r + W) % W) + ((r == 0 && j == 0) ? MDS_DIAG0 : 0);
}

// lo + hi * 2^64 mod p, lazy (any u64): with hi = h0 + h1 * 2^32,
// n = lo - h1 + h0 * (2^32 - 1)  (mod p), since 2^96 = -1 and
// 2^64 = 2^32 - 1 (mod p). Neither correction wraps again: after a borrow
// t >= 2^64 - 2^32 > EPSILON, and after a carry s < 2^64 - 2^32.
__device__ __forceinline__ uint64_t reduce128(uint64_t lo, uint64_t hi) {
    const uint64_t h0 = hi & EPSILON;
    const uint64_t h1 = hi >> 32;
    uint64_t t = lo - h1;
    if (lo < h1) t -= EPSILON;               // borrow: add p
    const uint64_t u = (h0 << 32) - h0;
    uint64_t s = t + u;
    if (s < t) s += EPSILON;                 // carry: add 2^64 mod p
    return s;
}

__device__ __forceinline__ uint64_t canonical(uint64_t x) {
    return x >= P ? x - P : x;
}

// a + c for any u64 a and a canonical c, lazy: a + c - 2^64 < p - 1, so
// adding 2^64 mod p after a carry never carries again.
__device__ __forceinline__ uint64_t gl_add(uint64_t a, uint64_t c) {
    uint64_t s = a + c;
    if (s < a) s += EPSILON;
    return s;
}

// a * b + c mod p, lazy, for any u64 a, b, c: a * b + c < 2^128.
__device__ __forceinline__ uint64_t gl_mul_add(uint64_t a, uint64_t b,
                                               uint64_t c) {
    uint64_t lo, hi;
    asm("mad.lo.cc.u64 %0, %2, %3, %4;\n\t"
        "madc.hi.u64 %1, %2, %3, 0;"
        : "=l"(lo), "=l"(hi) : "l"(a), "l"(b), "l"(c));
    return reduce128(lo, hi);
}

__device__ __forceinline__ uint64_t gl_mul(uint64_t a, uint64_t b) {
    return reduce128(a * b, __umul64hi(a, b));
}

// A sum of general products in 192 bits: lo + hi * 2^64 + top * 2^128.
struct AccU64 {
    uint64_t lo = 0, hi = 0;
    uint32_t top = 0;

    __device__ __forceinline__ void mac(uint64_t a, uint64_t b) {
        asm("mad.lo.cc.u64 %0, %3, %4, %0;\n\t"
            "madc.hi.cc.u64 %1, %3, %4, %1;\n\t"
            "addc.u32 %2, %2, 0;"
            : "+l"(lo), "+l"(hi), "+r"(top) : "l"(a), "l"(b));
    }

    // 2^128 = -2^32 (mod p); top counts at most one carry a term, so
    // t < 2^36 < p.
    __device__ __forceinline__ uint64_t reduce() const {
        const uint64_t r = reduce128(lo, hi);
        const uint64_t t = static_cast<uint64_t>(top) << 32;
        uint64_t d = r - t;
        if (r < t) d -= EPSILON;             // borrow: add p
        return d;
    }
};

// The arithmetic of the dense kernels: the functions above.
struct U64Arith {
    using Acc = AccU64;

    static __device__ __forceinline__ uint64_t reduce_small(uint64_t lo,
                                                            uint32_t h0) {
        return reduce128(lo, h0);
    }
    static __device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
        return gl_mul(a, b);
    }
    static __device__ __forceinline__ uint64_t sqr(uint64_t a) {
        return gl_mul(a, a);
    }
    static __device__ __forceinline__ uint64_t mul_add(uint64_t a,
                                                       uint64_t b,
                                                       uint64_t c) {
        return gl_mul_add(a, b, c);
    }
};

template <class F>
__device__ __forceinline__ uint64_t sbox7(uint64_t x) {
    const uint64_t x2 = F::sqr(x);
    const uint64_t x3 = F::mul(x2, x);
    const uint64_t x6 = F::sqr(x3);
    return F::mul(x6, x);
}

// The MDS on 16-bit limb planes, plus a canonical constant vector
// CONSTANTS[post..post+11] folded into the sums. Each output word
// accumulates the twelve small-constant products of each of its four limb
// planes in 32 bits (coefficients sum to at most 264, plus a 16-bit limb
// of the constant: below 2^25), then one carry chain across the planes
// and one F::reduce_small.
template <class F>
__device__ __forceinline__ void mds_limb_planes(uint64_t s[W], int post) {
    uint32_t limb[4][W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
        const uint32_t lo = static_cast<uint32_t>(s[j]);
        const uint32_t hi = static_cast<uint32_t>(s[j] >> 32);
        limb[0][j] = lo & MASK16;
        limb[1][j] = lo >> 16;
        limb[2][j] = hi & MASK16;
        limb[3][j] = hi >> 16;
    }
#pragma unroll
    for (int r = 0; r < W; ++r) {
        const uint64_t c = CONSTANTS[post + r];
        const uint32_t c_lo = static_cast<uint32_t>(c);
        const uint32_t c_hi = static_cast<uint32_t>(c >> 32);
        const uint32_t c_limb[4] = {c_lo & MASK16, c_lo >> 16,
                                    c_hi & MASK16, c_hi >> 16};
        uint32_t acc[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            uint32_t a = c_limb[k] + static_cast<uint32_t>(
                MDS_DIAG0 * (r == 0)) * limb[k][r];
#pragma unroll
            for (int i = 0; i < W; ++i)
                a += static_cast<uint32_t>(mds_circ(i))
                    * limb[k][(r + i) % W];
            acc[k] = a;
        }
        // one carry chain across the limb planes
        const uint32_t t0 = acc[0] & MASK16;
        const uint32_t s1 = acc[1] + (acc[0] >> 16);
        const uint32_t t1 = s1 & MASK16;
        const uint32_t s2 = acc[2] + (s1 >> 16);
        const uint32_t t2 = s2 & MASK16;
        const uint32_t s3 = acc[3] + (s2 >> 16);
        const uint32_t t3 = s3 & MASK16;
        const uint64_t lo = static_cast<uint64_t>(t0 | (t1 << 16))
            | (static_cast<uint64_t>(t2 | (t3 << 16)) << 32);
        s[r] = F::reduce_small(lo, s3 >> 16);
    }
}

// Full rounds first..first+3 on a state whose round constants for `first`
// are already added: S-boxes, then the MDS with the next constant vector
// folded in (after round 3 the fast first constant layer; after round 29
// the zero row).
template <class F>
__device__ __forceinline__ void full_rounds(uint64_t s[W], int first) {
#pragma unroll 1
    for (int rnd = first; rnd < first + HALF_FULL_ROUNDS; ++rnd) {
#pragma unroll
        for (int j = 0; j < W; ++j) s[j] = sbox7<F>(s[j]);
        mds_limb_planes<F>(s, rnd == HALF_FULL_ROUNDS - 1 ? FAST_FIRST
                                                         : (rnd + 1) * W);
    }
}

__device__ __forceinline__ void add_round_constants(uint64_t s[W], int rnd) {
#pragma unroll
    for (int j = 0; j < W; ++j) s[j] = gl_add(s[j], CONSTANTS[rnd * W + j]);
}

// The 22 partial rounds in fast form, on a state whose first constant
// layer is already added.
template <class F>
__device__ __forceinline__ void partial_rounds(uint64_t s[W]) {
    uint64_t t[W - 1];
#pragma unroll
    for (int i = 0; i < W - 1; ++i) {
        typename F::Acc acc;
#pragma unroll
        for (int j = 0; j < W - 1; ++j)
            acc.mac(CONSTANTS[FAST_INITIAL + i * (W - 1) + j], s[j + 1]);
        t[i] = acc.reduce();
    }
#pragma unroll
    for (int i = 0; i < W - 1; ++i) s[i + 1] = t[i];
#pragma unroll 1
    for (int r = 0; r < N_PARTIAL_ROUNDS; ++r) {
        const uint64_t x = s[0];
        const uint64_t x2 = F::sqr(x);
        const uint64_t x3 = F::mul(x2, x);
        const uint64_t x6 = F::sqr(x3);
        const uint64_t s0 = F::mul_add(x6, x, CONSTANTS[FAST_PARTIAL + r]);
        typename F::Acc acc;
        acc.mac(s0, MDS_00);
#pragma unroll
        for (int j = 0; j < W - 1; ++j)
            acc.mac(CONSTANTS[FAST_W_HATS + r * (W - 1) + j], s[j + 1]);
#pragma unroll
        for (int i = 1; i < W; ++i)
            s[i] = F::mul_add(s0, CONSTANTS[FAST_VS + r * (W - 1) + i - 1],
                              s[i]);
        s[0] = acc.reduce();
    }
}

// The 30 rounds on one state held in registers; the result is lazy.
template <class F = U64Arith>
__device__ __forceinline__ void permute_state(uint64_t s[W]) {
    add_round_constants(s, 0);
    full_rounds<F>(s, 0);
    partial_rounds<F>(s);
    add_round_constants(s, HALF_FULL_ROUNDS + N_PARTIAL_ROUNDS);
    full_rounds<F>(s, HALF_FULL_ROUNDS + N_PARTIAL_ROUNDS);
}

// Words 0..width-1 of a chunk whose k-th word sits at p[k * stride].
__device__ __forceinline__ void load_chunk(const uint64_t* p, int64_t width,
                                           int64_t stride,
                                           uint64_t buf[RATE]) {
#pragma unroll
    for (int j = 0; j < RATE; ++j)
        if (j < width) buf[j] = p[j * stride];
}

// Overwrite-mode sponge over one leaf whose k-th word sits at
// row[k * stride], n_cols > 0: each chunk replaces the rate lanes it
// covers; a trailing partial chunk of rem < 8 words replaces lanes
// 0..rem-1 and keeps the running values of the rest. The loads of chunk
// c + 1 are issued into a register buffer before chunk c is permuted, so
// their latency hides behind its 30 rounds. Leaves the lazy state in s.
__device__ __forceinline__ void sponge_leaf(const uint64_t* row,
                                            int64_t n_cols, int64_t stride,
                                            uint64_t s[W]) {
#pragma unroll
    for (int j = 0; j < W; ++j) s[j] = 0;
    const int64_t n_chunks = (n_cols + RATE - 1) / RATE;
    uint64_t next[RATE];
    load_chunk(row, n_cols, stride, next);
    for (int64_t c = 0; c < n_chunks; ++c) {
        const int64_t left = n_cols - c * RATE;    // words from chunk c on
#pragma unroll
        for (int j = 0; j < RATE; ++j)
            if (j < left) s[j] = next[j];
        if (c + 1 < n_chunks)
            load_chunk(row + (c + 1) * RATE * stride, left - RATE, stride,
                       next);
        permute_state(s);
    }
}

}  // namespace

// The constant uploads every Poseidon library exports under its own
// prefix. Each returns a cudaError_t as an int.
#define ZK_POSEIDON_CONSTANT_UPLOADS(prefix)                                  \
    extern "C" int prefix##_mds_coef(int r, int j) {                          \
        return static_cast<int>(mds_coef(r, j));                              \
    }                                                                         \
    extern "C" int prefix##_set_round_constants(const uint64_t* host_rcs) {   \
        return static_cast<int>(cudaMemcpyToSymbol(                           \
            CONSTANTS, host_rcs, sizeof(uint64_t) * N_ROUNDS * W));           \
    }                                                                         \
    extern "C" int prefix##_set_fast_constants(const uint64_t* host_fast,     \
                                               int64_t n) {                   \
        if (n != N_FAST) return static_cast<int>(cudaErrorInvalidValue);      \
        return static_cast<int>(cudaMemcpyToSymbol(                           \
            CONSTANTS, host_fast, sizeof(uint64_t) * N_FAST,                  \
            sizeof(uint64_t) * FAST_FIRST));                                  \
    }
