// Goldilocks field arithmetic and the Poseidon parameters shared by the
// CUDA Poseidon kernels (poseidon.cu, poseidon_pallas.cu). Width 12,
// rate 8, 4 + 22 + 4 rounds, S-box x^7, MDS = circulant(17,15,41,16,2,28,
// 13,13,39,18,34,20) + diag(8,0,...,0); bit-identical to the plain
// PyTorch version in zk_evm_tpu_torch/hash/poseidon.py.
//
// Field elements are canonical u64 values (< p = 2^64 - 2^32 + 1). A
// product is one a*b and one __umul64hi, reduced with 2^64 = 2^32 - 1
// and 2^96 = -1 (mod p).

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

// Each library that includes this header uploads its own copy.
__constant__ uint64_t ROUND_CONSTANTS[N_ROUNDS * W];

__host__ __device__ constexpr uint64_t mds_circ(int i) {
    return i == 0 ? 17 : i == 1 ? 15 : i == 2 ? 41 : i == 3 ? 16
         : i == 4 ? 2 : i == 5 ? 28 : i == 6 ? 13 : i == 7 ? 13
         : i == 8 ? 39 : i == 9 ? 18 : i == 10 ? 34 : 20;
}

constexpr uint64_t MDS_DIAG0 = 8;            // diag = (8, 0, ..., 0)

// MDS coefficient M[r][j] = circ[(j - r) mod 12] + diag[r] * (j == r).
__host__ __device__ constexpr uint64_t mds_coef(int r, int j) {
    return mds_circ((j - r + W) % W) + ((r == 0 && j == 0) ? MDS_DIAG0 : 0);
}

// lo + hi * 2^64 mod p, canonical: with hi = h0 + h1 * 2^32,
// n = lo - h1 + h0 * (2^32 - 1)  (mod p), since 2^96 = -1 and
// 2^64 = 2^32 - 1 (mod p).
__device__ __forceinline__ uint64_t reduce128(uint64_t lo, uint64_t hi) {
    const uint64_t h0 = hi & EPSILON;
    const uint64_t h1 = hi >> 32;
    uint64_t t = lo - h1;
    if (lo < h1) t -= EPSILON;               // borrow: add p
    const uint64_t u = (h0 << 32) - h0;
    uint64_t s = t + u;
    if (s < t) s += EPSILON;                 // carry: add 2^64 mod p
    if (s >= P) s -= P;
    return s;
}

__device__ __forceinline__ uint64_t gl_add(uint64_t a, uint64_t b) {
    uint64_t s = a + b;
    if (s < a) s += EPSILON;                 // a + b < 2p: never re-carries
    if (s >= P) s -= P;
    return s;
}

__device__ __forceinline__ uint64_t gl_mul(uint64_t a, uint64_t b) {
    return reduce128(a * b, __umul64hi(a, b));
}

__device__ __forceinline__ uint64_t sbox7(uint64_t x) {
    const uint64_t x2 = gl_mul(x, x);
    const uint64_t x3 = gl_mul(x2, x);
    const uint64_t x6 = gl_mul(x3, x3);
    return gl_mul(x6, x);
}

template <class Mds>
__device__ __forceinline__ void full_round(uint64_t s[W], int rnd) {
#pragma unroll
    for (int j = 0; j < W; ++j)
        s[j] = sbox7(gl_add(s[j], ROUND_CONSTANTS[rnd * W + j]));
    Mds::apply(s);
}

template <class Mds>
__device__ __forceinline__ void partial_round(uint64_t s[W], int rnd) {
#pragma unroll
    for (int j = 0; j < W; ++j)
        s[j] = gl_add(s[j], ROUND_CONSTANTS[rnd * W + j]);
    s[0] = sbox7(s[0]);
    Mds::apply(s);
}

// The 30 rounds on one state held in registers; `Mds::apply(s)` is the
// kernel's MDS layer.
template <class Mds>
__device__ __forceinline__ void permute_state(uint64_t s[W]) {
#pragma unroll 1
    for (int rnd = 0; rnd < HALF_FULL_ROUNDS; ++rnd)
        full_round<Mds>(s, rnd);
#pragma unroll 1
    for (int rnd = HALF_FULL_ROUNDS; rnd < HALF_FULL_ROUNDS + N_PARTIAL_ROUNDS;
         ++rnd)
        partial_round<Mds>(s, rnd);
#pragma unroll 1
    for (int rnd = HALF_FULL_ROUNDS + N_PARTIAL_ROUNDS; rnd < N_ROUNDS; ++rnd)
        full_round<Mds>(s, rnd);
}

// Overwrite-mode sponge over one leaf whose k-th word sits at
// row[k * stride]: each chunk replaces the rate lanes it covers; a
// trailing partial chunk of rem < 8 words replaces lanes 0..rem-1 and
// keeps the running values of the rest. Leaves the state in s.
template <class Mds>
__device__ __forceinline__ void sponge_leaf(const uint64_t* row,
                                            int64_t n_cols, int64_t stride,
                                            uint64_t s[W]) {
#pragma unroll
    for (int j = 0; j < W; ++j) s[j] = 0;
    const int64_t n_full = n_cols / RATE;
    const int64_t rem = n_cols % RATE;
    for (int64_t c = 0; c < n_full; ++c) {
        const uint64_t* chunk = row + c * RATE * stride;
#pragma unroll
        for (int j = 0; j < RATE; ++j) s[j] = chunk[j * stride];
        permute_state<Mds>(s);
    }
    if (rem) {
        const uint64_t* chunk = row + n_full * RATE * stride;
#pragma unroll
        for (int j = 0; j < RATE; ++j)
            if (j < rem) s[j] = chunk[j * stride];
        permute_state<Mds>(s);
    }
}

}  // namespace
