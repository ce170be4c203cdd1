// Poseidon over Goldilocks for Hopper (sm_90a): width 12, rate 8,
// 4 + 22 + 4 rounds, S-box x^7, MDS = circulant(17,15,41,16,2,28,13,13,
// 39,18,34,20) + diag(8,0,...,0). Bit-identical to the plain PyTorch
// version in zk_evm_tpu_torch/hash/poseidon.py and the python-int twin in
// zk_evm_tpu_torch/hash/host_poseidon.py.
//
// Two kernels, each replacing one Pallas kernel of the JAX package:
//
//   poseidon_permute_kernel  replaces zk_evm_tpu/hash/poseidon_dense.py
//                            _permute_kernel (Merkle compress levels and
//                            the FRI proof-of-work grind).
//   poseidon_sponge_kernel   replaces zk_evm_tpu/hash/poseidon_dense.py
//                            _sponge_kernel (the leaf hash of every
//                            commitment).
//
// Design. One thread owns one state: its 12 u64 words stay in registers
// for all 30 rounds and, in the sponge, across every rate-8 chunk of the
// row, so device memory sees one read of the input and one write of the
// output. The TPU kernels' 1024-state tiles, (8, 128) layouts and limb
// planes were artefacts of that chip and are gone: any batch size is
// taken and the ragged edge is masked. The sponge reads the leaf matrix
// through its strides; for the LDE's (n_cols, n_rows) layout neighbouring
// threads read neighbouring addresses of each column, so its loads
// coalesce, and no transposed copy is made.
//
// What bounds it on the card: 64-bit integer multiplies. A Goldilocks
// product is one a*b plus one __umul64hi, which Hopper builds from
// several 32-bit IMADs, followed by a short add/compare reduction. A
// permutation costs 8*12 + 22 S-boxes of 4 products each (392 products)
// plus 30 MDS layers of small-constant multiply-adds; a 523-column leaf
// row costs 66 permutations. Memory traffic is small beside that (8 bytes
// read per 49 products in the sponge), so the kernels are integer-ALU
// bound. Round constants sit in __constant__ memory: every thread of a
// warp reads the same word, which the constant cache broadcasts. The MDS
// sums its small-constant products of the 32-bit halves in 64-bit
// accumulators (a 128-bit value) and reduces once per output word. No
// wgmma or TMA: this is the simple, correct first version.

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
constexpr int THREADS = 128;

__constant__ uint64_t ROUND_CONSTANTS[N_ROUNDS * W];

// MDS coefficient M[r][j] = circ[(j - r) mod 12] + diag[r] * (j == r).
__host__ __device__ constexpr uint64_t mds_circ(int i) {
    return i == 0 ? 17 : i == 1 ? 15 : i == 2 ? 41 : i == 3 ? 16
         : i == 4 ? 2 : i == 5 ? 28 : i == 6 ? 13 : i == 7 ? 13
         : i == 8 ? 39 : i == 9 ? 18 : i == 10 ? 34 : 20;
}

__host__ __device__ constexpr uint64_t mds_coef(int r, int j) {
    return mds_circ((j - r + W) % W) + ((r == 0 && j == 0) ? 8 : 0);
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

__device__ __forceinline__ void mds(uint64_t s[W]) {
    uint64_t out[W];
#pragma unroll
    for (int r = 0; r < W; ++r) {
        uint64_t acc_lo = 0;                 // sum of M * low halves, < 2^41
        uint64_t acc_hi = 0;                 // sum of M * high halves
#pragma unroll
        for (int j = 0; j < W; ++j) {
            acc_lo += mds_coef(r, j) * (s[j] & EPSILON);
            acc_hi += mds_coef(r, j) * (s[j] >> 32);
        }
        // value = acc_lo + acc_hi * 2^32 < 2^74, as a 128-bit (lo, hi)
        const uint64_t lo = acc_lo + (acc_hi << 32);
        const uint64_t hi = (acc_hi >> 32) + (lo < acc_lo ? 1 : 0);
        out[r] = reduce128(lo, hi);
    }
#pragma unroll
    for (int r = 0; r < W; ++r) s[r] = out[r];
}

__device__ __forceinline__ void full_round(uint64_t s[W], int rnd) {
#pragma unroll
    for (int j = 0; j < W; ++j)
        s[j] = sbox7(gl_add(s[j], ROUND_CONSTANTS[rnd * W + j]));
    mds(s);
}

__device__ __forceinline__ void partial_round(uint64_t s[W], int rnd) {
#pragma unroll
    for (int j = 0; j < W; ++j)
        s[j] = gl_add(s[j], ROUND_CONSTANTS[rnd * W + j]);
    s[0] = sbox7(s[0]);
    mds(s);
}

__device__ __forceinline__ void permute_state(uint64_t s[W]) {
#pragma unroll 1
    for (int rnd = 0; rnd < HALF_FULL_ROUNDS; ++rnd) full_round(s, rnd);
#pragma unroll 1
    for (int rnd = HALF_FULL_ROUNDS; rnd < HALF_FULL_ROUNDS + N_PARTIAL_ROUNDS;
         ++rnd)
        partial_round(s, rnd);
#pragma unroll 1
    for (int rnd = HALF_FULL_ROUNDS + N_PARTIAL_ROUNDS; rnd < N_ROUNDS; ++rnd)
        full_round(s, rnd);
}

// states: (batch, 12) row-major; out may not alias states.
__global__ void __launch_bounds__(THREADS)
poseidon_permute_kernel(const uint64_t* __restrict__ states,
                        uint64_t* __restrict__ out, int64_t batch) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
    if (i >= batch) return;
    uint64_t s[W];
#pragma unroll
    for (int j = 0; j < W; ++j) s[j] = states[i * W + j];
    permute_state(s);
#pragma unroll
    for (int j = 0; j < W; ++j) out[i * W + j] = s[j];
}

// Leaf (r, c) of the matrix sits at m[r * row_stride + c * col_stride];
// out: (n_rows, 4) row-major digests. Overwrite-mode sponge: each chunk
// replaces the rate lanes it covers; a trailing partial chunk of k < 8
// words replaces lanes 0..k-1 and keeps the running values of the rest.
__global__ void __launch_bounds__(THREADS)
poseidon_sponge_kernel(const uint64_t* __restrict__ m, int64_t n_rows,
                       int64_t n_cols, int64_t row_stride,
                       int64_t col_stride, uint64_t* __restrict__ out) {
    const int64_t r = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
    if (r >= n_rows) return;
    const uint64_t* row = m + r * row_stride;
    uint64_t s[W];
#pragma unroll
    for (int j = 0; j < W; ++j) s[j] = 0;
    const int64_t n_full = n_cols / RATE;
    const int64_t rem = n_cols % RATE;
    for (int64_t c = 0; c < n_full; ++c) {
        const uint64_t* chunk = row + c * RATE * col_stride;
#pragma unroll
        for (int j = 0; j < RATE; ++j) s[j] = chunk[j * col_stride];
        permute_state(s);
    }
    if (rem) {
        const uint64_t* chunk = row + n_full * RATE * col_stride;
#pragma unroll
        for (int j = 0; j < RATE; ++j)
            if (j < rem) s[j] = chunk[j * col_stride];
        permute_state(s);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) out[r * 4 + e] = s[e];
}

unsigned int blocks_for(int64_t n) {
    return static_cast<unsigned int>((n + THREADS - 1) / THREADS);
}

}  // namespace

// Plain C interface, loaded with ctypes. Each launch goes on the caller's
// stream and returns cudaGetLastError(), so a refused launch is reported.

extern "C" int zk_poseidon_mds_coef(int r, int j) {
    return static_cast<int>(mds_coef(r, j));
}

extern "C" int zk_poseidon_set_round_constants(const uint64_t* host_rcs) {
    return static_cast<int>(cudaMemcpyToSymbol(
        ROUND_CONSTANTS, host_rcs, sizeof(uint64_t) * N_ROUNDS * W));
}

extern "C" int zk_poseidon_permute(const void* states, void* out,
                                   int64_t batch, void* stream) {
    if (batch > 0) {
        poseidon_permute_kernel<<<blocks_for(batch), THREADS, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint64_t*>(states),
            static_cast<uint64_t*>(out), batch);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int zk_poseidon_sponge(const void* m, int64_t n_rows,
                                  int64_t n_cols, int64_t row_stride,
                                  int64_t col_stride, void* out,
                                  void* stream) {
    if (n_rows > 0) {
        poseidon_sponge_kernel<<<blocks_for(n_rows), THREADS, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint64_t*>(m), n_rows, n_cols, row_stride,
            col_stride, static_cast<uint64_t*>(out));
    }
    return static_cast<int>(cudaGetLastError());
}
