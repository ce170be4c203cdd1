// Poseidon over Goldilocks for Hopper (sm_90a), dense layout: one state's
// 12 words are adjacent in memory. Bit-identical to the plain PyTorch
// version in zk_evm_tpu_torch/hash/poseidon.py and the python-int twin in
// zk_evm_tpu_torch/hash/host_poseidon.py. Field arithmetic and the round
// structure are in poseidon_common.cuh.
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
// permutation costs 8*12 + 22 S-boxes of 4 products each (472 products)
// plus 30 MDS layers of small-constant multiply-adds; a 523-column leaf
// row costs 66 permutations. Memory traffic is small beside that (8 bytes
// read per 49 products in the sponge), so the kernels are integer-ALU
// bound. Round constants sit in __constant__ memory: every thread of a
// warp reads the same word, which the constant cache broadcasts. The MDS
// sums its small-constant products of the 32-bit halves in 64-bit
// accumulators (a 128-bit value) and reduces once per output word. No
// wgmma or TMA: this is the simple, correct first version.

#include "poseidon_common.cuh"

namespace {

constexpr int THREADS = 128;

struct MdsHalves {
    __device__ __forceinline__ static void apply(uint64_t s[W]) {
        uint64_t out[W];
#pragma unroll
        for (int r = 0; r < W; ++r) {
            uint64_t acc_lo = 0;             // sum of M * low halves, < 2^41
            uint64_t acc_hi = 0;             // sum of M * high halves
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
};

// states: (batch, 12) row-major; out may not alias states.
__global__ void __launch_bounds__(THREADS)
poseidon_permute_kernel(const uint64_t* __restrict__ states,
                        uint64_t* __restrict__ out, int64_t batch) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
    if (i >= batch) return;
    uint64_t s[W];
#pragma unroll
    for (int j = 0; j < W; ++j) s[j] = states[i * W + j];
    permute_state<MdsHalves>(s);
#pragma unroll
    for (int j = 0; j < W; ++j) out[i * W + j] = s[j];
}

// Leaf (r, c) of the matrix sits at m[r * row_stride + c * col_stride];
// out: (n_rows, 4) row-major digests.
__global__ void __launch_bounds__(THREADS)
poseidon_sponge_kernel(const uint64_t* __restrict__ m, int64_t n_rows,
                       int64_t n_cols, int64_t row_stride,
                       int64_t col_stride, uint64_t* __restrict__ out) {
    const int64_t r = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
    if (r >= n_rows) return;
    uint64_t s[W];
    sponge_leaf<MdsHalves>(m + r * row_stride, n_cols, col_stride, s);
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
