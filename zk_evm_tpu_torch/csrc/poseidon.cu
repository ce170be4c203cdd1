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
// output. Any batch size is taken and the ragged edge is masked. The
// sponge reads the leaf matrix through its strides; for the LDE's
// (n_cols, n_rows) layout neighbouring threads read neighbouring
// addresses of each column, so its loads coalesce, and no transposed
// copy is made.
//
// What bounds it on the card: integer instruction issue, not bytes (the
// bytes bound is 11-31x lower). A Goldilocks product is one 64x64-bit
// multiply, which Hopper builds from 32-bit IMADs, plus a short
// add/compare reduction. The design, in poseidon_common.cuh, cuts the
// instructions a permutation issues:
//
//   1. Fast partial rounds. 22 of the 30 linear layers follow a round
//      with one S-box; they become one dense 11x11 matrix and 22 sparse
//      layers of 22 general products (plonky2's form; constants from
//      hash/poseidon_fast.py), in place of 22 full 12x12 MDS layers and
//      264 constant additions.
//   2. One MDS for the 8 full rounds: the 16-bit limb-plane form of the
//      planes kernels (four 32-bit accumulators per word, one carry chain,
//      one reduction), which beat the 64-bit halves form at every shape.
//   3. Lazy reduction: words stay any u64 congruent mod p inside the
//      permutation; the next round's constants are folded into the MDS
//      sums; only the words a kernel writes are made canonical.
//   4. A prefetching sponge: the loads of chunk c + 1 go out into a
//      register buffer before chunk c is permuted (without it the 30- and
//      523-column sponges took 22% and 47% longer on an H100).
//   5. Launch shapes from ptxas's register count and the measured rate
//      (below).
//
// By cuobjdump, a permutation now issues about 33,000 SASS instructions
// (31,700 integer), against 49,800 (41,700) with 30 dense MDS layers in
// the 64-bit halves form; `python3 -m zk_evm_tpu_torch.poseidon_ab`
// counts them and times both forms.
//
// Round and fast constants sit in __constant__ memory: every thread of a
// warp reads the same word, which the constant cache broadcasts. No wgmma
// or TMA: an op-bound kernel with coalesced loads gains nothing from TMA,
// and a tensor-core MDS would now cover only 8 layers, at about the
// integer cost of splitting bytes and recombining the sums it replaces.

#include "poseidon_common.cuh"

namespace {

// Launch shapes (step 5): 256-thread permute blocks with at most 128
// registers a thread (ptxas gives 116, no spills) ran 2^18 states in 0.46
// ms against 0.61 for 128-thread blocks at 120 registers. The sponge
// keeps 128-thread blocks with an explicit minimum of one block an SM,
// which lets ptxas take 216 registers: without the minimum it stopped at
// 128 and spilled, and the 30-column sponge took 18.6 ms instead of
// 14.7; every tighter cap or larger block tried was as fast or slower.
constexpr int PERMUTE_THREADS = 256;
constexpr int PERMUTE_MIN_BLOCKS = 2;
constexpr int SPONGE_THREADS = 128;
constexpr int SPONGE_MIN_BLOCKS = 1;

// states: (batch, 12) row-major; out may not alias states.
__global__ void __launch_bounds__(PERMUTE_THREADS, PERMUTE_MIN_BLOCKS)
poseidon_permute_kernel(const uint64_t* __restrict__ states,
                        uint64_t* __restrict__ out, int64_t batch) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * PERMUTE_THREADS
        + threadIdx.x;
    if (i >= batch) return;
    uint64_t s[W];
#pragma unroll
    for (int j = 0; j < W; ++j) s[j] = states[i * W + j];
    permute_state(s);
#pragma unroll
    for (int j = 0; j < W; ++j) out[i * W + j] = canonical(s[j]);
}

// Leaf (r, c) of the matrix sits at m[r * row_stride + c * col_stride];
// out: (n_rows, 4) row-major digests.
__global__ void __launch_bounds__(SPONGE_THREADS, SPONGE_MIN_BLOCKS)
poseidon_sponge_kernel(const uint64_t* __restrict__ m, int64_t n_rows,
                       int64_t n_cols, int64_t row_stride,
                       int64_t col_stride, uint64_t* __restrict__ out) {
    const int64_t r = static_cast<int64_t>(blockIdx.x) * SPONGE_THREADS
        + threadIdx.x;
    if (r >= n_rows) return;
    uint64_t s[W];
    sponge_leaf(m + r * row_stride, n_cols, col_stride, s);
#pragma unroll
    for (int e = 0; e < 4; ++e) out[r * 4 + e] = canonical(s[e]);
}

unsigned int blocks_for(int64_t n, int threads) {
    return static_cast<unsigned int>((n + threads - 1) / threads);
}

}  // namespace

// Plain C interface, loaded with ctypes. Each launch goes on the caller's
// stream and returns cudaGetLastError(), so a refused launch is reported.

ZK_POSEIDON_CONSTANT_UPLOADS(zk_poseidon)

extern "C" int zk_poseidon_permute(const void* states, void* out,
                                   int64_t batch, void* stream) {
    if (batch > 0) {
        poseidon_permute_kernel<<<blocks_for(batch, PERMUTE_THREADS),
                                  PERMUTE_THREADS, 0,
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
        poseidon_sponge_kernel<<<blocks_for(n_rows, SPONGE_THREADS),
                                 SPONGE_THREADS, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint64_t*>(m), n_rows, n_cols, row_stride,
            col_stride, static_cast<uint64_t*>(out));
    }
    return static_cast<int>(cudaGetLastError());
}
