// Poseidon over Goldilocks for Hopper (sm_90a), planes layout: the state
// batch is held as twelve planes, (12, B) — word j of state i at
// planes[j * ld + i]. Bit-identical to the dense kernels (poseidon.cu),
// the plain PyTorch version (zk_evm_tpu_torch/hash/poseidon.py) and the
// python-int twin. Field arithmetic and the round structure are in
// poseidon_common.cuh.
//
// Two kernels, each replacing one Pallas kernel of the JAX package:
//
//   poseidon_planes_permute_kernel  replaces zk_evm_tpu/hash/
//                                   poseidon_pallas.py _permute_kernel.
//   poseidon_planes_sponge_kernel   replaces zk_evm_tpu/hash/
//                                   poseidon_pallas.py _sponge_kernel.
//
// Design, carried over from the TPU kernels: structure of arrays. Each
// thread owns one state, and a warp reads one state word of 32
// neighbouring states at neighbouring addresses, so every load and store
// coalesces without strides. The MDS is that of `_mds_tile_roll`: the
// state words are split into four 16-bit limb planes, each output word
// accumulates the twelve small-constant products (circulant coefficients
// <= 41, sum 264, so every 32-bit accumulator stays below 2^25) of one
// limb plane, and one carry chain across the four planes plus one
// reduce128 yields the canonical word.
//
// Left behind with the TPU: the u32 limb arithmetic of the field
// products (Hopper has __umul64hi; the S-box products are u64 as in
// poseidon.cu), the TILE % 1024 requirement (any batch and any row count
// are taken; the ragged edge is masked) and the sequential chunk axis of
// the sponge grid (one thread carries its state across all chunks in
// registers).
//
// What bounds it on the card: integer operations, as for poseidon.cu —
// 472 u64 products a permutation in the S-boxes and 30 MDS layers of
// 4 x 12 x 12 32-bit multiply-adds; memory traffic is one read of the
// input and one write of the output. The tensor-core MDS (mma.sync
// u8 x u8 -> s32 on byte planes, the counterpart of the TPU's
// `_mds_tile`) is a later redesign.

#include "poseidon_common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr uint32_t MASK16 = 0xFFFFu;

struct MdsLimbPlanes {
    __device__ __forceinline__ static void apply(uint64_t s[W]) {
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
            uint32_t acc[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                uint32_t a = static_cast<uint32_t>(MDS_DIAG0 * (r == 0))
                    * limb[k][r];
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
            s[r] = reduce128(lo, s3 >> 16);
        }
    }
};

// planes in/out: (12, ld), states 0..batch-1; out may not alias in.
__global__ void __launch_bounds__(THREADS)
poseidon_planes_permute_kernel(const uint64_t* __restrict__ in,
                               uint64_t* __restrict__ out, int64_t batch,
                               int64_t ld) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
    if (i >= batch) return;
    uint64_t s[W];
#pragma unroll
    for (int j = 0; j < W; ++j) s[j] = in[j * ld + i];
    permute_state<MdsLimbPlanes>(s);
#pragma unroll
    for (int j = 0; j < W; ++j) out[j * ld + i] = s[j];
}

// m: (n_cols, ld) planes, leaf r = column r; out: (4, n_rows) digest
// planes.
__global__ void __launch_bounds__(THREADS)
poseidon_planes_sponge_kernel(const uint64_t* __restrict__ m,
                              int64_t n_rows, int64_t n_cols, int64_t ld,
                              uint64_t* __restrict__ out) {
    const int64_t r = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
    if (r >= n_rows) return;
    uint64_t s[W];
    sponge_leaf<MdsLimbPlanes>(m + r, n_cols, ld, s);
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e * n_rows + r] = s[e];
}

unsigned int blocks_for(int64_t n) {
    return static_cast<unsigned int>((n + THREADS - 1) / THREADS);
}

}  // namespace

// Plain C interface, loaded with ctypes. Each launch goes on the caller's
// stream and returns cudaGetLastError(), so a refused launch is reported.

extern "C" int zk_poseidon_pallas_mds_coef(int r, int j) {
    return static_cast<int>(mds_coef(r, j));
}

extern "C" int zk_poseidon_pallas_set_round_constants(
        const uint64_t* host_rcs) {
    return static_cast<int>(cudaMemcpyToSymbol(
        ROUND_CONSTANTS, host_rcs, sizeof(uint64_t) * N_ROUNDS * W));
}

extern "C" int zk_poseidon_pallas_permute(const void* in, void* out,
                                          int64_t batch, int64_t ld,
                                          void* stream) {
    if (batch > 0) {
        poseidon_planes_permute_kernel<<<blocks_for(batch), THREADS, 0,
                                         static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out),
            batch, ld);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int zk_poseidon_pallas_sponge(const void* m, int64_t n_rows,
                                         int64_t n_cols, int64_t ld,
                                         void* out, void* stream) {
    if (n_rows > 0) {
        poseidon_planes_sponge_kernel<<<blocks_for(n_rows), THREADS, 0,
                                        static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint64_t*>(m), n_rows, n_cols, ld,
            static_cast<uint64_t*>(out));
    }
    return static_cast<int>(cudaGetLastError());
}
