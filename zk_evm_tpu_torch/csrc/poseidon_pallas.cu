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
// coalesces without strides. The MDS of the full rounds is that of
// `_mds_tile_roll`: the state words split into four 16-bit limb planes,
// each output word accumulates the twelve small-constant products of each
// plane in 32 bits, and one carry chain plus one reduction yields the
// word. That MDS, the fast partial rounds and the lazy reduction live in
// poseidon_common.cuh and are shared with the dense kernels, so the two
// files differ only in layout.
//
// Left behind with the TPU: the u32 limb arithmetic of the field
// products (Hopper has __umul64hi; the S-box products are u64 as in
// poseidon.cu), the TILE % 1024 requirement (any batch and any row count
// are taken; the ragged edge is masked) and the sequential chunk axis of
// the sponge grid (one thread carries its state across all chunks in
// registers).
//
// What bounds it on the card: integer operations, as for poseidon.cu,
// whose note says what the shared round code does about them; memory
// traffic is one read of the input and one write of the output.

#include "poseidon_common.cuh"

namespace {

constexpr int THREADS = 128;

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
    permute_state(s);
#pragma unroll
    for (int j = 0; j < W; ++j) out[j * ld + i] = canonical(s[j]);
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
    sponge_leaf(m + r, n_cols, ld, s);
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e * n_rows + r] = canonical(s[e]);
}

unsigned int blocks_for(int64_t n) {
    return static_cast<unsigned int>((n + THREADS - 1) / THREADS);
}

}  // namespace

// Plain C interface, loaded with ctypes. Each launch goes on the caller's
// stream and returns cudaGetLastError(), so a refused launch is reported.

ZK_POSEIDON_CONSTANT_UPLOADS(zk_poseidon_pallas)

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
