// Poseidon over Goldilocks for Hopper (sm_90a), planes layout: the state
// batch is held as twelve planes, (12, B) — word j of state i at
// planes[j * ld + i]. Bit-identical to the dense kernels (poseidon.cu),
// the plain PyTorch version (zk_evm_tpu_torch/hash/poseidon.py) and the
// python-int twins (hash/host_poseidon.py; hash/goldilocks32.py for the
// exact sequence these kernels run).
//
// Two kernels, each replacing one Pallas kernel of the JAX package:
//
//   poseidon_planes_permute_kernel  replaces zk_evm_tpu/hash/
//                                   poseidon_pallas.py:182 _permute_kernel.
//   poseidon_planes_sponge_kernel   replaces zk_evm_tpu/hash/
//                                   poseidon_pallas.py:250 _sponge_kernel.
//
// What bounds them on the card: integer instruction issue. The bytes
// bound is 11-31x below the operations bound (6,656 IMADs a permutation,
// zk_evm_tpu_torch/bench.py); a permutation issues about 27,000 SASS
// instructions, nearly all integer. The round structure (fast partial
// rounds, limb-plane MDS, lazy words) is the shared one of
// poseidon_common.cuh.
//
// What the design does about it (times by poseidon_ab on an NVIDIA H100
// 80GB HBM3 at 700 W, each against the other forms in the same run):
//
//   1. A cheaper Goldilocks product (goldilocks32.cuh): 32-bit
//      mad.lo / madc.hi chains whose carries and reductions issue as
//      IMADs, 27,260 SASS instructions a permutation against the shared
//      u64 form's 32,902; that note says what was tried.
//   2. Launch shapes from ptxas and measurement. The permute keeps the
//      dense permute's 256 threads and a minimum of 2 blocks an SM (114
//      registers, no spills): 0.374 ms for 2^18 states, against 0.394 with
//      128 threads and 4 blocks and 0.375 with a minimum of 1. The sponge
//      runs 128-thread blocks (116 registers) two to an SM, a limit set by
//      its 80 KB ring below: eight warps an SM ran the 523-column leaves
//      in 12.86 ms against 13.96 with twelve in the same run (sixteen
//      took 14.22 in another), and at the other shapes eight were never
//      the slowest, within 5%. Warps that sit at different points of the
//      permutation slow each other down, and long leaves let them drift
//      apart.
//   3. The sponge stages its rate-8 chunks through shared memory by TMA.
//      A block owns TILE rows; for chunk c, one cp.async.bulk.tensor.2d
//      brings the box of column planes [8c, 8c + 8) x rows
//      [r0, r0 + TILE) into a ring of STAGES buffers, each signalled by an
//      mbarrier. A thread reads its 8 words at neighbouring u64s of its
//      warp's (no bank conflicts). After the block's barrier, thread 0
//      refills the stage just read with chunk c + STAGES, so the copies
//      run STAGES - 1 chunks ahead, and the barrier keeps the block's
//      warps at one point of the permutation. The copy computes the
//      addresses and the tensor map's zero fill covers the ragged edges:
//      rows past n_rows and planes past n_cols. The overwrite mask still
//      decides which lanes a partial chunk replaces, so a zero fill is
//      never absorbed, and the digest stores are masked. No register
//      holds a prefetched chunk (the shared sponge_leaf's next[8]) or its
//      strided addresses.
//
// Tried and dropped, at 30 x 2^21 / 523 x 2^17 / 64 x 2^16 /
// 2431 x 2^15 leaves (ms), beside this design's 11.88 / 12.86 / 0.809 /
// 14.99 in one run: a refill by the last warp to read a stage (a counter
// in shared memory, no barrier) 11.92 / 12.95 / 0.817 / 15.12; 256-row
// blocks, one an SM, 12.13 / 12.75 / 0.786 / 14.70; and, in an earlier
// run with a 3-stage ring at four blocks an SM, thread 0 waiting on an
// "empty" mbarrier for every warp before refilling 14.34 / 17.63 / 0.976
// / 15.99 against the counter's 13.05 / 16.52 / 0.869 / 15.19, and a
// producer warp (warp specialisation: one warp issuing the copies, four
// permuting, no setmaxnreg; three blocks an SM) 12.69 / 16.26 / 0.817 /
// 15.31 against the counter's 13.10 / 16.54 / 0.872 / 15.28.
//
// The permute keeps direct loads and stores: a warp reads one state word
// of 32 neighbouring states at neighbouring addresses, so they coalesce,
// and its bytes bound is about 30x below its operations bound; TMA would
// buy it nothing.
//
// The tensor map wants a 16-byte-aligned base and an even ld (a global
// stride that is a multiple of 16 bytes). The wrapper
// (hash/poseidon_pallas.py) makes one aligned copy of a matrix that is
// not; the main path's LDEs are powers of two wide and need none.

#include <cuda.h>

#include "goldilocks32.cuh"

namespace {

constexpr int PERMUTE_THREADS = 256;
constexpr int PERMUTE_MIN_BLOCKS = 2;
constexpr int TILE = 128;                  // sponge rows a block, one a thread
constexpr int STAGES = 10;
constexpr uint32_t STAGE_BYTES = RATE * TILE * sizeof(uint64_t);
// the ring, in dynamic shared memory: 80 KB, room for two blocks an SM
// and not three
constexpr int RING_BYTES = STAGES * STAGE_BYTES;

// planes in/out: (12, ld), states 0..batch-1; out may not alias in.
__global__ void __launch_bounds__(PERMUTE_THREADS, PERMUTE_MIN_BLOCKS)
poseidon_planes_permute_kernel(const uint64_t* __restrict__ in,
                               uint64_t* __restrict__ out, int64_t batch,
                               int64_t ld) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * PERMUTE_THREADS
        + threadIdx.x;
    if (i >= batch) return;
    uint64_t s[W];
#pragma unroll
    for (int j = 0; j < W; ++j) s[j] = in[j * ld + i];
    permute_state<Gl32>(s);
#pragma unroll
    for (int j = 0; j < W; ++j) out[j * ld + i] = canonical(s[j]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared.b64 [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile("{\n\t.reg .pred p;\n\t"
                     "mbarrier.try_wait.parity.shared::cta.b64 "
                     "p, [%1], %2;\n\t"
                     "selp.b32 %0, 1, 0, p;\n\t"
                     "}"
                     : "=r"(done) : "r"(smem_addr(bar)), "r"(parity)
                     : "memory");
    } while (!done);
}

// One TMA copy of the box at (row r0, plane col) into dst; it completes
// on `bar`, which expects STAGE_BYTES (the whole box, zero fill included).
__device__ __forceinline__ void load_chunk_tma(const CUtensorMap* map,
                                               uint64_t* dst, uint64_t* bar,
                                               int32_t r0, int32_t col) {
    asm volatile("{\n\t.reg .b64 state;\n\t"
                 "mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 "
                 "state, [%0], %1;\n\t"
                 "}" :: "r"(smem_addr(bar)), "r"(STAGE_BYTES) : "memory");
    asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.tile"
                 ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];"
                 :: "r"(smem_addr(dst)),
                    "l"(reinterpret_cast<uint64_t>(map)), "r"(r0), "r"(col),
                    "r"(smem_addr(bar))
                 : "memory");
}

// map: the (n_cols, n_rows) u64 matrix, box TILE x RATE; leaf r = column
// r; out: (4, n_rows) digest planes.
__global__ void __launch_bounds__(TILE, 1)
poseidon_planes_sponge_kernel(const __grid_constant__ CUtensorMap map,
                              int64_t n_rows, int64_t n_cols,
                              uint64_t* __restrict__ out) {
    extern __shared__ __align__(128) uint64_t ring_words[];
    uint64_t (*ring)[RATE * TILE] =
        reinterpret_cast<uint64_t (*)[RATE * TILE]>(ring_words);
    __shared__ __align__(8) uint64_t full[STAGES];   // chunk landed
    const int tid = threadIdx.x;
    const int32_t r0 = static_cast<int32_t>(blockIdx.x) * TILE;
    const int n_chunks = static_cast<int>((n_cols + RATE - 1) / RATE);
    if (tid == 0) {
        if (smem_addr(ring_words) % 128 != 0) __trap();   // TMA's alignment
        for (int k = 0; k < STAGES; ++k) mbar_init(&full[k], 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        for (int c = 0; c < STAGES && c < n_chunks; ++c)
            load_chunk_tma(&map, ring[c], &full[c], r0, c * RATE);
    }
    __syncthreads();
    uint64_t s[W];
#pragma unroll
    for (int j = 0; j < W; ++j) s[j] = 0;
    for (int c = 0; c < n_chunks; ++c) {
        const int k = c % STAGES;
        mbar_wait(&full[k], (c / STAGES) & 1);
        const int left = static_cast<int>(n_cols) - c * RATE;
#pragma unroll
        for (int j = 0; j < RATE; ++j)
            if (j < left) s[j] = ring[k][j * TILE + tid];
        __syncthreads();                           // stage k is read
        if (tid == 0 && c + STAGES < n_chunks) {
            // the block's reads of stage k before the copy's writes
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            load_chunk_tma(&map, ring[k], &full[k], r0, (c + STAGES) * RATE);
        }
        permute_state<Gl32>(s);
    }
    const int64_t r = static_cast<int64_t>(r0) + tid;
    if (r < n_rows) {
#pragma unroll
        for (int e = 0; e < 4; ++e) out[e * n_rows + r] = canonical(s[e]);
    }
}

unsigned int blocks_for(int64_t n, int threads) {
    return static_cast<unsigned int>((n + threads - 1) / threads);
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry points
// (CUDA 12.5 or later): the library links the CUDA runtime only.
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static const EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found{};
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
        return err == cudaSuccess && found == cudaDriverEntryPointSuccess
            ? reinterpret_cast<EncodeTiled>(p) : nullptr;
    }();
    return fn;
}

}  // namespace

// Plain C interface, loaded with ctypes. Each launch goes on the caller's
// stream and returns cudaGetLastError(), so a refused launch is reported.

ZK_POSEIDON_CONSTANT_UPLOADS(zk_poseidon_pallas)

extern "C" int zk_poseidon_pallas_permute(const void* in, void* out,
                                          int64_t batch, int64_t ld,
                                          void* stream) {
    if (batch > 0) {
        poseidon_planes_permute_kernel<<<blocks_for(batch, PERMUTE_THREADS),
                                         PERMUTE_THREADS, 0,
                                         static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out),
            batch, ld);
    }
    return static_cast<int>(cudaGetLastError());
}

// m: (n_cols, ld) u64 planes, n_rows <= ld, with a 16-byte-aligned base
// and an even ld (else cudaErrorInvalidValue); a failed tensor-map encode
// returns its CUresult.
extern "C" int zk_poseidon_pallas_sponge(const void* m, int64_t n_rows,
                                         int64_t n_cols, int64_t ld,
                                         void* out, void* stream) {
    if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
    if (n_cols <= 0 || ld < n_rows || ld % 2 != 0
        || reinterpret_cast<uintptr_t>(m) % 16 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    CUtensorMap map;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n_rows),
                                static_cast<cuuint64_t>(n_cols)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld)
                                   * sizeof(uint64_t)};
    const cuuint32_t box[2] = {TILE, RATE};
    const cuuint32_t unit[2] = {1, 1};
    const CUresult res = encode(
        &map, CU_TENSOR_MAP_DATA_TYPE_UINT64, 2, const_cast<void*>(m), dims,
        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return static_cast<int>(res);
    const cudaError_t err = cudaFuncSetAttribute(
        poseidon_planes_sponge_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, RING_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    poseidon_planes_sponge_kernel<<<blocks_for(n_rows, TILE), TILE,
                                    RING_BYTES,
                                    static_cast<cudaStream_t>(stream)>>>(
        map, n_rows, n_cols, static_cast<uint64_t*>(out));
    return static_cast<int>(cudaGetLastError());
}
