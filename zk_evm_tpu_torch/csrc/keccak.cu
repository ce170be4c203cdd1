// keccak256 of the rows of a u64 matrix, for Hopper (sm_90a): the leaf
// hash and the compress levels of the Keccak commitment trees
// (StarkConfig.hasher = "keccak"). Bit-identical to the plain PyTorch
// version (zk_evm_tpu_torch/hash/keccak_device.py keccak_rows_plain), the
// numpy batch hasher (hash/keccak_np.py) and the scalar keccak256 of the
// native host library.
//
//   keccak_rows_kernel  replaces zk_evm_tpu/hash/keccak_device.py
//                       _keccak_rows with keccak_f1600_pair (plain XLA,
//                       not Pallas: under jax.jit its 24 rounds and every
//                       absorbed block unrolled into one fused program;
//                       as eager torch ops the same code would launch about
//                       3,600 tensor ops a block).
//
// The digest law. A row of `width` u64 words is the message of
// width * 8 bytes, its words little-endian (a word is one keccak lane).
// keccak256 pads with 0x01 after the message and 0x80 in the last byte of
// the last 136-byte rate block, so a row absorbs width * 8 / 136 + 1
// blocks of 17 lanes: at width 17 the padding fills a block of its own.
// The digest is the state's first 4 lanes, each made canonical
// Goldilocks (p subtracted where it is >= p). An inner tree node is the
// keccak256 of the (left, right) digest pair: the wrapper passes a level
// as its (n / 2, 8) view, consecutive digests paired.
//
// Design. One thread owns one row: its 25-lane state stays in registers
// across every absorbed block and all 24 rounds, so device memory sees one
// read of the row and one write of the digest. The row is read through
// the matrix's strides; for the LDE's (n_cols, n_rows) layout, which the
// prover hands over transposed, neighbouring threads read neighbouring
// words of each column, and no copy is made. Lanes are native 64-bit
// words (the TPU needed (lo, hi) u32 pairs; the card does not).
//
// What bounds it on the card: integer instructions, not bytes. A permutation
// needs at least 4,309 32-bit logic and funnel-shift instructions: per
// round, the column parities 20 (three-input LOP3s), rotl(C, 1) 10 funnel
// shifts, D applied 50 (s ^ C[x-1] ^ rotl(C[x+1], 1), one LOP3 a half),
// rho 48 funnel shifts, chi 50 LOP3s, and iota 1 for the low half; times
// 24 rounds, plus 13 for the round constants whose high half is nonzero.
// Against that, a row reads 8 bytes a lane absorbed: for Logic's
// 523 x 2^17 leaves, 1.05 ms of logic against 548 MB (0.16 ms) of reads.
// Nothing here is tuned yet: a simple kernel that is right comes first.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int RATE_LANES = 17;             // 136-byte rate of keccak256
constexpr uint64_t P = 0xFFFFFFFF00000001ULL;

__constant__ uint64_t ROUND_CONSTANTS[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

// rho and pi in the usual compact form: starting from lane 1, lane
// `lane` takes the previous lane rotated left by `r` (lane (x, y) at index
// x + 5 y). Written out so that every lane index is a constant and the
// state stays in registers.
#define RHO_PI(lane, r)                    \
    {                                      \
        const uint64_t t = s[lane];        \
        s[lane] = rotl(carry, r);          \
        carry = t;                         \
    }

__device__ __forceinline__ uint64_t rotl(uint64_t v, int n) {
    return (v << n) | (v >> (64 - n));
}

// Keccak-f[1600] in place. Every loop over lanes is unrolled, so each lane
// index is a compile-time constant and the state lives in registers.
__device__ __forceinline__ void keccak_f1600(uint64_t s[25]) {
#pragma unroll 1
    for (int round = 0; round < 24; ++round) {
        uint64_t c[5];
#pragma unroll
        for (int x = 0; x < 5; ++x)
            c[x] = s[x] ^ s[x + 5] ^ s[x + 10] ^ s[x + 15] ^ s[x + 20];
#pragma unroll
        for (int x = 0; x < 5; ++x) {
            const uint64_t d = c[(x + 4) % 5] ^ rotl(c[(x + 1) % 5], 1);
#pragma unroll
            for (int y = 0; y < 25; y += 5) s[y + x] ^= d;
        }
        uint64_t carry = s[1];
        RHO_PI(10, 1)  RHO_PI(7, 3)   RHO_PI(11, 6)  RHO_PI(17, 10)
        RHO_PI(18, 15) RHO_PI(3, 21)  RHO_PI(5, 28)  RHO_PI(16, 36)
        RHO_PI(8, 45)  RHO_PI(21, 55) RHO_PI(24, 2)  RHO_PI(4, 14)
        RHO_PI(15, 27) RHO_PI(23, 41) RHO_PI(19, 56) RHO_PI(13, 8)
        RHO_PI(12, 25) RHO_PI(2, 43)  RHO_PI(20, 62) RHO_PI(14, 18)
        RHO_PI(22, 39) RHO_PI(9, 61)  RHO_PI(6, 20)  RHO_PI(1, 44)
#pragma unroll
        for (int y = 0; y < 25; y += 5) {
            const uint64_t b0 = s[y], b1 = s[y + 1], b2 = s[y + 2],
                           b3 = s[y + 3], b4 = s[y + 4];
            s[y] = b0 ^ (~b1 & b2);
            s[y + 1] = b1 ^ (~b2 & b3);
            s[y + 2] = b2 ^ (~b3 & b4);
            s[y + 3] = b3 ^ (~b4 & b0);
            s[y + 4] = b4 ^ (~b0 & b1);
        }
        s[0] ^= ROUND_CONSTANTS[round];
    }
}

// m: element (row, col) at m[row * row_stride + col * col_stride];
// out: (n_rows, 4) row-major.
__global__ void __launch_bounds__(THREADS)
keccak_rows_kernel(const uint64_t* __restrict__ m, int64_t n_rows,
                   int64_t width, int64_t row_stride, int64_t col_stride,
                   uint64_t* __restrict__ out) {
    const int64_t row = static_cast<int64_t>(blockIdx.x) * THREADS
        + threadIdx.x;
    if (row >= n_rows) return;
    const uint64_t* src = m + row * row_stride;
    const int64_t n_blocks = width * 8 / 136 + 1;
    const int64_t last = n_blocks * RATE_LANES - 1;
    uint64_t s[25];
#pragma unroll
    for (int i = 0; i < 25; ++i) s[i] = 0;
    for (int64_t b = 0; b < n_blocks; ++b) {
#pragma unroll
        for (int j = 0; j < RATE_LANES; ++j) {
            const int64_t lane = b * RATE_LANES + j;
            uint64_t v = lane < width ? src[lane * col_stride] : 0;
            if (lane == width) v ^= 0x01ULL;
            if (lane == last) v ^= 0x80ULL << 56;
            s[j] ^= v;
        }
        keccak_f1600(s);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
        out[row * 4 + i] = s[i] >= P ? s[i] - P : s[i];
}

}  // namespace

extern "C" int zk_keccak_rows(const void* m, int64_t n_rows, int64_t width,
                              int64_t row_stride, int64_t col_stride,
                              void* out, void* stream) {
    if (n_rows > 0) {
        const int64_t blocks = (n_rows + THREADS - 1) / THREADS;
        keccak_rows_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint64_t*>(m), n_rows, width, row_stride,
            col_stride, static_cast<uint64_t*>(out));
    }
    return static_cast<int>(cudaGetLastError());
}
