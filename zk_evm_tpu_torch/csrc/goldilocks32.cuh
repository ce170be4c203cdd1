// Goldilocks arithmetic as explicit 32-bit PTX, the planes kernels' field
// policy (poseidon_pallas.cu passes `Gl32` to the round code of
// poseidon_common.cuh; the dense kernels keep `U64Arith`). The python-int
// twin of every sequence below is zk_evm_tpu_torch/hash/goldilocks32.py.
//
// Why: a 64 x 64-bit product written as u64 PTX (mul.lo.u64, mul.hi.u64,
// mad.lo.cc.u64) is widened by ptxas into 32-bit partial products
// recombined twice, once for the low and once for the high half, and the
// u64 compares of reduce128 become pairs of ISETPs and SELs: 32,902 SASS
// instructions a permutation, 18,287 of them integer ALU ones (IADD3,
// ISETP, SEL, LOP3, SHF) beside 13,172 IMADs. Here a product is the
// schoolbook chain of mul.lo / mul.hi and mad.lo.cc / madc.hi.cc on the
// 32-bit halves (a square takes its cross term once and adds it twice), a
// mul_add takes its addend into that chain and a sum of products its
// words, and reduce128 adds h0 (2^32 - 1) and its carry correction by
// mad.lo.cc / madc.hi with 2^32 - 1, so that they issue as IMADs; only
// the borrow correction is an ALU mask. A permutation then issues 27,260
// instructions, 10,997 ALU beside 13,152 IMADs (poseidon_ab, an NVIDIA
// H100 80GB HBM3 at 700 W). The first form tried, four mul.wide.u32
// partial products summed by add.cc chains and reductions corrected by
// add / sub masks, issued 32,731 (15,843 IADD3), spilled 8 bytes at the
// permute's 128 registers and took 0.432 ms for 2^18 states against
// 0.374 in the same run.
// A carry chain never spans two asm statements: the condition code does
// not survive between them.
//
// Words stay lazy as in poseidon_common.cuh: any u64 congruent mod p;
// constants are canonical; only the words a kernel writes are made
// canonical.

#pragma once

#include "poseidon_common.cuh"

namespace {

__device__ __forceinline__ uint32_t lo32(uint64_t x) {
    return static_cast<uint32_t>(x);
}

__device__ __forceinline__ uint32_t hi32(uint64_t x) {
    return static_cast<uint32_t>(x >> 32);
}

__device__ __forceinline__ uint64_t join32(uint32_t lo, uint32_t hi) {
    uint64_t x;
    asm("mov.b64 %0, {%1, %2};" : "=l"(x) : "r"(lo), "r"(hi));
    return x;
}

// r = a * b as four 32-bit words, little-endian.
__device__ __forceinline__ void mul_words(uint64_t a, uint64_t b,
                                          uint32_t r[4]) {
    // The schoolbook chain: a0 b0 and a1 b1 into the four words, then
    // each cross term at 2^32, its carry into r3; r < 2^128, so r3 never
    // carries out.
    asm("{\n\t"
        ".reg .u32 a0, a1, b0, b1, z;\n\t"
        "mov.u32 z, 0;\n\t"
        "mov.b64 {a0, a1}, %4;\n\t"
        "mov.b64 {b0, b1}, %5;\n\t"
        "mul.lo.u32 %0, a0, b0;\n\t"
        "mul.hi.u32 %1, a0, b0;\n\t"
        "mul.lo.u32 %2, a1, b1;\n\t"
        "mul.hi.u32 %3, a1, b1;\n\t"
        "mad.lo.cc.u32 %1, a0, b1, %1;\n\t"
        "madc.hi.cc.u32 %2, a0, b1, %2;\n\t"
        "addc.u32 %3, %3, z;\n\t"
        "mad.lo.cc.u32 %1, a1, b0, %1;\n\t"
        "madc.hi.cc.u32 %2, a1, b0, %2;\n\t"
        "addc.u32 %3, %3, z;\n\t"
        "}"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "l"(a), "l"(b));
}

// r = a * a: p = a0^2, m = a0 a1, q = a1^2; r = p + 2 m 2^32 + q 2^64,
// the cross term added twice.
__device__ __forceinline__ void sqr_words(uint64_t a, uint32_t r[4]) {
    asm("{\n\t"
        ".reg .u32 a0, a1, m0, m1, z;\n\t"
        "mov.u32 z, 0;\n\t"
        "mov.b64 {a0, a1}, %4;\n\t"
        "mul.lo.u32 %0, a0, a0;\n\t"
        "mul.hi.u32 %1, a0, a0;\n\t"
        "mul.lo.u32 %2, a1, a1;\n\t"
        "mul.hi.u32 %3, a1, a1;\n\t"
        "mul.lo.u32 m0, a0, a1;\n\t"
        "mul.hi.u32 m1, a0, a1;\n\t"
        "add.cc.u32 %1, %1, m0;\n\t"
        "addc.cc.u32 %2, %2, m1;\n\t"
        "addc.u32 %3, %3, z;\n\t"
        "add.cc.u32 %1, %1, m0;\n\t"
        "addc.cc.u32 %2, %2, m1;\n\t"
        "addc.u32 %3, %3, z;\n\t"
        "}"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "l"(a));
}

// r = a * b + c; a * b + c < 2^128.
__device__ __forceinline__ void mul_add_words(uint64_t a, uint64_t b,
                                              uint64_t c, uint32_t r[4]) {
    // c enters with a0 b0: lo(a0 b0) + c0 and hi(a0 b0) + c1 + carry fit
    // the chain, whose carry goes on through a1 b1.
    asm("{\n\t"
        ".reg .u32 a0, a1, b0, b1, z;\n\t"
        "mov.u32 z, 0;\n\t"
        "mov.b64 {a0, a1}, %4;\n\t"
        "mov.b64 {b0, b1}, %5;\n\t"
        "mad.lo.cc.u32 %0, a0, b0, %6;\n\t"
        "madc.hi.cc.u32 %1, a0, b0, %7;\n\t"
        "madc.lo.cc.u32 %2, a1, b1, z;\n\t"
        "madc.hi.u32 %3, a1, b1, z;\n\t"
        "mad.lo.cc.u32 %1, a0, b1, %1;\n\t"
        "madc.hi.cc.u32 %2, a0, b1, %2;\n\t"
        "addc.u32 %3, %3, z;\n\t"
        "mad.lo.cc.u32 %1, a1, b0, %1;\n\t"
        "madc.hi.cc.u32 %2, a1, b0, %2;\n\t"
        "addc.u32 %3, %3, z;\n\t"
        "}"
        : "=&r"(r[0]), "=&r"(r[1]), "=&r"(r[2]), "=&r"(r[3])
        : "l"(a), "l"(b), "r"(lo32(c)), "r"(hi32(c)));
}

// (l0, l1, h0, h1) mod p, lazy: lo + hi 2^64 with 2^64 = 2^32 - 1 and
// 2^96 = -1, so n = lo - h1 + h0 (2^32 - 1).
//   t = lo - h1, with a borrow b: t = lo - h1 + b 2^64;
//   s = t + h0 (2^32 - 1), with a carry c: s = t + h0 (2^32 - 1) - c 2^64;
//   n = s + c (2^32 - 1) - b (2^32 - 1), in that order: after a carry
//   s <= 2^64 - 2^33, and after a borrow t >= 2^64 - 2^32 + 1, so
//   neither correction wraps.
__device__ __forceinline__ uint64_t reduce_words(uint32_t l0, uint32_t l1,
                                                 uint32_t h0, uint32_t h1) {
    uint32_t t0, t1;
    asm("{\n\t"
        ".reg .u32 z, eps, m, c;\n\t"
        "mov.u32 z, 0;\n\t"
        "mov.u32 eps, 0xffffffff;\n\t"
        "sub.cc.u32 %0, %2, %5;\n\t"
        "subc.cc.u32 %1, %3, z;\n\t"
        "subc.u32 m, z, z;\n\t"              // m = b (2^32 - 1)
        "mad.lo.cc.u32 %0, %4, eps, %0;\n\t" // + h0 (2^32 - 1)
        "madc.hi.cc.u32 %1, %4, eps, %1;\n\t"
        "addc.u32 c, z, z;\n\t"
        "mad.lo.cc.u32 %0, c, eps, %0;\n\t"  // + c (2^32 - 1)
        "madc.hi.u32 %1, c, eps, %1;\n\t"
        "sub.cc.u32 %0, %0, m;\n\t"          // - b (2^32 - 1)
        "subc.u32 %1, %1, z;\n\t"
        "}"
        : "=&r"(t0), "=&r"(t1)
        : "r"(l0), "r"(l1), "r"(h0), "r"(h1));
    return join32(t0, t1);
}

// A sum of general products in five 32-bit words, exactly: w + top 2^128.
struct AccGl32 {
    uint32_t w[4] = {0, 0, 0, 0};
    uint32_t top = 0;

    __device__ __forceinline__ void mac(uint64_t a, uint64_t b) {
        // the product's partial products straight into the words
        asm("{\n\t"
            ".reg .u32 a0, a1, b0, b1, z;\n\t"
            "mov.u32 z, 0;\n\t"
            "mov.b64 {a0, a1}, %5;\n\t"
            "mov.b64 {b0, b1}, %6;\n\t"
            "mad.lo.cc.u32 %0, a0, b0, %0;\n\t"
            "madc.hi.cc.u32 %1, a0, b0, %1;\n\t"
            "madc.lo.cc.u32 %2, a1, b1, %2;\n\t"
            "madc.hi.cc.u32 %3, a1, b1, %3;\n\t"
            "addc.u32 %4, %4, z;\n\t"
            "mad.lo.cc.u32 %1, a0, b1, %1;\n\t"
            "madc.hi.cc.u32 %2, a0, b1, %2;\n\t"
            "addc.cc.u32 %3, %3, z;\n\t"
            "addc.u32 %4, %4, z;\n\t"
            "mad.lo.cc.u32 %1, a1, b0, %1;\n\t"
            "madc.hi.cc.u32 %2, a1, b0, %2;\n\t"
            "addc.cc.u32 %3, %3, z;\n\t"
            "addc.u32 %4, %4, z;\n\t"
            "}"
            : "+r"(w[0]), "+r"(w[1]), "+r"(w[2]), "+r"(w[3]), "+r"(top)
            : "l"(a), "l"(b));
    }

    // 2^128 = -2^32 (mod p): d = r - top 2^32; on a borrow d -= 2^32 - 1
    // (the words hold the exact sum, so top < 12 for 12 products, and
    // after a borrow d >= 2^64 - 2^36: it cannot wrap).
    __device__ __forceinline__ uint64_t reduce() const {
        const uint64_t r = reduce_words(w[0], w[1], w[2], w[3]);
        uint32_t d0, d1;
        asm("{\n\t"
            ".reg .u32 z, m;\n\t"
            "mov.u32 z, 0;\n\t"
            "sub.cc.u32 %1, %3, %4;\n\t"
            "subc.u32 m, z, z;\n\t"
            "sub.cc.u32 %0, %2, m;\n\t"
            "subc.u32 %1, %1, z;\n\t"
            "}"
            : "=&r"(d0), "=&r"(d1)
            : "r"(lo32(r)), "r"(hi32(r)), "r"(top));
        return join32(d0, d1);
    }
};

// The planes kernels' arithmetic.
struct Gl32 {
    using Acc = AccGl32;

    // lo + h0 2^64 mod p for h0 < 2^32, lazy: s = lo + h0 (2^32 - 1); on
    // a carry s += 2^32 - 1 (then s <= 2^64 - 2^33: it cannot wrap).
    static __device__ __forceinline__ uint64_t reduce_small(uint64_t lo,
                                                            uint32_t h0) {
        uint32_t s0, s1;
        asm("{\n\t"
            ".reg .u32 z, eps, c;\n\t"
            "mov.u32 z, 0;\n\t"
            "mov.u32 eps, 0xffffffff;\n\t"
            "mad.lo.cc.u32 %0, %4, eps, %2;\n\t" // lo + h0 (2^32 - 1)
            "madc.hi.cc.u32 %1, %4, eps, %3;\n\t"
            "addc.u32 c, z, z;\n\t"
            "mad.lo.cc.u32 %0, c, eps, %0;\n\t"  // + c (2^32 - 1)
            "madc.hi.u32 %1, c, eps, %1;\n\t"
            "}"
            : "=&r"(s0), "=&r"(s1)
            : "r"(lo32(lo)), "r"(hi32(lo)), "r"(h0));
        return join32(s0, s1);
    }
    static __device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
        uint32_t r[4];
        mul_words(a, b, r);
        return reduce_words(r[0], r[1], r[2], r[3]);
    }
    static __device__ __forceinline__ uint64_t sqr(uint64_t a) {
        uint32_t r[4];
        sqr_words(a, r);
        return reduce_words(r[0], r[1], r[2], r[3]);
    }
    static __device__ __forceinline__ uint64_t mul_add(uint64_t a,
                                                       uint64_t b,
                                                       uint64_t c) {
        uint32_t r[4];
        mul_add_words(a, b, c, r);
        return reduce_words(r[0], r[1], r[2], r[3]);
    }
};

}  // namespace
