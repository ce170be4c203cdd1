"""The Goldilocks arithmetic of csrc/goldilocks32.cuh, with exact python
ints: a twin of each PTX sequence the planes kernels run, instruction for
instruction on 32-bit words, and `permute_gl32`, the permutation those
kernels compute (the round structure of csrc/poseidon_common.cuh with this
arithmetic).

`Chain` models the condition code of one asm statement: add.cc / addc
and mad.lo.cc / madc.hi carry through it, sub.cc / subc borrow through
it. Every claim in the header that a step cannot wrap is asserted here on
the exact integers, so a test over boundary and random states checks
those claims as well as the result.
"""

from __future__ import annotations

from functools import lru_cache

from . import poseidon_fast
from . import poseidon_params as pp

P = pp.P
W = pp.WIDTH
M32 = (1 << 32) - 1
M64 = (1 << 64) - 1
EPSILON = (1 << 32) - 1             # 2^64 mod p
HALF = pp.HALF_FULL_ROUNDS
N_PARTIAL = pp.N_PARTIAL_ROUNDS


class Chain:
    """The carry flag of one asm statement's carry chain, on 32-bit
    words."""

    def __init__(self):
        self.cf = 0

    def add_cc(self, a: int, b: int, carry_in: bool = False) -> int:
        s = a + b + (self.cf if carry_in else 0)
        self.cf = s >> 32
        return s & M32

    def addc(self, a: int, b: int) -> int:
        return (a + b + self.cf) & M32

    def mad_lo(self, a: int, b: int, c: int, carry_in: bool = False) -> int:
        """mad.lo.cc / madc.lo.cc: lo(a b) + c (+ carry), carry out."""
        return self.add_cc((a * b) & M32, c, carry_in)

    def mad_hi(self, a: int, b: int, c: int, carry_in: bool = False) -> int:
        """mad.hi.cc / madc.hi.cc: hi(a b) + c (+ carry), carry out."""
        return self.add_cc((a * b) >> 32, c, carry_in)

    def sub_cc(self, a: int, b: int, borrow_in: bool = False) -> int:
        d = a - b - (self.cf if borrow_in else 0)
        self.cf = int(d < 0)
        return d & M32

    def subc(self, a: int, b: int) -> int:
        return (a - b - self.cf) & M32


def split(x: int) -> tuple[int, int]:
    return x & M32, x >> 32


def join(lo: int, hi: int) -> int:
    return lo | hi << 32


def cross_terms(r: list[int], a0: int, a1: int, b0: int,
                b1: int) -> list[int]:
    """r + (a0 b1 + a1 b0) 2^32: each cross term by mad.lo.cc /
    madc.hi.cc at words 1 and 2, its carry into word 3 (which never
    carries out: the sum stays below 2^128)."""
    r0, r1, r2, r3 = r
    for x, y in ((a0, b1), (a1, b0)):
        cc = Chain()
        r1 = cc.mad_lo(x, y, r1)
        r2 = cc.mad_hi(x, y, r2, carry_in=True)
        assert r3 + cc.cf <= M32
        r3 = cc.addc(r3, 0)
    return [r0, r1, r2, r3]


def mul_words(a: int, b: int) -> list[int]:
    """a * b as four 32-bit words: a0 b0 and a1 b1 (mul.lo / mul.hi) as
    the words, then the cross terms."""
    a0, a1 = split(a)
    b0, b1 = split(b)
    r = [(a0 * b0) & M32, (a0 * b0) >> 32, (a1 * b1) & M32, (a1 * b1) >> 32]
    return cross_terms(r, a0, a1, b0, b1)


def mul_add_words(a: int, b: int, c: int) -> list[int]:
    """a * b + c as four 32-bit words (below 2^128): c enters with a0 b0,
    the chain's carry goes on through a1 b1, then the cross terms."""
    a0, a1 = split(a)
    b0, b1 = split(b)
    c0, c1 = split(c)
    cc = Chain()
    r0 = cc.mad_lo(a0, b0, c0)
    r1 = cc.mad_hi(a0, b0, c1, carry_in=True)
    r2 = cc.mad_lo(a1, b1, 0, carry_in=True)
    assert ((a1 * b1) >> 32) + cc.cf <= M32
    r3 = ((a1 * b1) >> 32) + cc.cf
    return cross_terms([r0, r1, r2, r3], a0, a1, b0, b1)


def sqr_words(a: int) -> list[int]:
    """a * a from three partial products, p = a0^2, m = a0 a1, q = a1^2:
    r = p + 2 m 2^32 + q 2^64, the cross term added twice."""
    a0, a1 = split(a)
    r0, r1 = split(a0 * a0)
    r2, r3 = split(a1 * a1)
    m0, m1 = split(a0 * a1)
    cc = Chain()
    for _ in range(2):
        r1 = cc.add_cc(r1, m0)
        r2 = cc.add_cc(r2, m1, carry_in=True)
        assert r3 + cc.cf <= M32
        r3 = cc.addc(r3, 0)
    return [r0, r1, r2, r3]


def add_epsilon_times(t0: int, t1: int, x: int) -> tuple[int, int, int]:
    """t + x (2^32 - 1) by mad.lo.cc / madc.hi.cc with 2^32 - 1, and the
    carry out (addc), for x < 2^32."""
    cc = Chain()
    s0 = cc.mad_lo(x, EPSILON, t0)
    s1 = cc.mad_hi(x, EPSILON, t1, carry_in=True)
    return s0, s1, cc.addc(0, 0)


def reduce_words(l0: int, l1: int, h0: int, h1: int) -> int:
    """(l0, l1, h0, h1) mod p, lazy: t = lo - h1 (borrow b), s = t +
    h0 (2^32 - 1) (carry c), then + c (2^32 - 1) and - b (2^32 - 1)."""
    cc = Chain()
    t0 = cc.sub_cc(l0, h1)
    t1 = cc.sub_cc(l1, 0, borrow_in=True)
    m = cc.subc(0, 0)                    # b (2^32 - 1)
    s0, s1, c = add_epsilon_times(t0, t1, h0)
    assert join(s0, s1) + c * EPSILON <= M64   # after a carry s <= 2^64 - 2^33
    s0, s1, carry = add_epsilon_times(s0, s1, c)
    assert carry == 0
    assert join(s0, s1) - m >= 0         # after a borrow: no wrap
    cc = Chain()
    s0 = cc.sub_cc(s0, m)
    s1 = cc.subc(s1, 0)
    out = join(s0, s1)
    assert out % P == (join(l0, l1) + join(h0, h1) * (1 << 64)) % P
    return out


def reduce_small(lo: int, h0: int) -> int:
    """lo + h0 2^64 mod p for h0 < 2^32, lazy: s = lo + h0 (2^32 - 1),
    plus 2^32 - 1 on a carry."""
    assert 0 <= h0 <= M32
    s0, s1, c = add_epsilon_times(*split(lo), h0)
    assert join(s0, s1) + c * EPSILON <= M64
    s0, s1, carry = add_epsilon_times(s0, s1, c)
    assert carry == 0
    out = join(s0, s1)
    assert out % P == (lo + h0 * (1 << 64)) % P
    return out


def mul(a: int, b: int) -> int:
    return reduce_words(*mul_words(a, b))


def sqr(a: int) -> int:
    return reduce_words(*sqr_words(a))


def mul_add(a: int, b: int, c: int) -> int:
    return reduce_words(*mul_add_words(a, b, c))


class Acc:
    """A sum of general products in five 32-bit words, exactly:
    w + top 2^128."""

    def __init__(self):
        self.w = [0, 0, 0, 0]
        self.top = 0

    def mac(self, a: int, b: int) -> None:
        """a0 b0 and a1 b1 into the words by one chain, then each cross
        term at word 1 by another, every carry out of word 3 into top."""
        a0, a1 = split(a)
        b0, b1 = split(b)
        w0, w1, w2, w3 = self.w
        cc = Chain()
        w0 = cc.mad_lo(a0, b0, w0)
        w1 = cc.mad_hi(a0, b0, w1, carry_in=True)
        w2 = cc.mad_lo(a1, b1, w2, carry_in=True)
        w3 = cc.mad_hi(a1, b1, w3, carry_in=True)
        self.top = cc.addc(self.top, 0)
        for x, y in ((a0, b1), (a1, b0)):
            cc = Chain()
            w1 = cc.mad_lo(x, y, w1)
            w2 = cc.mad_hi(x, y, w2, carry_in=True)
            w3 = cc.add_cc(w3, 0, carry_in=True)
            self.top = cc.addc(self.top, 0)
        self.w = [w0, w1, w2, w3]

    def reduce(self) -> int:
        """r - top 2^32 (2^128 = -2^32 mod p), less 2^32 - 1 on a borrow."""
        assert self.top < 12
        r0, r1 = split(reduce_words(*self.w))
        cc = Chain()
        d1 = cc.sub_cc(r1, self.top)
        m = cc.subc(0, 0)
        assert join(r0, d1) - m >= 0     # after a borrow d >= 2^64 - 2^37
        cc = Chain()
        d0 = cc.sub_cc(r0, m)
        d1 = cc.subc(d1, 0)
        return join(d0, d1)


def gl_add(a: int, c: int) -> int:
    """poseidon_common.cuh's gl_add: a + c, plus 2^32 - 1 on a carry."""
    s = a + c
    return (s - (1 << 64) + EPSILON) if s > M64 else s


def canonical(x: int) -> int:
    return x - P if x >= P else x


@lru_cache(maxsize=1)
def constants() -> tuple[int, ...]:
    """`CONSTANTS` of poseidon_common.cuh: the round constants, a zero row,
    then the fast partial-round constants."""
    rcs = [int(v) for v in pp.round_constants_np().reshape(-1)]
    fast = [int(v) for v in poseidon_fast.fast_constants_np()]
    return tuple(rcs + [0] * W + fast)


ZERO_ROW = pp.N_ROUNDS * W
FAST_FIRST = ZERO_ROW + W
FAST_INITIAL = FAST_FIRST + W
FAST_PARTIAL = FAST_INITIAL + (W - 1) * (W - 1)
FAST_W_HATS = FAST_PARTIAL + N_PARTIAL
FAST_VS = FAST_W_HATS + N_PARTIAL * (W - 1)
MDS_CIRC = pp.MDS_CIRC
MDS_DIAG0 = pp.MDS_DIAG[0]


def sbox7(x: int) -> int:
    x2 = sqr(x)
    x3 = mul(x2, x)
    x6 = sqr(x3)
    return mul(x6, x)


def mds_limb_planes(s: list[int], post: int) -> list[int]:
    """The shared limb-plane MDS with the constants CONSTANTS[post..]
    folded in, reduced by `reduce_small`."""
    k = constants()
    limb = [[(x >> (16 * i)) & 0xFFFF for x in s] for i in range(4)]
    out = []
    for r in range(W):
        c = k[post + r]
        acc = []
        for i in range(4):
            a = (c >> (16 * i)) & 0xFFFF
            a += MDS_DIAG0 * (r == 0) * limb[i][r]
            a += sum(MDS_CIRC[j] * limb[i][(r + j) % W] for j in range(W))
            assert a <= M32
            acc.append(a)
        t0 = acc[0] & 0xFFFF
        s1 = acc[1] + (acc[0] >> 16)
        s2 = acc[2] + (s1 >> 16)
        s3 = acc[3] + (s2 >> 16)
        lo = t0 | (s1 & 0xFFFF) << 16 | (s2 & 0xFFFF) << 32 \
            | (s3 & 0xFFFF) << 48
        out.append(reduce_small(lo, s3 >> 16))
    return out


def full_rounds(s: list[int], first: int) -> list[int]:
    for rnd in range(first, first + HALF):
        s = [sbox7(x) for x in s]
        s = mds_limb_planes(s, FAST_FIRST if rnd == HALF - 1
                            else (rnd + 1) * W)
    return s


def partial_rounds(s: list[int]) -> list[int]:
    k = constants()
    t = []
    for i in range(W - 1):
        acc = Acc()
        for j in range(W - 1):
            acc.mac(k[FAST_INITIAL + i * (W - 1) + j], s[j + 1])
        t.append(acc.reduce())
    s = [s[0]] + t
    for r in range(N_PARTIAL):
        x = s[0]
        s0 = mul_add(sqr(mul(sqr(x), x)), x, k[FAST_PARTIAL + r])
        acc = Acc()
        acc.mac(s0, MDS_CIRC[0] + MDS_DIAG0)
        for j in range(W - 1):
            acc.mac(k[FAST_W_HATS + r * (W - 1) + j], s[j + 1])
        s = [acc.reduce()] + [
            mul_add(s0, k[FAST_VS + r * (W - 1) + i - 1], s[i])
            for i in range(1, W)]
    return s


def permute_gl32(state: list[int]) -> list[int]:
    """One Poseidon permutation as the planes kernels compute it: lazy
    words through the rounds, canonical at the end; equal to
    host_poseidon.permute on canonical inputs (any u64 inputs are taken,
    as the kernels take them)."""
    if len(state) != W:
        raise ValueError(f"expected {W} words, got {len(state)}")
    k = constants()
    s = [gl_add(x, k[j]) for j, x in enumerate(state)]
    s = full_rounds(s, 0)
    s = partial_rounds(s)
    s = [gl_add(x, k[(HALF + N_PARTIAL) * W + j]) for j, x in enumerate(s)]
    s = full_rounds(s, HALF + N_PARTIAL)
    return [canonical(x) for x in s]
