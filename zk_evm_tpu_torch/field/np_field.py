"""Vectorized host-side (numpy uint64) Goldilocks arithmetic.

Trace-free twin of the device limb kernels: used to precompute constant
tables (twiddles, coset powers, logUp denominators' bases) of millions of
elements without python-int loops and without touching JAX (so results are
safely cacheable regardless of any ambient jit trace).
"""

from __future__ import annotations

import numpy as np

P = np.uint64((1 << 64) - (1 << 32) + 1)
_P_INT = (1 << 64) - (1 << 32) + 1
_M32 = np.uint64(0xFFFFFFFF)
_EPS = np.uint64(0xFFFFFFFF)  # 2^64 mod p

_old = np.seterr(over="ignore")  # u64 wrap-around is intentional throughout
np.seterr(**_old)


def add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        s = a + b
        carry = s < a
        s = s + np.where(carry, _EPS, np.uint64(0))
        # result may still be >= p
        ge = s >= P
        return np.where(ge, s - P, s)


def sub(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        d = a - b
        borrow = a < b
        return d - np.where(borrow, _EPS, np.uint64(0))


def mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise (a * b) mod p on uint64 arrays via 32-bit halves."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    with np.errstate(over="ignore"):
        al = a & _M32
        ah = a >> np.uint64(32)
        bl = b & _M32
        bh = b >> np.uint64(32)
        ll = al * bl
        lh = al * bh
        hl = ah * bl
        hh = ah * bh
        # mid = lh + hl (65-bit): track carry
        mid = lh + hl
        mid_c = (mid < lh).astype(np.uint64)  # carry into bit 64
        lo = ll + ((mid & _M32) << np.uint64(32))
        lo_c = (lo < ll).astype(np.uint64)
        hi = hh + (mid >> np.uint64(32)) + (mid_c << np.uint64(32)) + lo_c
        # reduce 128 -> 64: n = lo + hi*2^64; hi = n1 + n2*2^32
        n1 = hi & _M32
        n2 = hi >> np.uint64(32)
        # t = lo - n2 (mod p)
        t = lo - n2
        t = t - np.where(lo < n2, _EPS, np.uint64(0))
        t = np.where(t >= P, t - P, t)          # canonicalize before add()
        # u = n1 * (2^32 - 1) < p always
        u = (n1 << np.uint64(32)) - n1
        return add(t, u)


def inv(a: np.ndarray) -> np.ndarray:
    """Elementwise modular inverse via Fermat (a^(p-2)), using the same
    addition chain as the device kernel (~72 vector multiplies)."""
    def pow_acc(x, n, m):
        for _ in range(n):
            x = mul(x, x)
        return mul(x, m)

    a1 = a
    a2 = pow_acc(a1, 1, a1)
    a3 = pow_acc(a2, 1, a1)
    a6 = pow_acc(a3, 3, a3)
    a12 = pow_acc(a6, 6, a6)
    a24 = pow_acc(a12, 12, a12)
    a30 = pow_acc(a24, 6, a6)
    a31 = pow_acc(a30, 1, a1)
    a32 = pow_acc(a31, 1, a1)
    r = a31
    for _ in range(33):
        r = mul(r, r)
    return mul(r, a32)


def powmod(base: int, e: int) -> int:
    return pow(base % _P_INT, e, _P_INT)


def powers(base: int, n: int) -> np.ndarray:
    """[base^0 .. base^(n-1)] as uint64, by log-doubling (log2 n vec muls)."""
    out = np.empty(n, dtype=np.uint64)
    if n == 0:
        return out
    out[0] = 1
    filled = 1
    while filled < n:
        step = np.uint64(powmod(base, filled))
        take = min(filled, n - filled)
        out[filled:filled + take] = mul(out[:take], step)
        filled += take
    return out
