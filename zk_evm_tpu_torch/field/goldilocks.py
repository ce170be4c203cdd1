"""Goldilocks field F_p, p = 2^64 - 2^32 + 1, as plain PyTorch int64 ops.

Every field array is ONE int64 tensor holding the u64 bit pattern of each
canonical element (< p). PyTorch has no arithmetic on uint64 tensors, and on
int64 `>>` sign-extends and `<` is signed, so:

- every right shift is masked back to the limb width it extracts;
- unsigned order is compared on sign-biased values (`_ult`), never on the
  raw int64;
- multiplication builds the 128-bit product from 32 x 16-bit partial
  products (each < 2^48, exact in int64), then reduces with the Goldilocks
  identities 2^64 = 2^32 - 1 and 2^96 = -1 (mod p).

Additions of two 64-bit patterns wrap mod 2^64, which is what the carry
logic expects. The functions are elementwise and broadcast like torch ops.
"""

from __future__ import annotations

import numpy as np
import torch

P = (1 << 64) - (1 << 32) + 1
MULT_GENERATOR = 7
TWO_ADICITY = 32
POWER_OF_TWO_GENERATOR = 1753635133440165772

EPSILON = 0xFFFFFFFF              # 2^64 mod p
M32 = 0xFFFFFFFF
_SIGN = -(1 << 63)                # xor-ing this maps unsigned order to signed
_P_I64 = P - (1 << 64)            # p's bit pattern as an int64


def _ult(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned a < b on u64 bit patterns held in int64."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _canon(s: torch.Tensor) -> torch.Tensor:
    """Subtract p once if s >= p (s any u64 pattern; s - p = s + EPSILON)."""
    return torch.where(_ult(s, _P_I64), s, s + EPSILON)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = a + b
    # a carry out of 2^64 is worth 2^64 mod p = EPSILON; the true sum is
    # < 2p, so adding it back never carries again
    s = s + _ult(s, a).to(torch.int64) * EPSILON
    return _canon(s)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    # a borrow means the true value is negative: add p = 2^64 - EPSILON
    return d - _ult(a, b).to(torch.int64) * EPSILON


def neg(a: torch.Tensor) -> torch.Tensor:
    return sub(torch.zeros_like(a), a)


def reduce128(n0: torch.Tensor, n1: torch.Tensor,
               n2: torch.Tensor) -> torch.Tensor:
    """n0 + n1 * 2^64 + n2 * 2^96 mod p, with n0 a u64 pattern and
    n1, n2 < 2^32: n = n0 - n2 + n1 * (2^32 - 1)  (mod p)."""
    t = n0 - n2
    t = t - _ult(n0, n2).to(torch.int64) * EPSILON
    u = (n1 << 32) - n1                     # < 2^64
    s = t + u
    s = s + _ult(s, t).to(torch.int64) * EPSILON
    return _canon(s)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod p. The product's low 64 bits are the wrapped int64
    product; its high 64 bits come from four 32 x 32 partial products."""
    a0 = a & M32
    a1 = (a >> 32) & M32
    b0 = b & M32
    b1 = (b >> 32) & M32
    p00 = a0 * b0                           # each < 2^64 as a u64 pattern
    p01 = a0 * b1
    p10 = a1 * b0
    mid = ((p00 >> 32) & M32) + (p01 & M32) + (p10 & M32)   # < 3 * 2^32
    hi = a1 * b1 + ((p01 >> 32) & M32) + ((p10 >> 32) & M32) + (mid >> 32)
    return reduce128(a * b, hi & M32, (hi >> 32) & M32)


def square(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    """Multiply by a constant 0 <= k < 2^16."""
    assert 0 <= k < (1 << 16)
    lo = (a & M32) * k                      # < 2^48
    hi = ((a >> 32) & M32) * k
    h = hi + (lo >> 32)                     # < 2^49
    n0 = (lo & M32) | ((h & M32) << 32)
    return reduce128(n0, h >> 32, torch.zeros_like(h))


def reduce_limb_sums(s_lo: torch.Tensor, s_hi: torch.Tensor) -> torch.Tensor:
    """(s_lo + s_hi * 2^32) mod p for non-negative sums s_lo, s_hi < 2^63:
    the exact field value of a sum whose terms were split into 32-bit
    halves and summed as plain integers."""
    m = ((s_lo >> 32) & M32) + (s_hi & M32)             # < 2^33
    n0 = (s_lo & M32) | ((m & M32) << 32)
    n1 = ((s_hi >> 32) & M32) + ((m >> 32) & M32)      # < 2^32
    return reduce128(n0, n1, torch.zeros_like(n1))


def exp_u64(a: torch.Tensor, e: int) -> torch.Tensor:
    """Raise to a host integer power by square-and-multiply."""
    r = torch.ones_like(a)
    base = a
    while e > 0:
        if e & 1:
            r = mul(r, base)
        e >>= 1
        if e:
            base = square(base)
    return r


def inv(a: torch.Tensor) -> torch.Tensor:
    """Field inverse via Fermat, a^(p-2) (maps 0 to 0)."""
    return exp_u64(a, P - 2)


# ---------------------------------------------------------------------------
# Host <-> tensor conversion
# ---------------------------------------------------------------------------

def from_u64(x, device=None) -> torch.Tensor:
    """numpy uint64 (or python-int array-like) -> int64 bit-pattern tensor."""
    arr = np.ascontiguousarray(np.asarray(x, dtype=np.uint64))
    return torch.from_numpy(arr.view(np.int64).copy()).to(device)


def to_u64(t: torch.Tensor) -> np.ndarray:
    """int64 bit-pattern tensor -> numpy uint64 array (host)."""
    return t.detach().cpu().contiguous().numpy().view(np.uint64)
