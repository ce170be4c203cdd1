"""Exact host NTT oracle (python ints) for testing the device kernels.

Recursive Cooley-Tukey; fine for test sizes (n <= 2^12).
"""

from __future__ import annotations

from ..field import host


def fft(coeffs: list[int]) -> list[int]:
    """Forward NTT: coefficients -> values on the 2-adic subgroup, natural
    order (values[i] = poly(g^i))."""
    n = len(coeffs)
    assert n & (n - 1) == 0
    if n == 1:
        return list(coeffs)
    even = fft(coeffs[0::2])
    odd = fft(coeffs[1::2])
    g = host.primitive_root_of_unity(n.bit_length() - 1)
    out = [0] * n
    w = 1
    for i in range(n // 2):
        t = host.fmul(w, odd[i])
        out[i] = host.fadd(even[i], t)
        out[i + n // 2] = host.fsub(even[i], t)
        w = host.fmul(w, g)
    return out


def ifft(values: list[int]) -> list[int]:
    n = len(values)
    ninv = host.finv(n)
    # inverse NTT = conjugate transform: evaluate at inverse points.
    coeffs = fft(values)
    out = [host.fmul(coeffs[0], ninv)]
    for i in range(1, n):
        out.append(host.fmul(coeffs[n - i], ninv))
    return out


def coset_fft(coeffs: list[int], shift: int) -> list[int]:
    """Values of the polynomial on the coset shift * <g_n>, natural order."""
    scaled = []
    s = 1
    for c in coeffs:
        scaled.append(host.fmul(c, s))
        s = host.fmul(s, shift)
    return fft(scaled)


def lde(values: list[int], rate_bits: int, shift: int) -> list[int]:
    """Low-degree extension: values on H -> values on shift * K,
    |K| = |H| << rate_bits, natural order."""
    coeffs = ifft(values)
    coeffs = coeffs + [0] * ((len(values) << rate_bits) - len(values))
    return coset_fft(coeffs, shift)


def bit_reverse(xs: list) -> list:
    n = len(xs)
    bits = n.bit_length() - 1
    return [xs[int(format(i, f"0{bits}b")[::-1], 2)] for i in range(n)] \
        if n > 1 else list(xs)
