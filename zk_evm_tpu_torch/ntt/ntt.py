"""Radix-2/4 NTT and coset LDE over Goldilocks, as plain PyTorch ops.

Polynomials are GF arrays of shape (..., n), n = 2^k; a whole table
(num_polys, n) transforms in one pass per stage. The butterfly network is
the constant-geometry (Pease) form of the JAX package: every radix-4 stage
splits the array into quarters and interleaves its four outputs, and the
output order is bit-reversed, which is the Merkle-leaf / FRI-fold layout.
Field arithmetic is exact, so any correct transform gives the same
elements; keeping the Pease network keeps the intermediate layout too.
Twiddle tables are host numpy, cached.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..field import GF, host, np_field

COSET_SHIFT = host.MULT_GENERATOR  # 7, the reference's coset shift g


@lru_cache(maxsize=64)
def bit_reverse_indices(logn: int) -> np.ndarray:
    n = 1 << logn
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros(n, dtype=np.uint32)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev


def bit_reverse(x: GF) -> GF:
    """Permute the last axis into bit-reversed order (an involution)."""
    n = x.shape[-1]
    return x.take(bit_reverse_indices(n.bit_length() - 1), axis=-1)


def powers(base: int, n: int, device=None) -> GF:
    """[1, base, base^2, ..., base^(n-1)] as a GF array."""
    return GF.from_u64(np_field.powers(base, n), device)


@lru_cache(maxsize=64)
def _pease_twiddles_np(logn: int, inverse: bool) -> np.ndarray:
    """(logn, n/2) twiddle table: row s, lane q = w^(q & ~(2^s - 1))."""
    n = 1 << logn
    w = host.primitive_root_of_unity(logn)
    if inverse:
        w = host.finv(w)
    pw = np_field.powers(w, max(n, 2))
    q = np.arange(n // 2, dtype=np.int64)
    out = np.empty((logn, n // 2), dtype=np.uint64)
    for s in range(logn):
        out[s] = pw[(q >> s) << s]
    return out


@lru_cache(maxsize=64)
def _pease4_twiddles_np(logn: int, inverse: bool) -> np.ndarray:
    """(n_r4_stages, 3, n/4) twiddles for the radix-4 stages: stage s
    (covering radix-2 stages 2s, 2s+1) lane q uses base exponent
    e = (q >> 2s) << 2s and rows (w^e, w^2e, w^3e)."""
    n = 1 << logn
    w = host.primitive_root_of_unity(logn)
    if inverse:
        w = host.finv(w)
    pw = np_field.powers(w, max(n, 4))
    q = np.arange(n // 4, dtype=np.int64)
    n4 = logn // 2
    out = np.empty((n4, 3, n // 4), dtype=np.uint64)
    for i in range(n4):
        e = (q >> (2 * i)) << (2 * i)
        out[i, 0] = pw[e % n]
        out[i, 1] = pw[(2 * e) % n]
        out[i, 2] = pw[(3 * e) % n]
    return out


def _pease(x: GF, inverse: bool) -> GF:
    """Constant-geometry butterfly network: natural in, bit-reversed out.

    Radix-4 stages (two radix-2 stages per pass over the data), with one
    trailing radix-2 stage when log2(n) is odd. Outputs are stacked
    [B0, B2, B1, B3] (the j index bit-reversed inside each radix-4
    butterfly) so the overall output order is exactly bit-reversed."""
    n = x.shape[-1]
    logn = n.bit_length() - 1
    if logn == 0:
        return x
    shape = x.shape
    dev = x.device
    half = n // 2
    quarter = n // 4

    if logn >= 2:
        w4 = host.primitive_root_of_unity(logn)
        if inverse:
            w4 = host.finv(w4)
        i4 = GF.const(host.fexp(w4, n // 4), device=dev)
        tw4 = GF.from_u64(_pease4_twiddles_np(logn, inverse), dev)
        for s in range(logn // 2):
            tws = tw4[s]
            a = x[..., :quarter]
            b = x[..., quarter:2 * quarter]
            c = x[..., 2 * quarter:3 * quarter]
            d = x[..., 3 * quarter:]
            ac0 = a + c
            ac1 = a - c
            bd0 = b + d
            bd1 = (b - d) * i4
            y0 = ac0 + bd0
            y1 = (ac0 - bd0) * tws[1]
            y2 = (ac1 + bd1) * tws[0]
            y3 = (ac1 - bd1) * tws[2]
            x = GF.stack([y0, y1, y2, y3], axis=-1).reshape(shape)

    if logn % 2:
        tws = GF.from_u64(_pease_twiddles_np(logn, inverse)[logn - 1], dev)
        u = x[..., :half]
        v = x[..., half:]
        x = GF.stack([u + v, (u - v) * tws], axis=-1).reshape(shape)
    return x


def fft(coeffs: GF) -> GF:
    """coeffs (natural) -> values (natural) on the 2-adic subgroup."""
    return bit_reverse(_pease(coeffs, inverse=False))


def fft_bitrev(coeffs: GF) -> GF:
    """coeffs (natural) -> values in bit-reversed order."""
    return _pease(coeffs, inverse=False)


def ifft(values: GF) -> GF:
    """values (natural) -> coeffs (natural): (1/n) * NTT_{w^-1}(values)."""
    n = values.shape[-1]
    coeffs = bit_reverse(_pease(values, inverse=True))
    return coeffs * GF.const(host.finv(n), device=values.device)


def coset_fft(coeffs: GF, shift: int = COSET_SHIFT) -> GF:
    """coeffs (natural) -> values on shift*<g_n> (natural)."""
    n = coeffs.shape[-1]
    return bit_reverse(_pease(coeffs * powers(shift, n, coeffs.device),
                              inverse=False))


def lde_from_coeffs_bitrev(coeffs: GF, rate_bits: int = 1,
                           shift: int = COSET_SHIFT) -> GF:
    """coeffs (natural) -> LDE values on shift*K in BIT-REVERSED order,
    |K| = n << rate_bits."""
    n = coeffs.shape[-1]
    coeffs = coeffs * powers(shift, n, coeffs.device)
    pad = GF.zeros(coeffs.shape[:-1] + (n * ((1 << rate_bits) - 1),),
                   coeffs.device)
    return _pease(GF.concatenate([coeffs, pad], axis=-1), inverse=False)


def lde_bitrev(values: GF, rate_bits: int = 1,
               shift: int = COSET_SHIFT) -> GF:
    """Full LDE pipeline: values on H (natural) -> values on shift*K in
    BIT-REVERSED order, |K| = |H| << rate_bits. This is the Merkle-leaf /
    FRI-oracle layout."""
    return lde_from_coeffs_bitrev(ifft(values), rate_bits, shift)


def coset_ifft_from_bitrev(values_br: GF, shift: int = COSET_SHIFT) -> GF:
    """values on shift*<g> in bit-reversed order -> coeffs (natural)."""
    n = values_br.shape[-1]
    coeffs = ifft(bit_reverse(values_br))
    return coeffs * powers(host.finv(shift), n, values_br.device)
