"""Precomputed LDE-domain tables (numpy, cached): selector polynomials and
next-row permutations, in the bit-reversed layout the oracles use.

All quantities are exact uint64 numpy arrays so they are safe to cache and
cheap to lift as device constants at trace time.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..field import host, np_field
from ..ntt.ntt import bit_reverse_indices

SHIFT = host.MULT_GENERATOR


@lru_cache(maxsize=32)
def lde_points_natural(log_m: int) -> np.ndarray:
    """x_i = 7 * g_m^i, natural order."""
    return np_field.mul(
        np_field.powers(host.primitive_root_of_unity(log_m), 1 << log_m),
        np.uint64(SHIFT))


@lru_cache(maxsize=32)
def next_row_perm_bitrev(log_m: int, rate_bits: int) -> np.ndarray:
    """Gather indices so that lde_br[perm][i] = value at point x_i * g_H
    (the next trace row), staying in bit-reversed layout.

    Natural step is 2^rate_bits positions (g_H = g_M^{2^rate_bits})."""
    m = 1 << log_m
    br = bit_reverse_indices(log_m)
    step = 1 << rate_bits
    # value at bitrev slot i sits at natural index br[i]; next-row natural
    # index is br[i] + step (mod m); its bitrev slot is br[that].
    return br[(br + step) % m]


@lru_cache(maxsize=32)
def selector_tables_bitrev(degree_bits: int, rate_bits: int):
    """Returns dict of uint64 arrays over the LDE coset (bit-reversed):
    zh_inv     = 1 / (x^n - 1)
    z_last     = x - g^(n-1)
    l_first    = Z_H / (n * (x - 1))          (Lagrange basis at 1)
    l_last     = Z_H * g^(n-1) / (n * (x - g^(n-1)))
    """
    n = 1 << degree_bits
    log_m = degree_bits + rate_bits
    m = 1 << log_m
    xs = lde_points_natural(log_m)
    g_n = host.primitive_root_of_unity(degree_bits)
    g_last = host.fexp(g_n, n - 1)
    # x^n = 7^n * (g_m^n)^i  — g_m^n has small order 2^rate_bits
    w = host.fexp(host.primitive_root_of_unity(log_m), n)
    xn = np_field.mul(np_field.powers(w, m), np.uint64(host.fexp(SHIFT, n)))
    zh = np_field.sub(xn, np.uint64(1))
    zh_inv = np_field.inv(zh)
    n_inv = np.uint64(host.finv(n))
    x_m1 = np_field.sub(xs, np.uint64(1))
    x_mg = np_field.sub(xs, np.uint64(g_last))
    l_first = np_field.mul(np_field.mul(zh, np_field.inv(x_m1)), n_inv)
    l_last = np_field.mul(
        np_field.mul(np_field.mul(zh, np_field.inv(x_mg)), n_inv),
        np.uint64(g_last))
    br = bit_reverse_indices(log_m)
    return {
        "zh_inv": zh_inv[br],
        "z_last": x_mg[br],
        "l_first": l_first[br],
        "l_last": l_last[br],
    }


def selectors_at_point(z, degree_bits: int):
    """Same selectors evaluated at an extension point z (host-exact).
    Returns (z_last, l_first, l_last, zh) as ext tuples."""
    n = 1 << degree_bits
    g_n = host.primitive_root_of_unity(degree_bits)
    g_last = host.fexp(g_n, n - 1)
    zn = host.eexp(z, n)
    zh = host.esub(zn, (1, 0))
    n_inv = host.finv(n)
    z_last = host.esub(z, (g_last, 0))
    l_first = host.escalar(
        host.emul(zh, host.einv(host.esub(z, (1, 0)))), n_inv)
    l_last = host.escalar(
        host.emul(zh, host.einv(z_last)), host.fmul(n_inv, g_last))
    return z_last, l_first, l_last, zh
