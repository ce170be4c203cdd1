"""Host-side (exact python-int) Goldilocks arithmetic.

Used by everything that runs on the CPU in small quantities: the Fiat-Shamir
challenger, twiddle/constant generation, the proof verifier, and test oracles
for the device limb kernels. Python ints are exact, so this module is the
ground truth the JAX kernels are tested against.
"""

from __future__ import annotations

P = (1 << 64) - (1 << 32) + 1
MULT_GENERATOR = 7
TWO_ADICITY = 32
POWER_OF_TWO_GENERATOR = 1753635133440165772
W_EXT = 7  # quadratic extension non-residue


def fadd(a: int, b: int) -> int:
    s = a + b
    return s - P if s >= P else s


def fsub(a: int, b: int) -> int:
    d = a - b
    return d + P if d < 0 else d


def fneg(a: int) -> int:
    return P - a if a else 0


def fmul(a: int, b: int) -> int:
    return (a * b) % P


def fexp(a: int, e: int) -> int:
    return pow(a, e, P)


def finv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("inverse of 0 in Goldilocks")
    return pow(a, P - 2, P)


def primitive_root_of_unity(n_log: int) -> int:
    """Primitive 2^n_log-th root of unity (matches plonky2's choice)."""
    assert 0 <= n_log <= TWO_ADICITY
    g = POWER_OF_TWO_GENERATOR
    for _ in range(TWO_ADICITY - n_log):
        g = fmul(g, g)
    return g


def two_adic_subgroup(n_log: int) -> list[int]:
    g = primitive_root_of_unity(n_log)
    out = [1]
    for _ in range((1 << n_log) - 1):
        out.append(fmul(out[-1], g))
    return out


def batch_inv(xs: list[int]) -> list[int]:
    """Montgomery batch inversion."""
    n = len(xs)
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = fmul(prefix[i], x if x else 1)
    inv_all = finv(prefix[n])
    out = [0] * n
    for i in range(n - 1, -1, -1):
        if xs[i]:
            out[i] = fmul(inv_all, prefix[i])
            inv_all = fmul(inv_all, xs[i])
    return out


# -- quadratic extension (a + b*X, X^2 = 7) as int pairs ---------------------

def eadd(x, y):
    return (fadd(x[0], y[0]), fadd(x[1], y[1]))


def esub(x, y):
    return (fsub(x[0], y[0]), fsub(x[1], y[1]))


def emul(x, y):
    a, b = x
    c, d = y
    return (fadd(fmul(a, c), fmul(W_EXT, fmul(b, d))),
            fadd(fmul(a, d), fmul(b, c)))


def escalar(x, k: int):
    return (fmul(x[0], k), fmul(x[1], k))


def eneg(x):
    return (fneg(x[0]), fneg(x[1]))


def einv(x):
    a, b = x
    norm = fsub(fmul(a, a), fmul(W_EXT, fmul(b, b)))
    ninv = finv(norm)
    return (fmul(a, ninv), fneg(fmul(b, ninv)))


def eexp(x, e: int):
    r = (1, 0)
    base = x
    while e > 0:
        if e & 1:
            r = emul(r, base)
        e >>= 1
        if e:
            base = emul(base, base)
    return r


def efrom_base(a: int):
    return (a, 0)
