"""BN254 extension-tower host arithmetic.

Twin of zk_evm's evm_arithmetization/src/extension_tower.rs for
the pieces the PROVER_INPUT oracles need: Fp2 = Fp[i]/(i^2+1),
Fp6 = Fp2[v]/(v^3 - (9+i)) (mul_adj, :492-499), Fp12 = Fp6[w]/(w^2 - v).
The 12-limb memory layout is the transmuted struct order
[z0.t0.re, z0.t0.im, z0.t1.re, z0.t1.im, z0.t2.re, z0.t2.im,
 z1.t0.re, ... z1.t2.im] (prover_input.rs:1090-1094).
"""

from __future__ import annotations

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583


# ---- Fp2: pairs (re, im) --------------------------------------------------

def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % P,
            (a[0] * b[1] + a[1] * b[0]) % P)


def f2_inv(a):
    d = pow((a[0] * a[0] + a[1] * a[1]) % P, P - 2, P)
    return ((a[0] * d) % P, (-a[1] * d) % P)


def f2_mul_adj(a):
    """Multiply by xi = 9 + i (extension_tower.rs:493-499)."""
    return ((9 * a[0] - a[1]) % P, (a[0] + 9 * a[1]) % P)


# ---- Fp6: triples of Fp2, c0 + c1 v + c2 v^2, v^3 = xi --------------------

def f6_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f6_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def f6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = f2_mul(a0, b0)
    t1 = f2_mul(a1, b1)
    t2 = f2_mul(a2, b2)
    c0 = f2_add(t0, f2_mul_adj(
        f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)), f2_add(t1, t2))))
    c1 = f2_add(f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)),
                       f2_add(t0, t1)), f2_mul_adj(t2))
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)),
                       f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def f6_mul_by_v(a):
    """v * (c0 + c1 v + c2 v^2) = xi*c2 + c0 v + c1 v^2."""
    return (f2_mul_adj(a[2]), a[0], a[1])


def f6_inv(a):
    a0, a1, a2 = a
    c0 = f2_sub(f2_mul(a0, a0), f2_mul_adj(f2_mul(a1, a2)))
    c1 = f2_sub(f2_mul_adj(f2_mul(a2, a2)), f2_mul(a0, a1))
    c2 = f2_sub(f2_mul(a1, a1), f2_mul(a0, a2))
    t = f2_add(f2_mul(a0, c0),
               f2_mul_adj(f2_add(f2_mul(a2, c1), f2_mul(a1, c2))))
    t_inv = f2_inv(t)
    return (f2_mul(c0, t_inv), f2_mul(c1, t_inv), f2_mul(c2, t_inv))


# ---- Fp12: pairs of Fp6, z0 + z1 w, w^2 = v -------------------------------

def fp12_inverse(limbs: list[int]) -> list[int]:
    """12 limbs -> 12 limbs of the Fp12 inverse."""
    assert len(limbs) == 12
    z0 = tuple((limbs[2 * i], limbs[2 * i + 1]) for i in range(3))
    z1 = tuple((limbs[6 + 2 * i], limbs[6 + 2 * i + 1]) for i in range(3))
    # (z0 + z1 w)^-1 = (z0 - z1 w) / (z0^2 - v z1^2)
    norm = f6_sub(f6_mul(z0, z0), f6_mul_by_v(f6_mul(z1, z1)))
    ninv = f6_inv(norm)
    r0 = f6_mul(z0, ninv)
    r1 = f6_mul(tuple(f2_sub((0, 0), x) for x in z1), ninv)
    out = []
    for t in r0:
        out.extend(t)
    for t in r1:
        out.extend(t)
    return out


def fp12_mul(a: list[int], b: list[int]) -> list[int]:
    az0 = tuple((a[2 * i], a[2 * i + 1]) for i in range(3))
    az1 = tuple((a[6 + 2 * i], a[6 + 2 * i + 1]) for i in range(3))
    bz0 = tuple((b[2 * i], b[2 * i + 1]) for i in range(3))
    bz1 = tuple((b[6 + 2 * i], b[6 + 2 * i + 1]) for i in range(3))
    c0 = f6_add(f6_mul(az0, bz0), f6_mul_by_v(f6_mul(az1, bz1)))
    c1 = f6_add(f6_mul(az0, bz1), f6_mul(az1, bz0))
    out = []
    for t in c0:
        out.extend(t)
    for t in c1:
        out.extend(t)
    return out
