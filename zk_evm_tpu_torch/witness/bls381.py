"""BLS12-381 host arithmetic for the KZG point-evaluation oracle.

The kernel's EIP-4844 POINT_EVALUATION precompile delegates the pairing
check to the host through PROVER_INPUT(kzg_point_eval)
(zk_evm's evm_arithmetization/src/cpu/kernel/asm/core/
precompiles/kzg_peval.asm:55-59, generation/prover_input.rs:634-710).
This module supplies the curve: a compact, self-contained BLS12-381
with the pairing computed on points lifted to E(Fq12) — Fq12 is one
polynomial ring Fq[w]/(w^12 - 2 w^6 + 2), G2 points untwist into it,
and the Miller loop uses plain affine line functions. Slower than a
tower-and-sparse-multiplication pairing but obviously correct; the
precompile identity e1 * e2 == 1 is convention-independent, so any
nondegenerate bilinear pairing works.

Verified by bilinearity tests (e(aP, bQ) == e(P, Q)^ab) and a
synthetic-trusted-setup KZG round-trip in tests/test_kzg.py.
"""

from __future__ import annotations

import hashlib

# base field and scalar group order
Q = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# generators (standard, e.g. IETF BLS signature draft / EIP-2537)
G1 = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2 = (
    (0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
     0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E),
    (0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
     0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE),
)

# EIP-4844 trusted-setup G2 point (s*G2 from the KZG ceremony; constant
# data from ethereum/c-kzg-4844 trusted_setup.txt, as pinned by the
# reference at cpu/kernel/constants/mod.rs:426-431)
G2_TRUSTED_SETUP_POINT = (
    (0x185CBFEE53492714734429B7B38608E23926C911CCECEAC9A36851477BA4C60B087041DE621000EDC98EDADA20C1DEF2,
     0x15BFD7DD8CDEB128843BC287230AF38926187075CBFBEFA81009A2CE615AC53D2914E5870CB452D2AFAAAB24F3499F72),
    (0x014353BDB96B626DD7D5EE8599D1FCA2131569490E28DE18E82451A496A9C9794CE26D105941F383EE689BFBBB832A99,
     0x1666C54B0A32529503432FCAE0181B4BEF79DE09FC63671FDA5ED1BA9BFA07899495346F3D7AC9CD23048EF30D0A154F),
)

KZG_VERSIONED_HASH = 0x01
FIELD_ELEMENTS_PER_BLOB = 0x1000


# ---------------------------------------------------------------------------
# Fq2: a + b*i with i^2 = -1 (tuples of ints)
# ---------------------------------------------------------------------------

def f2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def f2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def f2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % Q,
            (a[0] * b[1] + a[1] * b[0]) % Q)


def f2_inv(a):
    d = pow(a[0] * a[0] + a[1] * a[1], Q - 2, Q)
    return (a[0] * d % Q, -a[1] * d % Q)


def f2_neg(a):
    return (-a[0] % Q, -a[1] % Q)


# ---------------------------------------------------------------------------
# Generic short-Weierstrass affine ops, parameterized by the field.
# Infinity is None. Works over Fq (ints), Fq2 (pairs) and Fq12 (Poly12).
# ---------------------------------------------------------------------------

class _FqOps:
    add = staticmethod(lambda a, b: (a + b) % Q)
    sub = staticmethod(lambda a, b: (a - b) % Q)
    mul = staticmethod(lambda a, b: (a * b) % Q)
    inv = staticmethod(lambda a: pow(a, Q - 2, Q))
    neg = staticmethod(lambda a: -a % Q)
    three = 3
    two = 2


class _Fq2Ops:
    add = staticmethod(f2_add)
    sub = staticmethod(f2_sub)
    mul = staticmethod(f2_mul)
    inv = staticmethod(f2_inv)
    neg = staticmethod(f2_neg)
    three = (3, 0)
    two = (2, 0)


def pt_double(p, F):
    if p is None:
        return None
    x, y = p
    m = F.mul(F.mul(F.three, F.mul(x, x)), F.inv(F.mul(F.two, y)))
    nx = F.sub(F.mul(m, m), F.add(x, x))
    ny = F.sub(F.mul(m, F.sub(x, nx)), y)
    return (nx, ny)


def pt_add(p, q, F):
    if p is None:
        return q
    if q is None:
        return p
    (x1, y1), (x2, y2) = p, q
    if x1 == x2:
        if y1 == y2:
            return pt_double(p, F)
        return None
    m = F.mul(F.sub(y2, y1), F.inv(F.sub(x2, x1)))
    nx = F.sub(F.sub(F.mul(m, m), x1), x2)
    ny = F.sub(F.mul(m, F.sub(x1, nx)), y1)
    return (nx, ny)


def pt_neg(p):
    if p is None:
        return None
    x, y = p
    if isinstance(y, int):
        return (x, -y % Q)
    return (x, tuple((-c) % Q for c in y))


def pt_mul(p, k: int, F):
    acc = None
    while k:
        if k & 1:
            acc = pt_add(acc, p, F)
        p = pt_double(p, F)
        k >>= 1
    return acc


def g1_mul(p, k):
    return pt_mul(p, k, _FqOps)


def g2_mul(p, k):
    return pt_mul(p, k, _Fq2Ops)


def g1_add(p, q):
    return pt_add(p, q, _FqOps)


def g2_add(p, q):
    return pt_add(p, q, _Fq2Ops)


def on_g1(p) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - (x * x * x + 4)) % Q == 0


def on_g2(p) -> bool:
    if p is None:
        return True
    x, y = p
    rhs = f2_add(f2_mul(f2_mul(x, x), x), (4, 4))
    return f2_sub(f2_mul(y, y), rhs) == (0, 0)


# ---------------------------------------------------------------------------
# Fq12 = Fq[w] / (w^12 - 2 w^6 + 2), elements as 12-tuples of ints.
# Fq2 embeds via i |-> w^6 - 1 (since (w^6 - 1)^2 = -1 mod the modulus).
# ---------------------------------------------------------------------------

def p12_mul(a, b):
    t = [0] * 23
    for i, ai in enumerate(a):
        if ai:
            for j, bj in enumerate(b):
                t[i + j] += ai * bj
    # reduce: w^(12+k) = 2 w^(6+k) - 2 w^k
    for k in range(10, -1, -1):
        c = t[12 + k]
        if c:
            t[6 + k] += 2 * c
            t[k] -= 2 * c
            t[12 + k] = 0
    return tuple(x % Q for x in t[:12])


def p12_add(a, b):
    return tuple((x + y) % Q for x, y in zip(a, b))


def p12_sub(a, b):
    return tuple((x - y) % Q for x, y in zip(a, b))


def p12_neg(a):
    return tuple(-x % Q for x in a)


P12_ONE = (1,) + (0,) * 11
P12_MOD = (2, 0, 0, 0, 0, 0, -2, 0, 0, 0, 0, 0, 1)  # w^12 - 2w^6 + 2


def _poly_deg(p):
    for i in range(len(p) - 1, -1, -1):
        if p[i] % Q:
            return i
    return -1


def p12_inv(a):
    """Extended Euclid in Fq[w] against the modulus polynomial.
    Invariant: low == lm * a and high == hm * a (mod w^12 - 2w^6 + 2);
    the Bezout multipliers can reach degree 11 mid-run, so the update
    must span the full multiplier, not just the partner's degree."""
    n = 26
    lm, hm = [1] + [0] * (n - 1), [0] * n
    low = list(a) + [0] * (n - 12)
    high = list(P12_MOD) + [0] * (n - 13)
    while _poly_deg(low) > 0:
        dl, dh = _poly_deg(low), _poly_deg(high)
        if dl < dh:
            low, high, lm, hm = high, low, hm, lm
            continue
        coef = low[dl] * pow(high[dh], Q - 2, Q) % Q
        shift = dl - dh
        for i in range(dh + 1):
            low[i + shift] = (low[i + shift] - coef * high[i]) % Q
        for i in range(n - shift):
            lm[i + shift] = (lm[i + shift] - coef * hm[i]) % Q
    d = _poly_deg(low)
    assert d == 0, "non-invertible Fq12 element"
    assert _poly_deg(lm) < 12, "multiplier escaped the ring"
    inv0 = pow(low[0], Q - 2, Q)
    return tuple(x * inv0 % Q for x in lm[:12])


def p12_pow(a, e: int):
    acc = P12_ONE
    while e:
        if e & 1:
            acc = p12_mul(acc, a)
        a = p12_mul(a, a)
        e >>= 1
    return acc


class _Fq12Ops:
    add = staticmethod(p12_add)
    sub = staticmethod(p12_sub)
    mul = staticmethod(p12_mul)
    inv = staticmethod(p12_inv)
    neg = staticmethod(p12_neg)
    three = (3,) + (0,) * 11
    two = (2,) + (0,) * 11


def _embed_fq(a: int):
    return (a % Q,) + (0,) * 11


def _embed_fq2(a):
    """a + b*i -> (a - b) + b * w^6."""
    c = [0] * 12
    c[0] = (a[0] - a[1]) % Q
    c[6] = a[1] % Q
    return tuple(c)


# w^-2 and w^-3 for the untwist (computed once)
_W = (0, 1) + (0,) * 10
_W_INV = p12_inv(_W)
_W_INV2 = p12_mul(_W_INV, _W_INV)
_W_INV3 = p12_mul(_W_INV2, _W_INV)


def lift_g1(p):
    if p is None:
        return None
    return (_embed_fq(p[0]), _embed_fq(p[1]))


def untwist_g2(p):
    """G2 (on the twist over Fq2) -> the same point on E(Fq12)."""
    if p is None:
        return None
    x = p12_mul(_embed_fq2(p[0]), _W_INV2)
    y = p12_mul(_embed_fq2(p[1]), _W_INV3)
    return (x, y)


# ---------------------------------------------------------------------------
# Pairing: Miller loop with affine line functions on E(Fq12)
# ---------------------------------------------------------------------------

ATE_LOOP_COUNT = 0xD201000000010000   # |x|, the BLS parameter magnitude


def _linefunc(p1, p2, t):
    """Evaluate the line through p1,p2 (or tangent at p1) at point t."""
    F = _Fq12Ops
    (x1, y1), (x2, y2) = p1, p2
    xt, yt = t
    if x1 != x2:
        m = F.mul(F.sub(y2, y1), F.inv(F.sub(x2, x1)))
        return F.sub(F.mul(m, F.sub(xt, x1)), F.sub(yt, y1))
    if y1 == y2:
        m = F.mul(F.mul(F.three, F.mul(x1, x1)),
                  F.inv(F.add(y1, y1)))
        return F.sub(F.mul(m, F.sub(xt, x1)), F.sub(yt, y1))
    return F.sub(xt, x1)


def miller_loop(q12, p12_pt):
    f = P12_ONE
    r = q12
    for i in range(ATE_LOOP_COUNT.bit_length() - 2, -1, -1):
        f = p12_mul(p12_mul(f, f), _linefunc(r, r, p12_pt))
        r = pt_double(r, _Fq12Ops)
        if (ATE_LOOP_COUNT >> i) & 1:
            f = p12_mul(f, _linefunc(r, q12, p12_pt))
            r = pt_add(r, q12, _Fq12Ops)
    return f


_FINAL_EXP = (Q ** 12 - 1) // R


def pairing(p, q) -> tuple:
    """e(P, Q) for P on G1, Q on G2 (affine tuples; None = infinity).
    Returns an Fq12 element; bilinear and nondegenerate."""
    if p is None or q is None:
        return P12_ONE
    return p12_pow(miller_loop(untwist_g2(q), lift_g1(p)), _FINAL_EXP)


def pairings_product_is_one(pairs) -> bool:
    """prod e(P_i, Q_i) == 1, with one shared final exponentiation."""
    f = P12_ONE
    for p, q in pairs:
        if p is None or q is None:
            continue
        f = p12_mul(f, miller_loop(untwist_g2(q), lift_g1(p)))
    return p12_pow(f, _FINAL_EXP) == P12_ONE


# ---------------------------------------------------------------------------
# G1 point decompression (zkcrypto serialization: 48 bytes, 3 flag bits)
# ---------------------------------------------------------------------------

def g1_from_bytes(data: bytes):
    """48-byte compressed G1 -> affine point or raise ValueError
    (octets_to_point of the BLS signature draft; mirrors
    prover_input.rs' g1_from_bytes acceptance exactly)."""
    assert len(data) == 48
    compressed = (data[0] >> 7) & 1
    infinity = (data[0] >> 6) & 1
    sort = (data[0] >> 5) & 1
    x = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:], "big")
    if x > Q:
        raise ValueError("x coordinate larger than modulus")
    if infinity:
        if not (compressed and not sort and x == 0):
            raise ValueError("contradictory flags")
        return None
    if not compressed:
        raise ValueError("contradictory flags")
    rhs = (x * x * x + 4) % Q
    y = pow(rhs, (Q + 1) // 4, Q)          # q = 3 mod 4
    if y * y % Q != rhs:
        raise ValueError("point not on curve")
    if (y > Q - y) ^ bool(sort):
        y = Q - y
    return (x, y)


def g1_to_bytes(p) -> bytes:
    """Affine G1 -> 48-byte compressed encoding (inverse of
    g1_from_bytes)."""
    if p is None:
        return bytes([0xC0]) + bytes(47)
    x, y = p
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= 0x80
    if y > Q - y:
        out[0] |= 0x20
    return bytes(out)


# ---------------------------------------------------------------------------
# KZG point-evaluation verification (the EIP-4844 precompile's math)
# ---------------------------------------------------------------------------

def verify_kzg_proof(commitment, z: int, y: int, proof,
                     setup_g2=G2_TRUSTED_SETUP_POINT) -> bool:
    """e(C - y*G1, -G2) * e(pi, X - z*G2) == 1, i.e. the committed
    polynomial opens to y at z (prover_input.rs:706-769)."""
    comm_minus_y = g1_add(commitment, pt_neg(g1_mul(G1, y % R)))
    x_minus_z = g2_add(setup_g2, pt_neg(g2_mul(G2, z % R)))
    return pairings_product_is_one([
        (comm_minus_y, pt_neg(G2)),
        (proof, x_minus_z),
    ])


def kzg_point_eval(versioned_hash: int, z: int, y: int,
                   comm_hi: int, comm_lo: int,
                   proof_hi: int, proof_lo: int) -> int:
    """The PROVER_INPUT(kzg_point_eval) oracle: full input validation +
    pairing check. Returns BLS_MODULUS (the precompile return value's
    second word) on success, 0 on any failure
    (prover_input.rs:634-710)."""
    if z > R or y > R:
        return 0
    if comm_lo >> 128 or proof_lo >> 128:
        return 0
    comm_bytes = comm_hi.to_bytes(32, "big") + comm_lo.to_bytes(16, "big")
    proof_bytes = proof_hi.to_bytes(32, "big") \
        + proof_lo.to_bytes(16, "big")

    expected = int.from_bytes(hashlib.sha256(comm_bytes).digest(), "big")
    expected &= (1 << 248) - 1
    expected |= KZG_VERSIONED_HASH << 248
    if versioned_hash != expected:
        return 0

    try:
        comm = g1_from_bytes(comm_bytes)
        proof = g1_from_bytes(proof_bytes)
    except ValueError:
        return 0
    if not verify_kzg_proof(comm, z, y, proof):
        return 0
    return R
