"""The Poseidon permutation in its fast partial-round form, with exact
python ints: the constants the CUDA kernels run (csrc/poseidon_common.cuh)
and a twin that applies them.

The form is that of appendix B of the Poseidon paper (Grassi et al.,
"Poseidon: A New Hash Function for Zero-Knowledge Proof Systems"), as
plonky2 runs it. The 22 partial rounds, each "add 12 constants, S-box on
word 0, dense 12x12 MDS", become:

- one constant layer over all 12 words (`FIRST_CONSTANTS`);
- one dense 11x11 matrix on words 1..11 (`INITIAL_MATRIX`, word 0 kept);
- 22 rounds of: s[0] = s[0]^7 + PARTIAL_CONSTANTS[r]; then the sparse layer
  s[0] = M[0][0] * s[0] + sum_j W_HATS[r][j] * s[j + 1],
  s[i] = s[i] + s[0] * VS[r][i - 1]  (i = 1..11, with the old s[0]).

Both moves are exact. A round's constant vector c is moved back through
the MDS above it, since M x + c = M (x + M^-1 c): the part on words 1..11
joins the round before's constants (that round's S-box touches word 0
only) and the part on word 0 is added after that round's S-box. The
matrix is moved back too: M = A B with B = diag(1, M_hat) and A sparse,
and B, which leaves word 0 alone, commutes with the S-box layer above it,
so it joins the MDS of the round before; the first round's B is the
initial matrix. This repository's round constants are its own
(`poseidon_params.derive_round_constants`), so the fast constants are
derived here rather than copied from plonky2.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from . import poseidon_params as pp

P = pp.P
W = pp.WIDTH
HALF = pp.HALF_FULL_ROUNDS
N_PARTIAL = pp.N_PARTIAL_ROUNDS


def mds_matrix() -> list[list[int]]:
    """M[r][j] = circ[(j - r) mod 12] + diag[r] * (j == r)."""
    return [[pp.MDS_CIRC[(j - r) % W] + (pp.MDS_DIAG[r] if j == r else 0)
             for j in range(W)] for r in range(W)]


def mat_inv(a: list[list[int]]) -> list[list[int]]:
    """Inverse of a square matrix mod p by Gauss-Jordan elimination."""
    n = len(a)
    m = [[x % P for x in row] + [int(i == j) for j in range(n)]
         for i, row in enumerate(a)]
    for col in range(n):
        piv = next((r for r in range(col, n) if m[r][col]), None)
        if piv is None:
            raise ValueError("matrix is singular mod p")
        m[col], m[piv] = m[piv], m[col]
        inv = pow(m[col][col], P - 2, P)
        m[col] = [x * inv % P for x in m[col]]
        for r in range(n):
            if r != col and m[r][col]:
                f = m[r][col]
                m[r] = [(x - f * y) % P for x, y in zip(m[r], m[col])]
    return [row[n:] for row in m]


def _mat_vec(a: list[list[int]], v: list[int]) -> list[int]:
    return [sum(x * y for x, y in zip(row, v)) % P for row in a]


def _mat_mul(a: list[list[int]], b: list[list[int]]) -> list[list[int]]:
    cols = list(zip(*b))
    return [[sum(x * y for x, y in zip(row, col)) % P for col in cols]
            for row in a]


@lru_cache(maxsize=1)
def fast_constants() -> dict:
    """The fast partial-round constants, as python ints:
    FIRST_CONSTANTS (12), INITIAL_MATRIX (11 x 11), PARTIAL_CONSTANTS (22,
    the last 0), W_HATS (22 x 11), VS (22 x 11), and M00 = M[0][0]."""
    mds = mds_matrix()
    mds_inv = mat_inv(mds)
    params = pp.default_params()
    consts = [list(params.rc(HALF + r)) for r in range(N_PARTIAL)]
    after_sbox = [0] * N_PARTIAL
    for r in range(N_PARTIAL - 1, 0, -1):
        d = _mat_vec(mds_inv, consts[r])      # M x + c = M (x + d)
        after_sbox[r - 1] = d[0]
        consts[r - 1] = [consts[r - 1][0]] + [
            (x + y) % P for x, y in zip(consts[r - 1][1:], d[1:])]
        consts[r] = [0] * W
    # matrices, last round first: the round's MDS (with the B of the round
    # after it folded in) is A_r B_r, B_r = diag(1, M_hat_r)
    w_row = mds[0][1:]                        # row 0 of every round's MDS
    col0 = [mds[i][0] for i in range(1, W)]  # column 0 of M below row 0
    m_hat_block = [row[1:] for row in mds[1:]]
    w_hats = [None] * N_PARTIAL
    vs = [None] * N_PARTIAL
    after = [[int(i == j) for j in range(W - 1)] for i in range(W - 1)]
    for r in range(N_PARTIAL - 1, -1, -1):
        # this round's matrix is diag(1, after) @ M: row 0 is M's, column
        # 0 below is after @ col0, the block is after @ M_hat
        m_hat = _mat_mul(after, m_hat_block)
        inv = mat_inv(m_hat)
        w_hats[r] = [sum(w_row[i] * inv[i][j] for i in range(W - 1)) % P
                     for j in range(W - 1)]
        vs[r] = _mat_vec(after, col0)
        after = m_hat
    return {"FIRST_CONSTANTS": consts[0], "INITIAL_MATRIX": m_hat,
            "PARTIAL_CONSTANTS": after_sbox, "W_HATS": w_hats, "VS": vs,
            "M00": mds[0][0]}


def fast_constants_np() -> np.ndarray:
    """The fast constants as one uint64 vector, in the order of the
    fast part of `CONSTANTS` in csrc/poseidon_common.cuh: FIRST_CONSTANTS
    (12), INITIAL_MATRIX (121, row-major), PARTIAL_CONSTANTS (22), W_HATS
    (242), VS (242)."""
    c = fast_constants()
    flat = (list(c["FIRST_CONSTANTS"])
            + [x for row in c["INITIAL_MATRIX"] for x in row]
            + list(c["PARTIAL_CONSTANTS"])
            + [x for row in c["W_HATS"] for x in row]
            + [x for row in c["VS"] for x in row])
    return np.array(flat, dtype=np.uint64)


def _full_round(s: list[int], rc: tuple[int, ...], mds) -> list[int]:
    return _mat_vec(mds, [pow((x + c) % P, 7, P) for x, c in zip(s, rc)])


def permute_fast(state: list[int]) -> list[int]:
    """One Poseidon permutation of a width-12 state of canonical ints, in
    the fast partial-round form; equal to host_poseidon.permute."""
    if len(state) != W:
        raise ValueError(f"expected {W} words, got {len(state)}")
    params = pp.default_params()
    mds = mds_matrix()
    c = fast_constants()
    s = list(state)
    for rnd in range(HALF):
        s = _full_round(s, params.rc(rnd), mds)
    s = [(x + k) % P for x, k in zip(s, c["FIRST_CONSTANTS"])]
    s = [s[0]] + _mat_vec(c["INITIAL_MATRIX"], s[1:])
    for r in range(N_PARTIAL):
        s0 = (pow(s[0], 7, P) + c["PARTIAL_CONSTANTS"][r]) % P
        new0 = (c["M00"] * s0
                + sum(w * x for w, x in zip(c["W_HATS"][r], s[1:]))) % P
        s = [new0] + [(x + s0 * v) % P for x, v in zip(s[1:], c["VS"][r])]
    for rnd in range(HALF + N_PARTIAL, pp.N_ROUNDS):
        s = _full_round(s, params.rc(rnd), mds)
    return s
