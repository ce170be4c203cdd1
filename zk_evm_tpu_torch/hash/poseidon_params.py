"""Poseidon-over-Goldilocks parameters.

Instance shape follows the recursion-friendly hasher the reference proving
stack is built on (plonky2's ``PoseidonGoldilocksConfig``; used by zk_evm at
`/root/reference/evm_arithmetization/src/lib.rs:23` for every Merkle
commitment and the Fiat-Shamir challenger):

- width t = 12 field elements, sponge rate 8 / capacity 4,
- 8 full rounds (4 + 4) and 22 partial rounds, S-box x^7,
- MDS = circulant(CIRC) + diag(DIAG) with small (<= 6-bit) entries, so the
  matrix-vector product is a small-integer linear combination — on TPU this
  becomes exact uint32 limb accumulation with no general field multiplies.

The MDS entries are the published plonky2 parameters (small-circulant family).
Round constants are derived here by a documented nothing-up-my-sleeve
procedure (SHA-256 in counter mode with rejection sampling below p) because
the upstream constant tables live in the external plonky2 crate, which is not
part of the reference checkout. The permutation is parameterized by
``PoseidonParams``; dropping in the upstream ALL_ROUND_CONSTANTS table makes
it bit-compatible with plonky2.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from ..field import host

P = host.P

WIDTH = 12
RATE = 8
CAPACITY = 4
N_FULL_ROUNDS = 8        # 4 before + 4 after the partial rounds
HALF_FULL_ROUNDS = 4
N_PARTIAL_ROUNDS = 22
N_ROUNDS = N_FULL_ROUNDS + N_PARTIAL_ROUNDS
SBOX_EXP = 7

# Small-entry circulant MDS (plonky2's published Goldilocks parameters):
# out[r] = sum_i CIRC[i] * in[(i + r) % 12] + DIAG[r] * in[r].
MDS_CIRC = (17, 15, 41, 16, 2, 28, 13, 13, 39, 18, 34, 20)
MDS_DIAG = (8, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)

_RC_DOMAIN = b"zk_evm_tpu/poseidon/goldilocks/w12/a7/rf8/rp22"


def derive_round_constants(n: int = N_ROUNDS * WIDTH) -> tuple[int, ...]:
    """Nothing-up-my-sleeve round constants: SHA-256 counter stream, 8-byte
    big-endian chunks, rejection-sampled below p. Deterministic and
    reproducible from this file alone."""
    out: list[int] = []
    counter = 0
    while len(out) < n:
        digest = hashlib.sha256(
            _RC_DOMAIN + b"|" + counter.to_bytes(8, "big")
        ).digest()
        counter += 1
        for i in range(0, 32, 8):
            v = int.from_bytes(digest[i:i + 8], "big")
            if v < P:
                out.append(v)
                if len(out) == n:
                    break
    return tuple(out)


@dataclass(frozen=True)
class PoseidonParams:
    width: int = WIDTH
    rate: int = RATE
    half_full_rounds: int = HALF_FULL_ROUNDS
    n_partial_rounds: int = N_PARTIAL_ROUNDS
    sbox_exp: int = SBOX_EXP
    mds_circ: tuple[int, ...] = MDS_CIRC
    mds_diag: tuple[int, ...] = MDS_DIAG
    round_constants: tuple[int, ...] = ()   # len = n_rounds * width

    @property
    def n_rounds(self) -> int:
        return 2 * self.half_full_rounds + self.n_partial_rounds

    def rc(self, round_idx: int) -> tuple[int, ...]:
        w = self.width
        return self.round_constants[round_idx * w:(round_idx + 1) * w]


@lru_cache(maxsize=1)
def default_params() -> PoseidonParams:
    return PoseidonParams(round_constants=derive_round_constants())


@lru_cache(maxsize=1)
def round_constants_np() -> np.ndarray:
    """(n_rounds, width) uint64 round-constant table for device upload."""
    p = default_params()
    return np.array(p.round_constants, dtype=np.uint64).reshape(
        p.n_rounds, p.width)
