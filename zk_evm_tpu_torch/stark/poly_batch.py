"""PolynomialBatch: the committed oracle for a batch of trace polynomials.

IFFT -> coset LDE (bit-reversed) -> Merkle tree over the LDE rows with a
cap. The batch transforms on its tensors' device; leaves live in
bit-reversed evaluation order so FRI fold pairs are adjacent.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..field import GF, host
from .. import ntt
from ..merkle import MerkleTree, build_commitment_tree


@dataclass
class PolynomialBatch:
    """values: (num_polys, n) on H (natural order), or None;
    coeffs: (num_polys, n) coefficient form (kept for openings);
    lde: (num_polys, n << rate_bits) on the shift-7 coset, bit-reversed;
    tree: Merkle tree over rows of lde^T."""
    values: GF | None
    coeffs: GF
    lde: GF
    tree: MerkleTree
    rate_bits: int

    @property
    def num_polys(self) -> int:
        return self.coeffs.shape[0]

    @property
    def degree(self) -> int:
        return self.coeffs.shape[1]

    @property
    def cap(self) -> GF:
        return self.tree.cap

    def cap_ints(self) -> list[list[int]]:
        return [[int(x) for x in row] for row in self.tree.cap_u64()]

    @classmethod
    def from_values(cls, values: GF,
                    rate_bits: int = 1, cap_height: int = 4,
                    hasher: str = "poseidon") -> "PolynomialBatch":
        batch = cls.from_coeffs(ntt.ifft(values), rate_bits=rate_bits,
                                cap_height=cap_height, hasher=hasher)
        batch.values = values
        return batch

    @classmethod
    def from_coeffs(cls, coeffs: GF,
                    rate_bits: int = 1, cap_height: int = 4,
                    hasher: str = "poseidon") -> "PolynomialBatch":
        """Commit polynomials given in coefficient form (quotient chunks)."""
        lde = ntt.lde_from_coeffs_bitrev(coeffs, rate_bits=rate_bits)
        # lde.T is a view: the leaf sponge reads the LDE's own layout
        tree = build_commitment_tree(lde.T, cap_height, hasher)
        return cls(None, coeffs, lde, tree, rate_bits)

    def open_at(self, zs: list[tuple[int, int]]) -> np.ndarray:
        """Evaluate every poly at each extension point z = (a, b).

        Returns array of shape (len(zs), num_polys, 2) uint64: sum_i c_i z^i
        as two base-field weighted sums per point, with the z-power tables
        built on the batch's device."""
        out = np.empty((len(zs), self.num_polys, 2), dtype=np.uint64)
        for k, z in enumerate(zs):
            out[k] = _eval_at_ext_point(self.coeffs, z)
        return out


def _weighted_sums(coeffs: GF, pa: GF, pb: GF):
    return (coeffs * pa).sum(axis=1), (coeffs * pb).sum(axis=1)


def _eval_at_ext_point(coeffs: GF, z: tuple[int, int]) -> np.ndarray:
    """sum_i coeffs[:, i] * z^i for an extension point z; returns
    (num_polys, 2) uint64."""
    za, zb = ext_powers(z, coeffs.shape[1], coeffs.device)
    ra, rb = _weighted_sums(coeffs, za, zb)
    return np.stack([ra.to_u64(), rb.to_u64()], axis=-1)


def ext_powers(z: tuple[int, int], n: int, device=None) -> tuple[GF, GF]:
    """[(z^0) .. (z^(n-1))] in GF(p^2) as two GF vectors on `device`, by
    log-doubling: each step multiplies the filled prefix by z^filled."""
    a = GF.const(1, (1,), device)
    b = GF.const(0, (1,), device)
    cur = z  # z^filled
    while a.shape[0] < n:
        take = min(a.shape[0], n - a.shape[0])
        sa, sb = cur
        # (a + bX)(sa + sbX) = (a sa + 7 b sb) + (a sb + b sa) X
        na = a[:take] * sa + b[:take] * host.fmul(7, sb)
        nb = a[:take] * sb + b[:take] * sa
        a = GF.concatenate([a, na], axis=0)
        b = GF.concatenate([b, nb], axis=0)
        cur = host.emul(cur, cur)
    return a, b
