"""PolynomialBatch: the committed oracle for a batch of trace polynomials.

IFFT -> coset LDE (bit-reversed) -> Merkle tree over the LDE rows with a
cap. The batch transforms on its tensors' device; leaves live in
bit-reversed evaluation order so FRI fold pairs are adjacent.

With a mesh (`parallel.Mesh`, k devices) the polys axis splits into k
contiguous groups, each transformed on its own device with no copies;
each device cuts its LDE into k row blocks, and device s gathers block s
of every group (the all-to-all GSPMD inserts in the JAX package, written
out) and hashes it into a whole subtree (`merkle.build_tree_from_blocks`).
`values`, `coeffs`, `lde` and the tree end up on `mesh[0]`, so the
quotient, the openings and FRI read an ordinary batch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..field import GF, host
from .. import ntt
from ..merkle import (MerkleTree, build_commitment_tree,
                      build_tree_from_blocks)


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
                    hasher: str = "poseidon",
                    mesh=None) -> "PolynomialBatch":
        groups = [ntt.ifft(g) for g in _split_polys(values, mesh)]
        batch = _commit_groups(groups, mesh, rate_bits, cap_height, hasher)
        batch.values = _gather([values], batch.coeffs.device)
        return batch

    @classmethod
    def from_coeffs(cls, coeffs: GF,
                    rate_bits: int = 1, cap_height: int = 4,
                    hasher: str = "poseidon",
                    mesh=None) -> "PolynomialBatch":
        """Commit polynomials given in coefficient form (quotient chunks)."""
        return _commit_groups(_split_polys(coeffs, mesh), mesh, rate_bits,
                              cap_height, hasher)

    def tensors(self) -> list:
        """Every device tensor the batch keeps."""
        out = [self.coeffs.v, self.lde.v, self.tree.leaves.v]
        out += [lv.v for lv in self.tree.levels]
        if self.values is not None:
            out.append(self.values.v)
        return out

    def open_at(self, zs: list[tuple[int, int]]) -> np.ndarray:
        """Evaluate every poly at each extension point z = (a, b).

        Returns array of shape (len(zs), num_polys, 2) uint64: sum_i c_i z^i
        as two base-field weighted sums per point, with the z-power tables
        built on the batch's device."""
        out = np.empty((len(zs), self.num_polys, 2), dtype=np.uint64)
        for k, z in enumerate(zs):
            out[k] = _eval_at_ext_point(self.coeffs, z)
        return out


def _split_polys(x: GF, mesh) -> list[GF]:
    """The polys axis of `x` in len(mesh) contiguous groups (the first
    ones a poly larger when it does not divide), group g on mesh[g];
    empty groups are left out. Without a mesh, `x` alone."""
    if mesh is None:
        return [x]
    bounds = np.linspace(0, x.shape[0], len(mesh) + 1).round().astype(int)
    return [GF(x.v[lo:hi].to(dev))
            for lo, hi, dev in zip(bounds[:-1], bounds[1:], mesh)
            if hi > lo]


def _gather(parts: list[GF], dev) -> GF:
    """The parts concatenated along polys on `dev`; one part on `dev`
    is returned as it is."""
    if len(parts) == 1:
        return GF(parts[0].v.to(dev))
    return GF(torch.cat([p.v.to(dev) for p in parts]))


def _commit_groups(groups: list[GF], mesh, rate_bits: int,
                   cap_height: int, hasher: str) -> PolynomialBatch:
    """Commit coefficient groups, group g on mesh[g] (one group on its
    own device without a mesh): each group's coset LDE on its device,
    the all-to-all of row blocks, a subtree a device, and `coeffs`/`lde`
    gathered onto the first device. With one row block no copy is made."""
    ldes = [ntt.lde_from_coeffs_bitrev(c, rate_bits=rate_bits)
            for c in groups]
    devices = list(mesh) if mesh is not None else [groups[0].device]
    coeffs = _gather(groups, devices[0])
    lde = _gather(ldes, devices[0])
    if mesh is None and hasher == "keccak_host":
        tree = build_commitment_tree(lde.T, cap_height, hasher)
        return PolynomialBatch(None, coeffs, lde, tree, rate_bits)
    m = lde.shape[1]
    k = min(len(devices), m)
    step = m // k
    # lde.T is a view: the leaf sponge reads the LDE's own layout
    blocks = [lde.T] if k == 1 else [
        GF(torch.cat([x.v[:, s * step:(s + 1) * step].to(devices[s])
                      for x in ldes])).T for s in range(k)]
    tree = build_tree_from_blocks(blocks, lde.T, cap_height, hasher)
    return PolynomialBatch(None, coeffs, lde, tree, rate_bits)


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
