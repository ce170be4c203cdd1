"""Trace commitment pipeline over one device or a mesh of devices.

The JAX package shards the commitment over a device mesh and lets GSPMD
insert the copies. The port's mesh is one process with an ordered list of
`torch.device`s, and the copies are written out (`.to(device)`, peer
copies over NVLink between cards): the polys axis splits into contiguous
groups whose IFFT and coset LDE run each on its own device, one
all-to-all hands device s row block s of every group, each device hashes
its block of leaves into a whole subtree, and the subtrees' levels are
gathered in order onto `mesh[0]`, where the top levels are compressed
down to the cap (`stark/poly_batch.py`, `merkle/tree.py`). The cap is
the same at any mesh, because the tree order is fixed: that keeps the
Fiat-Shamir transcript the same at any device count.

A mesh may name one device more than once (`Mesh(["cuda:0"] * 2)`): the
split and the gathers then run on that device, and the copies between
entries are no-ops. That is how a host with one card, and the CPU tests
(8 entries that all name `cpu`), run the mesh code.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..field import GF
from .. import ntt
from ..hash import poseidon


@dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices. The size must be a power of two, so
    that each device's block of a power-of-two leaf count is a whole
    subtree."""
    devices: tuple

    def __init__(self, devices):
        devs = tuple(torch.device(d) for d in devices)
        n = len(devs)
        if n == 0 or n & (n - 1):
            raise ValueError(f"a mesh's size must be a power of two, got "
                             f"{n} devices: its row blocks would not be "
                             f"whole subtrees")
        object.__setattr__(self, "devices", devs)

    def __len__(self) -> int:
        return len(self.devices)

    def __getitem__(self, i) -> torch.device:
        return self.devices[i]

    def __iter__(self):
        return iter(self.devices)


def make_mesh(n_devices: int | None = None,
              device_type: str = "cuda") -> Mesh:
    """The first `n_devices` CUDA devices (all of them when not given),
    or, with `device_type="cpu"`, `n_devices` entries (1 when not given)
    that all name the CPU. Asking for more cards than the host has
    raises; a mesh that repeats a card is built on purpose, by passing
    the list to `Mesh`."""
    if device_type == "cpu":
        return Mesh([torch.device("cpu")] * (n_devices or 1))
    if device_type != "cuda":
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n_devices is None else n_devices
    if n > have or n == 0:
        raise ValueError(f"need {n} CUDA devices, have {have}")
    return Mesh([torch.device("cuda", i) for i in range(n)])


def commit_cap(values: GF, cap_height: int = 4, rate_bits: int = 1) -> GF:
    """Trace commitment: values (polys, n) -> Merkle cap (2^cap_height, 4):
    LDE (IFFT, shift-7 coset NTT, bit-reversed), leaf sponge over every
    LDE row, compression up to the cap."""
    lde = ntt.lde_bitrev(values, rate_bits=rate_bits)
    digests = poseidon.hash_rows(lde.T)
    while digests.shape[0] > (1 << cap_height):
        digests = poseidon.compress(digests[0::2], digests[1::2])
    return digests


def sharded_commit_cap(values: GF, mesh: Mesh, cap_height: int = 4,
                       rate_bits: int = 1) -> GF:
    """`commit_cap` with the polys axis split over `mesh`, through the
    batch's mesh path (`PolynomialBatch.from_values(mesh=)`); the cap,
    on `mesh[0]`, equals `commit_cap`'s."""
    from ..stark.poly_batch import PolynomialBatch
    return PolynomialBatch.from_values(values, rate_bits=rate_bits,
                                       cap_height=cap_height,
                                       mesh=mesh).cap
