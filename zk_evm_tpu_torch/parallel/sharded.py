"""Trace commitment pipeline: values (polys, n) -> Merkle cap.

The JAX package shards this over a device mesh; the port runs it on one
device for now (multi-GPU sharding is a later slice). The cap is the same
at any sharding, because the tree order is fixed.
"""

from __future__ import annotations

from ..field import GF
from .. import ntt
from ..hash import poseidon


def commit_cap(values: GF, cap_height: int = 4, rate_bits: int = 1) -> GF:
    """Trace commitment: values (polys, n) -> Merkle cap (2^cap_height, 4):
    LDE (IFFT, shift-7 coset NTT, bit-reversed), leaf sponge over every
    LDE row, compression up to the cap."""
    lde = ntt.lde_bitrev(values, rate_bits=rate_bits)
    digests = poseidon.hash_rows(lde.T)
    while digests.shape[0] > (1 << cap_height):
        digests = poseidon.compress(digests[0::2], digests[1::2])
    return digests
