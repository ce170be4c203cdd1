"""Carry state across from the JAX package, without importing it.

The JAX package stores a GF array as a `(lo, hi)` pair of uint32 arrays,
its challenger as three lists of ints, and a proof as JSON. These helpers
take those objects duck-typed (anything with `.lo`/`.hi`, or with the
challenger's three buffers), so the tests can feed both implementations
identical state while this package still never imports jax.
"""

from __future__ import annotations

import numpy as np

from .challenger import Challenger
from .field import GF
from .stark.proof import StarkProof
from .stark.serialization import stark_proof_from_json


def u64_from_limbs(lo, hi) -> np.ndarray:
    """A (lo, hi) uint32 limb pair (numpy or array-like) -> uint64."""
    lo = np.asarray(lo).astype(np.uint64)
    hi = np.asarray(hi).astype(np.uint64)
    return lo | (hi << np.uint64(32))


def gf_from_limbs(x, device=None) -> GF:
    """A JAX-package GF (anything with `.lo` and `.hi` uint32 arrays) ->
    a port GF on `device`."""
    return GF.from_u64(u64_from_limbs(x.lo, x.hi), device)


def challenger_from(other) -> Challenger:
    """A challenger at the same transcript position as `other` (anything
    with `sponge_state`, `input_buffer` and `output_buffer`)."""
    ch = Challenger(list(other.sponge_state))
    ch.input_buffer = [int(x) for x in other.input_buffer]
    ch.output_buffer = [int(x) for x in other.output_buffer]
    return ch


def proof_from_json(s: str) -> StarkProof:
    """A single-table proof serialized by either package's proof_to_json."""
    return stark_proof_from_json(s)
