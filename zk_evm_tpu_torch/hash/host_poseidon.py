"""Exact (python-int) Poseidon twin — ground truth for the device kernel and
the arithmetic used by the host Fiat-Shamir challenger.

Mirrors the sponge construction the reference proving stack uses for Merkle
hashing and transcripts (overwrite-mode duplex, rate 8 / capacity 4, 4-element
digests; cf. zk_evm SURVEY §2.1 "Merkle hashers" and plonky2's PoseidonHash
usage at zk_evm's evm_arithmetization/src/lib.rs:23).
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..field import host
from . import poseidon_params as pp

P = host.P


def _mds(state: list[int], params: pp.PoseidonParams) -> list[int]:
    w = params.width
    out = []
    for r in range(w):
        acc = params.mds_diag[r] * state[r]
        for i in range(w):
            acc += params.mds_circ[i] * state[(i + r) % w]
        out.append(acc % P)
    return out


def permute(state: list[int],
            params: pp.PoseidonParams | None = None) -> list[int]:
    """One Poseidon permutation over a width-12 state of canonical ints.
    Dispatches to the native C++ twin when the host library is built
    (native/zkhost.cpp poseidon_permute_many); permute_py is the exact
    pure-python ground truth it is tested against."""
    params = params or pp.default_params()
    out = native.poseidon_permute_many(np.array([state], dtype=np.uint64),
                                       params)
    if out is not None:
        return [int(v) for v in out[0]]
    return permute_py(state, params)


def permute_py(state: list[int],
               params: pp.PoseidonParams | None = None) -> list[int]:
    """Pure-python permutation (exact ground truth)."""
    params = params or pp.default_params()
    w = params.width
    assert len(state) == w
    s = list(state)
    rnd = 0
    for _ in range(params.half_full_rounds):
        rc = params.rc(rnd)
        s = [pow((x + c) % P, params.sbox_exp, P) for x, c in zip(s, rc)]
        s = _mds(s, params)
        rnd += 1
    for _ in range(params.n_partial_rounds):
        rc = params.rc(rnd)
        s = [(x + c) % P for x, c in zip(s, rc)]
        s[0] = pow(s[0], params.sbox_exp, P)
        s = _mds(s, params)
        rnd += 1
    for _ in range(params.half_full_rounds):
        rc = params.rc(rnd)
        s = [pow((x + c) % P, params.sbox_exp, P) for x, c in zip(s, rc)]
        s = _mds(s, params)
        rnd += 1
    return s


def hash_no_pad(inputs: list[int]) -> list[int]:
    """Overwrite-mode sponge: absorb in rate-8 chunks, squeeze 4 elements."""
    params = pp.default_params()
    state = [0] * params.width
    for off in range(0, len(inputs), params.rate):
        chunk = inputs[off:off + params.rate]
        state[:len(chunk)] = chunk
        state = permute(state, params)
    return state[:4]


def two_to_one(left: list[int], right: list[int]) -> list[int]:
    """Compress two 4-element digests into one (Merkle interior nodes)."""
    assert len(left) == 4 and len(right) == 4
    params = pp.default_params()
    state = list(left) + list(right) + [0] * (params.width - 8)
    state = permute(state, params)
    return state[:4]


def hash_or_noop(inputs: list[int]) -> list[int]:
    """Digest of a leaf: pad-with-zeros passthrough for <= 4 elements,
    sponge otherwise (mirrors plonky2 leaf hashing semantics)."""
    if len(inputs) <= 4:
        return list(inputs) + [0] * (4 - len(inputs))
    return hash_no_pad(inputs)
