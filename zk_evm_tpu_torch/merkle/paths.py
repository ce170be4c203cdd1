"""Host Merkle verification of many openings of one tree at once: the
FRI verifier's query rounds open each oracle's tree 84 times at the
standard config. Same checks as merkle/host.py's and keccak_host.py's
verify_path, opening by opening."""

from __future__ import annotations

import numpy as np

from .. import native
from ..hash import poseidon_params as pp
from . import host as host_merkle
from . import keccak_host as keccak_merkle


def _one_by_one(verify_path, leaves, indices, paths, cap,
                path_len: int) -> bool:
    return all(verify_path(leaf, index, path, cap, path_len=path_len)
               for leaf, index, path in zip(leaves, indices, paths))


def verify_paths_keccak(leaves, indices, paths, cap, path_len: int) -> bool:
    """keccak_host.verify_path of every opening, all true or not."""
    return _one_by_one(keccak_merkle.verify_path, leaves, indices, paths,
                       cap, path_len)


def verify_paths(leaves: list[list[int]], indices: list[int],
                 paths: list[list[list[int]]], cap: list[list[int]],
                 path_len: int) -> bool:
    """host.verify_path of every opening, all true or not: the leaves'
    sponges and each level's compressions are one batch of native
    Poseidon permutations each, not one call a permutation. Openings a
    batch cannot hold (leaves of mixed widths, values outside u64, ragged
    caps) and a host without the native library go one by one."""
    if not leaves:
        return True
    for index, path in zip(indices, paths):
        if len(path) != path_len or index < 0 \
                or index >= len(cap) << path_len \
                or any(len(sib) != 4 for sib in path):
            return False
    if len({len(leaf) for leaf in leaves}) != 1 or not native.available():
        return _one_by_one(host_merkle.verify_path, leaves, indices, paths,
                           cap, path_len)
    try:
        values = np.array(leaves, dtype=np.uint64).reshape(len(leaves), -1)
        sibs = np.array(paths, dtype=np.uint64).reshape(len(leaves),
                                                        path_len, 4)
        caps = np.array(cap, dtype=np.uint64).reshape(len(cap), 4)
    except (OverflowError, TypeError, ValueError):
        return _one_by_one(host_merkle.verify_path, leaves, indices, paths,
                           cap, path_len)
    params = pp.default_params()
    n, width = values.shape
    if width <= 4:                            # hash_or_noop: zero padding
        digests = np.zeros((n, 4), dtype=np.uint64)
        digests[:, :width] = values
    else:                                     # hash_no_pad, rate 8
        state = np.zeros((n, params.width), dtype=np.uint64)
        for off in range(0, width, params.rate):
            chunk = values[:, off:off + params.rate]
            state[:, :chunk.shape[1]] = chunk
            state = native.poseidon_permute_many(state, params)
        digests = state[:, :4]
    idx = np.array(indices, dtype=np.int64)
    for level in range(path_len):
        odd = ((idx >> level) & 1).astype(bool)[:, None]
        state = np.zeros((n, params.width), dtype=np.uint64)
        state[:, :4] = np.where(odd, sibs[:, level], digests)
        state[:, 4:8] = np.where(odd, digests, sibs[:, level])
        digests = native.poseidon_permute_many(state, params)[:, :4]
    return bool(np.array_equal(digests, caps[idx >> path_len]))
