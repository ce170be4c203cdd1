"""Keccak Merkle commitment trees (batch host path).

The committed-oracle twin for the Keccak hasher config: same digest law
as merkle/keccak_host.py (leaf = keccak256 of le64-packed values with
limbs reduced into GF, hash_or_noop identity for <=4-element leaves,
inner = keccak256(left || right)), built level-batched with the
vectorized keccak (hash/keccak_np.py). Mirrors the reference's
KeccakGoldilocksConfig commitment trees (plonky2 config; used as the
outer config of every evm_arithmetization integration test, e.g.
tests/simple_transfer.rs:24,30). Interface-compatible with
merkle.tree.MerkleTree (cap_u64 / prove_many / leaves_at), so
PolynomialBatch and FRI swap it in per StarkConfig.hasher.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..field import host
from ..hash.keccak_np import keccak256_batch

_P = np.uint64(host.P)


def _digest_reduce(raw: np.ndarray) -> np.ndarray:
    """(k, 32) u8 keccak digests -> (k, 4) u64 limbs reduced mod p
    (keccak_host._to_digest law)."""
    limbs = raw.view("<u8").reshape(-1, 4).copy()
    hi = limbs >= _P
    limbs[hi] -= _P
    return limbs


def _hash_leaves(leaves: np.ndarray) -> np.ndarray:
    n, width = leaves.shape
    if width <= 4:
        out = np.zeros((n, 4), dtype=np.uint64)
        out[:, :width] = leaves
        return out
    return _digest_reduce(keccak256_batch(
        np.ascontiguousarray(leaves).view(np.uint8).reshape(n, width * 8)))


def _compress(level: np.ndarray) -> np.ndarray:
    pairs = level.reshape(-1, 8)
    return _digest_reduce(keccak256_batch(pairs.view(np.uint8)
                                          .reshape(-1, 64)))


@dataclass
class KeccakMerkleTree:
    """Same shape contract as merkle.tree.MerkleTree, host numpy data."""
    leaves: np.ndarray                 # (n, leaf_len) uint64
    levels: list[np.ndarray]           # [0] = leaf digests, [-1] = cap
    cap_height: int

    def cap_u64(self) -> np.ndarray:
        return self.levels[-1]

    def cap_ints(self) -> list[list[int]]:
        return [[int(x) for x in row] for row in self.levels[-1]]

    def prove(self, index: int) -> list[list[int]]:
        return self.prove_many([index])[0]

    def prove_many(self, indices) -> list[list[list[int]]]:
        idx = np.asarray(indices, dtype=np.int64)
        paths: list[list[list[int]]] = [[] for _ in indices]
        for level in self.levels[:-1]:
            sibs = level[idx ^ 1]
            for q in range(len(paths)):
                paths[q].append([int(x) for x in sibs[q]])
            idx = idx >> 1
        return paths

    def leaves_at(self, indices) -> np.ndarray:
        idx = np.asarray(indices, dtype=np.int64)
        return self.leaves[idx]


def build_tree_keccak(leaves: np.ndarray, cap_height: int = 4
                      ) -> KeccakMerkleTree:
    leaves = np.ascontiguousarray(leaves, dtype=np.uint64)
    n = leaves.shape[0]
    assert n & (n - 1) == 0 and n >= (1 << cap_height), (n, cap_height)
    levels = [_hash_leaves(leaves)]
    while levels[-1].shape[0] > (1 << cap_height):
        levels.append(_compress(levels[-1]))
    return KeccakMerkleTree(leaves, levels, cap_height)
