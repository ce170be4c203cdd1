"""Merkle tree with caps, built level by level on the tensors' device.

The whole tree is batched hashing: one `hash_rows` over all leaves, then
log2(n) - cap_height `compress` calls, each over a full level. On CUDA the
Poseidon tree's leaf hash is the sponge kernel and every level the permute
kernel; the Keccak tree's (`build_tree_keccak_device`) are both the
keccak256 rows kernel.

Leaf index convention: callers pass leaves in the order they will be opened
(for LDE oracles that is bit-reversed evaluation order, matching the FRI
folding layout; see ntt.lde_bitrev).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..field import GF
from ..hash import poseidon


@dataclass
class MerkleTree:
    """leaves: (n, leaf_len); levels[0] = leaf digests (n, 4), each next
    level halves, levels[-1] = cap (2^cap_height, 4)."""
    leaves: GF
    levels: list[GF]
    cap_height: int

    @property
    def cap(self) -> GF:
        return self.levels[-1]

    def cap_u64(self):
        return self.cap.to_u64()

    def prove(self, index: int) -> list[list[int]]:
        """Merkle path for a leaf: sibling digests bottom-up (host ints),
        stopping at the cap."""
        return self.prove_many([index])[0]

    def prove_many(self, indices) -> list[list[list[int]]]:
        """Merkle paths for many leaves with one batched gather per level
        (the per-query path extraction the FRI prover does for all query
        rounds at once)."""
        idx = np.asarray(indices, dtype=np.int64)
        paths: list[list[list[int]]] = [[] for _ in indices]
        for level in self.levels[:-1]:
            sibs = level.take(idx ^ 1, axis=0).to_u64()
            for q in range(len(paths)):
                paths[q].append([int(x) for x in sibs[q]])
            idx = idx >> 1
        return paths

    def leaves_at(self, indices) -> np.ndarray:
        """Leaf rows at `indices` as a (Q, leaf_len) uint64 array, one
        batched gather."""
        idx = np.asarray(indices, dtype=np.int64)
        return self.leaves.take(idx, axis=0).to_u64()


def _build_levels(leaves: GF, cap_height: int) -> list[GF]:
    levels = [poseidon.hash_rows(leaves)]
    while levels[-1].shape[0] > (1 << cap_height):
        cur = levels[-1]
        levels.append(poseidon.compress(cur[0::2], cur[1::2]))
    return levels


def build_tree(leaves: GF, cap_height: int = 4) -> MerkleTree:
    n = leaves.shape[0]
    assert n & (n - 1) == 0 and n >= (1 << cap_height), (n, cap_height)
    return MerkleTree(leaves, _build_levels(leaves, cap_height), cap_height)


def build_tree_keccak_device(leaves: GF, cap_height: int = 4) -> MerkleTree:
    """Keccak commitment tree on the leaves' device (hash/keccak_device.py):
    the digest law of the host-numpy twin (merkle/keccak_tree.py), the
    MerkleTree interface of the Poseidon tree; the engine of
    StarkConfig.hasher="keccak" (zk_evm's KeccakGoldilocksConfig,
    tests/simple_transfer.rs:24,30)."""
    from ..hash import keccak_device
    n = leaves.shape[0]
    assert n & (n - 1) == 0 and n >= (1 << cap_height), (n, cap_height)
    levels = [keccak_device.hash_rows(leaves)]
    while levels[-1].shape[0] > (1 << cap_height):
        levels.append(keccak_device.compress(levels[-1]))
    return MerkleTree(leaves, levels, cap_height)
