"""Merkle tree with caps, built level by level on the tensors' device.

The whole tree is batched hashing: one `hash_rows` over all leaves, then
log2(n) - cap_height `compress` calls, each over a full level. On CUDA the
Poseidon tree's leaf hash is the sponge kernel and every level the permute
kernel; the Keccak tree's (`build_tree_keccak_device`) are both the
keccak256 rows kernel.

Leaf index convention: callers pass leaves in the order they will be opened
(for LDE oracles that is bit-reversed evaluation order, matching the FRI
folding layout; see ntt.lde_bitrev).

Over a mesh of k = 2^j devices (`parallel.Mesh`), block s of the leaves,
[s n/k, (s+1) n/k), is a whole subtree: each device hashes its block and
compresses its subtree on its own, then the levels are gathered in order
onto the first device, which compresses the top levels down to the cap
(`build_tree_from_blocks`). The tree is the same as on one device.
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


def _poseidon_level(level: GF) -> GF:
    return poseidon.compress(level[0::2], level[1::2])


def _hashers(hasher: str):
    """(leaf hash, one level's compression) of a device tree."""
    if hasher == "poseidon":
        return poseidon.hash_rows, _poseidon_level
    if hasher == "keccak":
        from ..hash import keccak_device
        return keccak_device.hash_rows, keccak_device.compress
    raise ValueError(f'hasher {hasher!r} builds no tree on devices: the '
                     f'"keccak_host" tree is one numpy array on the host, '
                     f'and takes no mesh (use "keccak")')


def build_tree(leaves: GF, cap_height: int = 4) -> MerkleTree:
    return build_tree_from_blocks([leaves], leaves, cap_height, "poseidon")


def build_tree_from_blocks(blocks: list[GF], leaves: GF, cap_height: int = 4,
                           hasher: str = "poseidon") -> MerkleTree:
    """The tree over `leaves` (n, leaf_len) from its row blocks: blocks[s]
    holds rows [s n/k, (s+1) n/k) on its own device, k = len(blocks) a
    power of two. Each block's subtree is built on its device, down to
    one root or to its share of the cap; the levels are gathered in
    order onto `leaves`' device and compressed there down to the cap.
    With one block this is the single-device tree."""
    k = len(blocks)
    n = leaves.shape[0]
    assert k & (k - 1) == 0 and n % k == 0, (n, k)
    assert n & (n - 1) == 0 and n >= (1 << cap_height), (n, cap_height)
    hash_rows, compress = _hashers(hasher)
    shards = [[hash_rows(b)] for b in blocks]
    size = n                       # entries in the current level, all shards
    while size > (1 << cap_height) and size > k:
        for levels in shards:
            levels.append(compress(levels[-1]))
        size //= 2
    dev = leaves.device
    levels = [shards[0][i] if k == 1 else
              GF.concatenate([GF(s[i].v.to(dev)) for s in shards])
              for i in range(len(shards[0]))]
    while levels[-1].shape[0] > (1 << cap_height):
        levels.append(compress(levels[-1]))
    return MerkleTree(leaves, levels, cap_height)


def build_tree_mesh(leaves: GF, mesh, cap_height: int = 4,
                    hasher: str = "poseidon") -> MerkleTree:
    """The tree over `leaves` with its row blocks hashed over `mesh`
    (a power-of-two count of leaves fewer than the mesh uses its first
    n entries); levels and leaves on `mesh[0]`."""
    leaves = GF(leaves.v.to(mesh[0]))
    k = min(len(mesh), leaves.shape[0])
    step = leaves.shape[0] // k
    blocks = [GF(leaves.v[s * step:(s + 1) * step].to(mesh[s]))
              for s in range(k)]
    return build_tree_from_blocks(blocks, leaves, cap_height, hasher)


def build_tree_keccak_device(leaves: GF, cap_height: int = 4) -> MerkleTree:
    """Keccak commitment tree on the leaves' device (hash/keccak_device.py):
    the digest law of the host-numpy twin (merkle/keccak_tree.py), the
    MerkleTree interface of the Poseidon tree; the engine of
    StarkConfig.hasher="keccak" (zk_evm's KeccakGoldilocksConfig,
    tests/simple_transfer.rs:24,30)."""
    return build_tree_from_blocks([leaves], leaves, cap_height, "keccak")
