"""Sparse Merkle tree over Poseidon (the Hermez/cdk-erigon type-2 state).

Functional twin of the reference's smt_trie crate (zk_evm's
smt_trie/src/{smt,keys,utils,bits}.rs, SURVEY.md §2.6): 4-field-element
keys whose bits interleave into the tree path, leaves hashed as
Poseidon(rem_key || value_hash; capacity [1,0,0,0]), internal nodes as
Poseidon(left || right; capacity 0), zero root for the empty tree, and
account keys derived by Poseidon over (address, key-type, slot-capacity).

Representation: a canonical kv-map; the root is computed recursively
(leaves sit at the minimal distinguishing depth — the same canonical
shape the reference maintains incrementally). Hash-capped subtrees
(witness minimization) are stored by bit-path.

Note on constants: the permutation is this repo's Poseidon instance
(hash/poseidon_params.py); the reference's HASH_ZEROS etc. are the same
formulas evaluated under plonky2's round constants.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

from ..hash import host_poseidon as hp

U256_MASK = (1 << 256) - 1


def _poseidon_first4(inputs12):
    return tuple(hp.permute(list(inputs12))[:4])


def hash0(x8):
    """Poseidon(x, capacity [0,0,0,0]) -> first 4 elements."""
    return _poseidon_first4(list(x8) + [0, 0, 0, 0])


def hash1(x8):
    """Poseidon(x, capacity [1,0,0,0]) -> first 4 elements."""
    return _poseidon_first4(list(x8) + [1, 0, 0, 0])


@lru_cache(maxsize=1)
def hash_zeros():
    return hash0([0] * 8)


@dataclass(frozen=True)
class Key:
    limbs: tuple      # 4 u64 field elements

    def bit(self, t: int) -> int:
        """Path bit t: bits of the four limbs interleaved."""
        return (self.limbs[t % 4] >> (t // 4)) & 1

    def remove_bits(self, nbits: int) -> "Key":
        full = nbits // 4
        rem = []
        for i in range(4):
            n = full + (1 if full * 4 + i < nbits else 0)
            rem.append(self.limbs[i] >> n)
        return Key(tuple(rem))


def _value_limbs(value: int):
    return [(value >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


def _addr_words(address: bytes):
    assert len(address) == 20
    return [int.from_bytes(address[16 - 4 * i:20 - 4 * i], "big")
            for i in range(5)]


def _key_of_type(address: bytes, key_type: int, capacity=None) -> Key:
    arr = [0] * 12
    arr[0:5] = _addr_words(address)
    arr[6] = key_type
    arr[8:12] = list(capacity if capacity is not None else hash_zeros())
    return Key(_poseidon_first4(arr))


def key_balance(address: bytes) -> Key:
    return _key_of_type(address, 0)


def key_nonce(address: bytes) -> Key:
    return _key_of_type(address, 1)


def key_code(address: bytes) -> Key:
    return _key_of_type(address, 2)


def key_storage(address: bytes, slot: int) -> Key:
    cap = _poseidon_first4(_value_limbs(slot) + [0, 0, 0, 0])
    return _key_of_type(address, 3, cap)


def key_code_length(address: bytes) -> Key:
    return _key_of_type(address, 4)


# node type tags in the serialized format (smt.rs:18-20)
HASH_TYPE = 0
INTERNAL_TYPE = 1
LEAF_TYPE = 2


def _pack4(limbs) -> int:
    """4 u64 limbs -> u256 (key2u/hashout2u packing)."""
    return sum(int(x) << (64 * i) for i, x in enumerate(limbs))


def _unpack4(v: int) -> tuple:
    return tuple((v >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(4))


def hash_serialize(v: list[int], ptr: int = 2) -> tuple:
    """Recompute the root digest of a serialized (possibly pruned) SMT
    (smt.rs:508-546) — the verifier-side cross-check that the kernel
    format commits to the same tree."""
    tag = v[ptr]
    if tag == HASH_TYPE:
        return _unpack4(v[ptr + 1])
    if tag == INTERNAL_TYPE:
        parts = []
        for b in range(2):
            child = v[ptr + 1 + b]
            if child == 0:
                parts += [0, 0, 0, 0]
            else:
                parts += list(hash_serialize(v, int(child)))
        return hash0(parts)
    if tag == LEAF_TYPE:
        rem_key = _unpack4(v[ptr + 1])
        value_h = hash0(_value_limbs(v[ptr + 2]))
        return hash1(list(rem_key) + list(value_h))
    raise ValueError(f"bad node tag {tag} at ptr {ptr}")


def hash_serialize_u256(v: list[int]) -> int:
    return _pack4(hash_serialize(v))


class Smt:
    def __init__(self):
        self.kv: dict[Key, int] = {}
        self.hash_nodes: dict[tuple, tuple] = {}   # bit-path -> digest4

    def set(self, key: Key, value: int):
        value &= U256_MASK
        if value == 0:
            self.kv.pop(key, None)
        else:
            self.kv[key] = value

    def get(self, key: Key) -> int:
        return self.kv.get(key, 0)

    def set_hash(self, path_bits: tuple, digest: tuple):
        """Cap the subtree at `path_bits` with a known digest (witness
        subtrees; no kv key may descend into it)."""
        self.hash_nodes[tuple(path_bits)] = tuple(digest)

    def root(self) -> tuple:
        keys = list(self.kv.items())
        return self._root_rec(keys, ())

    def root_u256(self) -> int:
        r = self.root()
        return sum(x << (64 * i) for i, x in enumerate(r))

    def _root_rec(self, items, path):
        if path in self.hash_nodes:
            assert not items, "kv key descends into a hashed-out subtree"
            return self.hash_nodes[path]
        has_caps = any(p[:len(path)] == path for p in self.hash_nodes)
        if not items and not has_caps:
            return (0, 0, 0, 0)
        d = len(path)
        if len(items) == 1 and not has_caps:
            key, value = items[0]
            rem = key.remove_bits(d)
            vhash = hash0(_value_limbs(value))
            return hash1(list(rem.limbs) + list(vhash))
        left = [(k, v) for k, v in items if k.bit(d) == 0]
        right = [(k, v) for k, v in items if k.bit(d) == 1]
        lh = self._root_rec(left, path + (0,))
        rh = self._root_rec(right, path + (1,))
        return hash0(list(lh) + list(rh))

    # ------------------------------------------------------------------
    # Kernel memory format (smt_trie/src/smt.rs:404-506)
    # ------------------------------------------------------------------
    def serialize_and_prune(self, keys=None) -> list[int]:
        """Serialize the SMT into the kernel's TrieData format, hashing
        out every subtree not on the path of one of `keys`
        (smt.rs:415-439). Starts with [0, 0] so ptr=0 is the canonical
        empty node; the root lands at ptr=2. Node encodings:
        HASH [0, digest_u256], INTERNAL [1, left_ptr, right_ptr],
        LEAF [2, rem_key_u256, value]."""
        if keys is None:
            keys = list(self.kv.keys())
        include: set[tuple] = set()
        for k in keys:
            bits = tuple(k.bit(t) for t in range(256))
            for i in range(257):
                include.add(bits[:i])
        v = [0, 0]
        self._serialize(list(self.kv.items()), (), v, include)
        if len(v) == 2:
            v.extend([0, 0])
        return v

    def serialize(self) -> list[int]:
        """Serialize with every key included (smt.rs:441-444)."""
        return self.serialize_and_prune(list(self.kv.keys()))

    def _serialize(self, items, path, v, include) -> int:
        digest = self._root_rec(items, path)
        if digest == (0, 0, 0, 0):
            return 0
        d = len(path)
        pruned = path not in include or path in self.hash_nodes
        if pruned:
            idx = len(v)
            v.append(HASH_TYPE)
            v.append(_pack4(digest))
            return idx
        has_caps = any(p[:d] == path for p in self.hash_nodes if p != path)
        if len(items) == 1 and not has_caps:
            key, value = items[0]
            idx = len(v)
            v.append(LEAF_TYPE)
            v.append(_pack4(key.remove_bits(d).limbs))
            v.append(value)
            return idx
        idx = len(v)
        v.extend([INTERNAL_TYPE, 0, 0])
        left = [(k, val) for k, val in items if k.bit(d) == 0]
        right = [(k, val) for k, val in items if k.bit(d) == 1]
        v[idx + 1] = self._serialize(left, path + (0,), v, include)
        v[idx + 2] = self._serialize(right, path + (1,), v, include)
        return idx
