"""Build a partial trie from a collection of Merkle proofs.

Twin of the reference's mpt_trie/src/builder.rs PartialTrieBuilder:
`insert_proof` stores keccak-keyed RLP nodes, `build()` reconstructs
the partial trie top-down from the root hash, leaving unresolved
children as hash nodes. `insert_short_node_variants_from_proof`
(builder.rs:45-86) additionally indexes every key-suffix variant of
extension/leaf nodes so that tries whose short nodes moved between
the pre- and post-state proofs still resolve.
"""

from __future__ import annotations

from ..native import keccak256
from .rlp import rlp_decode, rlp_encode
from .trie import (Branch, Empty, Extension, HashNode, Leaf, Nibbles,
                   Trie, EMPTY_TRIE_HASH, hex_prefix_encode)

EMPTY = Empty()


def _decode_hp(encoded: bytes):
    """Hex-prefix decode -> (nibbles tuple, is_leaf)."""
    flag = encoded[0] >> 4
    nibs = []
    if flag in (1, 3):          # odd length: low nibble of first byte
        nibs.append(encoded[0] & 0xF)
    for b in encoded[1:]:
        nibs.append(b >> 4)
        nibs.append(b & 0xF)
    return tuple(nibs), flag >= 2


class PartialTrieBuilder:
    """Collects proof nodes and reconstructs a partial `Trie`."""

    def __init__(self, root: bytes, nodes: dict | None = None):
        assert len(root) == 32
        self.root = root
        self.nodes: dict[bytes, bytes] = dict(nodes or {})

    def insert_proof(self, proof: list[bytes]) -> None:
        for node in proof:
            self.nodes[keccak256(node)] = bytes(node)

    def insert_short_node_variants_from_proof(self,
                                              proof: list[bytes]) -> None:
        for node in proof:
            items = rlp_decode(node)
            if not isinstance(items, list):
                continue
            if len(items) == 2:
                self._insert_short_node_variants(items)
            elif len(items) == 17:
                for child in items[:16]:
                    if isinstance(child, list) and len(child) == 2:
                        self._insert_short_node_variants(child)

    def _insert_short_node_variants(self, items) -> None:
        """builder.rs:73-86: index the node under every front-truncated
        key suffix (new nodes only — existing entries win)."""
        nibs, is_leaf = _decode_hp(bytes(items[0]))
        nibs = list(nibs)
        while nibs:
            nibs.pop(0)
            enc = rlp_encode([hex_prefix_encode(Nibbles(nibs), is_leaf),
                              bytes(items[1])])
            self.nodes.setdefault(keccak256(enc), enc)

    # ------------------------------------------------------------ build

    def build(self) -> Trie:
        trie = Trie()
        trie.root = self._construct(self.root)
        return trie

    def _construct(self, digest: bytes):
        raw = self.nodes.get(digest)
        if raw is None:
            if digest in (b"\x00" * 32, EMPTY_TRIE_HASH):
                return EMPTY
            return HashNode(digest)
        return self._decode(rlp_decode(raw))

    def _decode(self, items):
        if len(items) == 17:
            children = [self._child(c) for c in items[:16]]
            return Branch(children, bytes(items[16]))
        assert len(items) == 2, f"bad node arity {len(items)}"
        nibs, is_leaf = _decode_hp(bytes(items[0]))
        if is_leaf:
            return Leaf(Nibbles(nibs), bytes(items[1]))
        return Extension(Nibbles(nibs), self._child(items[1]))

    def _child(self, ref):
        if isinstance(ref, list):               # inlined short node
            return self._decode(ref)
        ref = bytes(ref)
        if not ref:
            return EMPTY
        if len(ref) < 32:                       # inlined, re-decode
            return self._decode(rlp_decode(ref))
        return self._construct(ref)

    # -------------------------------------------------------- serialize

    def to_json(self) -> dict:
        """Serializable form for the `separate ... direct` pre-image:
        root hash + the node store (hex)."""
        return {"root": "0x" + self.root.hex(),
                "nodes": ["0x" + n.hex() for n in self.nodes.values()]}

    @classmethod
    def from_json(cls, obj: dict) -> "PartialTrieBuilder":
        b = cls(bytes.fromhex(obj["root"][2:]))
        b.insert_proof([bytes.fromhex(n[2:]) for n in obj["nodes"]])
        return b
