"""Merkle-Patricia trie (partial trie with Hash nodes).

Functional twin of the reference's mpt_trie crate (zk_evm's
mpt_trie/src/{partial_trie,nibbles,trie_ops,trie_hashing,trie_subsets}.rs,
SURVEY.md §2.6): node types Empty/Hash/Branch/Extension/Leaf, insert /
get / delete over nibble keys, keccak+RLP hashing per the yellow paper
(sub-encodings shorter than 32 bytes are inlined), and witness
minimization by replacing off-path subtrees with their hashes — the
subset property (root unchanged) is what block witnesses rely on.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..native import keccak256
from .rlp import rlp_encode

EMPTY_TRIE_HASH = bytes.fromhex(
    "56e81f171bcc55a6ff8345e692c0f86e5b48e01b996cadc001622fb5e363b421")


class Nibbles:
    """A sequence of 4-bit nibbles (most-significant first)."""

    __slots__ = ("nibs",)

    def __init__(self, nibs=()):
        self.nibs = tuple(nibs)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Nibbles":
        out = []
        for b in data:
            out.append(b >> 4)
            out.append(b & 0xF)
        return cls(out)

    @classmethod
    def from_int(cls, value: int, bit_len: int = 256) -> "Nibbles":
        return cls.from_bytes(value.to_bytes(bit_len // 8, "big"))

    def __len__(self):
        return len(self.nibs)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return Nibbles(self.nibs[i])
        return self.nibs[i]

    def __eq__(self, other):
        return self.nibs == other.nibs

    def __add__(self, other):
        return Nibbles(self.nibs + tuple(other.nibs
                                         if isinstance(other, Nibbles)
                                         else other))

    def common_prefix_len(self, other: "Nibbles") -> int:
        n = 0
        for a, b in zip(self.nibs, other.nibs):
            if a != b:
                break
            n += 1
        return n

    def __repr__(self):
        return "Nibbles(" + "".join(f"{x:x}" for x in self.nibs) + ")"


def hex_prefix_encode(nibs: Nibbles, is_leaf: bool) -> bytes:
    """Yellow-paper HP encoding."""
    flag = 2 if is_leaf else 0
    n = list(nibs.nibs)
    if len(n) % 2 == 1:
        first = bytes([((flag + 1) << 4) | n[0]])
        n = n[1:]
    else:
        first = bytes([flag << 4])
    return first + bytes((n[i] << 4) | n[i + 1] for i in range(0, len(n), 2))


# ---------------------------------------------------------------------------
# Nodes
# ---------------------------------------------------------------------------

class Empty:
    pass


@dataclass
class HashNode:
    digest: bytes           # 32 bytes


@dataclass
class Leaf:
    key: Nibbles
    value: bytes


@dataclass
class Extension:
    key: Nibbles
    child: object


@dataclass
class Branch:
    children: list          # 16 entries
    value: bytes


EMPTY = Empty()


class Trie:
    def __init__(self):
        self.root = EMPTY

    # -- queries ----------------------------------------------------------
    def get(self, key: Nibbles):
        return _get(self.root, key)

    def insert(self, key: Nibbles, value: bytes):
        assert value != b"", "empty values not supported"
        self.root = _insert(self.root, key, bytes(value))

    def delete(self, key: Nibbles):
        self.root = _delete(self.root, key)

    def root_hash(self) -> bytes:
        if isinstance(self.root, Empty):
            return EMPTY_TRIE_HASH
        if isinstance(self.root, HashNode):
            return self.root.digest
        return keccak256(_encode(self.root))

    def mask_subtree(self, path: Nibbles):
        """Replace the subtree at `path` by its hash (witness
        minimization; the root hash is unchanged)."""
        self.root = _mask(self.root, path)

    def delete_reporting(self, key: Nibbles):
        """Delete, and if a branch collapsed report the path of the
        sibling that got merged (the reference's
        delete_node_and_report_remaining_key_if_branch_collapsed;
        callers add it to witness masks)."""
        report = []
        self.root = _delete(self.root, key, Nibbles(), report)
        return report[0] if report else None

    def subset(self, keys) -> "Trie":
        """Minimal partial trie containing the given key paths: every
        node on a requested path is kept (terminals in full), all
        side subtrees are hashed out.  Root hash is unchanged
        (mpt_trie::trie_subsets::create_trie_subset)."""
        t = Trie()
        t.root = _subset(self.root, [Nibbles(k) for k in keys])
        return t

    def get_proof(self, key: Nibbles) -> list:
        """Merkle proof for `key`: the RLP encodings of every
        hash-referenced node from the root down the key path
        (eth_getProof's accountProof/storageProof node list; nodes
        inlined in their parent are not repeated)."""
        proof = []
        node, key = self.root, Nibbles(key)
        inlined = False
        while True:
            if isinstance(node, (Empty, HashNode)):
                return proof
            if not inlined:
                proof.append(_encode(node))
            if isinstance(node, Leaf):
                return proof
            if isinstance(node, Extension):
                if key[:len(node.key)] != node.key:
                    return proof
                child, key = node.child, key[len(node.key):]
            else:                                  # Branch
                if len(key) == 0:
                    return proof
                child, key = node.children[key[0]], key[1:]
            inlined = not isinstance(child, (Empty, HashNode)) \
                and len(_encode(child)) < 32
            node = child

    def snapshot(self) -> "Trie":
        """O(1) copy: all node operations are functional."""
        t = Trie()
        t.root = self.root
        return t

    def items(self):
        out = []
        _collect(self.root, Nibbles(), out)
        return out


# ---------------------------------------------------------------------------
# Operations
# ---------------------------------------------------------------------------

def _get(node, key: Nibbles):
    if isinstance(node, Empty):
        return None
    if isinstance(node, HashNode):
        raise KeyError("path crosses a hashed-out subtree")
    if isinstance(node, Leaf):
        return node.value if node.key == key else None
    if isinstance(node, Extension):
        cp = node.key.common_prefix_len(key)
        if cp < len(node.key):
            return None
        return _get(node.child, key[cp:])
    if isinstance(node, Branch):
        if len(key) == 0:
            return node.value or None
        return _get(node.children[key[0]], key[1:])
    raise TypeError(node)


def _insert(node, key: Nibbles, value: bytes):
    if isinstance(node, Empty):
        return Leaf(key, value)
    if isinstance(node, HashNode):
        raise KeyError("cannot insert through a hashed-out subtree")
    if isinstance(node, Leaf):
        if node.key == key:
            return Leaf(key, value)
        return _split(node.key, node.value, key, value)
    if isinstance(node, Extension):
        cp = node.key.common_prefix_len(key)
        if cp == len(node.key):
            return Extension(node.key,
                             _insert(node.child, key[cp:], value))
        # split the extension
        branch = Branch([EMPTY] * 16, b"")
        ext_rest = node.key[cp:]
        inner = node.child if len(ext_rest) == 1 \
            else Extension(ext_rest[1:], node.child)
        branch.children[ext_rest[0]] = inner
        rest = key[cp:]
        if len(rest) == 0:
            branch.value = value
        else:
            branch.children[rest[0]] = Leaf(rest[1:], value)
        if cp == 0:
            return branch
        return Extension(key[:cp], branch)
    if isinstance(node, Branch):
        if len(key) == 0:
            return Branch(list(node.children), value)
        c = list(node.children)
        c[key[0]] = _insert(c[key[0]], key[1:], value)
        return Branch(c, node.value)
    raise TypeError(node)


def _split(k1: Nibbles, v1: bytes, k2: Nibbles, v2: bytes):
    cp = k1.common_prefix_len(k2)
    branch = Branch([EMPTY] * 16, b"")
    for k, v in ((k1[cp:], v1), (k2[cp:], v2)):
        if len(k) == 0:
            branch.value = v
        else:
            branch.children[k[0]] = Leaf(k[1:], v)
    if cp == 0:
        return branch
    return Extension(k1[:cp], branch)


def _delete(node, key: Nibbles, prefix: Nibbles = None, report=None):
    if isinstance(node, Empty):
        return node
    if isinstance(node, HashNode):
        raise KeyError("cannot delete through a hashed-out subtree")
    if isinstance(node, Leaf):
        return EMPTY if node.key == key else node
    if isinstance(node, Extension):
        cp = node.key.common_prefix_len(key)
        if cp < len(node.key):
            return node
        child = _delete(node.child, key[cp:],
                        None if prefix is None else prefix + node.key,
                        report)
        return _normalize_ext(node.key, child)
    if isinstance(node, Branch):
        if len(key) == 0:
            node = Branch(list(node.children), b"")
        else:
            c = list(node.children)
            c[key[0]] = _delete(c[key[0]], key[1:],
                                None if prefix is None
                                else prefix + Nibbles([key[0]]),
                                report)
            node = Branch(c, node.value)
        return _normalize_branch(node, prefix, report)
    raise TypeError(node)


def _normalize_branch(b: Branch, prefix: Nibbles = None, report=None):
    live = [(i, ch) for i, ch in enumerate(b.children)
            if not isinstance(ch, Empty)]
    if len(live) == 0:
        return Leaf(Nibbles(), b.value) if b.value else EMPTY
    if len(live) == 1 and not b.value:
        i, ch = live[0]
        if report is not None and prefix is not None:
            report.append(prefix + Nibbles([i]))
        if isinstance(ch, Leaf):
            return Leaf(Nibbles([i]) + ch.key, ch.value)
        if isinstance(ch, Extension):
            return Extension(Nibbles([i]) + ch.key, ch.child)
        if isinstance(ch, HashNode):
            # reference semantics (mpt_trie OnOrphanedHashNode::
            # CollapseToExtension): assume the hashed-out child is a
            # branch and point an extension at it
            return Extension(Nibbles([i]), ch)
        return Extension(Nibbles([i]), ch)
    return b


def _normalize_ext(key: Nibbles, child):
    if isinstance(child, Empty):
        return EMPTY
    if isinstance(child, Leaf):
        return Leaf(key + child.key, child.value)
    if isinstance(child, Extension):
        return Extension(key + child.key, child.child)
    return Extension(key, child)


def _mask(node, path: Nibbles):
    if len(path) == 0:
        return HashNode(_hash_node(node))
    if isinstance(node, Extension):
        cp = node.key.common_prefix_len(path)
        assert cp == len(node.key), "mask path diverges"
        return Extension(node.key, _mask(node.child, path[cp:]))
    if isinstance(node, Branch):
        c = list(node.children)
        c[path[0]] = _mask(c[path[0]], path[1:])
        return Branch(c, node.value)
    raise KeyError("mask path not found")


def _maybe_hash(node):
    """Hash a subtree out, except short-encoded nodes (their encoding is
    inlined into the parent, so replacing them with a digest would
    change the root) and terminals that are already hashes."""
    if isinstance(node, (Empty, HashNode)):
        return node
    enc = _encode(node)
    if len(enc) < 32:
        return node
    return HashNode(keccak256(enc))


def _subset(node, keys):
    if isinstance(node, (Empty, HashNode)):
        return node
    if not keys:
        return _maybe_hash(node)
    if any(len(k) == 0 for k in keys):
        return node            # path terminates here: keep in full
    if isinstance(node, Leaf):
        return node            # proves presence or absence either way
    if isinstance(node, Extension):
        through = [k[len(node.key):] for k in keys
                   if k.common_prefix_len(node.key) == len(node.key)]
        return Extension(node.key, _subset(node.child, through))
    if isinstance(node, Branch):
        children = [
            _subset(ch, [k[1:] for k in keys if k[0] == i])
            for i, ch in enumerate(node.children)]
        return Branch(children, node.value)
    raise TypeError(node)


def _collect(node, prefix: Nibbles, out):
    if isinstance(node, (Empty, HashNode)):
        return
    if isinstance(node, Leaf):
        out.append((prefix + node.key, node.value))
    elif isinstance(node, Extension):
        _collect(node.child, prefix + node.key, out)
    elif isinstance(node, Branch):
        if node.value:
            out.append((prefix, node.value))
        for i, ch in enumerate(node.children):
            _collect(ch, prefix + Nibbles([i]), out)


# ---------------------------------------------------------------------------
# Hashing (yellow paper c/n functions)
# ---------------------------------------------------------------------------

def _hash_node(node) -> bytes:
    if isinstance(node, HashNode):
        return node.digest
    return keccak256(_encode(node))


def _child_ref(node):
    """n(J): inline encodings shorter than 32 bytes, else keccak."""
    if isinstance(node, Empty):
        return b""
    if isinstance(node, HashNode):
        return node.digest
    enc = _encode(node)
    if len(enc) < 32:
        from .rlp import rlp_decode
        return rlp_decode(enc)      # inline the structure
    return keccak256(enc)


def _encode(node) -> bytes:
    if isinstance(node, Leaf):
        return rlp_encode([hex_prefix_encode(node.key, True), node.value])
    if isinstance(node, Extension):
        return rlp_encode([hex_prefix_encode(node.key, False),
                           _child_ref(node.child)])
    if isinstance(node, Branch):
        return rlp_encode([_child_ref(c) for c in node.children]
                          + [node.value])
    raise TypeError(node)
