"""Type-1 (MPT) witness frontend: instruction stream -> partial tries.

Behavioral twin of the reference's trace_decoder/src/type1.rs:
execute() :236-349 (the stack machine — Branch pops its set-mask
children highest index first; AccountLeaf pops (code, storage) in that
order) and visit()/node2storagetrie() :49-163 (folding the execution
tree into state + storage tries, hashing code, RLP-wrapping storage
values).  Instead of replaying inserts we build our mpt.Trie node
structure directly — the execution tree *is* the partial trie.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..native import keccak256
from ..mpt.rlp import rlp_encode
from ..mpt.trie import (Trie, Nibbles, Empty, EMPTY, HashNode, Leaf,
                        Extension, Branch)
from ..mpt.world import Account
from .wire import Instruction, parse_wire


class Type1Error(ValueError):
    pass


# Execution-tree nodes (code/account only exist pre-fold).
@dataclass
class _Code:
    code: bytes


@dataclass
class _AccountNode:
    key: tuple
    nonce: int
    balance: int
    storage: object          # execution node or None
    code: object             # _Code | HashNode | None


def execute(instructions: list[Instruction]) -> list:
    """Stack machine -> one execution tree per NewTrie-delimited witness
    (type1.rs:236-349)."""
    witnesses, stack = [], []

    def pop(what):
        if not stack:
            raise Type1Error(f"no node on stack for {what}")
        return stack.pop()

    for ins in instructions:
        if ins.op == "empty":
            stack.append(EMPTY)
        elif ins.op == "hash":
            stack.append(HashNode(ins.value))
        elif ins.op == "code":
            stack.append(_Code(ins.value))
        elif ins.op == "leaf":
            stack.append(Leaf(Nibbles(ins.key), ins.value))
        elif ins.op == "ext":
            stack.append(Extension(Nibbles(ins.key), pop("extension")))
        elif ins.op == "account":
            code = storage = None
            if ins.has_storage:
                storage = pop("account storage")
            if ins.has_code:
                code = pop("account code")
                if not isinstance(code, (_Code, HashNode)):
                    raise Type1Error("expected Code|Hash for account leaf")
            stack.append(_AccountNode(ins.key, ins.nonce, ins.balance,
                                      storage, code))
        elif ins.op == "branch":
            children = [EMPTY] * 16
            if ins.mask >> 16:
                raise Type1Error("oob mask bit for branch")
            for ix in reversed(range(16)):
                if (ins.mask >> ix) & 1:
                    children[ix] = pop("branch")
            stack.append(Branch(children, b""))
        elif ins.op == "new_trie":
            witnesses.append(_finish(stack))
        elif ins.op == "smt_leaf":
            raise Type1Error("SmtLeaf in a type-1 witness")
        else:
            raise Type1Error(f"unknown instruction {ins.op}")
    witnesses.append(_finish(stack))
    return witnesses


def _finish(stack):
    if len(stack) != 1:
        raise Type1Error(f"expected 1 node on stack, got {len(stack)}")
    node = stack.pop()
    if isinstance(node, _Code):
        raise Type1Error("dangling code node at top of stack")
    return node


@dataclass
class Type1Frontend:
    """Decoded pre-state: hashed-keyed partial state trie, per-account
    storage tries (keyed by the 64-nibble hashed address), contract
    code by hash."""
    state: Trie = field(default_factory=Trie)
    storage: dict = field(default_factory=dict)   # hashed addr -> Trie
    code: dict = field(default_factory=dict)      # keccak(code) -> bytes

    def state_root(self) -> bytes:
        return self.state.root_hash()


def type1_frontend(data_or_instructions) -> Type1Frontend:
    """Wire bytes (or parsed instructions) -> Type1Frontend
    (type1.rs:27-47)."""
    ins = (parse_wire(data_or_instructions)
           if isinstance(data_or_instructions, (bytes, bytearray))
           else list(data_or_instructions))
    trees = execute(ins)
    if len(trees) != 1:
        raise Type1Error("only a single execution is supported")
    fe = Type1Frontend()
    fe.state.root = _fold_state(trees[0], (), fe)
    return fe


def _fold_state(node, path: tuple, fe: Type1Frontend):
    """Execution tree -> state-trie node; collects storage/code
    (type1.rs:49-120)."""
    if isinstance(node, (Empty, HashNode)):
        return node
    if isinstance(node, _Code):
        fe.code[keccak256(node.code)] = node.code
        return EMPTY
    if isinstance(node, Extension):
        return Extension(node.key,
                         _fold_state(node.child, path + tuple(node.key),
                                     fe))
    if isinstance(node, Branch):
        return Branch([_fold_state(c, path + (ix,), fe)
                       for ix, c in enumerate(node.children)], b"")
    if isinstance(node, _AccountNode):
        full_key = path + node.key
        if len(full_key) != 64:
            raise Type1Error("account leaf not at depth 64")
        storage_trie = Trie()
        if node.storage is not None:
            storage_trie.root = _fold_storage(node.storage)
        hashed_addr = bytes(
            (full_key[i] << 4) | full_key[i + 1] for i in range(0, 64, 2))
        if hashed_addr in fe.storage:
            raise Type1Error("duplicate storage")
        fe.storage[hashed_addr] = storage_trie
        if isinstance(node.code, _Code):
            code_hash = keccak256(node.code.code)
            fe.code[code_hash] = node.code.code
        elif isinstance(node.code, HashNode):
            code_hash = node.code.digest
        else:
            code_hash = keccak256(b"")
        acct = Account(nonce=node.nonce, balance=node.balance,
                       storage_root=storage_trie.root_hash(),
                       code_hash=code_hash)
        return Leaf(Nibbles(node.key), acct.rlp())
    if isinstance(node, Leaf):
        raise Type1Error("bare value leaf in state trie")
    raise Type1Error(f"unexpected node {type(node).__name__}")


def _fold_storage(node):
    """Execution tree -> storage-trie node; raw values get RLP-wrapped
    (type1.rs:123-163)."""
    if isinstance(node, (Empty, HashNode)):
        return node
    if isinstance(node, Leaf):
        return Leaf(node.key, rlp_encode(node.value))
    if isinstance(node, Extension):
        return Extension(node.key, _fold_storage(node.child))
    if isinstance(node, Branch):
        return Branch([_fold_storage(c) for c in node.children], b"")
    raise Type1Error(
        f"unexpected node {type(node).__name__} in storage trie")
