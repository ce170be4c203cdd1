"""Type-2 (SMT / hermez cdk-erigon) witness frontend.

Behavioral twin of the reference's trace_decoder/src/type2.rs:
fold1() :78-106 (instructions are a PRE-ORDER traversal of a binary
tree; Branch mask 0b01=left-only, 0b10=right-only, 0b11=both; Code
instructions are filtered out-of-band), visit() :114-173 (collate the
SmtLeaf field writes per address, record Hash caps by bit path) and
world.rs:390-455 (Type2World -> smt).

Root hashes use this repo's Poseidon instance (see smt/smt.py's
constants note) — structurally identical to the reference, not
bit-exact with plonky2's round-constant tables.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..native import keccak256
from ..smt.smt import (Smt, key_balance, key_nonce, key_code,
                       key_code_length, key_storage)
from .wire import Instruction, parse_wire


class Type2Error(ValueError):
    pass


_LEAF_FIELDS = {0: "balance", 1: "nonce", 2: "code_hash", 4: "code_length"}


@dataclass
class Type2Entry:
    """Collated per-address writes (world.rs:380-387); fields stay None
    when the witness doesn't encode them."""
    balance: int = None
    nonce: int = None
    code_hash: int = None
    code_length: int = None
    storage: dict = field(default_factory=dict)


@dataclass
class Type2Frontend:
    accounts: dict = field(default_factory=dict)   # address20 -> Type2Entry
    hashes: dict = field(default_factory=dict)     # bit-path tuple -> digest
    code: dict = field(default_factory=dict)       # keccak(code) -> bytes

    def as_smt(self) -> Smt:
        """Replay collated writes into the SMT (world.rs:398-445)."""
        smt = Smt()
        for path, h in self.hashes.items():
            digest = tuple(int.from_bytes(h[24 - 8 * i:32 - 8 * i], "big")
                           for i in range(4))
            smt.set_hash(path, digest)
        for addr, e in self.accounts.items():
            for value, key_fn in ((e.balance, key_balance),
                                  (e.nonce, key_nonce),
                                  (e.code_hash, key_code),
                                  (e.code_length, key_code_length)):
                if value is not None:
                    smt.set(key_fn(addr), value)
            for slot, value in e.storage.items():
                smt.set(key_storage(addr, slot), value)
        return smt

    def state_root(self) -> int:
        return self.as_smt().root_u256()


def type2_frontend(data_or_instructions) -> Type2Frontend:
    ins = (parse_wire(data_or_instructions)
           if isinstance(data_or_instructions, (bytes, bytearray))
           else list(data_or_instructions))
    fe = Type2Frontend()
    body = []
    for i in ins:                       # Code is summarized out-of-band
        if i.op == "code":
            fe.code[keccak256(i.value)] = i.value
        else:
            body.append(i)
    it = iter(body)
    _fold1(it, (), fe)
    leftover = sum(1 for _ in it)
    if leftover:
        raise Type2Error(f"{leftover} leftover instructions")
    return fe


def _fold1(it, path: tuple, fe: Type2Frontend):
    """Consume one pre-order subtree rooted at `path`."""
    try:
        ins = next(it)
    except StopIteration:
        raise Type2Error("no instructions to fold")
    if ins.op == "hash":
        fe.hashes[path] = ins.value
    elif ins.op == "branch":
        if ins.mask == 0b01:
            _fold1(it, path + (0,), fe)
        elif ins.mask == 0b10:
            _fold1(it, path + (1,), fe)
        elif ins.mask == 0b11:
            _fold1(it, path + (0,), fe)
            _fold1(it, path + (1,), fe)
        else:
            raise Type2Error(f"unexpected branch mask {ins.mask:#b}")
    elif ins.op == "smt_leaf":
        _collate(ins, fe)
    else:
        raise Type2Error(f"expected SmtLeaf | Branch | Hash, got {ins.op}")


def _collate(ins: Instruction, fe: Type2Frontend):
    if len(ins.smt_address) != 20:
        raise Type2Error("smt leaf address must be 20 bytes")
    if len(ins.value) > 32:
        raise Type2Error("smt leaf value exceeds 32 bytes")
    entry = fe.accounts.setdefault(ins.smt_address, Type2Entry())
    value = int.from_bytes(ins.value, "big")
    t = ins.smt_node_type
    if t in _LEAF_FIELDS:
        name = _LEAF_FIELDS[t]
        if getattr(entry, name) is not None:
            raise Type2Error(f"double write of {name}")
        setattr(entry, name, value)
    elif t == 3:
        if len(ins.smt_slot) > 32:
            raise Type2Error("smt slot exceeds 32 bytes")
        slot = int.from_bytes(ins.smt_slot, "big")
        if slot in entry.storage:
            raise Type2Error("double write of storage slot")
        entry.storage[slot] = value
    else:
        raise Type2Error(f"unknown smt leaf type {t}")
