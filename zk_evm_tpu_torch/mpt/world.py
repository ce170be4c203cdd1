"""Ethereum state wrappers over the MPT: accounts, transactions, receipts.

Functional twin of the reference's evm_arithmetization/src/tries.rs
(StateMpt :?, TransactionTrie :188, ReceiptTrie :233) and the
AccountRlp layout used throughout the kernel: state keys are
keccak(address), account values are RLP([nonce, balance, storage_root,
code_hash]); transaction/receipt tries are keyed by RLP(index).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..native import keccak256
from .rlp import rlp_encode
from .trie import Trie, Nibbles, EMPTY_TRIE_HASH

EMPTY_CODE_HASH = bytes.fromhex(
    "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")


@dataclass
class Account:
    nonce: int = 0
    balance: int = 0
    storage_root: bytes = EMPTY_TRIE_HASH
    code_hash: bytes = EMPTY_CODE_HASH

    def rlp(self) -> bytes:
        return rlp_encode([self.nonce, self.balance, self.storage_root,
                           self.code_hash])


class StateMpt:
    """Account trie keyed by keccak(address)."""

    def __init__(self):
        self.trie = Trie()
        self.storage: dict[bytes, Trie] = {}   # state key -> storage trie

    @staticmethod
    def state_key(address: bytes) -> bytes:
        assert len(address) == 20
        return keccak256(address)

    def set_account(self, address: bytes, account: Account):
        self.trie.insert(Nibbles.from_bytes(self.state_key(address)),
                         account.rlp())

    def set_storage(self, address: bytes, slot: int, value: int):
        key = self.state_key(address)
        st = self.storage.setdefault(key, Trie())
        slot_key = keccak256(slot.to_bytes(32, "big"))
        if value == 0:
            st.delete(Nibbles.from_bytes(slot_key))
        else:
            st.insert(Nibbles.from_bytes(slot_key), rlp_encode(value))

    def storage_root(self, address: bytes) -> bytes:
        st = self.storage.get(self.state_key(address))
        return st.root_hash() if st else EMPTY_TRIE_HASH

    def root(self) -> bytes:
        return self.trie.root_hash()


class TransactionTrie:
    """Keyed by RLP(txn index); values are the raw signed transactions."""

    def __init__(self):
        self.trie = Trie()

    def insert(self, index: int, raw_txn: bytes):
        self.trie.insert(Nibbles.from_bytes(rlp_encode(index)), raw_txn)

    def root(self) -> bytes:
        return self.trie.root_hash()


class ReceiptTrie:
    def __init__(self):
        self.trie = Trie()

    def insert(self, index: int, receipt_rlp: bytes):
        self.trie.insert(Nibbles.from_bytes(rlp_encode(index)),
                         receipt_rlp)

    def root(self) -> bytes:
        return self.trie.root_hash()
