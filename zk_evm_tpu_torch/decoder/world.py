"""Mutable type-1 world: account + storage ops over partial tries.

Behavioral twin of the reference's Type1World (evm_arithmetization/src/
world.rs:118-270): accounts live in the state trie keyed by
keccak(address); each account's storage trie is kept alongside and its
root reconciled into the account RLP after every storage write
(on_storage, world.rs:155-169).  Slot keys are keccak(slot_be32); slot
values are RLP(minimal-int).
"""

from __future__ import annotations

from ..native import keccak256
from ..mpt.rlp import rlp_encode, rlp_decode
from ..mpt.trie import Trie, Nibbles, HashNode, EMPTY_TRIE_HASH
from ..mpt.world import Account
from .type1 import Type1Frontend

BEACON_ROOTS_ADDRESS = bytes.fromhex(
    "000f3df6d732807ef1319fb7b8bb8522d0beac02")
HISTORY_BUFFER_LENGTH = 8191


def _decode_account(raw: bytes) -> Account:
    nonce, balance, storage_root, code_hash = rlp_decode(raw)
    return Account(nonce=int.from_bytes(nonce, "big"),
                   balance=int.from_bytes(balance, "big"),
                   storage_root=storage_root, code_hash=code_hash)


class Type1World:
    """State + per-account storage tries with reference delta semantics."""

    def __init__(self, frontend: Type1Frontend):
        # snapshot: the world mutates its tries; the caller's frontend
        # (e.g. a reusable BlockProverInput) must stay untouched
        self.state = frontend.state.snapshot()
        self.storage = {h: t.snapshot()
                        for h, t in frontend.storage.items()}
        self.code = dict(frontend.code)
        # accounts present in the trie but with no storage entry get a
        # root-only (hash-capped) storage trie (world.rs:127-139)
        for key, raw in self.state.items():
            acct = _decode_account(raw)
            haddr = bytes((key[i] << 4) | key[i + 1]
                          for i in range(0, 64, 2))
            if haddr not in self.storage:
                t = Trie()
                if acct.storage_root != EMPTY_TRIE_HASH:
                    t.root = HashNode(acct.storage_root)
                self.storage[haddr] = t

    # -- account access ---------------------------------------------------

    @staticmethod
    def _haddr(address: bytes) -> bytes:
        return keccak256(address)

    def _get(self, address: bytes):
        raw = self.state.get(Nibbles.from_bytes(self._haddr(address)))
        return _decode_account(raw) if raw is not None else None

    def _put(self, address: bytes, acct: Account):
        self.state.insert(Nibbles.from_bytes(self._haddr(address)),
                          acct.rlp())

    def contains(self, address: bytes) -> bool:
        return self._get(address) is not None

    def update_balance(self, address: bytes, f):
        acct = self._get(address) or Account()
        acct.balance = f(acct.balance)
        self._put(address, acct)

    def update_nonce(self, address: bytes, f):
        acct = self._get(address) or Account()
        acct.nonce = f(acct.nonce)
        self._put(address, acct)

    def set_code(self, address: bytes, code: bytes = None,
                 code_hash: bytes = None):
        acct = self._get(address) or Account()
        if code is not None:
            code_hash = keccak256(code)
            self.code[code_hash] = code
        acct.code_hash = code_hash
        self._put(address, acct)

    def destroy_account(self, address: bytes):
        """Delete the account; returns the collapsed-sibling path (to be
        added to witness masks) if a branch collapsed."""
        return self.state.delete_reporting(
            Nibbles.from_bytes(self._haddr(address)))

    # -- storage ----------------------------------------------------------

    def create_storage(self, address: bytes):
        self.storage[self._haddr(address)] = Trie()

    def destroy_storage(self, address: bytes):
        self.storage.pop(self._haddr(address), None)

    def _on_storage(self, address: bytes, f):
        """Run f on the storage trie, then reconcile the account's
        storage_root (world.rs:155-169)."""
        haddr = self._haddr(address)
        st = self.storage.get(haddr)
        if st is None:
            raise KeyError(f"no storage for {address.hex()}")
        f(st)
        raw = self.state.get(Nibbles.from_bytes(haddr))
        if raw is None:
            raise KeyError(f"no account for {address.hex()}")
        acct = _decode_account(raw)
        acct.storage_root = st.root_hash()
        self.state.insert(Nibbles.from_bytes(haddr), acct.rlp())

    @staticmethod
    def _slot_key(slot: int) -> Nibbles:
        return Nibbles.from_bytes(keccak256(slot.to_bytes(32, "big")))

    def store_int(self, address: bytes, slot: int, value: int):
        self._on_storage(address, lambda st: st.insert(
            self._slot_key(slot), rlp_encode(value)))

    def load_int(self, address: bytes, slot: int) -> int:
        st = self.storage[self._haddr(address)]
        raw = st.get(self._slot_key(slot))
        return int.from_bytes(raw, "big") if raw else 0

    def destroy_slot(self, address: bytes, slot: int):
        """Delete a slot; returns the collapsed-sibling path if a
        branch collapsed (reference reporting_destroy_slot)."""
        report = []
        self._on_storage(address, lambda st: report.append(
            st.delete_reporting(self._slot_key(slot))))
        return report[0]

    def root(self) -> bytes:
        return self.state.root_hash()
