"""Block prover input: the JSON surface the proving pipeline consumes.

Behavioral twin of the reference's trace_decoder/src/interface.rs
(BlockTrace :22-35, TxnInfo :85-114, TxnTrace :121-154,
ContractCodeUsage :157-164) plus zero's BlockProverInput { block_trace,
other_data } wrapper and core.rs:787-794 (map_receipt_bytes: legacy
receipts are stored raw, typed receipts arrive RLP-string-wrapped and
are unwrapped before insertion).  Parses artifacts like
artifacts/witness_b1033.json into our decoder/trie/public-value types.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..mpt.rlp import rlp_decode
from ..mpt.world import TransactionTrie, ReceiptTrie
from ..stark.public_values import (BlockMetadata, BlockHashes,
                                   ExtraBlockData, TrieRoots)
from .type1 import Type1Frontend, type1_frontend


def _int(v) -> int:
    if isinstance(v, str):
        return int(v, 16) if v.startswith("0x") else int(v)
    return int(v)


def _bytes(v: str) -> bytes:
    s = v[2:] if v.startswith("0x") else v
    return bytes.fromhex("0" * (len(s) % 2) + s)


def _h256(v: str) -> bytes:
    return _bytes(v).rjust(32, b"\x00")


@dataclass
class TxnTraceDelta:
    """Per-account state delta for one transaction."""
    balance: int = None
    nonce: int = None
    storage_read: list = field(default_factory=list)      # hashed slots
    storage_written: dict = field(default_factory=dict)   # hashed -> value
    code_read: bytes = None                               # code hash
    code_written: bytes = None                            # full code
    self_destructed: bool = False

    @classmethod
    def from_json(cls, d: dict) -> "TxnTraceDelta":
        out = cls()
        if "balance" in d:
            out.balance = _int(d["balance"])
        if "nonce" in d:
            out.nonce = _int(d["nonce"])
        out.storage_read = [_h256(h) for h in d.get("storage_read", [])]
        out.storage_written = {_h256(k): _int(v) for k, v in
                               d.get("storage_written", {}).items()}
        cu = d.get("code_usage")
        if cu:
            if "read" in cu:
                out.code_read = _h256(cu["read"])
            if "write" in cu:
                out.code_written = _bytes(cu["write"])
        out.self_destructed = bool(d.get("self_destructed", False))
        return out


@dataclass
class TxnInfo:
    traces: dict                  # address20 -> TxnTraceDelta
    byte_code: bytes              # raw signed txn (the txn-trie value)
    receipt_node_bytes: bytes     # receipt-trie value (already unwrapped)
    gas_used: int

    @classmethod
    def from_json(cls, d: dict) -> "TxnInfo":
        m = d["meta"]
        return cls(
            traces={_bytes(a).rjust(20, b"\x00"):
                    TxnTraceDelta.from_json(t)
                    for a, t in d.get("traces", {}).items()},
            byte_code=_bytes(m["byte_code"]),
            receipt_node_bytes=map_receipt_bytes(
                _bytes(m["new_receipt_trie_node_byte"])),
            gas_used=_int(m["gas_used"]))


def map_receipt_bytes(raw: bytes) -> bytes:
    """Legacy receipts (an RLP list) pass through; typed receipts arrive
    wrapped in an RLP byte string and are unwrapped (core.rs:787-794)."""
    try:
        decoded = rlp_decode(raw)
    except Exception:
        return raw
    return decoded if isinstance(decoded, (bytes, bytearray)) else raw


@dataclass
class BlockProverInput:
    pre_state: Type1Frontend
    code_db: dict                 # keccak -> code (witness + code_db)
    txn_info: list                # [TxnInfo]
    block_metadata: BlockMetadata
    block_hashes: BlockHashes
    checkpoint_state_trie_root: bytes
    checkpoint_consolidated_hash: tuple
    withdrawals: list             # [(address20, amount)]

    def initial_extra_data(self) -> ExtraBlockData:
        return ExtraBlockData(
            checkpoint_state_trie_root=self.checkpoint_state_trie_root,
            checkpoint_consolidated_hash=self.checkpoint_consolidated_hash)

    def trie_roots_before(self) -> TrieRoots:
        return TrieRoots(state_root=self.pre_state.state_root())

    def txn_receipt_tries(self):
        """Fold every txn's trie values -> (TransactionTrie, ReceiptTrie)."""
        txns, receipts = TransactionTrie(), ReceiptTrie()
        for ix, t in enumerate(self.txn_info):
            txns.insert(ix, t.byte_code)
            receipts.insert(ix, t.receipt_node_bytes)
        return txns, receipts


def parse_block_prover_input(obj: dict) -> BlockProverInput:
    """One element of the artifact JSON array -> BlockProverInput."""
    bt, od = obj["block_trace"], obj["other_data"]
    pre_images = bt["trie_pre_images"]
    if "combined" in pre_images:
        pre_state = type1_frontend(_bytes(pre_images["combined"]
                                          ["compact"]))
    else:
        # Separate pre-images (trace_decoder/src/interface.rs
        # BlockTraceTriePreImages::Separate): state + per-account
        # storage tries given as proof-node stores (mpt.builder).
        from ..mpt.builder import PartialTrieBuilder
        from .type1 import Type1Frontend
        sep = pre_images["separate"]
        pre_state = Type1Frontend()
        pre_state.state = PartialTrieBuilder.from_json(
            sep["state"]["direct"]).build()
        for haddr, t in sep.get("storage", {}).items():
            pre_state.storage[_h256(haddr)] = \
                PartialTrieBuilder.from_json(t["direct"]).build()
    code_db = dict(pre_state.code)
    from ..native import keccak256
    for c in bt.get("code_db", []):
        code = _bytes(c)
        code_db[keccak256(code)] = code
    txn_info = [TxnInfo.from_json(t) for t in bt.get("txn_info", [])]

    bd = od["b_data"]
    m = bd["b_meta"]
    meta = BlockMetadata(
        block_beneficiary=_int(m["block_beneficiary"]),
        block_timestamp=_int(m["block_timestamp"]),
        block_number=_int(m["block_number"]),
        block_difficulty=_int(m["block_difficulty"]),
        block_random=_h256(m["block_random"]),
        block_gaslimit=_int(m["block_gaslimit"]),
        block_chain_id=_int(m["block_chain_id"]),
        block_base_fee=_int(m["block_base_fee"]),
        block_gas_used=_int(m["block_gas_used"]),
        block_blob_gas_used=_int(m.get("block_blob_gas_used", 0)),
        block_excess_blob_gas=_int(m.get("block_excess_blob_gas", 0)),
        parent_beacon_block_root=_h256(
            m.get("parent_beacon_block_root", "0x00")),
        block_bloom=tuple(_int(w) for w in m["block_bloom"]))
    bh = bd["b_hashes"]
    hashes = BlockHashes(
        prev_hashes=tuple(_h256(h) for h in bh["prev_hashes"]),
        cur_hash=_h256(bh["cur_hash"]))
    cch = od.get("checkpoint_consolidated_hash", (0, 0, 0, 0))
    return BlockProverInput(
        pre_state=pre_state,
        code_db=code_db,
        txn_info=txn_info,
        block_metadata=meta,
        block_hashes=hashes,
        checkpoint_state_trie_root=_h256(od["checkpoint_state_trie_root"]),
        checkpoint_consolidated_hash=tuple(_int(x) for x in cch),
        withdrawals=[(_bytes(a).rjust(20, b"\x00"), _int(v))
                     for a, v in bd.get("withdrawals", [])])
