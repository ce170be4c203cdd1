"""Block processing: apply per-txn state deltas -> per-batch trie roots.

Behavioral twin of the reference's trace_decoder/src/core.rs middle()
:395-620 — fold each transaction's TxnTraceDelta into the world
(born-account handling gated on receipt status, storage writes/deletes,
code updates, self-destructs), build the txn/receipt tries as we go,
apply withdrawals after the last txn, and run the EIP-4788 beacon-roots
hook before the first (do_beacon_hook :743-785).  Returns one Batch per
txn group with the post roots; `before` masking is handled by the trie
mask helpers.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..mpt.rlp import rlp_decode
from ..mpt.trie import Nibbles
from ..mpt.world import TransactionTrie, ReceiptTrie
from ..stark.public_values import TrieRoots
from .inputs import BlockProverInput, TxnInfo
from .world import Type1World, BEACON_ROOTS_ADDRESS, HISTORY_BUFFER_LENGTH


def receipt_status(receipt_bytes: bytes) -> int:
    """First field of the (typed or legacy) receipt payload
    (generation/mpt.rs:81-97)."""
    payload = receipt_bytes[1:] if receipt_bytes[:1] in (
        b"\x01", b"\x02", b"\x03") else receipt_bytes
    status, _cum_gas, _bloom, _logs = rlp_decode(payload)
    return int.from_bytes(status, "big")


@dataclass
class TrieInputs:
    """The minimal `before` tries a batch proof needs (core.rs's masked
    IntraBlockTries): touched paths kept, everything else hashed out."""
    state: object                 # mpt Trie
    storage: dict                 # hashed addr -> mpt Trie
    transactions: object
    receipts: object
    code: dict = field(default_factory=dict)


@dataclass
class Batch:
    first_txn_ix: int
    gas_used: int
    byte_code: list
    contract_code: dict           # hash -> code touched in this batch
    withdrawals: list
    before: TrieInputs = None
    after: TrieRoots = field(default_factory=TrieRoots)


class _Masks:
    """Touched-path accumulator for one batch (core.rs's
    state_mask/storage_masks)."""

    def __init__(self):
        self.state = set()        # Nibbles-as-tuple paths
        self.storage = {}         # haddr -> set of paths

    def touch_account(self, haddr: bytes):
        self.state.add(tuple(Nibbles.from_bytes(haddr)))

    def touch_path(self, path):
        if path is not None:
            self.state.add(tuple(path))

    def touch_slot(self, haddr: bytes, slot_path):
        if slot_path is not None:
            self.storage.setdefault(haddr, set()).add(tuple(slot_path))


def batch_txns(txns: list, hint: int) -> list:
    """Group txns into batches of ~hint, guaranteeing at least TWO
    batches (the aggregation layer needs two segment proofs); short
    blocks are padded with dummy (None) entries (core.rs:275-300)."""
    hint = max(hint, 1)
    if len(txns) <= 1:
        padded = list(txns) + [None] * (2 - len(txns))
        return [[t] for t in padded]
    batches = [txns[i:i + hint] for i in range(0, len(txns), hint)]
    if len(batches) < 2:
        half = len(txns) // 2
        return [txns[:half], txns[half:]]
    return batches


def gwei_to_wei(amount: int) -> int:
    return amount * 10**9


def middle(bpi: BlockProverInput, batch_size: int = 1,
           batches_in: list = None, withdrawals: list = None,
           observer=None) -> tuple[list, Type1World]:
    """Apply all txn deltas batch by batch; returns ([Batch], world).

    `batches_in` entries may contain None for dummy (padding) txns,
    which don't advance the txn index. `observer.collect_tries` is
    called with the post-execution tries after every batch
    (trace_decoder/src/core.rs:613, observer.rs:11-26)."""
    world = Type1World(bpi.pre_state)
    code_db = dict(bpi.code_db)
    txn_trie, receipt_trie = TransactionTrie(), ReceiptTrie()
    if batches_in is None:
        batches_in = [bpi.txn_info[i:i + batch_size]
                      for i in range(0, len(bpi.txn_info), batch_size)] \
            or [[]]
    if withdrawals is None:
        withdrawals = bpi.withdrawals
    out = []
    txn_ix = loop_ix = 0
    loop_len = sum(len(b) for b in batches_in)
    for batch in batches_in:
        first_ix = txn_ix
        gas = 0
        byte_code = []
        contract_code = {keccak_of_empty(): b""}
        masks = _Masks()
        before_state = world.state.snapshot()
        before_storage = {h: t.snapshot()
                          for h, t in world.storage.items()}
        before_txn, before_rcpt = (txn_trie.trie.snapshot(),
                                   receipt_trie.trie.snapshot())
        if txn_ix == 0:
            do_beacon_hook(world, bpi.block_metadata.block_timestamp,
                           bpi.block_metadata.parent_beacon_block_root,
                           masks)
        for txn in batch:
            loop_ix += 1
            if txn is None:
                continue          # dummy padding txn
            if txn.byte_code:
                byte_code.append(txn.byte_code)
                txn_trie.insert(txn_ix, txn.byte_code)
                receipt_trie.insert(txn_ix, txn.receipt_node_bytes)
            gas += txn.gas_used
            _apply_txn(world, code_db, txn, contract_code, masks)
            txn_ix += 1
        wds = []
        if loop_ix == loop_len and withdrawals:
            for addr, amt in withdrawals:
                masks.touch_account(world._haddr(addr))
                world.update_balance(addr, lambda b, amt=amt: b + amt)
            wds = list(withdrawals)
        out.append(Batch(
            first_txn_ix=first_ix, gas_used=gas, byte_code=byte_code,
            contract_code=contract_code, withdrawals=wds,
            before=_mask_before(before_state, before_storage, before_txn,
                                before_rcpt, masks,
                                range(first_ix, txn_ix), code_db),
            after=TrieRoots(state_root=world.root(),
                            transactions_root=txn_trie.root(),
                            receipts_root=receipt_trie.root())))
        if observer is not None:
            observer.collect_tries(
                bpi.block_metadata.block_number, len(out) - 1,
                world.state.snapshot(),
                {h: t.snapshot() for h, t in world.storage.items()},
                txn_trie.trie.snapshot(), receipt_trie.trie.snapshot())
    return out, world


def _mask_before(state, storage, txns, receipts, masks: _Masks,
                 txn_range, code_db) -> TrieInputs:
    from ..mpt.rlp import rlp_encode
    ix_keys = [Nibbles.from_bytes(rlp_encode(ix)) for ix in txn_range]
    return TrieInputs(
        state=state.subset([Nibbles(p) for p in masks.state]),
        storage={h: storage[h].subset([Nibbles(p) for p in paths])
                 for h, paths in masks.storage.items() if h in storage},
        transactions=_wrap_txn(txns.subset(ix_keys)),
        receipts=_wrap_rcpt(receipts.subset(ix_keys)),
        code=code_db)


def _wrap_txn(trie):
    t = TransactionTrie()
    t.trie = trie
    return t


def _wrap_rcpt(trie):
    t = ReceiptTrie()
    t.trie = trie
    return t


def _apply_txn(world: Type1World, code_db: dict, txn: TxnInfo,
               contract_code: dict, masks: _Masks = None):
    status = receipt_status(txn.receipt_node_bytes) \
        if txn.byte_code else 1
    for addr, d in txn.traces.items():
        just_access = (d.balance is None and d.nonce is None
                       and not d.storage_read and not d.storage_written
                       and d.code_read is None and d.code_written is None
                       and not d.self_destructed)
        born = not world.contains(addr)
        if born:
            world.create_storage(addr)
        haddr = world._haddr(addr)
        if masks is not None:
            masks.touch_account(haddr)
            for slot_h256 in list(d.storage_written) + d.storage_read:
                masks.touch_slot(haddr, Nibbles.from_bytes(
                    _keccak(slot_h256)))
        # failed txns don't commit a newborn account (core.rs:504-509)
        do_writes = not just_access and (bool(status) if born else True)
        if do_writes:
            if d.balance is not None:
                world.update_balance(addr, lambda _, v=d.balance: v)
            if d.nonce is not None:
                world.update_nonce(addr, lambda _, v=d.nonce: v)
            if d.code_written is not None:
                code_db[_keccak(d.code_written)] = d.code_written
                contract_code[_keccak(d.code_written)] = d.code_written
                world.set_code(addr, code=d.code_written)
            elif d.code_read is not None:
                code = code_db.get(d.code_read)
                if code is not None:
                    contract_code[d.code_read] = code
                    world.set_code(addr, code=code)
                else:
                    world.set_code(addr, code_hash=d.code_read)
            for slot_h256, value in d.storage_written.items():
                slot = int.from_bytes(slot_h256, "big")
                if value == 0:
                    collapsed = world.destroy_slot(addr, slot)
                    if masks is not None:
                        masks.touch_slot(haddr, collapsed)
                else:
                    world.store_int(addr, slot, value)
        if d.self_destructed:
            world.destroy_storage(addr)
            collapsed = world.destroy_account(addr)
            if masks is not None:
                masks.touch_path(collapsed)


def do_beacon_hook(world: Type1World, timestamp: int,
                   parent_beacon_block_root: bytes,
                   masks: _Masks = None):
    """EIP-4788 pre-execution writes (core.rs:743-785)."""
    haddr = world._haddr(BEACON_ROOTS_ADDRESS)
    if masks is not None:
        masks.touch_account(haddr)
    t_idx = timestamp % HISTORY_BUFFER_LENGTH
    r_idx = t_idx + HISTORY_BUFFER_LENGTH
    for ix, v in ((t_idx, timestamp),
                  (r_idx, int.from_bytes(parent_beacon_block_root,
                                         "big"))):
        if masks is not None:
            masks.touch_slot(haddr, Nibbles.from_bytes(
                _keccak(ix.to_bytes(32, "big"))))
        if v == 0:
            collapsed = world.destroy_slot(BEACON_ROOTS_ADDRESS, ix)
            if masks is not None:
                masks.touch_slot(haddr, collapsed)
        else:
            world.store_int(BEACON_ROOTS_ADDRESS, ix, v)


def _keccak(b: bytes) -> bytes:
    from ..native import keccak256
    return keccak256(b)


def keccak_of_empty() -> bytes:
    return _keccak(b"")


@dataclass
class GenerationInputs:
    """Everything one batch proof consumes (the reference's
    GenerationInputs, evm_arithmetization/src/generation/mod.rs:82-128).
    Feeds witness generation + the segment prover."""
    txn_number_before: int
    gas_used_before: int
    gas_used_after: int
    signed_txns: list
    withdrawals: list
    tries: TrieInputs
    trie_roots_after: TrieRoots
    checkpoint_state_trie_root: bytes
    checkpoint_consolidated_hash: tuple
    contract_code: dict
    block_metadata: object
    block_hashes: object
    # cdk_erigon only (generation/mod.rs:99-133): pre-block GER write
    # data (l1 root, l1 block hash) and the burn address
    ger_data: tuple | None = None
    burn_addr: bytes | None = None


def entrypoint(bpi: BlockProverInput, batch_size_hint: int = 1,
               observer=None) -> list:
    """Block prover input -> one GenerationInputs per batch
    (core.rs:43-178).  Withdrawal amounts arrive in gwei and are
    converted to wei before application. An optional `observer`
    (decoder.observer) receives the post-batch intermediate tries."""
    wds = [(a, gwei_to_wei(v)) for a, v in bpi.withdrawals]
    batches, _ = middle(bpi,
                        batches_in=batch_txns(bpi.txn_info,
                                              batch_size_hint),
                        withdrawals=wds, observer=observer)
    out = []
    running_gas = 0
    for b in batches:
        gas_before = running_gas
        running_gas += b.gas_used
        out.append(GenerationInputs(
            txn_number_before=b.first_txn_ix,
            gas_used_before=gas_before,
            gas_used_after=running_gas,
            signed_txns=b.byte_code,
            withdrawals=b.withdrawals,
            tries=b.before,
            trie_roots_after=b.after,
            checkpoint_state_trie_root=bpi.checkpoint_state_trie_root,
            checkpoint_consolidated_hash=bpi.checkpoint_consolidated_hash,
            contract_code=b.contract_code,
            block_metadata=bpi.block_metadata,
            block_hashes=bpi.block_hashes))
    return out
