"""Test fixtures: beacon-roots (EIP-4788) preinitialized state.

Twin of zk_evm's evm_arithmetization/src/testing_utils.rs:87-151
and cpu/kernel/constants/mod.rs:436-466 (cancun constants).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from ..mpt.trie import EMPTY_TRIE_HASH, Trie, Nibbles
from ..mpt.rlp import rlp_decode, rlp_encode
from ..mpt.world import Account
from ..native import keccak256

HISTORY_BUFFER_LENGTH = 8191

BEACON_ROOTS_CONTRACT_ADDRESS = bytes.fromhex(
    "000F3df6D732807Ef1319fB7B8bB8522d0Beac02".lower())
BEACON_ROOTS_CONTRACT_ADDRESS_HASHED = bytes.fromhex(
    "37d65eaa92c6bc4c13a5ec45527f0c18ea8932588728769ec7aecfe6d9f32e42")
BEACON_ROOTS_CONTRACT_CODE = bytes.fromhex(
    "3373fffffffffffffffffffffffffffffffffffffffe14604d57602036146024"
    "575f5ffd5b5f35801560495762001fff810690815414603c575f5ffd5b62001f"
    "ff01545f5260205ff35b5f5ffd5b62001fff42064281555f359062001fff0155"
    "00")
BEACON_ROOTS_CONTRACT_CODE_HASH = bytes.fromhex(
    "f57acd40259872606d76197ef052f3d35588dadf919ee1f0e3cb9b62d3f4b02c")

BEACON_ROOTS_ACCOUNT = Account(
    nonce=0, balance=0,
    storage_root=bytes.fromhex(
        "56e81f171bcc55a6ff8345e692c0f86e5b48e01b996cadc001622fb5e363b421"),
    code_hash=BEACON_ROOTS_CONTRACT_CODE_HASH)



def _empty_cch() -> tuple:
    """Checkpoint consolidated hash of an all-zero window (the
    reference's EMPTY_CONSOLIDATED_BLOCKHASH, proof.rs:505-510, under
    our Poseidon; both fixture blocks anchor at genesis-like state)."""
    from ..orchestration.aggregation import empty_consolidated_blockhash
    return empty_consolidated_blockhash()

def insert_storage(trie: Trie, slot: int, value: int) -> None:
    """testing_utils.rs:87-99."""
    key = keccak256(slot.to_bytes(32, "big"))
    nibs = Nibbles.from_bytes(key)
    if value == 0:
        trie.delete(nibs)
    else:
        trie.insert(nibs, rlp_encode(value))


def update_beacon_roots_account_storage(storage: Trie, timestamp: int,
                                        parent_root: bytes) -> None:
    """testing_utils.rs:113-123."""
    timestamp_idx = timestamp % HISTORY_BUFFER_LENGTH
    root_idx = timestamp_idx + HISTORY_BUFFER_LENGTH
    insert_storage(storage, timestamp_idx, timestamp)
    insert_storage(storage, root_idx, int.from_bytes(parent_root, "big"))


def beacon_roots_contract_from_storage(storage: Trie) -> Account:
    return Account(nonce=0, balance=0,
                   storage_root=storage.root_hash(),
                   code_hash=BEACON_ROOTS_CONTRACT_CODE_HASH)


def beacon_roots_account_nibbles() -> Nibbles:
    return Nibbles.from_bytes(BEACON_ROOTS_CONTRACT_ADDRESS_HASHED)


def preinitialized_state_and_storage_tries():
    """testing_utils.rs:135-146: (state trie, {hashed_addr: storage})."""
    state = Trie()
    state.insert(beacon_roots_account_nibbles(),
                 BEACON_ROOTS_ACCOUNT.rlp())
    return state, {BEACON_ROOTS_CONTRACT_ADDRESS_HASHED: Trie()}


# ---------------------------------------------------------------------------
# Complete GenerationInputs fixtures (the reference's integration tests:
# tests/simple_transfer.rs:33-182, tests/add11_yml.rs:30-201)
# ---------------------------------------------------------------------------

def eth_to_wei(eth: int) -> int:
    return eth * 10**18


SENDER = bytes.fromhex("2c7536e3605d9c16a7a3d7b1898e529396a65c23")
TO = bytes.fromhex("a0a0a0a0a0a0a0a0a0a0a0a0a0a0a0a0a0a0a0a0")
BENEFICIARY = bytes.fromhex("deadbeefdeadbeefdeadbeefdeadbeefdeadbeef")
# Generated by the reference with a py-evm script (simple_transfer.rs:70)
TXN = bytes.fromhex(
    "f861050a8255f094a0a0a0a0a0a0a0a0a0a0a0a0a0a0a0a0a0a0a0a0648242421b"
    "a02c89eb757d9deeb1f5b3859a9d4d679951ef610ac47ad4608dc142beb1b7e313"
    "a05af7e9fbab825455d36c36c7f4cfcafbeafa9a77bdff936b52afb36d4fe4bcdd")
VALUE = 100


def build_simple_transfer_inputs():
    return _simple_transfer_block().inputs


def _simple_transfer_block() -> FixtureBlock:
    from ..decoder.core import GenerationInputs, TrieInputs
    from ..stark.public_values import (BlockMetadata, BlockHashes,
                                       TrieRoots)
    from ..mpt.rlp import rlp_encode
    from ..native import keccak256

    sender_key = keccak256(SENDER)
    to_key = keccak256(TO)

    sender_before = Account(nonce=5, balance=eth_to_wei(100_000))

    state_before, storage_tries = preinitialized_state_and_storage_tries()
    beacon_storage = Trie()  # starts empty
    state_before.insert(Nibbles.from_bytes(sender_key),
                        sender_before.rlp())

    md = BlockMetadata(
        block_beneficiary=int.from_bytes(BENEFICIARY, "big"),
        block_timestamp=0x03E8,
        block_number=1,
        block_difficulty=0x020000,
        block_random=(0x020000).to_bytes(32, "big"),
        block_gaslimit=0xFF112233,
        block_chain_id=1,
        block_base_fee=0xA,
        block_gas_used=21032)

    contract_code = {keccak256(b""): b""}

    # expected post-state
    txdata_gas = 2 * 16
    gas_used = 21_000 + txdata_gas
    state_after = Trie()
    update_beacon_roots_account_storage(
        beacon_storage, md.block_timestamp, md.parent_beacon_block_root)
    beacon_after = beacon_roots_contract_from_storage(beacon_storage)
    sender_after = Account(
        nonce=6, balance=sender_before.balance - VALUE - gas_used * 10)
    to_after = Account(balance=VALUE)
    state_after.insert(Nibbles.from_bytes(sender_key), sender_after.rlp())
    state_after.insert(Nibbles.from_bytes(to_key), to_after.rlp())
    state_after.insert(beacon_roots_account_nibbles(), beacon_after.rlp())

    receipt_0 = rlp_encode([1, 21032, b"\x00" * 256, []])
    receipts = Trie()
    receipts.insert(Nibbles([8, 0]), receipt_0)
    transactions = Trie()
    transactions.insert(Nibbles([8, 0]), TXN)

    roots_after = TrieRoots(state_root=state_after.root_hash(),
                            transactions_root=transactions.root_hash(),
                            receipts_root=receipts.root_hash())

    tries = TrieInputs(state=state_before, storage=storage_tries,
                       transactions=Trie(), receipts=Trie())

    inputs = GenerationInputs(
        txn_number_before=0,
        gas_used_before=0,
        gas_used_after=21032,
        signed_txns=[TXN],
        withdrawals=[],
        tries=tries,
        trie_roots_after=roots_after,
        checkpoint_state_trie_root=Trie().root_hash(),
        checkpoint_consolidated_hash=_empty_cch(),
        contract_code=contract_code,
        block_metadata=md,
        block_hashes=BlockHashes())
    return FixtureBlock(
        inputs=inputs, accounts=(SENDER, TO, BENEFICIARY), slots={},
        state_after=state_after,
        storage_after={BEACON_ROOTS_CONTRACT_ADDRESS_HASHED:
                       beacon_storage},
        receipt=receipt_0, gas_used=gas_used)


def build_add11_inputs():
    """The `add11_yml` ethereum-tests case: a txn calling a contract
    that computes 1+1 and SSTOREs it — exercises user-mode execution,
    syscalls, jumpdest analysis, and the account_code oracle
    (zk_evm's evm_arithmetization/tests/add11_yml.rs:30-201)."""
    return _add11_block().inputs


def _add11_block() -> FixtureBlock:
    from ..decoder.core import GenerationInputs, TrieInputs
    from ..stark.public_values import (BlockMetadata, BlockHashes,
                                       TrieRoots)
    from ..mpt.rlp import rlp_encode
    from ..native import keccak256

    beneficiary = bytes.fromhex("2adc25665018aa1fe0e6bc666dac8fc2697ff9ba")
    sender = bytes.fromhex("a94f5374fce5edbc8e2a8697c15331677e6ebf0b")
    to = bytes.fromhex("095e7baea6a6c7c4c2dfeb977efac326af552d87")
    code = bytes([0x60, 0x01, 0x60, 0x01, 0x01, 0x60, 0x00, 0x55, 0x00])
    code_hash = keccak256(code)
    txn = bytes.fromhex(
        "f863800a83061a8094095e7baea6a6c7c4c2dfeb977efac326af552d87830186"
        "a0801ba0ffb600e63115a7362e7811894a91d8ba4330e526f22121c994c46920"
        "35dfdfd5a06198379fcac8de3dbfac48b165df4bf88e2088f294b61efb9a65fe"
        "2281c76e16")

    bk, sk, tk = (keccak256(a) for a in (beneficiary, sender, to))
    state_before, storage_tries = preinitialized_state_and_storage_tries()
    beacon_storage = Trie()
    bal = 0x0DE0B6B3A7640000
    state_before.insert(Nibbles.from_bytes(bk), Account(nonce=1).rlp())
    state_before.insert(Nibbles.from_bytes(sk),
                        Account(balance=bal).rlp())
    state_before.insert(Nibbles.from_bytes(tk),
                        Account(balance=bal, code_hash=code_hash).rlp())
    storage_tries[tk] = Trie()

    md = BlockMetadata(
        block_beneficiary=int.from_bytes(beneficiary, "big"),
        block_timestamp=0x03E8, block_number=1,
        block_difficulty=0x020000,
        block_random=(0x020000).to_bytes(32, "big"),
        block_gaslimit=0xFF112233, block_chain_id=1, block_base_fee=0xA,
        block_gas_used=0xA868)

    contract_code = {keccak256(b""): b"", code_hash: code}

    update_beacon_roots_account_storage(
        beacon_storage, md.block_timestamp, md.parent_beacon_block_root)
    beacon_after = beacon_roots_contract_from_storage(beacon_storage)
    storage_after = Trie()
    insert_storage(storage_after, 0, 2)
    state_after = Trie()
    state_after.insert(Nibbles.from_bytes(bk), Account(nonce=1).rlp())
    state_after.insert(Nibbles.from_bytes(sk),
                       Account(nonce=1, balance=0x0DE0B6B3A75BE550).rlp())
    state_after.insert(
        Nibbles.from_bytes(tk),
        Account(balance=0x0DE0B6B3A76586A0, code_hash=code_hash,
                storage_root=storage_after.root_hash()).rlp())
    state_after.insert(beacon_roots_account_nibbles(), beacon_after.rlp())

    receipt_0 = rlp_encode([1, 0xA868, b"\x00" * 256, []])
    receipts = Trie()
    receipts.insert(Nibbles([8, 0]), receipt_0)
    transactions = Trie()
    transactions.insert(Nibbles([8, 0]), txn)

    roots_after = TrieRoots(state_root=state_after.root_hash(),
                            transactions_root=transactions.root_hash(),
                            receipts_root=receipts.root_hash())
    tries = TrieInputs(state=state_before, storage=storage_tries,
                       transactions=Trie(), receipts=Trie())
    inputs = GenerationInputs(
        txn_number_before=0, gas_used_before=0, gas_used_after=0xA868,
        signed_txns=[txn], withdrawals=[], tries=tries,
        trie_roots_after=roots_after,
        checkpoint_state_trie_root=state_before.root_hash(),
        checkpoint_consolidated_hash=_empty_cch(),
        contract_code=contract_code, block_metadata=md,
        block_hashes=BlockHashes())
    return FixtureBlock(
        inputs=inputs, accounts=(beneficiary, sender, to), slots={to: (0,)},
        state_after=state_after,
        storage_after={BEACON_ROOTS_CONTRACT_ADDRESS_HASHED: beacon_storage,
                       tk: storage_after},
        receipt=receipt_0, gas_used=0xA868)


# the cdk_erigon flavor's cdk-ger fixture is not ported
FIXTURES = {"simple-transfer": build_simple_transfer_inputs,
            "add11": build_add11_inputs}


# ---------------------------------------------------------------------------
# Block witnesses built from the fixtures: the JSON that
# `decoder.parse_block_prover_input` reads, with the pre-state given as
# `separate` / `direct` proof-node stores (the shape the reference's native
# RPC fetcher writes, zero/src/rpc/native/state.rs). Test inputs for the
# decoder path; not a command-line feature.
# ---------------------------------------------------------------------------

@dataclass
class FixtureBlock:
    """A one-txn fixture block with what its witness needs beyond the
    inputs: the accounts and storage slots the txn touches, the
    post-state tries and the txn's receipt and gas."""
    inputs: object                # GenerationInputs
    accounts: tuple               # addresses the txn touches (beacon aside)
    slots: dict                   # address -> slots the txn writes
    state_after: Trie
    storage_after: dict           # hashed address -> storage Trie
    receipt: bytes
    gas_used: int


def _hex(b: bytes) -> str:
    return "0x" + bytes(b).hex()


def _proof_nodes(trie: Trie) -> dict:
    """`direct` pre-image of a whole trie: its root and the proof nodes of
    every key it holds (mpt.builder.PartialTrieBuilder.to_json)."""
    nodes = {}
    for key, _ in trie.items():
        for node in trie.get_proof(key):
            nodes[keccak256(node)] = node
    return {"root": _hex(trie.root_hash()),
            "nodes": [_hex(n) for n in nodes.values()]}


def _account(state: Trie, address: bytes):
    from ..decoder.world import _decode_account
    raw = state.get(Nibbles.from_bytes(keccak256(address)))
    return None if raw is None else _decode_account(raw)


def _slot(storage: dict, address: bytes, slot: int) -> int:
    trie = storage.get(keccak256(address))
    raw = None if trie is None else trie.get(
        Nibbles.from_bytes(keccak256(slot.to_bytes(32, "big"))))
    return 0 if raw is None else int.from_bytes(rlp_decode(raw), "big")


def _traces(block: FixtureBlock) -> dict:
    """The block's one txn as per-account deltas: for each touched
    account, the balance and nonce where they changed, the slots written
    and, where the account has code, the code read. An account that the
    txn only reads (the fee recipient) appears with no delta."""
    tries = block.inputs.tries
    out = {}
    for addr in block.accounts:
        pre = _account(tries.state, addr) or Account()
        post = _account(block.state_after, addr)
        delta = {}
        if post is not None:
            if post.balance != pre.balance:
                delta["balance"] = hex(post.balance)
            if post.nonce != pre.nonce:
                delta["nonce"] = hex(post.nonce)
            written = {
                _hex(slot.to_bytes(32, "big")):
                    hex(_slot(block.storage_after, addr, slot))
                for slot in block.slots.get(addr, ())
                if _slot(block.storage_after, addr, slot)
                != _slot(tries.storage, addr, slot)}
            if written:
                delta["storage_written"] = written
            if post.code_hash != keccak256(b""):
                delta["code_usage"] = {"read": _hex(post.code_hash)}
        out[_hex(addr)] = delta
    return out


def _witness(inputs, state: Trie, storage: dict, txn_info: list,
             withdrawals_gwei: list) -> dict:
    md, bh = inputs.block_metadata, inputs.block_hashes
    return {
        "block_trace": {
            "trie_pre_images": {"separate": {
                "state": {"direct": _proof_nodes(state)},
                "storage": {_hex(h): {"direct": _proof_nodes(t)}
                            for h, t in storage.items()},
            }},
            "code_db": [_hex(c) for c in inputs.contract_code.values()
                        if c],
            "txn_info": txn_info,
        },
        "other_data": {
            "b_data": {
                "b_meta": {
                    "block_beneficiary":
                        _hex(md.block_beneficiary.to_bytes(20, "big")),
                    "block_timestamp": md.block_timestamp,
                    "block_number": md.block_number,
                    "block_difficulty": md.block_difficulty,
                    "block_random": _hex(md.block_random),
                    "block_gaslimit": md.block_gaslimit,
                    "block_chain_id": md.block_chain_id,
                    "block_base_fee": md.block_base_fee,
                    "block_gas_used": md.block_gas_used,
                    "block_blob_gas_used": md.block_blob_gas_used,
                    "block_excess_blob_gas": md.block_excess_blob_gas,
                    "parent_beacon_block_root":
                        _hex(md.parent_beacon_block_root),
                    "block_bloom": list(md.block_bloom),
                },
                "b_hashes": {
                    "prev_hashes": [_hex(h) for h in bh.prev_hashes],
                    "cur_hash": _hex(bh.cur_hash),
                },
                "withdrawals": [[_hex(a), amount]
                                for a, amount in withdrawals_gwei],
            },
            "checkpoint_state_trie_root":
                _hex(inputs.checkpoint_state_trie_root),
            "checkpoint_consolidated_hash":
                list(inputs.checkpoint_consolidated_hash),
        },
    }


def _fixture_witness(block: FixtureBlock) -> dict:
    """Witness of a fixture block: its pre-state tries as proof nodes of
    every account and slot, its one signed txn with receipt, gas and
    per-account deltas. The beacon-roots account is not in the deltas:
    the decoder's EIP-4788 hook writes it."""
    gi = block.inputs
    (txn,) = gi.signed_txns
    txn_info = [{"meta": {"byte_code": _hex(txn),
                          "new_receipt_trie_node_byte": _hex(block.receipt),
                          "gas_used": block.gas_used},
                 "traces": _traces(block)}]
    return _witness(gi, gi.tries.state, gi.tries.storage, txn_info, [])


# the child block's one withdrawal: an address with no account yet, paid
# in gwei as a header's withdrawal list gives it
WITHDRAWAL_ADDRESS = bytes.fromhex("7e57ab1e7e57ab1e7e57ab1e7e57ab1e7e57ab1e")
WITHDRAWAL_GWEI = 32_000_000_000
BLOCK_TIME = 12


def _child_witness(parent: FixtureBlock) -> tuple[dict, bytes]:
    """A block on top of `parent`: the next number, 12 s later, no txns,
    one withdrawal to a new account, the previous-hash window slid by one
    onto the parent's hash, the same checkpoint; its pre-state is the
    parent's post-state. Returns (witness, expected post-state root), the
    root computed from the fixture's own EIP-4788 write and the
    withdrawal, not by the decoder."""
    gi = parent.inputs
    md = replace(gi.block_metadata,
                 block_number=gi.block_metadata.block_number + 1,
                 block_timestamp=gi.block_metadata.block_timestamp
                 + BLOCK_TIME,
                 block_gas_used=0)
    prev = tuple(gi.block_hashes.prev_hashes[1:]) \
        + (gi.block_hashes.cur_hash,)
    hashes = replace(gi.block_hashes, prev_hashes=prev,
                     cur_hash=keccak256(rlp_encode(md.block_number)))
    child = replace(gi, signed_txns=[], withdrawals=[], block_metadata=md,
                    block_hashes=hashes, gas_used_before=0,
                    gas_used_after=0, txn_number_before=0)
    witness = _witness(child, parent.state_after, parent.storage_after, [],
                       [(WITHDRAWAL_ADDRESS, WITHDRAWAL_GWEI)])

    state = parent.state_after.snapshot()
    beacon = parent.storage_after[
        BEACON_ROOTS_CONTRACT_ADDRESS_HASHED].snapshot()
    update_beacon_roots_account_storage(beacon, md.block_timestamp,
                                        md.parent_beacon_block_root)
    state.insert(beacon_roots_account_nibbles(),
                 beacon_roots_contract_from_storage(beacon).rlp())
    state.insert(Nibbles.from_bytes(keccak256(WITHDRAWAL_ADDRESS)),
                 Account(balance=WITHDRAWAL_GWEI * 10**9).rlp())
    return witness, state.root_hash()


_FIXTURE_BLOCKS = {"simple-transfer": _simple_transfer_block,
                  "add11": _add11_block}


def build_witness_chain(name: str = "add11") -> tuple[list, list]:
    """The two-block witness list [A, B]: A is the fixture block, B its
    txn-less child (`_child_witness`). Returns (witnesses, the TrieRoots
    each block must end at)."""
    block = _FIXTURE_BLOCKS[name]()
    child, child_root = _child_witness(block)
    from ..stark.public_values import TrieRoots
    roots = [block.inputs.trie_roots_after,
             TrieRoots(state_root=child_root,
                       transactions_root=EMPTY_TRIE_HASH,
                       receipts_root=EMPTY_TRIE_HASH)]
    return [_fixture_witness(block), child], roots
