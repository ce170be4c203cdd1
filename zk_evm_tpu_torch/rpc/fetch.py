"""Block-prover-input fetchers: jerigon and native RPC modes.

Twin of the reference's zero/src/rpc/{mod,jerigon}.rs and
zero/src/rpc/native/{mod,state,txn}.rs: given a provider, produce the
BlockProverInput JSON object that `decoder.parse_block_prover_input`
consumes — `{"block_trace": ..., "other_data": ...}`.

- jerigon mode asks the node for a ready-made zeroTracer trace
  (`debug_traceBlockByNumber`) plus the combined compact witness
  (`eth_getWitness`), rpc/jerigon.rs:36-69.
- native mode reconstructs the witness itself: per-txn prestate +
  diff tracers (rpc/native/txn.rs), then `eth_getProof` for every
  touched account/slot folded into partial tries
  (rpc/native/state.rs:118-175) via mpt.builder.PartialTrieBuilder.
"""

from __future__ import annotations

from ..hash import host_poseidon
from .provider import CachedProvider

PREVIOUS_HASHES_COUNT = 256  # rpc/mod.rs:33

# rpc/mod.rs:158-169: eth_call contract-creation payload whose "code"
# output is the concatenated 256 previous block hashes.
_PREV_HASHES_EVM_QUERY = \
    "0x60005B60010180430340816020025280610101116300000002576120205FF3"

# EIP-4788 beacon-roots system contract (eth_mainnet).
BEACON_ROOTS_CONTRACT_ADDRESS = \
    "0x000f3df6d732807ef1319fb7b8bb8522d0beac02"
HISTORY_BUFFER_LENGTH = 8191


def _int(v, default=None):
    if v is None:
        return default
    return int(v, 16) if isinstance(v, str) else int(v)


def _h256(v: str) -> str:
    return "0x" + int(v, 16).to_bytes(32, "big").hex()


def h256_limbs(h: bytes) -> list[int]:
    """32-byte hash -> 8 u32 field limbs (util.rs:116-126: byte-reverse
    then little-endian u32 chunks)."""
    rev = bytes(reversed(h))
    return [int.from_bytes(rev[i:i + 4], "little") for i in range(0, 32, 4)]


def consolidate_hashes(hashes: list[bytes]) -> tuple[int, int, int, int]:
    """256 H256 -> one 4-element Poseidon digest (proof.rs:385-393)."""
    assert len(hashes) == PREVIOUS_HASHES_COUNT
    payload = [w for h in hashes for w in h256_limbs(h)]
    return tuple(host_poseidon.hash_no_pad(payload))


def fetch_previous_block_hashes(provider: CachedProvider,
                                target_block_number: int) -> list[bytes]:
    """256 previous block hashes, oldest first, most recent last
    (rpc/mod.rs:62-137). Tries the one-shot eth_call disassembly trick
    first; falls back to per-block header fetches."""
    try:
        raw = provider.raw_request(
            "eth_call",
            [{"data": _PREV_HASHES_EVM_QUERY}, hex(target_block_number)])
        data = bytes.fromhex(raw[2:])
        chunks = [data[i:i + 32] for i in range(32, len(data), 32)]
        chunks.reverse()
        if len(chunks) == PREVIOUS_HASHES_COUNT \
                and any(c != b"\x00" * 32 for c in chunks):
            return chunks
    except Exception:
        pass

    prev = [b"\x00" * 32] * PREVIOUS_HASHES_COUNT
    lo = max(0, target_block_number - PREVIOUS_HASHES_COUNT)
    for num in range(lo, target_block_number):
        blk = provider.get_block(num)
        if blk is None:
            raise KeyError(f"block not found {num}")
        h = bytes.fromhex(blk["hash"][2:]).rjust(32, b"\x00")
        prev[PREVIOUS_HASHES_COUNT - (target_block_number - num)] = h
    return prev


def fetch_other_block_data(provider: CachedProvider, block_id,
                           checkpoint_block_number: int) -> dict:
    """OtherBlockData for one block (rpc/mod.rs:222-337), as the JSON
    `other_data` object of BlockProverInput."""
    number = provider.block_to_num(block_id)
    blk = provider.get_block(number)
    if blk is None:
        raise KeyError(f"target block not found {block_id}")
    chain_id = provider.chain_id()

    cp_blk = provider.get_block(checkpoint_block_number)
    if cp_blk is None:
        raise KeyError(f"checkpoint block not found "
                       f"{checkpoint_block_number}")

    prev_hashes = fetch_previous_block_hashes(provider, number)
    # +1: the checkpoint block itself is included (rpc/mod.rs:234).
    cp_prev_hashes = fetch_previous_block_hashes(
        provider, checkpoint_block_number + 1)

    bloom = bytes.fromhex(blk["logsBloom"][2:])
    assert len(bloom) == 256
    bloom_words = [int.from_bytes(bloom[i:i + 32], "little")
                   for i in range(0, 256, 32)]

    b_meta = {
        "block_beneficiary": blk["miner"],
        "block_timestamp": _int(blk["timestamp"]),
        "block_number": number,
        "block_difficulty": _int(blk.get("difficulty", "0x0")),
        "block_random": _h256(blk["mixHash"]),
        "block_gaslimit": _int(blk["gasLimit"]),
        "block_chain_id": chain_id,
        "block_base_fee": _int(blk.get("baseFeePerGas"), 0),
        "block_gas_used": _int(blk["gasUsed"]),
        "block_bloom": bloom_words,
        "parent_beacon_block_root":
            _h256(blk.get("parentBeaconBlockRoot", "0x0")),
        "block_blob_gas_used": _int(blk.get("blobGasUsed"), 0),
        "block_excess_blob_gas": _int(blk.get("excessBlobGas"), 0),
    }
    withdrawals = [(w["address"], _int(w["amount"]))
                   for w in blk.get("withdrawals") or []]
    return {
        "b_data": {
            "b_meta": b_meta,
            "b_hashes": {
                "prev_hashes": ["0x" + h.hex() for h in prev_hashes],
                "cur_hash": _h256(blk["hash"]),
            },
            "withdrawals": withdrawals,
        },
        "checkpoint_state_trie_root": _h256(cp_blk["stateRoot"]),
        "checkpoint_consolidated_hash":
            list(consolidate_hashes(cp_prev_hashes)),
    }


# ---------------------------------------------------------------- jerigon

def jerigon_block_prover_input(provider: CachedProvider, block_id,
                               checkpoint_block_number: int,
                               cdk_erigon: bool = False) -> dict:
    """rpc/jerigon.rs:26-69: zeroTracer txn traces + combined compact
    witness."""
    number = provider.block_to_num(block_id)
    tx_results = provider.raw_request(
        "debug_traceBlockByNumber",
        [hex(number), {"tracer": "zeroTracer"}])
    endpoint = "zkevm_getWitness" if cdk_erigon else "eth_getWitness"
    witness = provider.raw_request(endpoint, [hex(number)])
    other = fetch_other_block_data(provider, number,
                                   checkpoint_block_number)
    return {
        "block_trace": {
            "trie_pre_images": {"combined": {"compact": witness}},
            "txn_info": [r["result"] for r in tx_results],
            "code_db": [],
        },
        "other_data": other,
    }


# ----------------------------------------------------------------- native

def _prestate_options(diff_mode: bool) -> dict:
    return {"tracer": "prestateTracer",
            "tracerConfig": {"diffMode": diff_mode}}


def _process_tx_traces(access_list: dict, read: dict, diff_pre: dict,
                       diff_post: dict):
    """rpc/native/txn.rs process_tx_traces: merge the read-mode
    prestate frame with the diff-mode frame into per-address TxnTrace
    JSON deltas + the contract code the txn read or created."""
    code_db: list[str] = []
    traces: dict[str, dict] = {}
    addrs = set(read) | set(diff_pre) | set(diff_post) | set(access_list)
    for addr in sorted(addrs):
        pre = read.get(addr, {})
        dpre = diff_pre.get(addr, {})
        dpost = diff_post.get(addr, {})
        trace: dict = {}

        # Balance/nonce: written iff present in the diff post state
        # (or the account died: in diff_pre but not diff_post).
        self_destructed = addr in diff_pre and addr not in diff_post
        if "balance" in dpost:
            trace["balance"] = hex(_int(dpost["balance"]))
        if "nonce" in dpost:
            trace["nonce"] = _int(dpost["nonce"])

        # Storage reads: keys in the read-mode frame's storage.
        reads = sorted(pre.get("storage", {}).keys(),
                       key=lambda k: _int(k))
        extra = access_list.get(addr, ())
        reads = sorted({*reads, *extra}, key=lambda k: _int(k))
        if reads:
            trace["storage_read"] = [_h256(k) for k in reads]
        # Storage writes: post-state storage diff (deleted slots write 0).
        writes = {}
        for k, v in (dpost.get("storage") or {}).items():
            writes[_h256(k)] = hex(_int(v))
        for k in (dpre.get("storage") or {}):
            if k not in (dpost.get("storage") or {}):
                writes[_h256(k)] = "0x0"
        if writes:
            trace["storage_written"] = writes

        # Code: written if it changed, else read if observed.
        if "code" in dpost and dpost.get("code") != dpre.get("code"):
            trace["code_usage"] = {"write": dpost["code"]}
            code_db.append(dpost["code"])
        elif "code" in pre:
            from ..native import keccak256
            code = bytes.fromhex(pre["code"][2:])
            trace["code_usage"] = \
                {"read": "0x" + keccak256(code).hex()}
            code_db.append(pre["code"])
        if self_destructed:
            trace["self_destructed"] = True
        traces[addr] = trace
    return code_db, traces


def native_block_prover_input(provider: CachedProvider, block_id,
                              checkpoint_block_number: int) -> dict:
    """rpc/native/mod.rs:22-65: reconstruct the witness from standard
    endpoints (prestate tracers + eth_getProof)."""
    from ..mpt.builder import PartialTrieBuilder
    from ..native import keccak256

    number = provider.block_to_num(block_id)
    blk = provider.get_block(number, full_txns=True)
    if blk is None:
        raise KeyError(f"block not found {number}")

    # --- per-transaction traces (rpc/native/txn.rs) -------------------
    code_db: list[str] = []
    txn_info = []
    # address -> set of storage keys touched (rpc/native/state.rs:66-95)
    state_access: dict[str, set] = {}

    ts = _int(blk["timestamp"])
    beacon_keys = {hex(ts % HISTORY_BUFFER_LENGTH),
                   hex(ts % HISTORY_BUFFER_LENGTH + HISTORY_BUFFER_LENGTH)}
    state_access[BEACON_ROOTS_CONTRACT_ADDRESS] = set(beacon_keys)
    for w in blk.get("withdrawals") or []:
        state_access.setdefault(w["address"].lower(), set())
    state_access.setdefault(blk["miner"].lower(), set())

    for tx in blk["transactions"]:
        tx_hash = tx["hash"]
        receipt = provider.raw_request("eth_getTransactionReceipt",
                                       [tx_hash])
        pre = provider.raw_request("debug_traceTransaction",
                                   [tx_hash, _prestate_options(False)])
        diff = provider.raw_request("debug_traceTransaction",
                                    [tx_hash, _prestate_options(True)])
        access_list = {}
        for item in tx.get("accessList") or []:
            access_list.setdefault(item["address"].lower(), set()) \
                .update(item["storageKeys"])
        tx_code_db, traces = _process_tx_traces(
            access_list,
            {k.lower(): v for k, v in pre.items()},
            {k.lower(): v for k, v in diff.get("pre", {}).items()},
            {k.lower(): v for k, v in diff.get("post", {}).items()})

        # Failed contract creation still touches the address
        # (rpc/native/txn.rs:84-87).
        status_ok = _int(receipt.get("status", "0x1")) == 1
        if not status_ok and receipt.get("contractAddress"):
            traces.setdefault(receipt["contractAddress"].lower(), {})

        code_db.extend(tx_code_db)
        for addr, tr in traces.items():
            acc = state_access.setdefault(addr.lower(), set())
            acc.update(k for k in tr.get("storage_read", []))
            acc.update(k for k in tr.get("storage_written", {}))
        txn_info.append({
            "meta": {
                "byte_code": tx.get("raw") or _raw_txn(provider, tx_hash),
                "new_receipt_trie_node_byte":
                    _receipt_rlp(provider, receipt),
                "gas_used": _int(receipt["gasUsed"]),
            },
            "traces": traces,
        })

    # --- state witness from proofs (rpc/native/state.rs) --------------
    prev = provider.get_block(number - 1)
    state = PartialTrieBuilder(bytes.fromhex(prev["stateRoot"][2:]))
    storage: dict[str, PartialTrieBuilder] = {}
    next_proofs = []
    for addr, keys in sorted(state_access.items()):
        keys = sorted(keys, key=lambda k: _int(k))
        proof = provider.raw_request(
            "eth_getProof", [addr, keys, hex(number - 1)])
        state.insert_proof([bytes.fromhex(p[2:])
                            for p in proof["accountProof"]])
        hashed = keccak256(bytes.fromhex(addr[2:].zfill(40))).hex()
        smt = storage.setdefault(
            hashed, PartialTrieBuilder(
                bytes.fromhex(proof["storageHash"][2:])))
        for sp in proof.get("storageProof", []):
            smt.insert_proof([bytes.fromhex(p[2:]) for p in sp["proof"]])
        next_proofs.append((addr, keys))

    for addr, keys in next_proofs:
        proof = provider.raw_request(
            "eth_getProof", [addr, keys, hex(number)])
        state.insert_short_node_variants_from_proof(
            [bytes.fromhex(p[2:]) for p in proof["accountProof"]])
        hashed = keccak256(bytes.fromhex(addr[2:].zfill(40))).hex()
        if hashed in storage:
            for sp in proof.get("storageProof", []):
                storage[hashed].insert_short_node_variants_from_proof(
                    [bytes.fromhex(p[2:]) for p in sp["proof"]])

    other = fetch_other_block_data(provider, number,
                                   checkpoint_block_number)
    return {
        "block_trace": {
            "trie_pre_images": {"separate": {
                "state": {"direct": state.to_json()},
                "storage": {"0x" + h: {"direct": t.to_json()}
                            for h, t in storage.items()},
            }},
            "txn_info": txn_info,
            "code_db": sorted(set(code_db)),
        },
        "other_data": other,
    }


def _raw_txn(provider: CachedProvider, tx_hash: str) -> str:
    return provider.raw_request("eth_getRawTransactionByHash", [tx_hash])


def _receipt_rlp(provider: CachedProvider, receipt: dict) -> str:
    """RLP-encode a receipt response (txn.rs:70-71 encodes the typed
    receipt envelope; legacy receipts have no type byte)."""
    from ..mpt.rlp import rlp_encode

    def be(n: int) -> bytes:
        return n.to_bytes((n.bit_length() + 7) // 8, "big") if n else b""

    status = _int(receipt.get("status", "0x1"))
    cum_gas = _int(receipt["cumulativeGasUsed"])
    bloom = bytes.fromhex(receipt["logsBloom"][2:])
    logs = [[bytes.fromhex(lg["address"][2:].zfill(40)),
             [int(t, 16).to_bytes(32, "big") for t in lg["topics"]],
             bytes.fromhex(lg["data"][2:])]
            for lg in receipt.get("logs", [])]
    payload = rlp_encode([be(status), be(cum_gas), bloom, logs])
    txtype = _int(receipt.get("type", "0x0"), 0)
    if txtype:
        return "0x" + bytes([txtype]).hex() + payload.hex()
    return "0x" + payload.hex()
