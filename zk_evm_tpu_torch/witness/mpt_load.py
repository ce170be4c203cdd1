"""Loading MPTs into kernel memory: TrieData + accounts/storage linked
lists.

Functional twin of zk_evm's evm_arithmetization/src/generation/
mpt.rs (load_mpt :148, load_state_trie :225, get_state_and_storage_leaves
:333, get_storage_leaves :446, load_linked_lists_and_txn_and_receipt_mpts
:541, load_state_mpt :593, parse_receipts :99) and linked_list.rs
(node sizes :8-9, empty_list_mem :27).

The kernel reads tries from the `TrieData` segment as tagged node records
(PartialTrieType tags, constants/trie_type.rs) and reads the flat account
and storage state from two circular linked lists whose node payloads also
live in TrieData. All three segments are *preinitialized*: their content
is not part of MemBefore; soundness comes from the kernel hashing the
loaded tries and comparing against the claimed digests-before.
"""

from __future__ import annotations

from ..mpt.trie import Trie, Nibbles, Empty, HashNode, Leaf, Extension, Branch
from ..mpt.rlp import rlp_decode
from ..tables.segments import Segment, scaled

# PartialTrieType (constants/trie_type.rs)
MPT_NODE_EMPTY = 0
MPT_NODE_HASH = 1
MPT_NODE_BRANCH = 2
MPT_NODE_EXTENSION = 3
MPT_NODE_LEAF = 4

ACCOUNTS_LINKED_LIST_NODE_SIZE = 4
STORAGE_LINKED_LIST_NODE_SIZE = 5
U256_MAX = (1 << 256) - 1


def _node_type(node) -> int:
    if isinstance(node, Empty):
        return MPT_NODE_EMPTY
    if isinstance(node, HashNode):
        return MPT_NODE_HASH
    if isinstance(node, Branch):
        return MPT_NODE_BRANCH
    if isinstance(node, Extension):
        return MPT_NODE_EXTENSION
    if isinstance(node, Leaf):
        return MPT_NODE_LEAF
    raise TypeError(f"unknown trie node {type(node)}")


def _packed(nibs: Nibbles) -> int:
    v = 0
    for n in nibs.nibs:
        v = (v << 4) | n
    return v


def decode_account(value: bytes):
    """RLP([nonce, balance, storage_root, code_hash]) -> 4 ints/bytes."""
    nonce, balance, storage_root, code_hash = rlp_decode(value)
    return (int.from_bytes(nonce, "big"), int.from_bytes(balance, "big"),
            storage_root, code_hash)


def _parse_storage_value(value_rlp: bytes) -> list[int]:
    v = rlp_decode(value_rlp)
    return [int.from_bytes(v, "big")]


def _rlp_payload_len(rlp: bytes) -> int:
    """Length of the RLP payload (PayloadInfo.value_len)."""
    b0 = rlp[0]
    if b0 < 0x80:
        return 1
    if b0 < 0xB8:
        return b0 - 0x80
    if b0 < 0xC0:
        n = b0 - 0xB7
        return int.from_bytes(rlp[1:1 + n], "big")
    if b0 < 0xF8:
        return b0 - 0xC0
    n = b0 - 0xF7
    return int.from_bytes(rlp[1:1 + n], "big")


def parse_receipt(rlp: bytes) -> list[int]:
    """Receipt RLP -> TrieData payload (mpt.rs:99-130)."""
    txn_type = rlp[0] if rlp[0] in (1, 2, 3) else 0
    body = rlp[1:] if txn_type else rlp
    status, cum_gas, bloom, logs = rlp_decode(body)
    out = [txn_type] if txn_type else []
    out.append(_rlp_payload_len(body))
    out.append(int.from_bytes(status, "big"))
    out.append(int.from_bytes(cum_gas, "big"))
    out.extend(bloom)
    # re-encode the logs list to get its payload length
    from ..mpt.rlp import rlp_encode
    logs_enc = rlp_encode(logs)
    out.append(_rlp_payload_len(logs_enc))
    out.append(len(logs))
    for log in logs:
        address, topics, data = log
        log_enc = rlp_encode(log)
        out.append(_rlp_payload_len(log_enc))
        out.append(int.from_bytes(address, "big"))
        out.append(len(topics))
        out.extend(int.from_bytes(t, "big") for t in topics)
        out.append(len(data))
        out.extend(data)
    return out


def _parse_txn(rlp: bytes) -> list[int]:
    return [len(rlp)] + list(rlp)


def load_mpt(node, trie_data: list[int], parse_value) -> int:
    """Generic trie load (mpt.rs:148-224). Returns the node pointer
    (0 for Empty)."""
    node_ptr = len(trie_data)
    t = _node_type(node)
    if t > 0:
        trie_data.append(t)

    if isinstance(node, Empty):
        return 0
    if isinstance(node, HashNode):
        trie_data.append(int.from_bytes(node.digest, "big"))
        return node_ptr
    if isinstance(node, Branch):
        first_child_ptr = len(trie_data)
        trie_data.extend([0] * 16)
        if not node.value:
            trie_data.append(0)
        else:
            parsed = parse_value(node.value)
            trie_data.append(len(trie_data) + 1)
            trie_data.extend(parsed)
        for i, child in enumerate(node.children):
            child_ptr = load_mpt(child, trie_data, parse_value)
            trie_data[first_child_ptr + i] = child_ptr
        return node_ptr
    if isinstance(node, Extension):
        trie_data.append(len(node.key))
        trie_data.append(_packed(node.key))
        trie_data.append(len(trie_data) + 1)
        child_ptr = load_mpt(node.child, trie_data, parse_value)
        if child_ptr == 0:
            trie_data.append(0)
        return node_ptr
    if isinstance(node, Leaf):
        trie_data.append(len(node.key))
        trie_data.append(_packed(node.key))
        trie_data.append(len(trie_data) + 1)
        trie_data.extend(parse_value(node.value))
        return node_ptr
    raise TypeError(type(node))


def load_state_trie(node, key: Nibbles, trie_data: list[int],
                    storage_by_key: dict) -> int:
    """State-trie load with per-account storage tries inlined
    (mpt.rs:225-331). `storage_by_key` maps packed 64-nibble state keys
    (bytes) to storage Tries."""
    node_ptr = len(trie_data)
    t = _node_type(node)
    if t > 0:
        trie_data.append(t)

    if isinstance(node, Empty):
        return 0
    if isinstance(node, HashNode):
        trie_data.append(int.from_bytes(node.digest, "big"))
        return node_ptr
    if isinstance(node, Branch):
        assert not node.value, "state branch with value"
        first_child_ptr = len(trie_data)
        trie_data.extend([0] * 16)
        trie_data.append(0)
        for i, child in enumerate(node.children):
            ext = key + Nibbles([i])
            child_ptr = load_state_trie(child, ext, trie_data,
                                        storage_by_key)
            trie_data[first_child_ptr + i] = child_ptr
        return node_ptr
    if isinstance(node, Extension):
        trie_data.append(len(node.key))
        trie_data.append(_packed(node.key))
        trie_data.append(len(trie_data) + 1)
        child_ptr = load_state_trie(node.child, key + node.key, trie_data,
                                    storage_by_key)
        if child_ptr == 0:
            trie_data.append(0)
        return node_ptr
    if isinstance(node, Leaf):
        nonce, balance, storage_root, code_hash = decode_account(node.value)
        merged = key + node.key
        storage_trie = _storage_for(merged, storage_root, storage_by_key)
        trie_data.append(len(node.key))
        trie_data.append(_packed(node.key))
        trie_data.append(len(trie_data) + 1)
        trie_data.append(nonce)
        trie_data.append(balance)
        storage_ptr_ptr = len(trie_data)
        trie_data.append(len(trie_data) + 2)
        trie_data.append(int.from_bytes(code_hash, "big"))
        storage_ptr = load_mpt(storage_trie, trie_data,
                               lambda _rlp: [])
        if storage_ptr == 0:
            trie_data[storage_ptr_ptr] = 0
        return node_ptr
    raise TypeError(type(node))


def _storage_for(merged_key: Nibbles, storage_root: bytes, storage_by_key):
    """Resolve an account's storage trie node: the supplied trie if one
    was given, else a hash-only stand-in (mpt.rs:296-305)."""
    st = storage_by_key.get(bytes(merged_key.nibs))
    if st is None:
        if storage_root == Trie().root_hash():
            return Empty()
        return HashNode(storage_root)
    assert st.root_hash() == storage_root, \
        "account storage_root != storage trie hash"
    return st.root


def get_state_and_storage_leaves(node, key: Nibbles,
                                 state_leaves: list[int],
                                 storage_leaves: list[int],
                                 trie_data: list[int],
                                 accounts_ptrs: dict,
                                 storage_ptrs: dict,
                                 storage_by_key: dict) -> None:
    """Walk the state trie collecting account/storage linked-list nodes
    (mpt.rs:333-444)."""
    if isinstance(node, Branch):
        assert not node.value, "state branch with value"
        for i, child in enumerate(node.children):
            get_state_and_storage_leaves(
                child, key + Nibbles([i]), state_leaves, storage_leaves,
                trie_data, accounts_ptrs, storage_ptrs, storage_by_key)
        return
    if isinstance(node, Extension):
        get_state_and_storage_leaves(
            node.child, key + node.key, state_leaves, storage_leaves,
            trie_data, accounts_ptrs, storage_ptrs, storage_by_key)
        return
    if isinstance(node, Leaf):
        nonce, balance, storage_root, code_hash = decode_account(node.value)
        merged = key + node.key
        storage_trie = _storage_for(merged, storage_root, storage_by_key)
        # link previous tail to this node
        n = len(state_leaves)
        state_leaves[n - 1] = scaled(Segment.AccountsLinkedList) + n
        addr_key = _packed(merged)
        state_leaves.append(addr_key)
        state_leaves.append(len(trie_data))      # value_ptr
        state_leaves.append(0)                   # counter
        state_leaves.append(scaled(Segment.AccountsLinkedList))  # next=head
        # account payload in TrieData (storage ptr written by the kernel)
        trie_data.append(nonce)
        trie_data.append(balance)
        trie_data.append(0)
        trie_data.append(int.from_bytes(code_hash, "big"))
        get_storage_leaves(addr_key, Nibbles(), storage_trie,
                           storage_leaves, storage_ptrs)
        accounts_ptrs[addr_key] = scaled(Segment.AccountsLinkedList) + n
        return
    # Empty / HashNode contribute no leaves


def get_storage_leaves(addr_key: int, key: Nibbles, node,
                       storage_leaves: list[int],
                       storage_ptrs: dict) -> None:
    """mpt.rs:446-529."""
    if isinstance(node, Branch):
        for i, child in enumerate(node.children):
            get_storage_leaves(addr_key, key + Nibbles([i]), child,
                               storage_leaves, storage_ptrs)
        return
    if isinstance(node, Extension):
        get_storage_leaves(addr_key, key + node.key, node.child,
                           storage_leaves, storage_ptrs)
        return
    if isinstance(node, Leaf):
        n = len(storage_leaves)
        storage_leaves[n - 1] = scaled(Segment.StorageLinkedList) + n
        merged = key + node.key
        slot_key = _packed(merged)
        storage_leaves.append(addr_key)
        storage_leaves.append(slot_key)
        [value] = _parse_storage_value(node.value)
        storage_leaves.append(value)
        storage_leaves.append(0)                 # counter
        storage_leaves.append(scaled(Segment.StorageLinkedList))
        storage_ptrs[(addr_key, slot_key)] = \
            scaled(Segment.StorageLinkedList) + n
        return


def empty_list_mem(segment_idx: int, node_size: int) -> list[int]:
    """[U256_MAX, 0.., segment] head node (linked_list.rs:27-37)."""
    out = [0] * node_size
    out[0] = U256_MAX
    out[-1] = scaled(segment_idx)
    return out


def load_linked_lists_and_txn_and_receipt_mpts(trie_inputs):
    """mpt.rs:541-591. `trie_inputs` has .state_trie (Trie),
    .transactions_trie (Trie), .receipts_trie (Trie), .storage_tries
    (list of (state_key_bytes32, Trie)).

    Returns (trie_root_ptrs dict, state_leaves, storage_leaves,
    trie_data, accounts_ptrs, storage_ptrs)."""
    state_leaves = empty_list_mem(Segment.AccountsLinkedList,
                                  ACCOUNTS_LINKED_LIST_NODE_SIZE)
    storage_leaves = empty_list_mem(Segment.StorageLinkedList,
                                    STORAGE_LINKED_LIST_NODE_SIZE)
    trie_data = [0]
    accounts_ptrs: dict = {}
    storage_ptrs: dict = {}

    storage_by_key = {
        bytes(Nibbles.from_bytes(h).nibs): st
        for h, st in trie_inputs.storage_tries}

    txn_root_ptr = load_mpt(trie_inputs.transactions_trie.root, trie_data,
                            _parse_txn)
    receipt_root_ptr = load_mpt(trie_inputs.receipts_trie.root, trie_data,
                                parse_receipt)
    get_state_and_storage_leaves(
        trie_inputs.state_trie.root, Nibbles(), state_leaves,
        storage_leaves, trie_data, accounts_ptrs, storage_ptrs,
        storage_by_key)

    root_ptrs = {"state": None, "txn": txn_root_ptr,
                 "receipt": receipt_root_ptr}
    return (root_ptrs, state_leaves, storage_leaves, trie_data,
            accounts_ptrs, storage_ptrs)


def load_state_mpt(trie_inputs, trie_data: list[int]) -> int:
    """mpt.rs:593-613: load the full state trie (for trie_ptr::
    initial_state, served lazily on the first request)."""
    storage_by_key = {
        bytes(Nibbles.from_bytes(h).nibs): st
        for h, st in trie_inputs.storage_tries}
    return load_state_trie(trie_inputs.state_trie.root, Nibbles(),
                           trie_data, storage_by_key)
