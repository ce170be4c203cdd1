"""The port's RPC frontend (`zk_evm_tpu_torch/rpc/`, byte-for-byte copies
of the JAX package's, pinned in tests/test_torch_isolation.py) against the
JAX package: the twins of `tests/test_rpc.py`'s cases, the native
fetcher's whole BlockProverInput object equal to the JAX package's, and
the same fetch through `HttpTransport` against a JSON-RPC node on
127.0.0.1 (`rpc/loopback.py`). The jerigon case replays an artifact of
the reference checkout and skips where it is absent, as in the JAX
package. No XLA compile: both packages' fetchers are host code."""

import hashlib
import json

import pytest

from zk_evm_tpu.rpc import (CachedProvider as JCachedProvider,
                            MockTransport as JMockTransport)
from zk_evm_tpu.rpc.fetch import (
    native_block_prover_input as jnative_block_prover_input)
from zk_evm_tpu_torch.decoder import parse_block_prover_input
from zk_evm_tpu_torch.mpt import Nibbles, Trie
from zk_evm_tpu_torch.mpt.builder import PartialTrieBuilder
from zk_evm_tpu_torch.native import keccak256
from zk_evm_tpu_torch.rpc import (BlockInterval, CachedProvider,
                                  MockTransport, RetryTransport, RpcError,
                                  TransportError, consolidate_hashes)
from zk_evm_tpu_torch.rpc.fetch import (jerigon_block_prover_input,
                                        native_block_prover_input)
from zk_evm_tpu_torch.rpc.loopback import serve_loopback, toy_native_block
from zk_evm_tpu_torch.rpc.provider import HttpTransport
from test_rpc import CASES, needs_cases     # the JAX tests' artifact cases

# sha256 of json.dumps(obj, sort_keys=True) of the JAX package's
# native_block_prover_input of the toy block (toy_native_block(), the
# case of tests/test_rpc.py); chip_smoke.py holds the same constant
NATIVE_TOY_SHA256 = (
    "a65989905ba91c079aee142de6d42c847b8f0980596f1403c736a72fdbfa4b71")


def obj_sha256(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()) \
        .hexdigest()


# ------------------------------------------------------------- transport

class FlakyTransport:
    def __init__(self, fail_times, result="ok"):
        self.fail_times = fail_times
        self.calls = 0
        self.result = result

    def __call__(self, method, params):
        self.calls += 1
        if self.calls <= self.fail_times:
            raise TransportError("boom")
        return self.result


def test_retry_transport_retries_transport_errors():
    t = RetryTransport(FlakyTransport(2), max_retries=3)
    assert t("eth_blockNumber", []) == "ok"

    t = RetryTransport(FlakyTransport(5), max_retries=3)
    with pytest.raises(TransportError):
        t("eth_blockNumber", [])


def test_retry_transport_does_not_retry_rpc_errors():
    calls = []

    def inner(method, params):
        calls.append(method)
        raise RpcError(method, {"code": -32000})

    with pytest.raises(RpcError):
        RetryTransport(inner, max_retries=3)("eth_call", [])
    assert len(calls) == 1


def test_cached_provider_caches_header_blocks():
    mt = MockTransport()
    hdr = {"number": "0x10", "hash": "0x" + "ab" * 32}
    mt.expect("eth_getBlockByNumber", ["0x10", False], hdr)
    p = CachedProvider(mt)
    assert p.get_block(16) == hdr
    assert p.get_block(16) == hdr            # served from cache
    assert len(mt.requests) == 1
    assert p.get_block_by_hash("0x" + "AB" * 32) == hdr
    assert len(mt.requests) == 1
    full = dict(hdr, transactions=[])
    mt.expect("eth_getBlockByNumber", ["0x10", True], full)
    assert p.get_block(16, full_txns=True) == full
    assert p.block_to_num("0x" + "ab" * 32) == 16


def test_http_transport_is_constructible():
    t = HttpTransport("http://localhost:0", timeout=0.01)
    with pytest.raises(TransportError):
        t("eth_blockNumber", [])


def test_http_transport_over_loopback():
    """A result and a JSON-RPC error through real HTTP on 127.0.0.1."""
    mt = MockTransport()
    mt.expect("eth_blockNumber", [], "0x6")
    server, url = serve_loopback(mt)
    try:
        t = HttpTransport(url, timeout=10)
        assert t("eth_blockNumber", []) == "0x6"
        with pytest.raises(RpcError):
            t("eth_chainId", [])
        assert CachedProvider(t).latest_block_number() == 6
    finally:
        server.shutdown()
    assert [m for m, _ in mt.requests] == ["eth_blockNumber", "eth_chainId",
                                           "eth_blockNumber"]


# --------------------------------------------------------- block interval

def test_block_interval_parse_and_stream():
    assert BlockInterval.parse("7") == BlockInterval(7, 7)
    assert BlockInterval.parse("2..5") == BlockInterval(2, 5)
    assert BlockInterval.parse("9..") == BlockInterval(9, None)
    assert str(BlockInterval(2, 5)) == "2..5"

    assert list(BlockInterval(3, 3).bounded()) == [(3, True)]
    assert list(BlockInterval(2, 4).bounded()) == \
        [(2, False), (3, False), (4, True)]
    with pytest.raises(ValueError):
        list(BlockInterval(2, None).bounded())


def test_block_interval_new_and_follow():
    mt = MockTransport()
    mt.expect("eth_blockNumber", [], "0x6")
    p = CachedProvider(mt)
    assert BlockInterval.new(p, 3, 5) == BlockInterval(3, 5)
    assert BlockInterval.new(p, 3, 3) == BlockInterval(3, 3)
    assert BlockInterval.new(p, "latest") == BlockInterval(6, None)
    with pytest.raises(ValueError):
        BlockInterval.new(p, 5, 3)

    heads = iter(["0x6", "0x6", "0x7", "0x7"])
    mt2 = MockTransport()
    mt2.handle("eth_blockNumber", lambda p: next(heads))
    slept = []
    gen = BlockInterval(6, None).unbounded(
        CachedProvider(mt2), block_time_ms=10,
        sleep=lambda s: slept.append(s))
    assert next(gen) == (6, False)
    assert next(gen) == (7, False)
    assert slept


# ------------------------------------------------ proof-fed trie builder

def _trie_with(n):
    t = Trie()
    keys = []
    for i in range(n):
        k = Nibbles.from_bytes(keccak256(i.to_bytes(4, "big")))
        t.insert(k, b"value-%d" % i)
        keys.append(k)
    return t, keys


def test_get_proof_and_builder_roundtrip():
    t, keys = _trie_with(50)
    builder = PartialTrieBuilder(t.root_hash())
    proven = keys[:5]
    for k in proven:
        proof = t.get_proof(k)
        assert proof
        builder.insert_proof(proof)
    partial = builder.build()
    assert partial.root_hash() == t.root_hash()
    for i, k in enumerate(proven):
        assert partial.get(k) == b"value-%d" % i
    with pytest.raises(KeyError):
        partial.get(keys[40])


def test_builder_empty_and_unknown_roots():
    from zk_evm_tpu_torch.mpt import EMPTY_TRIE_HASH
    assert PartialTrieBuilder(EMPTY_TRIE_HASH).build().root_hash() \
        == EMPTY_TRIE_HASH
    digest = keccak256(b"unknown")
    t = PartialTrieBuilder(digest).build()
    assert t.root_hash() == digest


def test_short_node_variants_resolve_moved_leaves():
    t, keys = _trie_with(50)
    post = t.snapshot()
    post_proof = post.get_proof(keys[0])
    b = PartialTrieBuilder(t.root_hash())
    b.insert_short_node_variants_from_proof(post_proof)
    assert len(b.nodes) > len(post_proof)


def test_consolidate_hashes_equals_jax():
    from zk_evm_tpu.field.host import P
    from zk_evm_tpu.rpc import consolidate_hashes as jconsolidate
    hashes = [i.to_bytes(32, "big") for i in range(256)]
    d = consolidate_hashes(hashes)
    assert len(d) == 4 and all(0 <= x < P for x in d)
    assert d == jconsolidate(hashes)
    d2 = consolidate_hashes(list(reversed(hashes)))
    assert d != d2
    assert d2 == jconsolidate(list(reversed(hashes)))


# ------------------------------------------------------- jerigon fetcher

def _prev_hash_call_result(cur_hash, prev_hashes):
    data = bytes.fromhex(cur_hash[2:])
    for h in reversed(prev_hashes):
        data += bytes.fromhex(h[2:])
    return "0x" + data.hex()


@needs_cases
def test_jerigon_fetch_reproduces_reference_artifact():
    artifact = json.load(open(f"{CASES}/b4_dev.json"))[0]
    header = json.load(open(f"{CASES}/b4_dev_header.json"))[0]
    bmeta = artifact["other_data"]["b_data"]["b_meta"]
    bhashes = artifact["other_data"]["b_data"]["b_hashes"]
    query = ("0x60005B60010180430340816020025280610101116300000002576120205"
             "FF3")

    mt = MockTransport()
    mt.expect("eth_getBlockByNumber", ["0x4", False], header)
    mt.expect("eth_chainId", [], bmeta["block_chain_id"])
    mt.expect("eth_getWitness", ["0x4"],
              artifact["block_trace"]["trie_pre_images"]["combined"]
              ["compact"])
    mt.expect("debug_traceBlockByNumber",
              ["0x4", {"tracer": "zeroTracer"}],
              [{"txHash": "0x%02x" % i, "result": ti}
               for i, ti in
               enumerate(artifact["block_trace"]["txn_info"])])
    mt.expect("eth_call", [{"data": query}, "0x4"],
              _prev_hash_call_result(bhashes["cur_hash"],
                                     bhashes["prev_hashes"]))
    cp_root = artifact["other_data"]["checkpoint_state_trie_root"]
    mt.expect("eth_getBlockByNumber", ["0x0", False],
              {"number": "0x0", "hash": "0x" + "11" * 32,
               "stateRoot": cp_root})
    mt.expect("eth_call", [{"data": query}, "0x1"],
              _prev_hash_call_result("0x" + "11" * 32,
                                     ["0x" + "00" * 32] * 255
                                     + ["0x" + "11" * 32]))

    obj = jerigon_block_prover_input(CachedProvider(mt), 4,
                                     checkpoint_block_number=0)
    got = parse_block_prover_input(obj)
    want = parse_block_prover_input(artifact)
    assert got.trie_roots_before().state_root \
        == want.trie_roots_before().state_root
    assert got.block_metadata == want.block_metadata
    assert got.block_hashes == want.block_hashes
    assert got.checkpoint_state_trie_root == want.checkpoint_state_trie_root
    assert len(got.txn_info) == len(want.txn_info)
    for g, w in zip(got.txn_info, want.txn_info):
        assert g.byte_code == w.byte_code
        assert g.receipt_node_bytes == w.receipt_node_bytes
        assert g.traces == w.traces
    assert len(got.checkpoint_consolidated_hash) == 4


# -------------------------------------------------------- native fetcher

def check_toy_block(obj, facts) -> None:
    """What tests/test_rpc.py checks of the fetched toy block."""
    sep = obj["block_trace"]["trie_pre_images"]["separate"]
    assert sep["state"]["direct"]["root"] == "0x" + facts["root"].hex()
    bpi = parse_block_prover_input(obj)
    assert bpi.trie_roots_before().state_root == facts["root"]
    hashed = keccak256(facts["sender"])
    assert hashed in bpi.pre_state.storage
    assert bpi.pre_state.storage[hashed].root_hash() \
        == facts["storage_root"]
    tr = bpi.txn_info[0].traces[facts["sender"].rjust(20, b"\x00")]
    assert tr.balance == facts["balance"]
    assert tr.nonce == facts["nonce"]
    assert (1).to_bytes(32, "big") in tr.storage_written


def jax_toy_object():
    """The JAX package's fetch of the same toy block, its node replayed
    from the port's canned one."""
    node, _ = toy_native_block()
    jnode = JMockTransport()
    jnode.canned = node.canned
    jnode.handlers = node.handlers
    return jnative_block_prover_input(JCachedProvider(jnode), 1,
                                      checkpoint_block_number=0)


def test_native_fetch_builds_witness_from_proofs():
    node, facts = toy_native_block()
    obj = native_block_prover_input(CachedProvider(node), 1,
                                    checkpoint_block_number=0)
    check_toy_block(obj, facts)
    assert obj == jax_toy_object()
    assert obj_sha256(obj) == NATIVE_TOY_SHA256


def test_native_fetch_over_loopback_http():
    """The same fetch through HttpTransport and a node on 127.0.0.1:
    the same object as through the MockTransport, byte for byte."""
    node, facts = toy_native_block()
    server, url = serve_loopback(node)
    try:
        obj = native_block_prover_input(
            CachedProvider(HttpTransport(url, timeout=30)), 1,
            checkpoint_block_number=0)
    finally:
        server.shutdown()
    check_toy_block(obj, facts)
    assert obj_sha256(obj) == NATIVE_TOY_SHA256
    assert ("eth_getProof" in {m for m, _ in node.requests})
