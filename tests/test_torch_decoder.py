"""The block decoder of the PyTorch port against the JAX package.

`zk_evm_tpu_torch/decoder/`, `mpt/builder.py` and `smt/` are jax-free
copies of the JAX package's modules. Every case here feeds the same
inputs to both packages and compares the results exactly (tolerance 0):

- the reference-free cases of `tests/test_decoder.py` (wire keys and
  headers, the type-1 and type-2 frontends' refusals, trie subsets,
  batching, receipts, gwei);
- wire round trips and type-1 decoding of instruction streams built
  here;
- the `PartialTrieBuilder` cases of `tests/test_rpc.py`;
- block witnesses written from the in-repo fixtures
  (`witness.testing_fixtures.build_witness_chain`): add11 and
  simple-transfer, each with its txn-less child block. Both packages'
  `parse_block_prover_input` + `entrypoint` give equal GenerationInputs,
  the last batch ends at the fixture's own roots, and the port's witness
  generation of every decoded batch equals the JAX package's.
"""

import dataclasses
import json

import numpy as np
import pytest

import zk_evm_tpu.decoder as jdecoder
import zk_evm_tpu.decoder.core as jcore
import zk_evm_tpu.decoder.inputs as jinputs
import zk_evm_tpu.decoder.type1 as jtype1
import zk_evm_tpu.decoder.type2 as jtype2
import zk_evm_tpu.decoder.wire as jwire
import zk_evm_tpu.mpt.builder as jbuilder
import zk_evm_tpu.mpt.rlp as jrlp
import zk_evm_tpu.mpt.trie as jtrie
import zk_evm_tpu_torch.decoder as pdecoder
import zk_evm_tpu_torch.decoder.core as pcore
import zk_evm_tpu_torch.decoder.inputs as pinputs
import zk_evm_tpu_torch.decoder.type1 as ptype1
import zk_evm_tpu_torch.decoder.type2 as ptype2
import zk_evm_tpu_torch.decoder.wire as pwire
import zk_evm_tpu_torch.mpt.builder as pbuilder
import zk_evm_tpu_torch.mpt.rlp as prlp
import zk_evm_tpu_torch.mpt.trie as ptrie
from zk_evm_tpu_torch.native import keccak256
from zk_evm_tpu_torch.witness.testing_fixtures import build_witness_chain

JAX = dict(wire=jwire, type1=jtype1, type2=jtype2, core=jcore,
           inputs=jinputs, trie=jtrie, rlp=jrlp, builder=jbuilder,
           decoder=jdecoder)
PORT = dict(wire=pwire, type1=ptype1, type2=ptype2, core=pcore,
            inputs=pinputs, trie=ptrie, rlp=prlp, builder=pbuilder,
            decoder=pdecoder)


def both(case):
    """Run `case(modules)` on both packages; the results must be equal."""
    got, want = case(PORT), case(JAX)
    assert got == want
    return got


def raised(fn, *args):
    """The name of the exception `fn(*args)` raises, or its result."""
    try:
        return ("ok", fn(*args))
    except Exception as e:               # noqa: BLE001 - compared below
        return ("raised", type(e).__name__, str(e))


# ------------------------------------------------- tests/test_decoder.py

@pytest.mark.parametrize("raw, want", [
    (b"\x0a", (10,)),                       # one bare nibble
    (bytes([0x00, 0x12, 0x34]), (1, 2, 3, 4)),
    (bytes([0x01, 0x12, 0x30]), (1, 2, 3)),  # odd: one high tail nibble
    (bytes([0x02, 0xab]), (10, 11)),         # terminated flag tolerated
    (bytes([0x10]), None),                   # single nibble out of range
    (bytes([0x04, 0x12]), None),             # unknown flag bit
])
def test_decode_key(raw, want):
    got = both(lambda m: raised(m["wire"].decode_key, raw))
    if want is None:
        assert got[:2] == ("raised", "WireError")
    else:
        assert got == ("ok", want)


@pytest.mark.parametrize("blob", [b"\x02\x06", b"\x01\xfe"])
def test_parse_rejects_bad_header(blob):
    assert both(lambda m: raised(m["wire"].parse_wire, blob))[:2] \
        == ("raised", "WireError")


def test_empty_root_witness():
    root = both(lambda m: m["type1"].type1_frontend(b"\x01\x06")
                .state_root())
    assert root == ptrie.EMPTY_TRIE_HASH


def test_smt_leaf_rejected_in_type1():
    blob = b"\x01\x07\x00\x41\xaa\x41\x01"
    assert both(lambda m: raised(m["type1"].type1_frontend, blob))[:2] \
        == ("raised", "Type1Error")


def test_type2_double_write_rejected():
    def case(m):
        ins = m["wire"].Instruction
        leaf = ins("smt_leaf", smt_node_type=0, smt_address=b"\xaa" * 20,
                   value=b"\x01")
        return raised(m["type2"].type2_frontend,
                      [ins("branch", mask=0b11), leaf, leaf])
    assert both(case)[:2] == ("raised", "Type2Error")


def test_trie_subset_and_reporting_delete():
    def case(m):
        trie = m["trie"]
        t = trie.Trie()
        keys = {}
        for i in range(40):
            k = trie.Nibbles.from_bytes(bytes([i]) * 4)
            t.insert(k, bytes([i + 1]) * 40)
            keys[i] = k
        root = t.root_hash()
        sub = t.subset([keys[3], keys[7]])
        assert sub.root_hash() == root
        assert sub.get(keys[3]) == bytes([4]) * 40
        kept = len(sub.items())
        assert kept < 40
        t2 = trie.Trie()
        t2.insert(trie.Nibbles([1, 2, 3]), b"a" * 40)
        t2.insert(trie.Nibbles([1, 2, 4]), b"b" * 40)
        rep = t2.delete_reporting(trie.Nibbles([1, 2, 3]))
        assert list(rep) == [1, 2, 4]
        return root, kept, list(rep), t2.root_hash()
    both(case)


@pytest.mark.parametrize("txns, hint, want", [
    ([], 0, [1, 1]), ([1], 0, [1, 1]), ([1, 2], 0, [1, 1]),
    ([1, 2, 3], 1, [1, 1, 1]), ([1, 2, 3], 2, [2, 1]),
    ([1, 2, 3], 3, [1, 2]), ([], 5, [1, 1]),
])
def test_batch_txns_shapes(txns, hint, want):
    """Always at least two batches, dummy-padded when the block is short
    (core.rs:302-321)."""
    got = both(lambda m: m["core"].batch_txns(txns, hint))
    assert [len(b) for b in got] == want
    if not txns:
        assert got[0] == [None]


def test_gwei_to_wei():
    assert both(lambda m: m["core"].gwei_to_wei(3)) == 3 * 10**9


def test_receipt_status():
    legacy_ok = prlp.rlp_encode([1, 21000, b"\x00" * 256, []])
    legacy_fail = prlp.rlp_encode([b"", 21000, b"\x00" * 256, []])
    typed = b"\x02" + prlp.rlp_encode([1, 2, b"\x00" * 256, []])
    assert both(lambda m: [m["core"].receipt_status(r) for r in
                           (legacy_ok, legacy_fail, typed)]) == [1, 0, 1]


def test_map_receipt_bytes():
    legacy = prlp.rlp_encode([1, 21000, b"\x00" * 256, []])
    typed = b"\x02" + prlp.rlp_encode([1, 2, 3])
    wrapped = prlp.rlp_encode(typed)
    assert both(lambda m: [m["inputs"].map_receipt_bytes(r)
                           for r in (legacy, wrapped)]) == [legacy, typed]


# ------------------------------------------------- wire streams built here

CODE = bytes([0x60, 0x01, 0x60, 0x01, 0x01, 0x60, 0x00, 0x55, 0x00])


def type1_stream(m, seed):
    """A state trie of three children under one branch: an account with
    code and one storage slot, a hashed-out subtree and a plain account;
    keys and balances from `seed`."""
    rng = np.random.default_rng(seed)

    def nibs(n):
        return tuple(int(x) for x in rng.integers(0, 16, size=n))
    ins = m["wire"].Instruction
    return [
        ins("code", value=CODE),
        ins("leaf", key=nibs(64), value=bytes([int(rng.integers(1, 256))])),
        ins("account", key=nibs(63), nonce=1,
            balance=int(rng.integers(1, 2**62)), has_code=True,
            has_storage=True, code_length=len(CODE)),
        ins("hash", value=bytes(rng.integers(0, 256, size=32,
                                             dtype=np.uint8))),
        ins("account", key=nibs(63), nonce=7,
            balance=int(rng.integers(1, 2**62))),
        ins("branch", mask=(1 << 0) | (1 << 5) | (1 << 9)),
    ]


def smt_stream(m):
    ins = m["wire"].Instruction
    return [
        ins("smt_leaf", smt_node_type=0, smt_address=b"\x11" * 20,
            value=(10**18).to_bytes(8, "big")),
        ins("smt_leaf", smt_node_type=3, smt_address=b"\x22" * 20,
            smt_slot=b"\x07", value=b"\xde\xad"),
        ins("branch", mask=0b11),
        ins("new_trie"),
        ins("empty"),
        ins("ext", key=(1, 2, 3)),
    ]


@pytest.mark.parametrize("stream", ["type1-a", "type1-b", "smt"])
def test_wire_roundtrip(stream):
    """encode -> parse is the identity on instruction lists, and both
    packages write and read the same bytes."""
    def case(m):
        ins = type1_stream(m, {"type1-a": 1, "type1-b": 2}[stream]) \
            if stream != "smt" else smt_stream(m)
        blob = m["wire"].encode_wire(ins)
        back = m["wire"].parse_wire(blob)
        assert back == ins
        return blob, [dataclasses.astuple(i) for i in back]
    both(case)


@pytest.mark.parametrize("seed", [1, 2])
def test_type1_frontend_of_built_stream(seed):
    def case(m):
        fe = m["type1"].type1_frontend(
            m["wire"].encode_wire(type1_stream(m, seed)))
        return (fe.state_root(),
                {h: t.root_hash() for h, t in fe.storage.items()},
                fe.code, [(tuple(k), v) for k, v in fe.state.items()])
    root, storage, code, items = both(case)
    assert code == {keccak256(CODE): CODE}
    assert len(storage) == 2 and len(items) == 2


# --------------------------------------- tests/test_rpc.py, the builder

def trie_with(m, n):
    trie = m["trie"]
    t = trie.Trie()
    keys = []
    for i in range(n):
        k = trie.Nibbles.from_bytes(keccak256(i.to_bytes(4, "big")))
        t.insert(k, b"value-%d" % i)
        keys.append(k)
    return t, keys


def test_get_proof_and_builder_roundtrip():
    def case(m):
        t, keys = trie_with(m, 50)
        builder = m["builder"].PartialTrieBuilder(t.root_hash())
        proofs = [t.get_proof(k) for k in keys[:5]]
        for proof in proofs:
            assert proof
            builder.insert_proof(proof)
        partial = builder.build()
        assert partial.root_hash() == t.root_hash()
        got = [partial.get(k) for k in keys[:5]]
        assert got == [b"value-%d" % i for i in range(5)]
        with pytest.raises(KeyError):
            partial.get(keys[40])
        return proofs, partial.root_hash(), builder.to_json()
    both(case)


def test_builder_empty_and_unknown_roots():
    digest = keccak256(b"unknown")

    def case(m):
        empty = m["builder"].PartialTrieBuilder(
            m["trie"].EMPTY_TRIE_HASH).build().root_hash()
        unknown = m["builder"].PartialTrieBuilder(digest).build()
        return empty, unknown.root_hash()
    assert both(case) == (ptrie.EMPTY_TRIE_HASH, digest)


def test_short_node_variants_resolve_moved_leaves():
    def case(m):
        t, keys = trie_with(m, 50)
        post_proof = t.snapshot().get_proof(keys[0])
        b = m["builder"].PartialTrieBuilder(t.root_hash())
        b.insert_short_node_variants_from_proof(post_proof)
        assert len(b.nodes) > len(post_proof)
        return b.to_json()
    both(case)


# ---------------------------------------------- fixture block witnesses

CHAINS = ("add11", "simple-transfer")


@pytest.fixture(scope="module")
def chains():
    """name -> (witness JSON list [A, B] as read from a file, the roots
    each block must end at)."""
    out = {}
    for name in CHAINS:
        witnesses, roots = build_witness_chain(name)
        out[name] = (json.loads(json.dumps(witnesses)), roots)
    return out


def decode(m, witness, batch_size=10):
    bpi = m["decoder"].parse_block_prover_input(witness)
    return bpi, m["decoder"].entrypoint(bpi, batch_size_hint=batch_size)


def summary(bpi, gis):
    """Every GenerationInputs field as plain values: before-trie root
    hashes, the signed txns, code, withdrawals, counters, roots after,
    the checkpoint and the block's metadata and hashes."""
    def roots(tr):
        return (tr.state_root, tr.transactions_root, tr.receipts_root)
    out = [bpi.trie_roots_before().state_root, bpi.checkpoint_state_trie_root,
           bpi.checkpoint_consolidated_hash, bpi.withdrawals]
    for g in gis:
        t = g.tries
        out.append(dict(
            before=(t.state.root_hash(),
                    sorted((h, s.root_hash()) for h, s in t.storage.items()),
                    t.transactions.trie.root_hash(),
                    t.receipts.trie.root_hash(),
                    sorted((tuple(k), v) for k, v in t.state.items())),
            txns=(g.txn_number_before, list(g.signed_txns)),
            gas=(g.gas_used_before, g.gas_used_after),
            withdrawals=list(g.withdrawals),
            code=dict(g.contract_code),
            after=roots(g.trie_roots_after),
            checkpoint=(g.checkpoint_state_trie_root,
                        tuple(g.checkpoint_consolidated_hash)),
            meta=dataclasses.astuple(g.block_metadata),
            hashes=dataclasses.astuple(g.block_hashes)))
    return out


@pytest.mark.parametrize("name", CHAINS)
@pytest.mark.parametrize("block", [0, 1])
def test_fixture_witness_decodes_alike(chains, name, block):
    witnesses, roots = chains[name]
    got = summary(*decode(PORT, witnesses[block]))
    assert got == summary(*decode(JAX, witnesses[block]))
    bpi, gis = decode(PORT, witnesses[block])
    assert len(gis) == 2
    assert gis[-1].trie_roots_after == roots[block]
    assert gis[-1].gas_used_after == bpi.block_metadata.block_gas_used
    # untouched accounts reach the prover as hashed-out subtrees
    assert len(gis[1].tries.state.items()) < len(bpi.pre_state.state.items())


@pytest.mark.parametrize("name", CHAINS)
def test_fixture_chain_links(chains, name):
    """Block A's post-state is block B's pre-state; B pays its one
    withdrawal in wei in its last batch and starts both batches at txn 0;
    A's second (dummy) batch starts after its one txn, at its gas."""
    witnesses, _ = chains[name]
    (bpi_a, gis_a), (bpi_b, gis_b) = (decode(PORT, w) for w in witnesses)
    assert gis_a[-1].trie_roots_after.state_root \
        == bpi_b.trie_roots_before().state_root
    assert [g.txn_number_before for g in gis_a] == [0, 1]
    assert gis_a[1].gas_used_before == gis_a[0].gas_used_after > 0
    assert gis_a[1].signed_txns == []
    assert [g.txn_number_before for g in gis_b] == [0, 0]
    assert [len(g.withdrawals) for g in gis_b] == [0, 1]
    ((_, wei),) = gis_b[1].withdrawals
    assert wei == bpi_b.withdrawals[0][1] * 10**9
    assert bpi_b.block_metadata.block_number \
        == bpi_a.block_metadata.block_number + 1


def test_checkpoint_anchor(chains):
    """add11 anchors at its checkpoint (its pre-state root), and so does
    the chain's first block under `decode`'s check; its child does not."""
    for name, want in (("add11", [True, False]),
                       ("simple-transfer", [False, False])):
        witnesses, _ = chains[name]
        got = [decode(PORT, w)[0].trie_roots_before().state_root
               == decode(PORT, w)[0].checkpoint_state_trie_root
               for w in witnesses]
        assert got == want


@pytest.fixture(scope="module")
def decoded_batches(chains):
    """(name, block, batch) -> (port GenerationInputs, JAX
    GenerationInputs), each chain restamped with its consolidated hash as
    `prove --witness` does."""
    from zk_evm_tpu.orchestration.aggregation import (
        rewrite_checkpoint_consolidation as jrewrite)
    from zk_evm_tpu_torch.orchestration.aggregation import (
        rewrite_checkpoint_consolidation)
    out = {}
    for name in CHAINS:
        witnesses, _ = chains[name]
        port = [decode(PORT, w)[1] for w in witnesses]
        jax_ = [decode(JAX, w)[1] for w in witnesses]
        assert rewrite_checkpoint_consolidation(port) == jrewrite(jax_)
        for b, (pg, jg) in enumerate(zip(port, jax_)):
            for i, pair in enumerate(zip(pg, jg)):
                out[name, b, i] = pair
    return out


@pytest.mark.parametrize("batch", [0, 1])
@pytest.mark.parametrize("block", [0, 1])
@pytest.mark.parametrize("name", CHAINS)
def test_decoded_batch_witness_equal(decoded_batches, name, block, batch,
                                     monkeypatch):
    """The port's witness generation of a decoded batch (masked tries
    with hashed-out parts, dummy batches, the withdrawal) equals the JAX
    package's: every trace, the tables in use and the public values."""
    from zk_evm_tpu.stark.public_values import (
        public_values_to_dict as jpublic_values_to_dict)
    from zk_evm_tpu.witness.assembler import (
        combined_kernel as jcombined_kernel)
    from zk_evm_tpu.witness.segments import (
        generate_segment_tables as jgenerate_segment_tables)
    from zk_evm_tpu_torch.stark.public_values import public_values_to_dict
    from zk_evm_tpu_torch.witness.kernel import combined_kernel
    from zk_evm_tpu_torch.witness.segments import generate_segment_tables

    monkeypatch.delenv("ZK_TABLE_MIN_DEGREES", raising=False)
    pgi, jgi = decoded_batches[name, block, batch]
    port = [gt for _, gt in generate_segment_tables(combined_kernel(), pgi)]
    jax_ = [gt for _, gt in jgenerate_segment_tables(jcombined_kernel(),
                                                     jgi)]
    assert len(port) == len(jax_) == 1
    (g,), (w,) = port, jax_
    assert g.table_in_use == w.table_in_use
    for a, b in zip(g.traces, w.traces, strict=True):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert public_values_to_dict(g.public_values) \
        == jpublic_values_to_dict(w.public_values)
    assert g.public_values.trie_roots_after == pgi.trie_roots_after


def block_statement(pv, gis):
    """The block statement that a proof of the decoded batches `gis`
    would carry, without proving: the first batch's pre-state root, the
    last batch's roots after, the counters, checkpoint, metadata and
    hashes (the fields `check_block_parent` reads)."""
    first, last = gis[0], gis[-1]
    return pv.PublicValues(
        trie_roots_before=pv.TrieRoots(
            state_root=first.tries.state.root_hash()),
        trie_roots_after=last.trie_roots_after,
        block_metadata=first.block_metadata,
        block_hashes=first.block_hashes,
        extra_block_data=pv.ExtraBlockData(
            checkpoint_state_trie_root=first.checkpoint_state_trie_root,
            checkpoint_consolidated_hash=tuple(
                first.checkpoint_consolidated_hash),
            txn_number_before=first.txn_number_before,
            txn_number_after=last.txn_number_before
            + len(last.signed_txns),
            gas_used_before=first.gas_used_before,
            gas_used_after=last.gas_used_after))


def test_previous_proof_resume_restamps_from_the_child(chains):
    """`prove --witness B --previous-proof A` restamps every block with
    the consolidated hash of the first block of THIS run, B's window,
    while A's proof carries the consolidation of A's window: the parent
    link's equal-consolidation check then refuses the resumed chain. The
    same two blocks proved as one list [A, B] pass. Both packages agree.
    A's hash is set to a non-zero value, so the two windows differ as on
    a real chain (the fixture's own hashes are all zero)."""
    import zk_evm_tpu.orchestration.aggregation as jagg
    import zk_evm_tpu.stark.public_values as jpv
    import zk_evm_tpu_torch.orchestration.aggregation as pagg
    import zk_evm_tpu_torch.stark.public_values as ppv

    a, b = json.loads(json.dumps(chains["add11"][0]))
    a_hash = "0x" + keccak256(b"block A").hex()
    a["other_data"]["b_data"]["b_hashes"]["cur_hash"] = a_hash
    b["other_data"]["b_data"]["b_hashes"]["prev_hashes"][-1] = a_hash

    def case(m, agg, pv):
        def statements(witnesses):
            gpb = [decode(m, w)[1] for w in witnesses]
            agg.rewrite_checkpoint_consolidation(gpb)
            return [block_statement(pv, gis) for gis in gpb]
        a_stmt, b_stmt = statements([a, b])
        (b_resumed,) = statements([b])
        return [outcome(agg.check_block_parent, a_stmt, b_stmt),
                outcome(agg.check_block_parent, a_stmt, b_resumed),
                outcome(agg.check_checkpoint_block, a_stmt)]

    def outcome(fn, *args):
        try:
            fn(*args)
            return "ok"
        except AssertionError as e:
            return f"rejected: {e}"
    got = case(PORT, pagg, ppv)
    assert got == case(JAX, jagg, jpv)
    assert got == ["ok", "rejected: ", "ok"]
