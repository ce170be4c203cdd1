"""The batch and block statements of the PyTorch port against the JAX
package: the cases of `tests/test_aggregation.py:58-186` (batch pairs,
the block-initial and checkpoint checks, the parent link,
`FinalPublicValues` and `two_to_one_mix`), `verify_block_chain` over
block statements, and the multi-block and batch-pool drivers with a stub
prover. Each case builds the same public values in both packages and
compares the results exactly: combined statements, digests, which checks
pass and the message of each that fails.
"""

import dataclasses
import threading
import time

import pytest

import zk_evm_tpu.orchestration.aggregation as jagg
import zk_evm_tpu.stark.public_values as jpv
import zk_evm_tpu_torch.orchestration.aggregation as pagg
import zk_evm_tpu_torch.stark.public_values as ppv
from zk_evm_tpu_torch.mpt.trie import EMPTY_TRIE_HASH

PACKAGES = {"jax": (jagg, jpv), "port": (pagg, ppv)}
replace = dataclasses.replace


def both(case):
    """Run `case(aggregation, public_values)` on both packages; the
    results must be equal."""
    got = {name: case(*mods) for name, mods in PACKAGES.items()}
    assert got["port"] == got["jax"]
    return got["port"]


def outcome(fn, *args):
    try:
        fn(*args)
        return "ok"
    except AssertionError as e:
        return f"rejected: {e}"


def _h(i: int) -> bytes:
    return i.to_bytes(32, "big")


def make_pv(agg, pv, state_before=1, state_after=2, txn=(0, 3),
            gas=(0, 500), number=7, timestamp=1000, prev_base=0x100,
            gas_used=500):
    prev = tuple(_h(prev_base + i) for i in range(256))
    return pv.PublicValues(
        trie_roots_before=pv.TrieRoots(state_root=_h(state_before),
                                       transactions_root=EMPTY_TRIE_HASH,
                                       receipts_root=EMPTY_TRIE_HASH),
        trie_roots_after=pv.TrieRoots(state_root=_h(state_after),
                                      transactions_root=_h(0xAA),
                                      receipts_root=_h(0xBB)),
        block_metadata=pv.BlockMetadata(block_number=number,
                                        block_timestamp=timestamp,
                                        block_gas_used=gas_used),
        block_hashes=pv.BlockHashes(prev_hashes=prev,
                                    cur_hash=_h(prev_base + 256)),
        extra_block_data=pv.ExtraBlockData(
            checkpoint_state_trie_root=_h(state_before),
            checkpoint_consolidated_hash=agg.consolidate_hashes(list(prev)),
            txn_number_before=txn[0], txn_number_after=txn[1],
            gas_used_before=gas[0], gas_used_after=gas[1]),
        registers_before=pv.RegistersData(program_counter=10),
        registers_after=pv.RegistersData(program_counter=20))


def child_of(agg, pv, parent, **kw):
    """A block on top of `parent`: the window slid by one, the same
    checkpoint, the next number 12 s later."""
    child_prev = tuple(list(parent.block_hashes.prev_hashes[1:])
                       + [parent.block_hashes.cur_hash])
    base = make_pv(agg, pv, state_before=2, state_after=5, number=8,
                   timestamp=1012, **kw)
    return replace(
        base,
        block_hashes=pv.BlockHashes(prev_hashes=child_prev,
                                    cur_hash=_h(0x999)),
        extra_block_data=replace(
            base.extra_block_data,
            checkpoint_state_trie_root=parent.extra_block_data
            .checkpoint_state_trie_root,
            checkpoint_consolidated_hash=parent.extra_block_data
            .checkpoint_consolidated_hash))


def test_batch_pair_chains():
    def case(agg, pv):
        a = make_pv(agg, pv, txn=(0, 3), gas=(0, 200))
        b = replace(a, trie_roots_before=a.trie_roots_after,
                    trie_roots_after=pv.TrieRoots(state_root=_h(9)),
                    extra_block_data=replace(
                        a.extra_block_data, txn_number_before=3,
                        txn_number_after=5, gas_used_before=200,
                        gas_used_after=500))
        combined = agg.combine_batch_pvs(a, b)
        assert combined.trie_roots_before == a.trie_roots_before
        assert combined.trie_roots_after == b.trie_roots_after
        assert combined.registers_after == b.registers_after
        return [outcome(agg.check_batch_pair, a, b),
                pv.public_values_to_dict(combined),
                outcome(agg.check_block_initial, combined),
                outcome(agg.check_batch_pair, a, replace(
                    b, trie_roots_before=pv.TrieRoots(state_root=_h(42)))),
                outcome(agg.check_batch_pair, a, replace(
                    b, extra_block_data=replace(b.extra_block_data,
                                                gas_used_before=150)))]
    got = both(case)
    assert got[0] == got[2] == "ok"
    assert all(o.startswith("rejected") for o in got[3:])


def test_block_initial_rejects():
    def case(agg, pv):
        p = make_pv(agg, pv)
        return [outcome(agg.check_block_initial, q) for q in (
            p,
            replace(p, extra_block_data=replace(p.extra_block_data,
                                                txn_number_before=1)),
            replace(p, trie_roots_before=pv.TrieRoots(
                state_root=_h(1), transactions_root=_h(5),
                receipts_root=EMPTY_TRIE_HASH)),
            replace(p, block_metadata=replace(p.block_metadata,
                                              block_gas_used=1)))]
    got = both(case)
    assert got[0] == "ok"
    assert all(o.startswith("rejected") for o in got[1:])


def test_checkpoint_block():
    def case(agg, pv):
        p = make_pv(agg, pv)
        return [outcome(agg.check_checkpoint_block, q) for q in (
            p,
            replace(p, extra_block_data=replace(
                p.extra_block_data,
                checkpoint_consolidated_hash=(1, 2, 3, 4))),
            replace(p, trie_roots_before=pv.TrieRoots(
                state_root=_h(99), transactions_root=EMPTY_TRIE_HASH,
                receipts_root=EMPTY_TRIE_HASH)))]
    got = both(case)
    assert got[0] == "ok"
    assert all(o.startswith("rejected") for o in got[1:])


def test_block_parent_link():
    def case(agg, pv):
        parent = make_pv(agg, pv)
        child = child_of(agg, pv, parent)
        return [outcome(agg.check_block_parent, parent, c) for c in (
            child,
            replace(child, trie_roots_before=pv.TrieRoots(
                state_root=_h(3))),
            replace(child, block_metadata=replace(child.block_metadata,
                                                  block_number=9)),
            replace(child, block_hashes=parent.block_hashes),
            replace(child, block_metadata=replace(child.block_metadata,
                                                  block_timestamp=999)),
            replace(child, extra_block_data=replace(
                child.extra_block_data,
                checkpoint_consolidated_hash=(1, 2, 3, 4))))]
    got = both(case)
    assert got[0] == "ok"
    assert all(o.startswith("rejected") for o in got[1:])


def test_final_public_values():
    def case(agg, pv):
        p = make_pv(agg, pv)
        fin = agg.FinalPublicValues.from_public_values(p)
        assert fin.checkpoint_state_trie_root \
            == p.trie_roots_before.state_root
        assert fin.new_state_trie_root == p.trie_roots_after.state_root
        other = agg.FinalPublicValues.from_public_values(
            make_pv(agg, pv, state_after=3))
        elems = fin.to_elements()
        assert len(elems) == 25
        mix = agg.two_to_one_mix(fin, fin)
        assert len(mix) == 4 and mix != agg.two_to_one_mix(fin, other)
        return elems, mix, agg.two_to_one_mix(fin, other)
    both(case)


def test_empty_consolidated_blockhash_is_stable():
    got = both(lambda agg, pv: agg.empty_consolidated_blockhash())
    assert got == pagg.consolidate_hashes([b"\x00" * 32] * 256)
    assert all(isinstance(x, int) for x in got)


# ------------------------------------------- chains of block statements

def block_proofs(agg, pv, n=3):
    """`n` consecutive block statements, the first anchored at its
    checkpoint."""
    first = make_pv(agg, pv, state_before=1, state_after=2, number=7,
                    timestamp=1000)
    chain = [first]
    for i in range(1, n):
        prev = chain[-1]
        child = child_of(agg, pv, prev)
        child = replace(
            child,
            trie_roots_before=replace(child.trie_roots_before,
                                      state_root=prev.trie_roots_after
                                      .state_root),
            trie_roots_after=replace(child.trie_roots_after,
                                     state_root=_h(10 + i)),
            block_metadata=replace(
                child.block_metadata,
                block_number=prev.block_metadata.block_number + 1,
                block_timestamp=prev.block_metadata.block_timestamp + 12),
            block_hashes=replace(child.block_hashes,
                                 cur_hash=_h(0x999 + i)))
        chain.append(child)
    return [agg.BlockProof(batches=[], public_values=p) for p in chain]


def chain_outcome(agg, blocks, **kw):
    try:
        finals = agg.verify_block_chain(blocks, kernel=None, reverify=False,
                                        **kw)
        return [f.to_elements() for f in finals]
    except AssertionError as e:
        return f"rejected: {e}"


@dataclasses.dataclass
class _Gi:
    """The two fields of a GenerationInputs that the restamp reads."""
    block_hashes: object
    checkpoint_consolidated_hash: tuple


def test_verify_block_chain():
    """Block 0 anchors at the checkpoint, or at `parent` (a resume);
    each later block links to its predecessor."""
    def case(agg, pv):
        blocks = block_proofs(agg, pv)
        first = blocks[0].public_values
        swapped = [blocks[0], blocks[2], blocks[1]]
        resumed = blocks[1:]
        return [chain_outcome(agg, blocks),
                chain_outcome(agg, blocks,
                              checkpoint_state_trie_root=_h(1)),
                chain_outcome(agg, blocks,
                              checkpoint_state_trie_root=_h(77)),
                chain_outcome(agg, swapped),
                chain_outcome(agg, resumed),
                chain_outcome(agg, resumed, parent=first)]
    got = both(case)
    assert isinstance(got[0], list) and len(got[0]) == 3
    assert got[1] == got[0]
    assert got[2] == "rejected: chain anchored at the wrong checkpoint"
    assert got[3].startswith("rejected")
    # block 1 alone is not a checkpoint block, but chains from block 0
    assert got[4].startswith("rejected")
    assert got[5] == got[0][1:]


def test_resumed_chain_restamped_from_the_child():
    """`prove --witness --previous-proof`: `rewrite_checkpoint_consolidation`
    stamps every block with the consolidation of the FIRST block of the
    run, here the child, while the parent proof carries the checkpoint
    block's. The equal-consolidation check of `check_block_parent` then
    refuses the resumed chain, in both packages alike."""
    def case(agg, pv):
        blocks = block_proofs(agg, pv)
        parent, child = blocks[0].public_values, blocks[1].public_values
        gis = [[_Gi(child.block_hashes,
                    child.extra_block_data.checkpoint_consolidated_hash)]]
        cch = agg.rewrite_checkpoint_consolidation(gis)
        restamped = replace(child, extra_block_data=replace(
            child.extra_block_data, checkpoint_consolidated_hash=cch))
        return [cch == parent.extra_block_data.checkpoint_consolidated_hash,
                outcome(agg.check_block_parent, parent, child),
                outcome(agg.check_block_parent, parent, restamped)]
    got = both(case)
    assert got[0] is False
    assert got[1] == "ok"
    assert got[2].startswith("rejected")


def test_rewrite_checkpoint_consolidation():
    def case(agg, pv):
        prev = tuple(_h(0x300 + i) for i in range(256))
        gis = [[_Gi(pv.BlockHashes(prev_hashes=prev), (0, 0, 0, 0))] * 2,
               [_Gi(pv.BlockHashes(), (9, 9, 9, 9))]]
        cch = agg.rewrite_checkpoint_consolidation(gis)
        assert cch == agg.consolidate_hashes(list(prev))
        return cch, [[g.checkpoint_consolidated_hash for g in b]
                     for b in gis]
    cch, stamped = both(case)
    assert stamped == [[cch, cch], [cch]]


# --------------------------------------------- drivers with a stub prover

def test_prove_blocks_bounded_keeps_block_order():
    """At most `block_pool_size` blocks in flight; the proofs come back in
    block order whatever order they finish in."""
    def case(agg, pv):
        lock = threading.Lock()
        live = [0, 0]                      # in flight now, most seen

        def prove(gis):
            with lock:
                live[0] += 1
                live[1] = max(live[1], live[0])
            time.sleep(0.02 * (5 - gis[0]))
            with lock:
                live[0] -= 1
            return ("block", gis[0])
        got = agg.prove_blocks_bounded(None, [[i] for i in range(5)],
                                       block_pool_size=2,
                                       prove_batches=prove)
        return got, live[1] <= 2
    got, bounded = both(case)
    assert got == [("block", i) for i in range(5)] and bounded


@pytest.mark.parametrize("pool", [1, 3])
def test_prove_batch_chains_keeps_batch_order(pool):
    def case(agg, pv):
        def prove(item):
            bi, gi = item
            time.sleep(0.01 * (4 - bi))
            return (bi, gi * 2)
        return agg.prove_batch_chains([10, 11, 12, 13], prove, pool)
    assert both(case) == [(0, 20), (1, 22), (2, 24), (3, 26)]


def test_prove_block_batches_stub_chain_reaches_aggregation():
    """`prove_block_batches(prove_chain=)` hands every (index, inputs)
    pair to the stub in batch order before aggregating; an empty chain
    list is refused by the aggregation, in both packages."""
    def case(agg, pv):
        seen = []

        def chain(item):
            seen.append(item)
            return []
        try:
            agg.prove_block_batches(None, [], prove_chain=chain)
            result = "ok"
        except AssertionError as e:
            result = f"rejected: {e}"
        return seen, result
    assert both(case) == ([], "rejected: no batches")
