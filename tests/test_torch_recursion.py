"""The recursion layer (L2) of the PyTorch port against the JAX package's:
verification tapes built by both packages from the same child proofs
equal each other (program, Rvm and RAM traces, Poseidon ops, public
inputs), the port's NativeTape equals its PyTape, chunk splits equal the
JAX package's and balance their CTLs, the wrap proof of a Fibonacci
child equals the JAX package's byte for byte and verifies, and the
aggregation tape's cell algebra equals the host twins. Tolerance 0.

Child proofs are made by the port on the CPU and handed to the JAX
package as JSON (the two packages' proofs are byte-identical,
tests/test_torch_stark.py), so the JAX references here are host-only
tape builds; the JAX package's own `prove_system` of the Fibonacci wrap
takes minutes of XLA compiles on the CPU, so its `proof_to_json` is
pinned as a sha256 that the `slow` test recomputes."""

import hashlib
from dataclasses import replace

import numpy as np
import pytest
import torch

from zk_evm_tpu.recursion import aggregate as jagg
from zk_evm_tpu.recursion import continuation as jct
from zk_evm_tpu.recursion import vm as jvm
from zk_evm_tpu.recursion.verify_tape import (
    verify_all_tape as jverify_all_tape,
    verify_stark_tape as jverify_stark_tape)
from zk_evm_tpu.stark import (StarkConfig as JStarkConfig,
                              FriConfig as JFriConfig)
from zk_evm_tpu.stark.serialization import (
    all_proof_from_json as jall_proof_from_json,
    stark_proof_from_json as jstark_proof_from_json)
from zk_evm_tpu_torch.challenger import Challenger
from zk_evm_tpu_torch.field import host
from zk_evm_tpu_torch.hash import host_poseidon
from zk_evm_tpu_torch.recursion import aggregate as agg
from zk_evm_tpu_torch.recursion import continuation as ct
from zk_evm_tpu_torch.recursion import known, ram, vm
from zk_evm_tpu_torch.recursion.system import (RVM, prove_system,
                                               verify_system)
from zk_evm_tpu_torch.recursion.tape_lib import sponge_hash
from zk_evm_tpu_torch.recursion.verify_tape import (verify_all_tape,
                                                    verify_stark_tape)
from zk_evm_tpu_torch.stark import (CrossTableLookup, CtlView, Filter,
                                    FriConfig, Lookup, Stark, StarkConfig,
                                    col, prove_all, prove_stark)
from zk_evm_tpu_torch.stark import lookup as lk
from zk_evm_tpu_torch.stark import public_values as pvm
from zk_evm_tpu_torch.stark.debug import check_constraints, check_ctl_balance
from zk_evm_tpu_torch.stark.serialization import proof_to_json
from zk_evm_tpu_torch.tables import poseidon as ps
from test_stark import FibStark as JFibStark, fib_trace
from test_torch_stark import FibStark
from test_verify_tape import (TinyLookupStark as JTinyLookupStark,
                              ToyCtlStark as JToyCtlStark)
from test_aggregate_tape import random_pv as jrandom_pv

P = host.P
CHILD_KW = dict(rate_bits=1, cap_height=1, proof_of_work_bits=0,
                num_query_rounds=2, arity_bits=2, final_poly_bits=2)
OUTER_KW = dict(rate_bits=1, cap_height=2, proof_of_work_bits=0,
                num_query_rounds=1, arity_bits=2, final_poly_bits=2)
# sha256 of the JAX package's proof_to_json(prove_system(...)) of the
# Fibonacci wrap of tests/test_verify_tape.py (16-row child at CHILD_KW,
# outer at OUTER_KW), made on the CPU; chip_smoke.py holds the same
# constant for the card's proof
FIB_WRAP_SHA256 = (
    "860392d5d51b68ac4d272c054a695026546397c78a3de82d1ca71ca6aa769b7e")


def _cfg(kw):
    return StarkConfig(security_bits=1, fri_config=FriConfig(**kw))


def _jcfg(kw):
    return JStarkConfig(security_bits=1, fri_config=JFriConfig(**kw))


class TinyLookupStark(Stark):
    """tests/test_verify_tape.py's TinyLookupStark over the port's Stark:
    val, counter, freq — an in-table logUp range check."""
    name = "tiny_lookup"
    num_columns = 3

    def eval(self, frame, cc):
        lv, nv = frame.local, frame.next
        cc.constraint_first_row(lv[1])
        incr = nv[1] - lv[1]
        cc.constraint_transition(incr * incr - incr)

    def lookups(self):
        return [Lookup(looking_columns=(col(0),), table_column=1,
                       frequencies_column=2)]


class ToyCtlStark(Stark):
    """tests/test_verify_tape.py's ToyCtlStark: val, filter."""
    num_columns = 2

    def __init__(self, name):
        self.name = name

    def eval(self, frame, cc):
        f = frame.local[1]
        cc.constraint(f * (f - 1))

    def requires_ctls(self):
        return True


def _tiny_lookup_trace():
    vals = np.array([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3],
                    dtype=np.uint64)
    trace = np.zeros((3, 16), dtype=np.uint64)
    trace[0] = vals
    trace[1] = np.arange(16, dtype=np.uint64)
    trace[2] = np.bincount(vals.astype(np.int64), minlength=16)[:16]
    return trace


def _toy_ctl(vals_a=(5, 7, 9), vals_b=(9, 7, 5)):
    def trace(vals):
        tr = np.zeros((2, 4), dtype=np.uint64)
        tr[0, :len(vals)] = vals
        tr[1, :len(vals)] = 1
        return tr
    ctls = [CrossTableLookup(
        name="toy",
        looking=(CtlView(table=0, columns=(col(0),),
                         filter=Filter(column=1)),),
        looked=CtlView(table=1, columns=(col(0),),
                       filter=Filter(column=1)))]
    return [ToyCtlStark("toy_a"), ToyCtlStark("toy_b")], \
        [trace(vals_a), trace(vals_b)], ctls


def _jax_toy_ctls():
    from zk_evm_tpu.stark import Filter as JFilter
    from zk_evm_tpu.stark.lookup import (CrossTableLookup as JCtl,
                                         CtlView as JView, col as jcol)
    return [JCtl(name="toy",
                 looking=(JView(table=0, columns=(jcol(0),),
                                filter=JFilter(column=1)),),
                 looked=JView(table=1, columns=(jcol(0),),
                              filter=JFilter(column=1)))]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The CPU proofs here are small: one intra-op thread proves them
    faster than many and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bind(t, cells):
    for k, c in enumerate(cells):
        t.bind_public(c, k)
    return t


@pytest.fixture(scope="module")
def children():
    """The three children of tests/test_verify_tape.py, proved by the port
    on the CPU: (name, port-side builder, JAX-side builder)."""
    ccfg, jccfg = _cfg(CHILD_KW), _jcfg(CHILD_KW)
    trace, pis = fib_trace(16)
    fib = prove_stark(FibStark(), trace, ccfg, Challenger(),
                      public_inputs=pis, device="cpu")
    jfib = jstark_proof_from_json(proof_to_json(fib))
    tiny = prove_stark(TinyLookupStark(), _tiny_lookup_trace(), ccfg,
                       Challenger(), device="cpu")
    jtiny = jstark_proof_from_json(proof_to_json(tiny))
    starks, traces, ctls = _toy_ctl()
    allp = prove_all(starks, traces, ctls, ccfg, public_inputs=[5, 7, 9],
                     device="cpu")
    jallp = jall_proof_from_json(proof_to_json(allp))
    jstarks = [JToyCtlStark("toy_a"), JToyCtlStark("toy_b")]
    return {
        "fib": (
            lambda t: _bind(t, verify_stark_tape(
                t, FibStark(), fib, ccfg).public_inputs), 3,
            lambda t: _bind(t, jverify_stark_tape(
                t, JFibStark(), jfib, jccfg).public_inputs)),
        "lookup_child": (
            lambda t: verify_stark_tape(t, TinyLookupStark(), tiny, ccfg),
            0,
            lambda t: jverify_stark_tape(t, JTinyLookupStark(), jtiny,
                                         jccfg)),
        "all_proof": (
            lambda t: _bind(t, verify_all_tape(
                t, starks, allp, ctls, ccfg)[0]), 3,
            lambda t: _bind(t, jverify_all_tape(
                t, jstarks, jallp, _jax_toy_ctls(), jccfg)[0])),
    }


def _finalized(t):
    stark, rvm_trace, ram_trace, pose_ops, pub = t.finalize()
    return stark.known, rvm_trace, ram_trace, \
        [tuple(int(v) for v in op.input) for op in pose_ops], pub


@pytest.mark.parametrize("child", ["fib", "lookup_child", "all_proof"])
def test_tape_equals_jax(children, child):
    build, npub, jbuild = children[child]
    t = vm.Tape(npub=npub)
    assert isinstance(t, vm.NativeTape)
    build(t)
    jt = jvm.PyTape(npub=npub)
    jbuild(jt)
    assert len(t.rows) == len(jt.rows)
    got, want = _finalized(t), _finalized(jt)
    for g, w in zip(got[:3], want[:3]):
        assert g.shape == w.shape and np.array_equal(g, w)
    assert got[3] == want[3]
    assert got[4] == want[4]
    # the program's known columns are the first 41 + npub columns
    assert got[0].shape[0] == vm.PUBSEL_START + npub


@pytest.mark.parametrize("child", ["fib", "lookup_child", "all_proof"])
def test_native_tape_equals_py_tape(children, child):
    build, npub, _ = children[child]
    tn = vm.NativeTape(npub=npub)
    build(tn)
    tp = vm.PyTape(npub=npub)
    build(tp)
    got, want = _finalized(tn), _finalized(tp)
    for g, w in zip(got[:3], want[:3]):
        assert np.array_equal(g, w)
    assert got[3:] == want[3:]
    assert sorted((o.timestamp, o.addr, o.is_read, o.value)
                  for o in tn.ram_ops) == \
        sorted((o.timestamp, o.addr, o.is_read, o.value) for o in tp.ram_ops)


def test_native_tape_asserts():
    t = vm.NativeTape(npub=1)
    a, b = t.load(3), t.load(4)
    with pytest.raises(AssertionError):
        t.assert_eq(a, b)
    t.bind_public(a, 0)
    with pytest.raises(AssertionError):
        t.bind_public(a, 0)


def test_tape_rejects_corrupted_child():
    ccfg = _cfg(CHILD_KW)
    trace, pis = fib_trace(16)
    proof = prove_stark(FibStark(), trace, ccfg, Challenger(),
                        public_inputs=pis, device="cpu")
    a, b = proof.openings.trace_local[0]
    proof.openings.trace_local = [((a + 1) % P, b)] + \
        list(proof.openings.trace_local[1:])
    with pytest.raises(AssertionError):
        verify_stark_tape(vm.Tape(npub=3), FibStark(), proof, ccfg)


@pytest.fixture(scope="module")
def fib_system(children):
    t = vm.Tape(npub=3)
    children["fib"][0](t)
    cfg = _cfg(OUTER_KW)
    starks, proof, pub = prove_system(t, cfg, device="cpu")
    return starks, proof, pub, cfg


def test_fib_wrap_proof_equals_jax(fib_system):
    _, proof, pub, _ = fib_system
    assert pub == fib_trace(16)[1]
    digest = hashlib.sha256(proof_to_json(proof).encode()).hexdigest()
    assert digest == FIB_WRAP_SHA256


def test_verify_system_accepts_and_rejects(fib_system):
    starks, proof, pub, cfg = fib_system
    verify_system(starks, proof, cfg, expected_public_inputs=pub,
                  device="cpu")
    bad = list(pub)
    bad[0] = (bad[0] + 1) % P
    with pytest.raises(AssertionError):
        verify_system(starks, proof, cfg, expected_public_inputs=bad,
                      device="cpu")
    # a foreign program (another tape's Rvm) must not verify the proof
    t2 = vm.Tape(npub=3)
    a = t2.load(5)
    _bind(t2, [a, t2.mul(a, a), t2.add(a, a)])
    starks2, _, _ = prove_system(t2, cfg, device="cpu")
    with pytest.raises(AssertionError):
        verify_system([starks2[RVM], starks[1], starks[2]], proof, cfg,
                      device="cpu")


def test_wrap_program_is_preprocessed(fib_system):
    starks, proof, _, _ = fib_system
    rvm = starks[RVM]
    assert rvm.num_preprocessed == vm.PUBSEL_START + 3
    assert rvm.preprocessed() is rvm.known
    assert len(proof.proofs[RVM].openings.trace_local) == rvm.num_columns


def _sample_tape(tape_cls, npub=2):
    """tests/test_rvm.py's sample_tape on either tape class."""
    t = tape_cls(npub=npub)
    a = t.load(123456789)
    b = t.load(987654321)
    c = t.mul(a, b)
    d = t.add(c, a)
    bit = t.load(1)
    t.assert_bool(bit)
    e = t.sel(bit, a, b)
    out = t.pose([t.load(i + 1) for i in range(12)])
    assert [t.value(o) for o in out] == \
        host_poseidon.permute([i + 1 for i in range(12)])
    t.assert_eq(e, a)
    t.bind_public(d, 0)
    t.bind_public(out[0], 1)
    return t


def test_sample_tape_traces_equal_jax_and_hold():
    from tests.test_rvm import sample_tape as jsample_tape
    t = _sample_tape(vm.Tape)
    got, want = _finalized(t), _finalized(jsample_tape())
    for g, w in zip(got[:3], want[:3]):
        assert np.array_equal(g, w)
    assert got[3:] == want[3:]
    stark, rvm_trace, ram_trace, _, pub = t.finalize()
    check_constraints(stark, rvm_trace, public_inputs=pub)
    check_constraints(ram.RvmMemStark(), ram_trace)
    forged = ram_trace.copy()
    r = int(np.nonzero((forged[ram.IS_READ] == 1)
                       & (forged[ram.FILTER] == 1))[0][0])
    forged[ram.VALUE, r] = (int(forged[ram.VALUE, r]) + 1) % P
    with pytest.raises(AssertionError):
        check_constraints(ram.RvmMemStark(), forged)


@pytest.mark.parametrize("tape_cls", ["native", "py"])
def test_split_tape_equals_jax_and_balances(tape_cls):
    from tests.test_rvm import sample_tape as jsample_tape
    t = _sample_tape(vm.NativeTape if tape_cls == "native" else vm.PyTape)
    chunks = ct.split_tape(t, 4)
    jchunks = jct.split_tape(jsample_tape(), 4)
    assert len(chunks) == len(jchunks) >= 2
    assert chunks[0].before == {} and chunks[-1].after == {}
    for c, jc in zip(chunks, jchunks):
        assert c.clk_base == jc.clk_base
        assert np.array_equal(c.rvm_trace, jc.rvm_trace)
        assert np.array_equal(c.ram_trace, jc.ram_trace)
        assert np.array_equal(c.stark.known, jc.stark.known)
        assert c.before == jc.before and c.after == jc.after
        assert [o.input for o in c.pose_ops] == \
            [o.input for o in jc.pose_ops]
    beta, gamma = 123456789123, 987654321987
    for a, b in zip(chunks, chunks[1:]):
        assert a.after == b.before
    for c in chunks:
        traces = {ct.RVM_T: c.rvm_trace, ct.RAM_T: c.ram_trace,
                  ct.BEFORE_T: ct.boundary_trace(c.before),
                  ct.AFTER_T: ct.boundary_trace(c.after)}
        for ctl in ct.chunk_ctls(t.npub, c.clk_base):
            if ctl.name == "rvm_poseidon":
                continue
            looking = 0
            for v in ctl.looking:
                looking = host.fadd(looking, lk.ctl_view_sum_np(
                    traces[v.table], v, beta, gamma))
            assert looking == lk.ctl_view_sum_np(
                traces[ctl.looked.table], ctl.looked, beta, gamma), \
                f"chunk {c.index}: CTL {ctl.name} unbalanced"
        check_constraints(c.stark, c.rvm_trace, public_inputs=t.public_inputs)
        check_constraints(ram.RvmMemStark(), c.ram_trace)
        # the exact multisets of every chunk CTL, the Poseidon one included
        check_ctl_balance(ct.chunk_ctls(t.npub, c.clk_base), [
            c.rvm_trace, c.ram_trace,
            ps.generate_trace(c.pose_ops) if c.pose_ops else None,
            ct.boundary_trace(c.before), ct.boundary_trace(c.after)])


def test_prove_chunked_roundtrip():
    """A tape split into 16-op chunks proves as 5-table systems chained by
    their boundary tables' caps; verify_chunked accepts it and rejects
    wrong public inputs; each chunk verifies alone (`verify_chunk`, as
    chip_smoke.py's path 12 checks the chunks it proves) and fails with
    one FRI opening changed; and one tape verifying the whole chunk chain
    (wrap_chunked_tape) exposes the same public inputs."""
    import chip_smoke
    cfg = _cfg(OUTER_KW)
    t = _sample_tape(vm.Tape)
    chunks, proven, pub = ct.prove_chunked(t, cfg, 4, device="cpu")
    assert len(chunks) == 2 and pub == t.public_inputs
    ct.verify_chunked(chunks, proven, cfg, expected_public_inputs=pub,
                      device="cpu")
    with pytest.raises(AssertionError):
        ct.verify_chunked(chunks, proven, cfg,
                          expected_public_inputs=[pub[0], pub[1] + 1],
                          device="cpu")
    for ch, (starks, proof) in zip(chunks, proven):
        ct.verify_chunk(ch, starks, proof, cfg, expected_public_inputs=pub,
                        device="cpu")
        with pytest.raises(AssertionError, match="Merkle"):
            ct.verify_chunk(ch, starks, chip_smoke.tampered_opening(proof),
                            cfg, device="cpu")
    w = vm.Tape(npub=2)
    cells = ct.wrap_chunked_tape(w, chunks, proven, cfg, device="cpu")
    assert [w.value(c) for c in cells] == pub


def test_known_column_opening():
    rng = np.random.default_rng(11)
    n = 16
    vals = rng.integers(0, P, size=n, dtype=np.uint64)
    zeta = (int(vals[0]) * 7919 % P, int(vals[1]) * 104729 % P)
    from zk_evm_tpu.recursion import known as jknown
    got = known.eval_known_at(vals, zeta)
    assert got == jknown.eval_known_at(vals, zeta)
    g = host.primitive_root_of_unity(4)
    want = (0, 0)
    zn = host.esub(host.eexp(zeta, n), (1, 0))
    for i in range(n):
        gi = host.fexp(g, i)
        denom = host.escalar(host.esub(zeta, (gi, 0)), n % P)
        li = host.emul(zn, host.emul((gi, 0), host.einv(denom)))
        want = host.eadd(want, host.escalar(li, int(vals[i])))
    assert got == want


# ---- aggregation tape: the cell algebra against the host twins ----------

def _port_pv(jpv):
    """A JAX-package PublicValues as the port's, through the JSON dict."""
    from zk_evm_tpu.stark.public_values import public_values_to_dict
    return pvm.public_values_from_dict(public_values_to_dict(jpv))


def test_pv_offsets_equal_jax():
    for name in ("TRB", "TRA", "MD", "MD_TIMESTAMP", "MD_NUMBER",
                 "MD_CHAIN_ID", "MD_GAS_USED", "MD_BLOOM", "BH", "BH_CUR",
                 "EBD", "EBD_GAS_AFTER", "NUM_PV_ELEMENTS", "BP_CHAIN_ID",
                 "BP_NEW_STATE_ROOT", "BP_BLOCK_NUMBER", "NPUB_BLOCK"):
        assert getattr(agg, name) == getattr(jagg, name), name
    pv = _port_pv(jrandom_pv())
    els = pv.to_elements()
    assert len(els) == agg.NUM_PV_ELEMENTS
    assert els[agg.MD_TIMESTAMP] == pv.block_metadata.block_timestamp
    assert els[agg.MD_CHAIN_ID] == pv.block_metadata.block_chain_id
    assert els[agg.EBD_GAS_AFTER] == pv.extra_block_data.gas_used_after
    assert els[agg.TRB:agg.TRB + 8] == \
        pvm.h256_limbs(pv.trie_roots_before.state_root)
    assert els[agg.BH_CUR:agg.BH_CUR + 8] == \
        pvm.h256_limbs(pv.block_hashes.cur_hash)


def test_extra_rows_cells_equal_host():
    pv = _port_pv(jrandom_pv())
    kernel_hash, kernel_len = (1 << 255) + 12345, 77001
    want = pvm.memory_extra_looking_values(pv, kernel_hash, kernel_len)
    t = vm.Tape()
    pub = [t.load(int(v)) for v in pv.to_elements()]
    rows = agg.memory_extra_rows_cells(
        t, pub, agg.load_registers_cells(t, pv.registers_before),
        agg.load_registers_cells(t, pv.registers_after), kernel_hash,
        kernel_len)
    assert len(rows) == len(want)
    for cells, row in zip(rows, want):
        assert [t.value(c) for c in cells] == [v % P for v in row]


def test_sponge_hash_equals_host():
    rng = np.random.default_rng(5)
    t = vm.Tape()
    vals = [int(v) for v in rng.integers(0, P, size=21, dtype=np.uint64)]
    digest = sponge_hash(t, [t.load(v) for v in vals])
    assert [t.value(c) for c in digest] == host_poseidon.hash_no_pad(vals)


def test_block_statement_cell_algebra_equals_host():
    """tests/test_aggregate_tape.py's block-statement case on the port:
    block_statement_from_batch_pubs over two batch PV vectors == the
    port's host twins, and a broken gas chain is rejected in the tape."""
    from zk_evm_tpu_torch.mpt.trie import EMPTY_TRIE_HASH
    from zk_evm_tpu_torch.orchestration.aggregation import (
        FinalPublicValues, check_batch_pair, check_block_initial,
        check_checkpoint_block, combine_batch_pvs, consolidate_hashes)
    a = _port_pv(jrandom_pv())
    a = replace(
        a,
        trie_roots_before=pvm.TrieRoots(
            state_root=a.extra_block_data.checkpoint_state_trie_root,
            transactions_root=EMPTY_TRIE_HASH,
            receipts_root=EMPTY_TRIE_HASH),
        extra_block_data=replace(
            a.extra_block_data, txn_number_before=0, gas_used_before=0,
            checkpoint_consolidated_hash=consolidate_hashes(
                list(a.block_hashes.prev_hashes))))
    b = replace(
        a, trie_roots_before=a.trie_roots_after,
        trie_roots_after=pvm.TrieRoots(
            state_root=bytes(range(32)),
            transactions_root=bytes(range(1, 33)),
            receipts_root=bytes(range(2, 34))),
        extra_block_data=replace(
            a.extra_block_data,
            txn_number_before=a.extra_block_data.txn_number_after,
            txn_number_after=a.extra_block_data.txn_number_after + 5,
            gas_used_before=a.extra_block_data.gas_used_after,
            gas_used_after=a.extra_block_data.gas_used_after + 999))
    a = replace(a, block_metadata=replace(
        a.block_metadata, block_gas_used=b.extra_block_data.gas_used_after))
    b = replace(b, block_metadata=a.block_metadata)
    check_batch_pair(a, b)
    combined = combine_batch_pvs(a, b)
    check_block_initial(combined)
    check_checkpoint_block(combined)
    fin = FinalPublicValues.from_public_values(combined)

    t = vm.Tape()
    pub = agg.block_statement_from_batch_pubs(
        t, [[t.load(int(v)) for v in x.to_elements()] for x in (a, b)])
    got = [t.value(c) for c in pub]
    assert got[:25] == fin.to_elements()
    assert got[agg.BP_BLOCK_NUMBER] == combined.block_metadata.block_number
    assert got[agg.BP_PRE_STATE_ROOT:agg.BP_PRE_STATE_ROOT + 8] == \
        pvm.h256_limbs(combined.trie_roots_before.state_root)
    assert got[agg.BP_PREV_CONSOLIDATED:agg.BP_PREV_CONSOLIDATED + 4] == \
        list(combined.extra_block_data.checkpoint_consolidated_hash)
    agg.check_wrap_checkpoint_anchor(got)

    bad_b = replace(b, extra_block_data=replace(
        b.extra_block_data,
        gas_used_before=b.extra_block_data.gas_used_before + 1))
    t2 = vm.Tape()
    with pytest.raises(AssertionError):
        agg.block_statement_from_batch_pubs(
            t2, [[t2.load(int(v)) for v in x.to_elements()]
                 for x in (a, bad_b)])


def test_wrap_public_link_checks():
    def pub(number=7, ts=1000, pre=11, post=22, prev=(1, 2, 3, 4),
            new=(5, 6, 7, 8)):
        p = [0] * agg.NPUB_BLOCK
        p[agg.BP_CHAIN_ID] = 1
        p[agg.BP_CHECKPOINT_ROOT:agg.BP_CHECKPOINT_ROOT + 8] = \
            pvm.h256_limbs((11).to_bytes(32, "big"))
        p[agg.BP_PRE_STATE_ROOT:agg.BP_PRE_STATE_ROOT + 8] = \
            pvm.h256_limbs(pre.to_bytes(32, "big"))
        p[agg.BP_NEW_STATE_ROOT:agg.BP_NEW_STATE_ROOT + 8] = \
            pvm.h256_limbs(post.to_bytes(32, "big"))
        p[agg.BP_CHECKPOINT_CONSOLIDATED:
          agg.BP_CHECKPOINT_CONSOLIDATED + 4] = [1, 2, 3, 4]
        p[agg.BP_NEW_CONSOLIDATED:agg.BP_NEW_CONSOLIDATED + 4] = list(new)
        p[agg.BP_PREV_CONSOLIDATED:agg.BP_PREV_CONSOLIDATED + 4] = \
            list(prev)
        p[agg.BP_BLOCK_NUMBER] = number
        p[agg.BP_TIMESTAMP] = ts
        return p
    parent = pub(new=(9, 9, 9, 9))
    agg.check_wrap_checkpoint_anchor(parent)
    agg.check_wrap_parent_link(parent, pub(8, 1012, 22, prev=(9, 9, 9, 9)))
    for child in (pub(8, 1012, 23, prev=(9, 9, 9, 9)),
                  pub(8, 1012, 22, prev=(1, 1, 1, 1)),
                  pub(9, 1012, 22, prev=(9, 9, 9, 9)),
                  pub(8, 999, 22, prev=(9, 9, 9, 9))):
        with pytest.raises(AssertionError):
            agg.check_wrap_parent_link(parent, child)
    with pytest.raises(AssertionError):
        agg.check_wrap_checkpoint_anchor(pub(pre=12))


@pytest.mark.slow
def test_fib_wrap_constant_is_jax():
    """Recompute FIB_WRAP_SHA256 with the JAX package (minutes)."""
    from zk_evm_tpu.challenger import Challenger as JChallenger
    from zk_evm_tpu.recursion.system import prove_system as jprove_system
    from zk_evm_tpu.stark import prove_stark as jprove_stark
    from zk_evm_tpu.stark.serialization import proof_to_json as jpj
    trace, pis = fib_trace(16)
    jccfg = _jcfg(CHILD_KW)
    child = jprove_stark(JFibStark(), trace, jccfg, JChallenger(),
                         public_inputs=pis)
    t = jvm.Tape(npub=3)
    _bind(t, jverify_stark_tape(t, JFibStark(), child, jccfg).public_inputs)
    _, proof, _ = jprove_system(t, _jcfg(OUTER_KW))
    assert hashlib.sha256(jpj(proof).encode()).hexdigest() == \
        FIB_WRAP_SHA256


# ---- simple-transfer's segment chain --------------------------------------

def _simple_transfer_segments(max_cpu_len_log: int = 14):
    from zk_evm_tpu_torch.witness.kernel import combined_kernel
    from zk_evm_tpu_torch.witness.segments import generate_segment_tables
    from zk_evm_tpu_torch.witness.testing_fixtures import FIXTURES
    kernel = combined_kernel()
    return kernel, [gt for _, gt in generate_segment_tables(
        kernel, FIXTURES["simple-transfer"](),
        max_cpu_len_log=max_cpu_len_log)]


def test_fixture_statement_is_not_a_checkpoint_block():
    """Why the card's wrap phase wraps simple-transfer's chain alone
    (`wrap_segment_chain` + `sponge_hash`) rather than as a block
    (`wrap_block` + `verify_block_wrap_chain`): the fixture's statement
    passes the block-initial checks but not the checkpoint anchor, in the
    port's host twin as in the JAX package's."""
    from zk_evm_tpu.orchestration.aggregation import (
        check_checkpoint_block as jcheck_checkpoint_block)
    from zk_evm_tpu.stark.public_values import (
        public_values_from_dict as jpublic_values_from_dict)
    from zk_evm_tpu_torch.orchestration.aggregation import (
        check_block_initial, check_checkpoint_block)
    _, segments = _simple_transfer_segments()
    assert len(segments) == 3
    pv = segments[0].public_values
    check_block_initial(pv)
    with pytest.raises(AssertionError, match="checkpoint root"):
        check_checkpoint_block(pv)
    with pytest.raises(AssertionError, match="checkpoint root"):
        jcheck_checkpoint_block(jpublic_values_from_dict(
            pvm.public_values_to_dict(pv)))


@pytest.mark.slow
def test_chain_wrap_tape_equals_jax():
    """simple-transfer's chain (test config, chip_smoke.py's
    max_cpu_len_log WRAP_SEGMENT_LOG: two segments) proved by the port on
    the CPU, then wrapped by both packages from the same proofs (the JAX
    package reads the port's JSON): the tapes' Rvm and RAM traces hash
    alike, to chip_smoke.py's WRAP_TAPE_SHA256."""
    import chip_smoke
    from zk_evm_tpu.recursion.tape_lib import sponge_hash as jsponge_hash
    from zk_evm_tpu.stark.serialization import (
        block_proof_from_json as jblock_proof_from_json)
    from zk_evm_tpu.witness.assembler import combined_kernel as jkernel
    from zk_evm_tpu_torch.orchestration.aggregation import (
        BlockProof, batch_public_values)
    from zk_evm_tpu_torch.orchestration.block import prove_block
    from zk_evm_tpu_torch.stark.serialization import block_proof_to_json
    kernel, segments = _simple_transfer_segments(
        chip_smoke.WRAP_SEGMENT_LOG)
    cfg = StarkConfig.test_config()
    proofs = [prove_block(gt, cfg, device="cpu") for gt in segments]
    jproofs = jblock_proof_from_json(block_proof_to_json(BlockProof(
        batches=[proofs], public_values=batch_public_values(proofs)))
    ).batches[0]

    t = vm.Tape(npub=4)
    cells, _, _ = agg.wrap_segment_chain(t, proofs, kernel, cfg,
                                         device="cpu")
    _bind(t, sponge_hash(t, cells))
    jt = jvm.Tape(npub=4)
    jcells, _, _ = jagg.wrap_segment_chain(jt, jproofs, jkernel(),
                                           JStarkConfig.test_config())
    _bind(jt, jsponge_hash(jt, jcells))
    assert t.public_inputs == jt.public_inputs == \
        host_poseidon.hash_no_pad([int(v) for v in proofs[0].public_inputs])
    digests = [chip_smoke.tape_sha256(*x.finalize()[1:3]) for x in (t, jt)]
    assert digests == [chip_smoke.WRAP_TAPE_SHA256] * 2
