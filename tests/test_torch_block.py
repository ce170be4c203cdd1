"""Block proofs of the PyTorch port against the JAX package.

The public values of a block segment enter the transcript: the port's
`prove_all(public_values=)` proves the memory-continuation chain (at
`tests/test_torch_multi.py`'s 100-word size) under the `simple-transfer`
block's PublicValues, and both packages' `verify_all` accept its JSON and
reject it once one public value changes. The host checks of the segment
chain and of the block aggregation reject a broken register chain, a
broken MemAfter -> MemBefore cap chain, unchained batches and a block
whose initial values are wrong.

The test marked `slow` proves a whole `simple-transfer` segment (nine
tables, 2^18 Memory rows) on the CPU: the port's `proof_to_json` must hash
to the JAX package's, which the test recomputes, and both packages'
`verify_block` accept it.
"""

import dataclasses
import hashlib
import json
import os
import subprocess
import sys

import pytest
import torch

from zk_evm_tpu.stark import StarkConfig as JStarkConfig
from zk_evm_tpu.stark import verify_all as jverify_all
from zk_evm_tpu.stark.public_values import (
    public_values_to_dict as jpublic_values_to_dict)
from zk_evm_tpu.stark.serialization import (
    all_proof_from_json as jall_proof_from_json)
from zk_evm_tpu.tables import all_stark as jast
from zk_evm_tpu_torch.orchestration import block
from zk_evm_tpu_torch.orchestration.aggregation import aggregate_block
from zk_evm_tpu_torch.orchestration.block import check_segment_pair
from zk_evm_tpu_torch.stark import StarkConfig, prove_all, verify_all
from zk_evm_tpu_torch.stark.multi import AllProof
from zk_evm_tpu_torch.stark.public_values import (public_values_from_dict,
                                                  public_values_to_dict)
from zk_evm_tpu_torch.stark.serialization import (all_proof_from_json,
                                                  proof_to_json)
from zk_evm_tpu_torch.tables import all_stark as ast
from zk_evm_tpu_torch.tables.memory_chain import (chain_traces,
                                                  preinitialized_words)
from zk_evm_tpu_torch.witness.kernel import combined_kernel
from zk_evm_tpu_torch.witness.segments import generate_segment_tables
from zk_evm_tpu_torch.witness.testing_fixtures import FIXTURES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# sha256 of the JAX package's proof_to_json(prove_block(...)) of the
# one-segment simple-transfer block (max_cpu_len_log=16, default table
# sizes) at StarkConfig.test_config(); chip_smoke.py holds the card's
# proof to the same constant
SIMPLE_TRANSFER_TEST_CONFIG_SHA256 = (
    "3902cdd9bd01926e9f362b7c14ea25972b7c1720ad086fc708f06891a3743470")


def simple_transfer_segments(log: int):
    return [gt for _, gt in generate_segment_tables(
        combined_kernel(), FIXTURES["simple-transfer"](),
        max_cpu_len_log=log)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The CPU proofs here are small: one intra-op thread proves them
    faster than many and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def chain_proof():
    """(traces, public values, port proof) of the 100-word memory chain
    under the simple-transfer block's public values."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("ZK_TABLE_MIN_DEGREES", raising=False)
        pv = simple_transfer_segments(16)[0].public_values
    traces = chain_traces(preinitialized_words(100, seed=7))
    proof = prove_all(ast.all_starks(), traces,
                      ast.all_cross_table_lookups(),
                      StarkConfig.test_config(), public_values=pv,
                      device="cpu")
    return traces, pv, proof


def optional_of(traces):
    return tuple(i for i, t in enumerate(traces) if t is None)


def port_verify(traces, proof):
    verify_all(ast.all_starks(), proof, ast.all_cross_table_lookups(),
               StarkConfig.test_config(),
               optional_tables=optional_of(traces))


def jax_verify(traces, text):
    jverify_all(jast.all_starks(), jall_proof_from_json(text),
                jast.all_cross_table_lookups(), JStarkConfig.test_config(),
                optional_tables=optional_of(traces))


def test_public_values_in_proof(chain_proof):
    _, pv, proof = chain_proof
    assert proof.public_values is pv
    assert proof.public_inputs == pv.to_elements()
    with pytest.raises(AssertionError, match="not both"):
        prove_all([], [], [], StarkConfig.test_config(), public_inputs=[1],
                  public_values=pv, device="cpu")


def test_both_verifiers_accept_public_values_proof(chain_proof):
    traces, pv, proof = chain_proof
    text = proof_to_json(proof)
    jproof = jall_proof_from_json(text)
    assert jpublic_values_to_dict(jproof.public_values) == \
        public_values_to_dict(pv)
    assert jproof.public_values.to_elements() == pv.to_elements()
    jax_verify(traces, text)
    back = all_proof_from_json(text)
    assert back.public_values == pv
    assert proof_to_json(back) == text
    port_verify(traces, back)


@pytest.mark.parametrize("path", [
    ("block_metadata", "block_gas_used"),
    ("block_metadata", "block_timestamp"),
    ("extra_block_data", "txn_number_after"),
])
def test_changed_public_value_rejected(chain_proof, path):
    """One public value changed, with the public inputs re-encoded to
    match it: the transcript's challenges change, so both verifiers
    reject the proof."""
    traces, _, proof = chain_proof
    d = json.loads(proof_to_json(proof))
    d["public_values"][path[0]][path[1]] += 1
    d["public_inputs"] = public_values_from_dict(
        d["public_values"]).to_elements()
    assert d["public_inputs"] != proof.public_inputs
    text = json.dumps(d)
    with pytest.raises(AssertionError):
        port_verify(traces, all_proof_from_json(text))
    with pytest.raises(AssertionError):
        jax_verify(traces, text)


# ---- host chain checks, with stub proofs (tests/test_orchestration.py) ---

class _Stub:
    def __init__(self, cap):
        self.trace_cap = cap


def stub_proof(pv, regs_before, regs_after, before_cap, after_cap):
    """AllProof stub with just enough structure for the chain checks."""
    proofs = [None] * ast.NUM_TABLES
    proofs[ast.Table.MemBefore] = _Stub(before_cap)
    if after_cap is not None:
        proofs[ast.Table.MemAfter] = _Stub(after_cap)
    return AllProof(
        proofs=proofs, table_in_use=[p is not None for p in proofs],
        public_values=dataclasses.replace(
            pv,
            registers_before=dataclasses.replace(pv.registers_before,
                                                 **regs_before),
            registers_after=dataclasses.replace(pv.registers_after,
                                                **regs_after)))


def stub_chain(kernel, pv, broken=None):
    """Two chained stub segments of a block under the statement `pv`;
    `broken` names the link to break: "registers" or "caps"."""
    main, halt = (kernel.global_labels[k] for k in ("main", "halt"))
    ra = dict(program_counter=main, gas_used=0)
    rb = dict(program_counter=main + 10, gas_used=9)
    rc = dict(program_counter=halt, gas_used=11)
    caps = [[[i, 0, 0, 0]] for i in range(3)]
    s0 = stub_proof(pv, ra, rb, caps[0], caps[1])
    if broken == "registers":
        return [s0, stub_proof(pv, rc, rc, caps[1], None)]
    if broken == "caps":
        return [s0, stub_proof(pv, rb, rc, caps[2], None)]
    return [s0, stub_proof(pv, rb, rc, caps[1], None)]


def empty_batch(pv):
    """The statement of a batch that runs no transaction and ends where
    `pv`'s batch starts."""
    return dataclasses.replace(
        pv, trie_roots_after=pv.trie_roots_before,
        extra_block_data=dataclasses.replace(
            pv.extra_block_data, txn_number_after=0, gas_used_after=0))


def stub_batches(kernel, pv, case):
    """The batch chains of `test_aggregate_block_host_checks`' cases."""
    if case in ("registers", "caps"):
        return [stub_chain(kernel, pv, broken=case)]
    if case == "gas":
        md = pv.block_metadata
        return [stub_chain(kernel, dataclasses.replace(
            pv, block_metadata=dataclasses.replace(
                md, block_gas_used=md.block_gas_used + 1)))]
    if case == "txn_trie":
        roots = pv.trie_roots_before
        return [stub_chain(kernel, dataclasses.replace(
            pv, trie_roots_before=dataclasses.replace(
                roots, transactions_root=b"\x01" * 32)))]
    if case == "two_batches":
        return [stub_chain(kernel, empty_batch(pv)), stub_chain(kernel, pv)]
    if case == "unchained_batches":
        return [stub_chain(kernel, pv), stub_chain(kernel, pv)]
    return [stub_chain(kernel, pv)]


@pytest.mark.parametrize("case", ["good", "registers", "caps"])
def test_check_segment_pair(chain_proof, case):
    a, b = stub_chain(combined_kernel(), chain_proof[1],
                      broken=None if case == "good" else case)
    if case == "good":
        check_segment_pair(a, b)
        return
    with pytest.raises(AssertionError, match="chain broken"):
        check_segment_pair(a, b)


HOST_CHECK_REJECTS = {
    "registers": "register chain broken",
    "caps": "cap chain broken",
    "gas": "header gas_used",
    "txn_trie": "txn trie must start empty",
    "unchained_batches": "trie roots do not chain",
}


@pytest.mark.parametrize("case", ["good", "two_batches",
                                  *HOST_CHECK_REJECTS])
def test_aggregate_block_host_checks(chain_proof, case, monkeypatch):
    """aggregate_block with every segment's STARK verification stubbed
    out: what is left are the host checks of the segment chain, of the
    batch chain and of the block's initial values."""
    kernel, pv = combined_kernel(), chain_proof[1]
    batches = stub_batches(kernel, pv, case)
    monkeypatch.setattr(block, "verify_block", lambda *a, **k: None)
    if case in HOST_CHECK_REJECTS:
        with pytest.raises(AssertionError, match=HOST_CHECK_REJECTS[case]):
            aggregate_block(batches, kernel)
        return
    bp = aggregate_block(batches, kernel)
    # the block statement spans the batches: the first batch's start,
    # the last one's end
    last = batches[-1]
    assert bp.public_values == dataclasses.replace(
        last[0].public_values,
        registers_before=batches[0][0].public_values.registers_before,
        registers_after=last[-1].public_values.registers_after)


def test_pipeline_overlaps_witness_and_keeps_order():
    """prove_segments_pipelined proves in segment order, records each
    segment's host witness time beside its prove time, and raises what
    the witness thread raised."""
    import threading
    from zk_evm_tpu_torch.orchestration.pipeline import (
        prove_segments_pipelined)
    from zk_evm_tpu_torch.timing import TimingTree

    class Seg:
        def __init__(self, index):
            self.index = index

    threads = set()

    def segments(n, fail_at=None):
        for i in range(n):
            threads.add(threading.get_ident())
            if i == fail_at:
                raise ValueError("witness failed")
            yield Seg(i), i * 10

    with TimingTree() as tree:
        out = prove_segments_pipelined(segments(3), lambda t: t + 1)
    assert out == [1, 11, 21]
    assert threading.get_ident() not in threads
    assert [c.name for c in tree.root.children] == [
        f"{kind} segment {i}{suffix}" for i in range(3)
        for kind, suffix in (("witness", " (host)"), ("prove", ""))]
    with pytest.raises(ValueError, match="witness failed"):
        prove_segments_pipelined(segments(3, fail_at=1), lambda t: t)


def test_cli_prove_refuses_without_card():
    """`prove` defaults to CUDA: with no card visible it raises rather
    than proving on the CPU."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, "-m", "zk_evm_tpu_torch", "prove", "--fixture",
         "simple-transfer", "-o", os.devnull],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert proc.stdout == ""


def test_cli_verify_refuses_without_card(monkeypatch):
    """`verify` defaults to CUDA too (its initial-cap commitment runs
    there): with no card it raises before reading the proof."""
    from zk_evm_tpu_torch.__main__ import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["verify", os.path.join(REPO, "no-such.zkproof")])


@pytest.mark.slow
def test_simple_transfer_segment_equals_jax_on_cpu(monkeypatch):
    from zk_evm_tpu.orchestration.block import (
        prove_block as jprove_block, verify_block as jverify_block)
    from zk_evm_tpu.stark.serialization import proof_to_json as jjson
    from zk_evm_tpu.witness.assembler import combined_kernel as jkernel
    from zk_evm_tpu.witness.segments import (
        generate_segment_tables as jsegments)
    from zk_evm_tpu.witness.testing_fixtures import FIXTURES as JFIXTURES
    monkeypatch.delenv("ZK_TABLE_MIN_DEGREES", raising=False)
    (gt,) = simple_transfer_segments(16)
    text = proof_to_json(block.prove_block(gt, StarkConfig.test_config(),
                                           device="cpu"))
    digest = hashlib.sha256(text.encode()).hexdigest()
    assert digest == SIMPLE_TRANSFER_TEST_CONFIG_SHA256
    block.verify_block(all_proof_from_json(text), combined_kernel(),
                       StarkConfig.test_config(), device="cpu")
    jverify_block(jall_proof_from_json(text), jkernel(),
                  JStarkConfig.test_config())
    ((_, jgt),) = jsegments(jkernel(), JFIXTURES["simple-transfer"](),
                            max_cpu_len_log=16)
    jtext = jjson(jprove_block(jgt, JStarkConfig.test_config()))
    assert hashlib.sha256(jtext.encode()).hexdigest() == \
        SIMPLE_TRANSFER_TEST_CONFIG_SHA256
