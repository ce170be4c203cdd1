"""Multi-table proving of the PyTorch port against the JAX package: the
memory-continuation chain MemBefore -> Memory -> MemAfter under one
transcript, with Memory's logUp lookups and the cross-table lookups.
`proof_to_json(prove_all(...))` is byte-identical for two inputs
(`__graft_entry__.py`'s 5 words at its config, and 100 random words at
the test config); each package's `verify_all` accepts the other's proof;
a proof of a tampered Memory trace is rejected by both.

The JAX package's two `prove_all` runs take minutes of XLA compiles on
the CPU, so tier-1 holds the port's proofs to the sha256 of the JAX
proofs, pinned in JAX_ALL_PROOF_SHA256, and the `slow` test
(`-m slow`) makes the JAX proofs, checks the constants and has the
port's verifier accept them."""

import hashlib

import numpy as np
import pytest
import torch

from zk_evm_tpu.stark import (StarkConfig as JStarkConfig,
                              FriConfig as JFriConfig,
                              prove_all as jprove_all,
                              verify_all as jverify_all)
from zk_evm_tpu.stark.serialization import (
    all_proof_from_json as jall_proof_from_json,
    proof_to_json as jproof_to_json)
from zk_evm_tpu.tables import all_stark as jast
from zk_evm_tpu_torch.stark import (StarkConfig, FriConfig, prove_all,
                                    verify_all)
from zk_evm_tpu_torch.stark.multi import AllProof
from zk_evm_tpu_torch.stark.serialization import (all_proof_from_json,
                                                  proof_to_json)
from zk_evm_tpu_torch.tables import (all_stark as ast, memory,
                                     memory_continuation)
from zk_evm_tpu_torch.tables.memory_chain import (chain_traces,
                                                  preinitialized_words)
from zk_evm_tpu_torch.tables.segments import Segment

GRAFT_KW = dict(rate_bits=1, cap_height=1, proof_of_work_bits=0,
                num_query_rounds=2, arity_bits=2, final_poly_bits=2)
CASES = {
    # __graft_entry__.py's chain and config
    "graft_5_words": (
        [((0, Segment.MainMemory, 64 + i), i * 7 + 1) for i in range(5)],
        StarkConfig(security_bits=1, fri_config=FriConfig(**GRAFT_KW)),
        JStarkConfig(security_bits=1, fri_config=JFriConfig(**GRAFT_KW))),
    "words_100": (preinitialized_words(100, seed=7),
                  StarkConfig.test_config(), JStarkConfig.test_config()),
}


# sha256 of the JAX package's proof_to_json(prove_all(...)) of each case
JAX_ALL_PROOF_SHA256 = {
    "graft_5_words":
        "6b4be97ade9f5741540edda5d946cdad5ffbdcd7e82ef6d293a6fd8c18f22087",
    "words_100":
        "cdf308dc29fcccebcceb5ca8d997990fc6d081ac0cd0978be18118ed26167582",
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread runs these small CPU proofs and hashes as fast
    as many and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def optional_of(traces):
    return tuple(i for i, t in enumerate(traces) if t is None)


@pytest.fixture(scope="module", params=list(CASES))
def proofs(request):
    """(traces, port proof, case name, cfg, jcfg), each proof built
    once."""
    words, cfg, jcfg = CASES[request.param]
    traces = chain_traces(words)
    proof = prove_all(ast.all_starks(), traces,
                      ast.all_cross_table_lookups(), cfg, device="cpu")
    return traces, proof, request.param, cfg, jcfg


def test_all_proof_json_identical(proofs):
    _, proof, case, _, _ = proofs
    assert hashlib.sha256(proof_to_json(proof).encode()).hexdigest() == \
        JAX_ALL_PROOF_SHA256[case]


def test_jax_verifier_accepts_port_proof(proofs):
    traces, proof, _, _, jcfg = proofs
    jverify_all(jast.all_starks(), jall_proof_from_json(proof_to_json(proof)),
                jast.all_cross_table_lookups(), jcfg,
                optional_tables=optional_of(traces))


def test_port_verifier_accepts_jax_proof(proofs):
    """The port's proof, and the same proof read back from its JSON (the
    JAX proof's text, by test_all_proof_json_identical; the `slow` test
    reads the JAX package's own)."""
    traces, proof, _, cfg, _ = proofs
    for p in (proof, all_proof_from_json(proof_to_json(proof))):
        verify_all(ast.all_starks(), p, ast.all_cross_table_lookups(), cfg,
                   optional_tables=optional_of(traces))


@pytest.mark.slow
@pytest.mark.parametrize("case", list(CASES))
def test_jax_all_proof_constants(case):
    """The JAX package's proof of each case (minutes of XLA compiles):
    its sha256 is JAX_ALL_PROOF_SHA256's, and the port's verifier accepts
    it."""
    words, cfg, jcfg = CASES[case]
    traces = chain_traces(words)
    jjson = jproof_to_json(jprove_all(jast.all_starks(), traces,
                                      jast.all_cross_table_lookups(), jcfg))
    assert hashlib.sha256(jjson.encode()).hexdigest() == \
        JAX_ALL_PROOF_SHA256[case]
    verify_all(ast.all_starks(), all_proof_from_json(jjson),
               ast.all_cross_table_lookups(), cfg,
               optional_tables=optional_of(traces))


def test_all_proof_json_roundtrip(proofs):
    _, proof, _, _, _ = proofs
    text = proof_to_json(proof)
    assert proof_to_json(all_proof_from_json(text)) == text


def test_tampered_memory_value_rejected():
    """One value limb of a preinitialized word flipped in the Memory trace
    only: Memory no longer matches MemBefore, and the CTL totals do not
    cancel (as tests/test_all_stark.py's memory mutation)."""
    words, cfg, jcfg = CASES["words_100"]
    traces = chain_traces(words)
    mtrace = traces[ast.Table.Memory]
    r = int(np.nonzero(mtrace[memory.FILTER] == 1)[0][3])
    mtrace[memory.VALUE_COLS[0], r] ^= 1
    proof = prove_all(ast.all_starks(), traces,
                      ast.all_cross_table_lookups(), cfg, device="cpu")
    with pytest.raises(AssertionError):
        verify_all(ast.all_starks(), proof, ast.all_cross_table_lookups(),
                   cfg, optional_tables=optional_of(traces))
    with pytest.raises(AssertionError):
        jverify_all(jast.all_starks(),
                    jall_proof_from_json(proof_to_json(proof)),
                    jast.all_cross_table_lookups(), jcfg,
                    optional_tables=optional_of(traces))


def test_extra_looking_values_balance_memory_ctl():
    """Memory writes that no proved table looks up (as a block's
    public-value writes at timestamp 2) unbalance the memory CTL until
    the verifier adds their rows through `extra_looking_values`: both
    packages' `verify_all` accept the port's proof with them and reject
    it without."""
    words, cfg, jcfg = CASES["graft_5_words"]
    rng = np.random.default_rng(3)
    values = [int.from_bytes(rng.bytes(32), "little") for _ in range(4)]
    writes = [memory.MemoryOp(True, 2, 0, Segment.GlobalMetadata, i, False, v)
              for i, v in enumerate(values)]
    mem_trace, mem_after = memory.generate_trace(writes,
                                                 mem_before_values=words)
    traces = [None] * ast.NUM_TABLES
    traces[ast.Table.Memory] = mem_trace
    traces[ast.Table.MemBefore] = memory_continuation.generate_trace(words)
    traces[ast.Table.MemAfter] = memory_continuation.generate_trace(
        mem_after)
    extra = {ast.MEMORY_CTL_IDX: [
        [0, 0, int(Segment.GlobalMetadata), i]
        + [(v >> (32 * j)) & 0xFFFFFFFF for j in range(8)] + [2]
        for i, v in enumerate(values)]}
    proof = prove_all(ast.all_starks(), traces,
                      ast.all_cross_table_lookups(), cfg, device="cpu")
    jproof = jall_proof_from_json(proof_to_json(proof))
    opt = optional_of(traces)
    verify_all(ast.all_starks(), proof, ast.all_cross_table_lookups(), cfg,
               extra_looking_values=extra, optional_tables=opt)
    jverify_all(jast.all_starks(), jproof, jast.all_cross_table_lookups(),
                jcfg, extra_looking_values=extra, optional_tables=opt)
    with pytest.raises(AssertionError, match="'memory' unbalanced"):
        verify_all(ast.all_starks(), proof, ast.all_cross_table_lookups(),
                   cfg, optional_tables=opt)
    with pytest.raises(AssertionError, match="'memory' unbalanced"):
        jverify_all(jast.all_starks(), jproof,
                    jast.all_cross_table_lookups(), jcfg,
                    optional_tables=opt)


def test_vacuous_proof_rejected():
    """An AllProof with no table in use must not verify."""
    vacuous = AllProof(proofs=[None] * ast.NUM_TABLES,
                       table_in_use=[False] * ast.NUM_TABLES)
    with pytest.raises(AssertionError):
        verify_all(ast.all_starks(), vacuous, ast.all_cross_table_lookups(),
                   StarkConfig.test_config(),
                   optional_tables=ast.OPTIONAL_TABLES)


def test_prove_all_needs_cuda_or_explicit_cpu():
    """Without `device`, prove_all runs on CUDA; without a card it raises
    and never falls back to the CPU."""
    traces = chain_traces(CASES["graft_5_words"][0])
    cfg = CASES["graft_5_words"][1]
    if torch.cuda.is_available():
        proof = prove_all(ast.all_starks(), traces,
                          ast.all_cross_table_lookups(), cfg)
        assert proof_to_json(proof) == proof_to_json(prove_all(
            ast.all_starks(), traces, ast.all_cross_table_lookups(), cfg,
            device="cpu"))
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prove_all(ast.all_starks(), traces, ast.all_cross_table_lookups(),
                  cfg)
