"""The cdk_erigon table set of the PyTorch port against the JAX package: the
twins of tests/test_cdk_flavor.py's cases that need no zk_evm checkout.

- the registry: `all_starks("cdk_erigon")` (ten tables, the Poseidon
  coprocessor last) and `all_cross_table_lookups("cdk_erigon")` (the three
  Poseidon CTLs with their cdk-CPU looking views, the Poseidon table's 56
  byte reads in the memory CTL) equal the JAX package's, by repr and by
  the columns each view and filter gives on the same trace;
- `build_cdk_poseidon_scenario`: its traces equal the JAX package's,
  array for array; constraints and CTL balance hold, also with the
  7-block POSEIDON_GENERAL that fills an 8-row Poseidon table (the
  standard config's least);
- its proof at tests/test_cdk_flavor.py's config equals the JAX package's
  byte for byte (pinned as a sha256 that the `slow` test recomputes: the
  JAX proof takes minutes of XLA compiles), and both packages' verify_all
  accept it; a wrong memory byte and a wrong digest are rejected (`slow`,
  as the JAX package has them under ZK_SLOW);
- the block layer: `starks_for_kernel(kernel, "cdk_erigon")`, and
  `verify_block` reading a ten-proof AllProof as a cdk_erigon proof.

Tolerance 0."""

import copy
import hashlib

import numpy as np
import pytest
import torch

from zk_evm_tpu.stark import StarkConfig as JStarkConfig
from zk_evm_tpu.stark import FriConfig as JFriConfig
from zk_evm_tpu.stark import lookup as jlk
from zk_evm_tpu.stark import verify_all as jverify_all
from zk_evm_tpu.stark.serialization import (
    all_proof_from_json as jall_proof_from_json)
from zk_evm_tpu.tables import all_stark as jast
from zk_evm_tpu.tables.scenarios import (
    build_cdk_poseidon_scenario as jbuild_cdk_poseidon_scenario)
from zk_evm_tpu_torch.stark import (FriConfig, StarkConfig, prove_all,
                                    verify_all)
from zk_evm_tpu_torch.stark import lookup as lk
from zk_evm_tpu_torch.stark.debug import (check_constraints_np,
                                          check_ctl_balance)
from zk_evm_tpu_torch.stark.serialization import proof_to_json
from zk_evm_tpu_torch.tables import all_stark as ast
from zk_evm_tpu_torch.tables import cpu_columns as cc
from zk_evm_tpu_torch.tables import memory as mem
from zk_evm_tpu_torch.tables import poseidon as ps
from zk_evm_tpu_torch.tables.scenarios import build_cdk_poseidon_scenario
from zk_evm_tpu_torch.tables.segments import Segment

CDK = "cdk_erigon"
CFG_KW = dict(rate_bits=1, cap_height=2, proof_of_work_bits=0,
              num_query_rounds=1, arity_bits=2, final_poly_bits=2)
TABLES = ["Arithmetic", "BytePacking", "Cpu", "Keccak", "KeccakSponge",
          "Logic", "Memory", "MemBefore", "MemAfter", "Poseidon"]
POSEIDON_CTLS = ["poseidon_simple", "poseidon_general_input",
                 "poseidon_general_output"]
# sha256 of the JAX package's proof_to_json(prove_all(...)) of the cdk
# scenario at CFG_KW (tests/test_cdk_flavor.py's config), made on the CPU;
# the `slow` test recomputes it, and chip_smoke.py holds the card's proof
# to it
CDK_SCENARIO_SHA256 = (
    "10d286ea5b1baf5a5dbd237ec15b0bfe1fc1a02007221a8a1d764ecef4301260")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread proves these small tables faster than many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return StarkConfig(security_bits=1, fri_config=FriConfig(**CFG_KW))


def _jcfg():
    return JStarkConfig(security_bits=1, fri_config=JFriConfig(**CFG_KW))


def _optional(traces):
    return tuple(i for i, t in enumerate(traces) if t is None)


def _starks(cpu_stark):
    starks = ast.all_starks(CDK)
    starks[ast.Table.Cpu] = cpu_stark
    return starks


# ---- the registry --------------------------------------------------------

def test_cdk_registry():
    starks = ast.all_starks(CDK)
    assert len(starks) == ast.CDK_NUM_TABLES == jast.CDK_NUM_TABLES == 10
    assert ast.Table.Poseidon == jast.Table.Poseidon == 9
    assert ast.CDK_OPTIONAL_TABLES == jast.CDK_OPTIONAL_TABLES
    assert starks[ast.Table.Poseidon].name == "poseidon"
    assert starks[ast.Table.Cpu].num_columns == cc.NUM_CPU_COLUMNS_CDK
    assert [type(s).__name__ for s in starks] == \
        [type(s).__name__ for s in jast.all_starks(CDK)]
    ctls = ast.all_cross_table_lookups(CDK)
    assert [c.name for c in ctls][-3:] == POSEIDON_CTLS
    for c in ctls[-3:]:
        assert len(c.looking) == 1
        assert c.looking[0].table == ast.Table.Cpu
    pos_views = [v for v in ctls[ast.MEMORY_CTL_IDX].looking
                 if v.table == ast.Table.Poseidon]
    assert len(pos_views) == ps.BLOCK_BYTES
    jctls = jast.all_cross_table_lookups(CDK)
    assert [repr(c) for c in ctls] == [repr(c) for c in jctls]
    # the eth_mainnet set is untouched: nine tables, ten CTLs
    assert len(ast.all_starks()) == ast.NUM_TABLES == 9
    assert [repr(c) for c in ast.all_cross_table_lookups()] == \
        [repr(c) for c in jast.all_cross_table_lookups()]
    assert len(ctls) == len(ast.all_cross_table_lookups()) + 3


@pytest.mark.parametrize("table", TABLES)
def test_cdk_table_spec_equal(table):
    t = getattr(ast.Table, table)
    assert t == getattr(jast.Table, table)
    stark, jstark = ast.all_starks(CDK)[t], jast.all_starks(CDK)[t]
    assert (stark.name, stark.num_columns, stark.num_public_inputs) == \
        (jstark.name, jstark.num_columns, jstark.num_public_inputs)
    assert repr(stark.lookups()) == repr(jstark.lookups())
    groups = lk.ctl_groups_for_table(ast.all_cross_table_lookups(CDK), t)
    jgroups = jlk.ctl_groups_for_table(jast.all_cross_table_lookups(CDK), t)
    assert repr(groups) == repr(jgroups)


# ---- the scenario --------------------------------------------------------

@pytest.fixture(scope="module")
def scenario():
    return build_cdk_poseidon_scenario()


def test_cdk_scenario_traces_equal_jax(scenario):
    traces, cpu_stark = scenario
    jtraces, jcpu_stark = jbuild_cdk_poseidon_scenario()
    assert len(traces) == len(jtraces) == ast.CDK_NUM_TABLES
    for t, jt in zip(traces, jtraces):
        assert (t is None) == (jt is None)
        if t is not None:
            assert t.dtype == jt.dtype and np.array_equal(t, jt)
    assert (cpu_stark.flavor, cpu_stark.num_columns, cpu_stark.halt_pc) == \
        (jcpu_stark.flavor, jcpu_stark.num_columns, jcpu_stark.halt_pc)


def test_cdk_views_equal_jax(scenario):
    """Every view and filter of the three Poseidon CTLs and the memory
    CTL gives the JAX package's columns on the scenario's traces."""
    traces, _ = scenario
    ctls = ast.all_cross_table_lookups(CDK)
    jctls = jast.all_cross_table_lookups(CDK)
    for c, jc in zip(ctls, jctls):
        if c.name not in POSEIDON_CTLS and ctls.index(c) != \
                ast.MEMORY_CTL_IDX:
            continue
        for v, jv in zip(c.looking + (c.looked,), jc.looking + (jc.looked,)):
            trace = traces[v.table]
            if trace is None:
                continue
            assert len(v.columns) == len(jv.columns)
            for col, jcol in zip(v.columns, jv.columns):
                assert np.array_equal(col.eval_np(trace),
                                      jcol.eval_np(trace))
            assert np.array_equal(v.filter.eval_np(trace),
                                  jv.filter.eval_np(trace))


def test_cdk_scenario_balances_and_constrains(scenario):
    traces, cpu_stark = scenario
    check_constraints_np(cpu_stark, traces[ast.Table.Cpu])
    check_ctl_balance(ast.all_cross_table_lookups(CDK), traces)


def test_cdk_scenario_fills_standard_config_tables():
    """A 7-block POSEIDON_GENERAL fills an 8-row Poseidon table with real
    rows (the fewest a height-4 cap at rate 2^-1 commits), every block's
    56 bytes read from Memory; constraints and CTLs still balance."""
    traces, cpu_stark = build_cdk_poseidon_scenario(general_blocks=7)
    pos = traces[ast.Table.Poseidon]
    assert pos.shape[1] == 8 and pos[ps.NOT_PADDING].all()
    assert int(pos[ps.IS_SIMPLE_OP].sum()) == 1
    std = StarkConfig.standard_fast_config()
    assert min(t.shape[1] for t in traces if t is not None) \
        << std.rate_bits >= 1 << std.cap_height
    mtrace = traces[ast.Table.Memory]
    reads = (mtrace[mem.ADDR_SEGMENT] == int(Segment.KernelGeneral)) \
        & (mtrace[mem.FILTER] == 1) & (mtrace[mem.IS_READ] == 1)
    assert len(set(mtrace[mem.ADDR_VIRTUAL, reads].tolist())) == \
        7 * ps.BLOCK_BYTES
    check_constraints_np(cpu_stark, traces[ast.Table.Cpu])
    check_constraints_np(ast.all_starks(CDK)[ast.Table.Poseidon], pos)
    check_ctl_balance(ast.all_cross_table_lookups(CDK), traces)


@pytest.fixture(scope="module")
def cdk_proof(scenario):
    traces, cpu_stark = scenario
    return prove_all(_starks(cpu_stark), traces,
                     ast.all_cross_table_lookups(CDK), _cfg(), device="cpu")


def test_cdk_scenario_proof_equals_jax(cdk_proof):
    digest = hashlib.sha256(proof_to_json(cdk_proof).encode()).hexdigest()
    assert digest == CDK_SCENARIO_SHA256
    assert len(cdk_proof.proofs) == ast.CDK_NUM_TABLES


def test_cdk_scenario_proof_verifies_under_both(scenario, cdk_proof):
    traces, cpu_stark = scenario
    optional = _optional(traces)
    verify_all(_starks(cpu_stark), cdk_proof,
               ast.all_cross_table_lookups(CDK), _cfg(),
               optional_tables=optional)
    _, jcpu_stark = jbuild_cdk_poseidon_scenario()
    jstarks = jast.all_starks(CDK)
    jstarks[jast.Table.Cpu] = jcpu_stark
    jverify_all(jstarks, jall_proof_from_json(proof_to_json(cdk_proof)),
                jast.all_cross_table_lookups(CDK), _jcfg(),
                optional_tables=optional)


def _prove_rejected(traces, cpu_stark):
    starks = _starks(cpu_stark)
    ctls = ast.all_cross_table_lookups(CDK)
    proof = prove_all(starks, traces, ctls, _cfg(), device="cpu")
    with pytest.raises(AssertionError):
        verify_all(starks, proof, ctls, _cfg(),
                   optional_tables=_optional(traces))


@pytest.mark.slow
def test_cdk_rejects_wrong_memory_byte():
    """A coprocessor-read byte flipped in Memory: the memory CTL
    unbalances."""
    traces, cpu_stark = build_cdk_poseidon_scenario()
    mtrace = traces[ast.Table.Memory]
    rows = np.nonzero(mtrace[mem.ADDR_SEGMENT]
                      == int(Segment.KernelGeneral))[0]
    mtrace[mem.VALUE_COLS[0], int(rows[0])] ^= 1
    _prove_rejected(traces, cpu_stark)


@pytest.mark.slow
def test_cdk_rejects_wrong_digest():
    """The CPU-claimed simple digest (next row's top of stack) changed:
    the poseidon_simple CTL unbalances."""
    traces, cpu_stark = build_cdk_poseidon_scenario()
    traces[ast.Table.Cpu][cc.MEM_CHANNELS[0].value[0], 1] ^= 1
    _prove_rejected(traces, cpu_stark)


@pytest.mark.slow
def test_cdk_scenario_constant_is_jax():
    """Recompute CDK_SCENARIO_SHA256 with the JAX package (minutes)."""
    from zk_evm_tpu.stark import prove_all as jprove_all
    from zk_evm_tpu.stark.serialization import proof_to_json as jpj
    jtraces, jcpu_stark = jbuild_cdk_poseidon_scenario()
    jstarks = jast.all_starks(CDK)
    jstarks[jast.Table.Cpu] = jcpu_stark
    proof = jprove_all(jstarks, jtraces, jast.all_cross_table_lookups(CDK),
                       _jcfg())
    assert hashlib.sha256(jpj(proof).encode()).hexdigest() == \
        CDK_SCENARIO_SHA256


# ---- the block layer -----------------------------------------------------

def test_starks_for_kernel_cdk():
    from zk_evm_tpu_torch.orchestration.block import starks_for_kernel
    from zk_evm_tpu_torch.tables.cpu import cpu_stark_for_kernel
    from zk_evm_tpu_torch.witness.kernel import combined_kernel
    kernel = combined_kernel()
    starks = starks_for_kernel(kernel, CDK)
    assert [type(s).__name__ for s in starks] == \
        [type(s).__name__ for s in ast.all_starks(CDK)]
    want = cpu_stark_for_kernel(kernel, CDK)
    cpu = starks[ast.Table.Cpu]
    assert (cpu.flavor, cpu.num_columns, cpu.halt_pc) == \
        (CDK, cc.NUM_CPU_COLUMNS_CDK, want.halt_pc)
    assert len(starks_for_kernel(kernel)) == ast.NUM_TABLES


@pytest.mark.parametrize("n_tables", [ast.NUM_TABLES, ast.CDK_NUM_TABLES])
def test_verify_block_reads_flavor_from_proof_count(monkeypatch, cdk_proof,
                                                    n_tables):
    """verify_block hands verify_all the cdk_erigon starks, CTLs and
    optional tables for a ten-proof AllProof, the eth_mainnet ones for
    nine."""
    from zk_evm_tpu_torch.orchestration import block
    from zk_evm_tpu_torch.stark.multi import AllProof
    from zk_evm_tpu_torch.stark.public_values import PublicValues
    from zk_evm_tpu_torch.witness.kernel import combined_kernel
    seen = {}

    def record(starks, all_proof, ctls, config, **kw):
        seen.update(starks=starks, ctls=ctls, **kw)
    monkeypatch.setattr(block, "verify_all", record)
    pv = PublicValues()
    proof = AllProof(proofs=copy.copy(cdk_proof.proofs[:n_tables]),
                     table_in_use=cdk_proof.table_in_use[:n_tables],
                     public_inputs=pv.to_elements(), public_values=pv)
    block.verify_block(proof, combined_kernel(), _cfg(),
                       check_initial_cap=False, device="cpu")
    flavor = CDK if n_tables == ast.CDK_NUM_TABLES else "eth_mainnet"
    assert len(seen["starks"]) == n_tables
    assert seen["starks"][ast.Table.Cpu].flavor == flavor
    assert [repr(c) for c in seen["ctls"]] == \
        [repr(c) for c in ast.all_cross_table_lookups(flavor)]
    assert seen["optional_tables"] == (
        ast.CDK_OPTIONAL_TABLES if flavor == CDK else ast.OPTIONAL_TABLES)
