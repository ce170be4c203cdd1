"""The kernel-asm toolchain of the PyTorch port against the JAX package.

Parse trees, %stack searches, peephole rewrites, assembled kernels (the
snippets of tests/test_assembler.py, test_cpu.py, test_interpreter.py and
test_persistence.py, a synthetic 159-file kernel tree under both feature
sets), the frozen-kernel fallback, the kernel cache, `run_kernel`, the
CPU-table rows of assembled programs and the CPU-table proof of
test_cpu.py's SRC. Every output is exact: the tolerance is 0.

The programs that `chip_smoke.py` also runs, with their code hashes
pinned from the JAX assembler, live in tests/data/asm_programs.json. The
JAX package's CPU-table proof takes an XLA compile of about a minute, so
tier-1 holds the port's proof to STACK_TEST_PROOF_SHA256 and the `slow`
test recomputes the JAX proof."""

import dataclasses
import hashlib
import json
import os
import random

import numpy as np
import pytest
import torch

from zk_evm_tpu.orchestration import persistence as jper
from zk_evm_tpu.tables import cpu as jcpu
from zk_evm_tpu.witness import asm_parser as jap
from zk_evm_tpu.witness import assembler as jasm
from zk_evm_tpu.witness import extract_constants as jec
from zk_evm_tpu.witness import optimizer as jopt
from zk_evm_tpu.witness import stack_search as jss
from zk_evm_tpu.witness.interpreter import (Interpreter as JInterpreter,
                                            run_kernel as jrun_kernel)
from zk_evm_tpu_torch.challenger import Challenger
from zk_evm_tpu_torch.orchestration import persistence as per
from zk_evm_tpu_torch.stark import (FriConfig, StarkConfig, prove_stark,
                                    verify_stark)
from zk_evm_tpu_torch.stark.serialization import proof_to_json
from zk_evm_tpu_torch.tables import cpu
from zk_evm_tpu_torch.tables.segments import Segment
from zk_evm_tpu_torch.witness import asm_parser as ap
from zk_evm_tpu_torch.witness import assembler as asm
from zk_evm_tpu_torch.witness import extract_constants as ec
from zk_evm_tpu_torch.witness import optimizer as opt
from zk_evm_tpu_torch.witness import stack_search as ss
from zk_evm_tpu_torch.witness.interpreter import Interpreter, run_kernel
from zk_evm_tpu_torch.witness.kernel import load_frozen_kernel

import test_cpu
import test_lsp

PROGRAMS_PATH = os.path.join(os.path.dirname(__file__), "data",
                             "asm_programs.json")
with open(PROGRAMS_PATH) as _f:
    PROGRAMS = json.load(_f)
CPU_PROGRAMS = {p["entry"]: p for p in PROGRAMS["cpu_programs"]}
LOOP = PROGRAMS["loop"]
STACK_TEST_PROOF_SHA256 = PROGRAMS["stack_test_proof_sha256"]
RET = 0xDEADBEEF

CONSTANTS, OPCODES, KERNEL_FILES = asm.load_tables()
JCONSTANTS, JOPCODES, _ = jasm.load_tables()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread proves the small CPU table as fast as many and
    leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def loop_source(iterations: int) -> str:
    return LOOP["source"].replace("ITERATIONS", str(iterations))


# Every item kind the parser knows, every kind of macro argument and
# %stack replacement, %rep, PROVER_INPUT, BYTES, JUMPTABLE and the cfg
# prefixes; assembled, never run.
KITCHEN_SINK = """
%macro inner(x)
    PUSH $x
    POP
%endmacro
%macro outer(a)
%%top:
    %inner($a)
    %inner(%%top)
    %stack (p: 2, q) -> (q, %%top, $a, @GAS_VERYLOW, 7, p)
    PUSH %%top
    POP POP POP POP POP POP
%endmacro
GLOBAL sink:
    %outer(5)
    %outer(@GAS_LOW)
    %outer(sink)
    %rep 3
        PUSH 1
        POP
    %endrep
    PROVER_INPUT(ff::bn254_base::inverse)
    POP
    #[cfg(all(feature = eth_mainnet, cdk_erigon))] { PUSH 0xbad }
    #[cfg(any(feature = eth_mainnet, cdk_erigon))] { PUSH 0x600d POP }
    #[cfg(not(feature = eth_mainnet))] { PUSH 0xbad2 }
    /* a block
       comment */
    PUSH table
    JUMP
table:
    JUMPTABLE sink, table, target
    BYTES 1, 2, @GAS_VERYLOW
target:
    PUSH 0x0102030405060708090a0b0c0d0e0f101112131415161718191a1b1c1d1e1f20
    PUSH 0
    STOP
"""

# The snippets of tests/test_assembler.py, test_interpreter.py and
# test_persistence.py (name -> .asm sources, one a file), those of
# test_cpu.py, the loop program at few iterations and the kitchen sink.
SNIPPETS = {
    "basic_ops": ["""
        GLOBAL start:
            PUSH 5
            PUSH 0x1234
            ADD
            STOP
    """],
    "labels_across_files": ["GLOBAL a:\n PUSH b\n JUMP\n",
                            "GLOBAL b:\n STOP\n"],
    "macros_and_constants": ["""
        %macro add_const(c)
            PUSH $c
            ADD
        %endmacro
        GLOBAL go:
            %add_const(7)
            PUSH @SEGMENT_STACK
    """],
    "macro_labels": ["""
        %macro looper
        %%again:
            PUSH %%again
            JUMP
        %endmacro
        GLOBAL go:
            %looper
            %looper
    """],
    "stack_push": ["GLOBAL go:\n %stack (a, b, c) -> (c, 5, 0x20, a)\n"],
    "stack_swap": ["GLOBAL go:\n %stack (a, b) -> (b, a)\n"],
    "stack_drop": ["GLOBAL go:\n %stack (a) -> ()\n"],
    "stack_dup": ["GLOBAL go:\n %stack (a, b) -> (a, a, b, b)\n"],
    "stack_blocks": ["GLOBAL go:\n %stack (P: 4, T: 4, Q: 4) -> (Q, T, P)\n"],
    "conditional_features": ["""
        GLOBAL go:
        #[cfg(feature = eth_mainnet)] { PUSH 1 }
        #[cfg(feature = cdk_erigon)] { PUSH 2 }
        #[cfg(not(feature = cdk_erigon))] { PUSH 3 }
    """],
    "mul_add": ["""
        GLOBAL mul_add:
            // stack: a, b, c, retdest
            MUL ADD
            SWAP1 JUMP
    """],
    "persistence_f": ["GLOBAL f:\n ADD\n SWAP1 JUMP\n"],
    **{name: [p["source"]] for name, p in CPU_PROGRAMS.items()},
    "loop_short": [loop_source(LOOP["short_iterations"])],
    "kitchen_sink": [KITCHEN_SINK],
}


def norm(x):
    """A parse item (or a list of them) as nested tuples of class names and
    field values, so the two packages' dataclasses compare field by
    field."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(
            norm(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(norm(v) for v in x)
    return x


def kernel_fields(k) -> tuple:
    return (k.code, k.code_hash, k.global_labels, k.ordered_labels,
            k.prover_inputs)


def assemble_both(srcs, optimize: bool, features=("eth_mainnet",)):
    port = asm.assemble([ap.parse(s, features) for s in srcs], CONSTANTS,
                        OPCODES, optimize=optimize)
    jax_ = jasm.assemble([jap.parse(s, features) for s in srcs], JCONSTANTS,
                         JOPCODES, optimize=optimize)
    return port, jax_


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_snippet_parse_and_assemble(name):
    srcs = SNIPPETS[name]
    for features in (("eth_mainnet",), ("cdk_erigon",)):
        for s in srcs:
            assert ap.tokenize(s) == jap.tokenize(s)
            assert norm(ap.parse(s, features)) == norm(jap.parse(s, features))
    for optimize in (False, True):
        port, jax_ = assemble_both(srcs, optimize)
        assert isinstance(port, asm.Kernel)
        assert kernel_fields(port) == kernel_fields(jax_)


def test_programs_file_holds_the_tests_sources():
    assert CPU_PROGRAMS["stack_test"]["source"] == test_cpu.SRC
    assert CPU_PROGRAMS["eq_test"]["source"] == test_cpu.EQ_SRC
    assert PROGRAMS["lsp"]["source"] == test_lsp.SRC


@pytest.mark.parametrize("entry", sorted(CPU_PROGRAMS) + ["loop"])
def test_pinned_code_hashes(entry):
    """Both assemblers give the code hash the programs file pins (the
    hashes chip_smoke.py holds the card's run to)."""
    p = LOOP if entry == "loop" else CPU_PROGRAMS[entry]
    src = loop_source(p["iterations"]) if entry == "loop" else p["source"]
    port, jax_ = assemble_both([src], p["optimize"])
    assert port.code_hash.hex() == jax_.code_hash.hex() == p["code_hash"]


def run_both(srcs, entry: str, optimize: bool = False):
    port, jax_ = assemble_both(srcs, optimize)
    pi = Interpreter(port, initial_offset=port.global_labels[entry])
    ji = JInterpreter(jax_, initial_offset=jax_.global_labels[entry])
    pi.run()
    ji.run()
    return pi, ji


@pytest.mark.parametrize("entry", sorted(CPU_PROGRAMS) + ["loop_short"])
def test_cpu_rows_equal(entry):
    """The port's interpreter and CPU-table builder give the JAX
    package's rows; each program ends with an empty stack at 0xdeadbeef."""
    optimize = entry == "loop_short"
    pi, ji = run_both(SNIPPETS[entry],
                      "countdown" if optimize else entry, optimize)
    assert pi.stack() == ji.stack() == []
    assert pi.registers.program_counter == ji.registers.program_counter \
        == RET
    trace, stark = cpu.cpu_rows_from_run(pi)
    jtrace, jstark = jcpu.cpu_rows_from_run(ji)
    assert trace.dtype == jtrace.dtype
    np.testing.assert_array_equal(trace, jtrace)
    assert (stark.start_pc, stark.halt_pc) == (jstark.start_pc,
                                               jstark.halt_pc)


def test_loop_program_fills_a_2_16_table():
    """The full loop (the card's program) runs LOOP["steps"] steps, so its
    CPU table is 85 x 2^16; its routine returns the pinned sum."""
    k = asm.assemble([ap.parse(loop_source(LOOP["iterations"]))], CONSTANTS,
                     OPCODES, optimize=LOOP["optimize"])
    it = Interpreter(k, initial_offset=k.global_labels[LOOP["entry"]])
    it.run()
    assert it.stack() == []
    assert it.registers.program_counter == RET
    assert it._nvm.trace_len() == LOOP["steps"]
    assert (1 << 15) < LOOP["steps"] < (1 << 16)
    out = run_kernel(k, LOOP["routine"], [RET, LOOP["iterations"]]).stack()
    assert out == [LOOP["sum"]]


def _cfg() -> StarkConfig:
    """tests/test_stark.py's _cfg() for the port."""
    return StarkConfig(
        security_bits=1,
        fri_config=FriConfig(rate_bits=1, cap_height=2, proof_of_work_bits=0,
                             num_query_rounds=2, arity_bits=2,
                             final_poly_bits=2))


def test_stack_test_proof_sha256():
    """The port's CPU-table proof of test_cpu.py's SRC at the test config
    is the JAX package's (test_cpu_proof_roundtrip), byte for byte."""
    pi, _ = run_both(SNIPPETS["stack_test"], "stack_test")
    trace, stark = cpu.cpu_rows_from_run(pi)
    proof = prove_stark(stark, trace, _cfg(), Challenger(), device="cpu")
    assert hashlib.sha256(proof_to_json(proof).encode()).hexdigest() \
        == STACK_TEST_PROOF_SHA256
    verify_stark(stark, proof, _cfg(), Challenger())


@pytest.mark.slow
def test_jax_stack_test_proof_sha256():
    from zk_evm_tpu.challenger import Challenger as JChallenger
    from zk_evm_tpu.stark import prove_stark as jprove_stark
    from zk_evm_tpu.stark.serialization import proof_to_json as jjson
    from test_stark import _cfg as jcfg
    _, ji = run_both(SNIPPETS["stack_test"], "stack_test")
    trace, stark = jcpu.cpu_rows_from_run(ji)
    proof = jprove_stark(stark, trace, jcfg(), JChallenger())
    assert hashlib.sha256(jjson(proof).encode()).hexdigest() \
        == STACK_TEST_PROOF_SHA256


@pytest.mark.parametrize("name,stack", [
    ("mul_add", [RET, 10, 7, 3]),
    ("persistence_f", [RET, 2, 3]),
    ("loop_short", [RET, LOOP["short_iterations"]]),
])
def test_run_kernel(name, stack):
    port, jax_ = assemble_both(SNIPPETS[name], name == "loop_short")
    label = LOOP["routine"] if name == "loop_short" else port.ordered_labels[0]
    got = run_kernel(port, label, stack)
    assert got.stack() == jrun_kernel(jax_, label, stack).stack()
    assert got.memory.get(0, Segment.RlpRaw, 0) == 0x80


def _stack_pairs_of_the_jax_test():
    """test_assembler.py::test_stack_search_randomized_correctness's
    pairs (random.Random(7))."""
    rng = random.Random(7)
    names = ["a", "b", "c", "d", "e", "f"]
    for _ in range(60):
        k = rng.randint(0, 5)
        src = names[:k]
        pool = src + [("push", "literal", rng.randint(0, 255))
                      for _ in range(2)]
        m = rng.randint(0, 6)
        dst = [rng.choice(pool) for _ in range(m)]
        yield src, [d for i, d in enumerate(dst) if dst[:i].count(d) < 2]


def _stack_pairs_numpy(n: int = 200, seed: int = 13):
    rng = np.random.default_rng(seed)
    names = ["a", "b", "c", "d", "e", "f"]
    for _ in range(n):
        src = names[:int(rng.integers(0, 6))]
        pool = src + [("push", "literal", int(rng.integers(0, 1 << 20))),
                      ("push", "label", "lbl")]
        dst = [pool[int(i)] for i in rng.integers(0, len(pool),
                                                  int(rng.integers(0, 7)))]
        yield src, [d for i, d in enumerate(dst) if dst[:i].count(d) < 2]


@pytest.mark.parametrize("pairs", [_stack_pairs_of_the_jax_test,
                                   _stack_pairs_numpy],
                         ids=["jax_test_pairs", "numpy_pairs"])
def test_stack_search_agrees(pairs):
    cases = list(pairs())
    for src, dst in cases:
        ops = ss.shortest_path(src, dst)
        assert ops == jss.shortest_path(src, dst), (src, dst)
        assert ops is not None
        cur = tuple(src)
        for op in ops:
            cur = ss._apply(cur, op)
        assert list(cur) == dst
    # the costs and the candidates behind the tie-breaking
    for src, dst in cases[:40]:
        items = [d for d in dst if isinstance(d, tuple)]
        assert ss._candidates(tuple(src), tuple(dst), items) \
            == jss._candidates(tuple(src), tuple(dst), items)
        assert ss._candidates(tuple(src), tuple(dst), items, wide=True) \
            == jss._candidates(tuple(src), tuple(dst), items, wide=True)
    for op in [("pop",), ("dup", 3), ("swap", 2),
               ("push", ("push", "literal", 0)),
               ("push", ("push", "literal", 1 << 100)),
               ("push", ("push", "label", "x"))]:
        assert ss._op_cost(op) == jss._op_cost(op)


def _peephole_cases(m):
    """test_assembler.py::test_peephole_rules's inputs, in module m's
    item classes."""
    def push(v):
        return m.Push(m.PushTarget("literal", v))

    def ops(*names):
        return [m.StandardOp(n) for n in names]

    lbl = m.Push(m.PushTarget("label", "next"))
    return [
        [push(3), push(4), m.StandardOp("SUB")],
        [push(1), push(0), m.StandardOp("SUB")],
        [push(0), m.StandardOp("ADD")],
        [push(9), m.StandardOp("POP")],
        ops("DUP3", "POP"),
        [push(1), push(2), m.StandardOp("SWAP1"), m.StandardOp("MSTORE")],
        ops("SWAP1", "ADD"),
        ops("SWAP1", "SUB"),
        [lbl, m.StandardOp("JUMP"), m.GlobalLabel("next")],
        [lbl, m.StandardOp("JUMP"), m.GlobalLabel("other")],
        [push(5), m.StandardOp("NOT"), push(6), m.StandardOp("NOT"),
         m.StandardOp("AND"), m.StandardOp("MSTORE")],
        ops("DUP2", "NOT", "DUP1", "NOT", "AND"),
        [push(4), push(3), push(2), m.StandardOp("ADD"),
         m.StandardOp("MUL")],
    ]


RANDOM_OPS = ("ADD", "SUB", "MUL", "DIV", "MOD", "EXP", "SHL", "SHR", "AND",
              "OR", "XOR", "LT", "GT", "EQ", "ISZERO", "NOT", "POP", "DUP1",
              "DUP2", "SWAP1", "JUMP", "MSTORE", "BYTE")


def _random_streams(m, n: int = 200, seed: int = 29):
    """Seeded item streams in module m's classes: pushes of small, wide
    and label values, ops and labels."""
    rng = np.random.default_rng(seed)
    streams = []
    for _ in range(n):
        items = []
        for _ in range(int(rng.integers(2, 30))):
            r = int(rng.integers(0, 10))
            if r < 3:
                v = int(rng.integers(0, 4)) if r < 2 else \
                    int.from_bytes(rng.bytes(int(rng.integers(1, 33))), "big")
                items.append(m.Push(m.PushTarget("literal", v)))
            elif r == 3:
                items.append(m.Push(m.PushTarget("label", "l0")))
            elif r == 4:
                items.append(m.LocalLabel("l0") if rng.integers(0, 2)
                             else m.GlobalLabel("l1"))
            else:
                items.append(m.StandardOp(
                    RANDOM_OPS[int(rng.integers(0, len(RANDOM_OPS)))]))
        streams.append(items)
    return streams


@pytest.mark.parametrize("cases", [_peephole_cases, _random_streams],
                         ids=["peephole_cases", "random_streams"])
def test_optimizer_agrees(cases):
    port, jax_ = cases(ap), cases(jap)
    assert [norm(s) for s in port] == [norm(s) for s in jax_]
    for p, j in zip(port, jax_):
        assert norm(opt.optimize_asm(p)) == norm(jopt.optimize_asm(j))
        assert opt._cost(p) == jopt._cost(j)


def _stub_tree(root, kernel_files):
    """One small .asm a kernel file: a global named after its path, a %stack,
    a shared macro, a cdk-gated push, a prover input in every tenth, and
    a jump to the first file's global."""
    first = "g_" + kernel_files[0].replace("/", "_").replace(".", "_")
    for i, rel in enumerate(kernel_files):
        name = "g_" + rel.replace("/", "_").replace(".", "_")
        body = [f"GLOBAL {name}:",
                f"    %stub_step({i})",
                "    #[cfg(feature = cdk_erigon)] { PUSH @GAS_LOW POP }",
                f"    %stack (a, b) -> (b, {i}, a)"]
        if i % 10 == 0:
            body.append("    PROVER_INPUT(ff::bn254_base::inverse)")
        body += [f"    PUSH {first}", "    JUMP"]
        if i == 0:
            body = ["%macro stub_step(v)", "    PUSH $v", "    POP",
                    "%endmacro"] + body
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text("\n".join(body) + "\n")
    return first


@pytest.mark.parametrize("features", [("eth_mainnet",), ("cdk_erigon",)],
                         ids=["eth_mainnet", "cdk_erigon"])
def test_combined_kernel_synthetic_tree(tmp_path, features):
    """The full-tree path on a stub of every one of the 159 kernel files,
    with extra sources: both packages give the same kernel, and the
    cdk_erigon build leaves out the eth-only files (_FILE_FEATURES)."""
    first = _stub_tree(tmp_path, KERNEL_FILES)
    extra = [f"GLOBAL harness:\n PUSH 1\n %stub_step(2)\n PUSH {first}\n"
             " JUMP\n"]
    port = asm.combined_kernel(str(tmp_path), features, extra)
    jax_ = jasm.combined_kernel(str(tmp_path), features, extra)
    assert kernel_fields(port) == kernel_fields(jax_)
    assert "harness" in port.global_labels
    eth_only = "g_asm_core_withdrawals_asm" in port.global_labels
    assert eth_only == (features == ("eth_mainnet",))
    assert "g_asm_cdk_pre_execution_asm" in port.global_labels
    assert len(port.prover_inputs) == len(
        [r for i, r in enumerate(KERNEL_FILES)
         if i % 10 == 0 and (eth_only or r not in asm._FILE_FEATURES
                             or features[0] in asm._FILE_FEATURES[r])])


def test_stock_fallback_is_the_frozen_kernel(tmp_path, monkeypatch):
    frozen = load_frozen_kernel()
    monkeypatch.delenv("ZK_EVM_REFERENCE", raising=False)
    assert kernel_fields(asm.combined_kernel()) == kernel_fields(frozen)
    monkeypatch.setenv("ZK_EVM_REFERENCE", str(tmp_path / "nope"))
    assert kernel_fields(asm.combined_kernel()) == kernel_fields(frozen)
    assert kernel_fields(jasm.combined_kernel()) == kernel_fields(frozen)
    assert kernel_fields(asm.load_frozen_kernel()) == kernel_fields(frozen)


@pytest.mark.parametrize("kw", [
    dict(extra_sources=["GLOBAL x:\n STOP\n"]),
    dict(active_features=("cdk_erigon",)),
    dict(asm_dir="missing"),
], ids=["extra_sources", "cdk_erigon", "missing_asm_dir"])
def test_non_stock_build_without_tree_raises(tmp_path, monkeypatch, kw):
    if "asm_dir" in kw:
        kw = dict(asm_dir=str(tmp_path / kw["asm_dir"]))
    monkeypatch.setenv("ZK_EVM_REFERENCE", str(tmp_path / "nope"))
    with pytest.raises(FileNotFoundError):
        jasm.combined_kernel(**kw)
    with pytest.raises(FileNotFoundError):
        asm.combined_kernel(**kw)
    monkeypatch.delenv("ZK_EVM_REFERENCE")
    with pytest.raises(FileNotFoundError):
        asm.combined_kernel(**kw)


def test_kernel_cache_and_freeze_roundtrip(tmp_path):
    """save_kernel / load_kernel and freeze_kernel / load_frozen_kernel
    write the JAX package's formats: each package reads the other's
    files."""
    port, jax_ = assemble_both(SNIPPETS["kitchen_sink"], True)
    assert list(port.prover_inputs.values()) == [
        ("ff", "bn254_base", "inverse")]
    assert per.kernel_cache_path("d", port.code_hash) \
        == jper.kernel_cache_path("d", jax_.code_hash)
    path = per.save_kernel(str(tmp_path / "port"), port)
    jpath = jper.save_kernel(str(tmp_path / "jax"), jax_)
    assert os.path.basename(path) == os.path.basename(jpath)
    with open(path) as f, open(jpath) as g:
        assert f.read() == g.read()
    for p in (path, jpath):
        loaded = per.load_kernel(p)
        assert isinstance(loaded, asm.Kernel)
        assert kernel_fields(loaded) == kernel_fields(port)
        assert kernel_fields(jper.load_kernel(p)) == kernel_fields(port)
    frozen = str(tmp_path / "frozen.json.gz")
    asm.freeze_kernel(port, frozen)
    assert kernel_fields(asm.load_frozen_kernel(frozen)) \
        == kernel_fields(jasm.load_frozen_kernel(frozen)) \
        == kernel_fields(port)
    k = per.load_kernel(per.save_kernel(str(tmp_path / "mul"), assemble_both(
        SNIPPETS["persistence_f"], False)[0]))
    assert run_kernel(k, "f", [RET, 2, 3]).stack() == [5]


RUST_ENUM = """
pub(crate) enum Segment {
    /// Contains EVM bytecode.
    Code = 0,
    // The program stack.
    Stack,
    /* main memory */ MainMemory,
    ShiftTable,
}
"""

RUST_VAR_NAMES = """
    pub(crate) const fn var_name(&self) -> &'static str {
        match self {
            Segment::Code => "SEGMENT_CODE",
            Self::Stack => { "SEGMENT_STACK" }
            Segment::MainMemory => "SEGMENT_MAIN_MEMORY",
        }
    }
"""

RUST_FIELDS = """
pub(crate) enum GlobalMetadata {
    StateTrieRoot = Segment::GlobalMetadata as usize,
    TxnNumberBefore,
    GasUsedAfter,
}
"""


def test_extract_constants_helpers():
    for s in ("0x1f", "1_000", "42", "0b101", "0o17"):
        assert ec._parse_int(s) == jec._parse_int(s)
    for src, name in ((RUST_ENUM, "Segment"), (RUST_FIELDS, "GlobalMetadata")):
        assert ec._enum_variants(src, name) == jec._enum_variants(src, name)
    assert ec._enum_variants(RUST_ENUM, "Segment") == (
        ["Code", "Stack", "MainMemory", "ShiftTable"], "0")
    assert ec._var_names(RUST_VAR_NAMES) == jec._var_names(RUST_VAR_NAMES) \
        == {"Code": "SEGMENT_CODE", "Stack": "SEGMENT_STACK",
            "MainMemory": "SEGMENT_MAIN_MEMORY"}
    for ranges in ([], [(0, 0)], [(0x0c, 0x0f), (0x1e, 0x1f), (0xa5, 0xef)]):
        assert ec._bitfield_from_ranges(ranges) \
            == jec._bitfield_from_ranges(ranges)
    assert ec.OUT_PATH.endswith(os.path.join("zk_evm_tpu_torch", "witness",
                                             "kernel_constants.json"))
