"""Witness generation of the PyTorch port against the JAX package.

The port carries jax-free copies of the interpreter, the native VM bridge,
the frozen kernel, the tries, the fixtures and the table-trace assembly (`zk_evm_tpu_torch/witness/`, `mpt/`, `decoder/`,
`stark/public_values.py`). For the `simple-transfer` block in one and in
two segments and for `add11`, every segment's nine traces, the tables in
use, the public values, the memory-continuation values and the CpuStark
parameters equal the JAX package's exactly (tolerance 0). The table
minimum degrees lift shapes and change no value; the pure-python memory
model gives the same traces as the native one, and the command line
refuses to run without the native library.
"""

import numpy as np
import pytest

from zk_evm_tpu.stark.public_values import (
    public_values_to_dict as jpublic_values_to_dict)
from zk_evm_tpu.witness import bls381 as jbls381
from zk_evm_tpu.witness import bn254 as jbn254
from zk_evm_tpu.witness.assembler import combined_kernel as jcombined_kernel
from zk_evm_tpu.witness.segments import (
    generate_segment_tables as jgenerate_segment_tables)
from zk_evm_tpu.witness.testing_fixtures import FIXTURES as JFIXTURES
from zk_evm_tpu_torch import native
from zk_evm_tpu_torch.stark.public_values import public_values_to_dict
from zk_evm_tpu_torch.tables.all_stark import Table
from zk_evm_tpu_torch.witness import bls381, bn254, native_vm
from zk_evm_tpu_torch.witness.interpreter import Interpreter, MemoryState
from zk_evm_tpu_torch.witness.kernel import combined_kernel
from zk_evm_tpu_torch.witness.segments import generate_segment_tables
from zk_evm_tpu_torch.witness.testing_fixtures import FIXTURES

TABLE_NAMES = {v: k for k, v in vars(Table).items() if isinstance(v, int)}
# (fixture, max_cpu_len_log) -> number of segments
CASES = {
    "simple-transfer-1-segment": ("simple-transfer", 16, 1),
    "simple-transfer-2-segments": ("simple-transfer", 15, 2),
    "add11": ("add11", 16, 1),
}


def port_segments(fixture, log):
    return [gt for _, gt in generate_segment_tables(
        combined_kernel(), FIXTURES[fixture](), max_cpu_len_log=log)]


def jax_segments(fixture, log):
    return [gt for _, gt in jgenerate_segment_tables(
        jcombined_kernel(), JFIXTURES[fixture](), max_cpu_len_log=log)]


def assert_same_traces(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.table_in_use == w.table_in_use
        for t, (a, b) in enumerate(zip(g.traces, w.traces, strict=True)):
            assert (a is None) == (b is None), TABLE_NAMES[t]
            if a is not None:
                assert a.dtype == b.dtype and np.array_equal(a, b), \
                    TABLE_NAMES[t]


@pytest.fixture(scope="module")
def add11_port():
    """The port's add11 segments, shared by the add11 case and the
    memory-model check."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("ZK_TABLE_MIN_DEGREES", raising=False)
        return port_segments("add11", 16)


@pytest.fixture(scope="module", params=list(CASES))
def segments(request):
    """(port segments, JAX segments, expected count), generated once with
    the table minimum degrees off."""
    fixture, log, count = CASES[request.param]
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("ZK_TABLE_MIN_DEGREES", raising=False)
        port = request.getfixturevalue("add11_port") \
            if request.param == "add11" else port_segments(fixture, log)
        return port, jax_segments(fixture, log), count


def test_segment_traces_equal(segments):
    port, jax_, count = segments
    assert len(port) == count
    assert_same_traces(port, jax_)


def test_segment_public_values_equal(segments):
    port, jax_, _ = segments
    for g, w in zip(port, jax_):
        assert public_values_to_dict(g.public_values) == \
            jpublic_values_to_dict(w.public_values)
        assert g.public_values.to_elements() == w.public_values.to_elements()


def test_segment_memory_values_equal(segments):
    port, jax_, _ = segments
    for g, w in zip(port, jax_):
        assert g.mem_before_values == w.mem_before_values
        assert g.mem_after_values == w.mem_after_values
    for a, b in zip(port, port[1:]):       # MemAfter(k) == MemBefore(k+1)
        assert a.mem_after_values == b.mem_before_values


def test_segment_cpu_stark_parameters_equal(segments):
    port, jax_, _ = segments
    for g, w in zip(port, jax_):
        gs, ws = g.starks[Table.Cpu], w.starks[Table.Cpu]
        assert vars(gs) == vars(ws)
        assert [type(s).__name__ for s in g.starks] == \
            [type(s).__name__ for s in w.starks]


def test_kernel_equals_reference():
    k, jk = combined_kernel(), jcombined_kernel()
    assert len(k.code) == 68_210
    assert k.code == jk.code and k.code_hash == jk.code_hash
    assert k.global_labels == jk.global_labels
    assert k.ordered_labels == jk.ordered_labels
    assert k.prover_inputs == jk.prover_inputs


def test_table_min_degrees_lift_shapes(monkeypatch):
    monkeypatch.setenv("ZK_TABLE_MIN_DEGREES", "1")
    port = port_segments("simple-transfer", 16)
    assert_same_traces(port, jax_segments("simple-transfer", 16))
    shapes = {TABLE_NAMES[t]: tr.shape
              for t, tr in enumerate(port[0].traces) if tr is not None}
    assert shapes == {
        "Arithmetic": (116, 1 << 16), "BytePacking": (71, 1 << 9),
        "Cpu": (85, 1 << 16), "Keccak": (2431, 1 << 14),
        "KeccakSponge": (438, 1 << 9), "Logic": (523, 1 << 12),
        "Memory": (30, 1 << 18), "MemBefore": (12, 1 << 17)}


def test_memory_models_agree(add11_port, monkeypatch):
    """The port's pure-python MemoryState interpreter gives the same add11
    witness as its native core."""
    monkeypatch.delenv("ZK_TABLE_MIN_DEGREES", raising=False)
    assert native_vm.available()
    with monkeypatch.context() as mp:
        mp.setattr(native_vm, "make_memory", MemoryState)
        assert isinstance(Interpreter(combined_kernel(), 0).memory,
                          MemoryState)
        python = port_segments("add11", 16)
    assert not isinstance(Interpreter(combined_kernel(), 0).memory,
                          MemoryState)
    assert_same_traces(python, add11_port)


def test_native_require_raises_without_library(monkeypatch):
    """`native.require()`, which the command line calls first, returns
    the loaded library and raises where library callers would quietly
    fall back to the python twins."""
    assert native.require() is native.lib_handle()

    def failing_build():
        raise RuntimeError("g++ failed on native/")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_error", None)
    monkeypatch.setattr(native, "build", failing_build)
    with pytest.raises(RuntimeError, match="did not build or load"):
        native.require()
    assert not native.available()


def test_curve_oracle_copies_agree():
    """The host curve arithmetic behind the BN254 and BLS12-381
    prover-input oracles equals the JAX package's."""
    rng = np.random.default_rng(11)
    f = [int.from_bytes(rng.bytes(32), "big") % bn254.P for _ in range(12)]
    assert bn254.fp12_inverse(list(f)) == jbn254.fp12_inverse(list(f))
    k = int.from_bytes(rng.bytes(32), "big") % bls381.R
    p = bls381.g1_mul(bls381.G1, k)
    assert p == jbls381.g1_mul(jbls381.G1, k)
    assert bls381.g1_to_bytes(p) == jbls381.g1_to_bytes(p)
    assert bls381.g2_mul(bls381.G2, k) == jbls381.g2_mul(jbls381.G2, k)


@pytest.mark.parametrize("n_rows", [1, 2, 255, 256, 257, 1000, 1 << 16,
                                    (1 << 16) + 1, (1 << 22) + 1,
                                    (1 << 23) + 5])
def test_bucket_rows_equals_reference(n_rows):
    from zk_evm_tpu.compile_cache import bucket_rows as jbucket_rows
    from zk_evm_tpu_torch.witness.traces import bucket_rows
    assert bucket_rows(n_rows) == jbucket_rows(n_rows)
