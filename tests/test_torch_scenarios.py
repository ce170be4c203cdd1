"""Multi-table proving of the PyTorch port against the JAX package, with
the two options the recursion layer and the sponge scenario set:

- the sponge scenario (`tables/scenarios.py`): one keccak256 absorb
  through KeccakSponge, Keccak, Logic and the memory tables under
  `prove_all`, the CPU table's dispatch side supplied to `verify_all` as
  extra looking sums; the traces and `proof_to_json` equal the JAX
  package's, and a wrong memory value is rejected;
- preprocessed (program) columns: a table whose low columns are fixed by
  a program the verifier holds, committed in an oracle of their own, in
  `prove_stark` and in `prove_all` with a CTL filtered by a program
  column; the proofs equal the JAX package's (pinned as sha256 constants
  that the `slow` tests recompute), and a proof made under another
  program is rejected.

Tolerance 0."""

import hashlib

import numpy as np
import pytest
import torch

from zk_evm_tpu.challenger import Challenger as JChallenger
from zk_evm_tpu.stark import (Stark as JStark, StarkConfig as JStarkConfig,
                              FriConfig as JFriConfig, Filter as JFilter,
                              prove_all as jprove_all,
                              prove_stark as jprove_stark,
                              verify_all as jverify_all)
from zk_evm_tpu.stark.lookup import (CrossTableLookup as JCtl,
                                     CtlView as JView, col as jcol)
from zk_evm_tpu.stark.serialization import (
    all_proof_from_json as jall_proof_from_json,
    proof_to_json as jproof_to_json)
from zk_evm_tpu.tables.scenarios import (
    build_sponge_scenario as jbuild_sponge_scenario)
from zk_evm_tpu_torch.challenger import Challenger
from zk_evm_tpu_torch.stark import (CrossTableLookup, CtlView, Filter,
                                    FriConfig, Stark, StarkConfig, col,
                                    prove_all, prove_stark, verify_all,
                                    verify_stark)
from zk_evm_tpu_torch.stark.serialization import proof_to_json
from zk_evm_tpu_torch.tables import all_stark as ast
from zk_evm_tpu_torch.tables import memory as mem
from zk_evm_tpu_torch.tables.scenarios import (TS, build_sponge_scenario,
                                               cpu_side_extra_sums)

CFG_KW = dict(rate_bits=1, cap_height=2, proof_of_work_bits=0,
              num_query_rounds=1, arity_bits=2, final_poly_bits=2)
# sha256 of the JAX package's proof_to_json(prove_all(...)) of the sponge
# scenario at CFG_KW (tests/test_all_stark.py's config), made on the CPU;
# the `slow` test recomputes it
SPONGE_SCENARIO_SHA256 = (
    "d05197109608b91fb79c77cbecbdf6b976cb1fa9e8c7d7b6e4a81be0f27d0fbb")
# sha256 of the JAX package's proof_to_json of the program table's proof
# (prove_stark) and of the program and toy tables' (prove_all) at CFG_KW;
# the `slow` test recomputes them
PREPROCESSED_STARK_SHA256 = (
    "057a11fb34f3dbf913faf87d4e8b45bda8495dba5c356a5dbb155cd84378a1f9")
PREPROCESSED_ALL_SHA256 = (
    "d94a6207294669b045489378dd8317c67cac83ce9969900d3d134d0d7ecf702f")


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


# ---- the sponge scenario ------------------------------------------------

def test_sponge_scenario_traces_equal_jax():
    traces, sponge = build_sponge_scenario()
    jtraces, jsponge = jbuild_sponge_scenario()
    assert np.array_equal(sponge, jsponge)
    for t, jt in zip(traces, jtraces):
        assert (t is None) == (jt is None)
        if t is not None:
            assert np.array_equal(t, jt)


@pytest.fixture(scope="module")
def sponge_proof():
    traces, sponge = build_sponge_scenario()
    proof = prove_all(ast.all_starks(), traces,
                      ast.all_cross_table_lookups(), _cfg(), device="cpu")
    return traces, sponge, proof


def test_sponge_scenario_proof_equals_jax(sponge_proof):
    _, _, proof = sponge_proof
    digest = hashlib.sha256(proof_to_json(proof).encode()).hexdigest()
    assert digest == SPONGE_SCENARIO_SHA256


def test_sponge_scenario_verifies_with_extra_sums(sponge_proof):
    """Both packages' verify_all accept the port's proof, given the CPU
    side's sums; without them the keccak_sponge CTL is unbalanced."""
    from zk_evm_tpu.tables import all_stark as jast
    from zk_evm_tpu.tables.scenarios import (
        cpu_side_extra_sums as jcpu_side_extra_sums)
    traces, sponge, proof = sponge_proof
    ctls = ast.all_cross_table_lookups()
    extra = cpu_side_extra_sums(proof, ctls, _cfg(), sponge)
    verify_all(ast.all_starks(), proof, ctls, _cfg(),
               extra_looking_sums=extra, optional_tables=_optional(traces))
    jproof = jall_proof_from_json(proof_to_json(proof))
    jctls = jast.all_cross_table_lookups()
    jextra = jcpu_side_extra_sums(jproof, jctls, _jcfg(), sponge)
    assert jextra == extra
    jverify_all(jast.all_starks(), jproof, jctls, _jcfg(),
                extra_looking_sums=jextra,
                optional_tables=_optional(traces))
    with pytest.raises(AssertionError, match="keccak_sponge"):
        verify_all(ast.all_starks(), proof, ctls, _cfg(),
                   optional_tables=_optional(traces))


def test_sponge_scenario_rejects_wrong_memory_value():
    traces, sponge = build_sponge_scenario()
    mtrace = traces[ast.Table.Memory]
    r = int(np.nonzero(mtrace[mem.TIMESTAMP] == TS)[0][0])
    mtrace[mem.VALUE_COLS[0], r] ^= 1
    ctls = ast.all_cross_table_lookups()
    proof = prove_all(ast.all_starks(), traces, ctls, _cfg(), device="cpu")
    extra = cpu_side_extra_sums(proof, ctls, _cfg(), sponge)
    with pytest.raises(AssertionError):
        verify_all(ast.all_starks(), proof, ctls, _cfg(),
                   extra_looking_sums=extra,
                   optional_tables=_optional(traces))


# ---- preprocessed (program) columns --------------------------------------

N = 8
PROGRAM = np.array([[1, 0, 1, 0, 0, 1, 0, 0]], dtype=np.uint64)


PUBLIC = [3, 8]             # x on the last row, and an unused value


def _prog_eval(frame, cc):
    """x' = x + sel on every row but the last, x = 0 on the first and
    public input 0 on the last; `sel` (column 0) is the program."""
    lv, nv = frame.local, frame.next
    cc.constraint_transition(nv[1] - lv[1] - lv[0])
    cc.constraint_first_row(lv[1])
    cc.constraint_last_row(lv[1] - frame.public_inputs[0])


class ProgStark(Stark):
    """Columns: sel (the program, preprocessed), x."""
    name = "prog"
    num_columns = 2
    num_preprocessed = 1
    num_public_inputs = 2

    def __init__(self, program=PROGRAM):
        self.program = program

    def preprocessed(self):
        return self.program

    def eval(self, frame, cc):
        _prog_eval(frame, cc)

    def requires_ctls(self):
        return True


class JProgStark(JStark):
    """ProgStark over the JAX package's Stark."""
    name = "prog"
    num_columns = 2
    num_preprocessed = 1
    num_public_inputs = 2

    def __init__(self, program=PROGRAM):
        self.program = program

    def preprocessed(self):
        return self.program

    def eval(self, frame, cc):
        _prog_eval(frame, cc)

    def requires_ctls(self):
        return True


def _toy_eval(frame, cc):
    f = frame.local[1]
    cc.constraint(f * (f - 1))


class ToyStark(Stark):
    name = "toy"
    num_columns = 2
    eval = staticmethod(lambda frame, cc: _toy_eval(frame, cc))

    def requires_ctls(self):
        return True


class JToyStark(JStark):
    name = "toy"
    num_columns = 2
    eval = staticmethod(lambda frame, cc: _toy_eval(frame, cc))

    def requires_ctls(self):
        return True


def prog_trace(program=PROGRAM):
    trace = np.zeros((2, N), dtype=np.uint64)
    trace[0] = program[0]
    trace[1] = np.concatenate([[0], np.cumsum(program[0])[:-1]])
    return trace


def toy_trace(program=PROGRAM):
    """The x values of the program's selected rows, filtered."""
    x = prog_trace(program)[1][program[0] == 1]
    trace = np.zeros((2, 4), dtype=np.uint64)
    trace[0, :len(x)] = x
    trace[1, :len(x)] = 1
    return trace


def _ctls(ctl_cls, view_cls, filter_cls, c):
    """prog's x on its program-selected rows looks up toy's values."""
    return [ctl_cls(name="prog_toy",
                    looking=(view_cls(table=0, columns=(c(1),),
                                      filter=filter_cls(column=0)),),
                    looked=view_cls(table=1, columns=(c(0),),
                                    filter=filter_cls(column=1)))]


def _sha256(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def test_preprocessed_prove_stark_equals_jax():
    trace = prog_trace()
    proof = prove_stark(ProgStark(), trace, _cfg(), Challenger(), PUBLIC,
                        device="cpu")
    assert _sha256(proof_to_json(proof)) == PREPROCESSED_STARK_SHA256
    verify_stark(ProgStark(), proof, _cfg(), Challenger(), device="cpu")
    # the trace's program columns must be the stark's program
    other = np.array([[0, 1, 1, 0, 0, 1, 0, 0]], dtype=np.uint64)
    with pytest.raises(AssertionError, match="program columns"):
        prove_stark(ProgStark(), prog_trace(other), _cfg(), Challenger(),
                    PUBLIC, device="cpu")
    # a proof made under another program fails under this one
    foreign = prove_stark(ProgStark(other), prog_trace(other), _cfg(),
                          Challenger(), PUBLIC, device="cpu")
    with pytest.raises(AssertionError):
        verify_stark(ProgStark(), foreign, _cfg(), Challenger(),
                     device="cpu")


def test_preprocessed_prove_all_equals_jax():
    traces = [prog_trace(), toy_trace()]
    ctls = _ctls(CrossTableLookup, CtlView, Filter, col)
    proof = prove_all([ProgStark(), ToyStark()], traces, ctls, _cfg(),
                      public_inputs=PUBLIC, table_public_inputs={0: PUBLIC},
                      device="cpu")
    assert _sha256(proof_to_json(proof)) == PREPROCESSED_ALL_SHA256
    verify_all([ProgStark(), ToyStark()], proof, ctls, _cfg(),
               device="cpu")
    jverify_all([JProgStark(), JToyStark()],
                jall_proof_from_json(proof_to_json(proof)),
                _ctls(JCtl, JView, JFilter, jcol), _jcfg())
    other = np.array([[0, 1, 1, 0, 0, 1, 0, 0]], dtype=np.uint64)
    with pytest.raises(AssertionError):
        verify_all([ProgStark(other), ToyStark()], proof, ctls, _cfg(),
                   device="cpu")


def test_preprocessed_verify_needs_a_device_without_cuda():
    """The program cap is committed on the caller's device: CUDA unless
    the caller names the CPU, and without a card that raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: CUDA is the default device")
    proof = prove_stark(ProgStark(), prog_trace(), _cfg(), Challenger(),
                        PUBLIC, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        verify_stark(ProgStark(), proof, _cfg(), Challenger())


@pytest.mark.slow
def test_preprocessed_constants_are_jax():
    """Recompute PREPROCESSED_STARK_SHA256 and PREPROCESSED_ALL_SHA256
    with the JAX package (XLA compiles of tens of seconds each)."""
    jproof = jprove_stark(JProgStark(), prog_trace(), _jcfg(), JChallenger(),
                          PUBLIC)
    assert _sha256(jproof_to_json(jproof)) == PREPROCESSED_STARK_SHA256
    jproof = jprove_all([JProgStark(), JToyStark()],
                        [prog_trace(), toy_trace()],
                        _ctls(JCtl, JView, JFilter, jcol), _jcfg(),
                        public_inputs=PUBLIC,
                        table_public_inputs={0: PUBLIC})
    assert _sha256(jproof_to_json(jproof)) == PREPROCESSED_ALL_SHA256


@pytest.mark.slow
def test_sponge_scenario_constant_is_jax():
    """Recompute SPONGE_SCENARIO_SHA256 with the JAX package."""
    from zk_evm_tpu.tables import all_stark as jast
    traces, _ = jbuild_sponge_scenario()
    proof = jprove_all(jast.all_starks(), traces,
                       jast.all_cross_table_lookups(), _jcfg())
    assert hashlib.sha256(jproof_to_json(proof).encode()).hexdigest() == \
        SPONGE_SCENARIO_SHA256
