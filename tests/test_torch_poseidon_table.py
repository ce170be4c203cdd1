"""The Poseidon table (`tables/poseidon.py`) of the PyTorch port against
the JAX package's: the trace of simple and general (byte-sponge) ops, the
native and the row-at-a-time trace generators, the CTL views, the
vectorized constraint evaluation (torch GF over whole columns) against
the row-wise one (HExt scalars), and a small PoseidonStark proof whose
`proof_to_json` equals the JAX package's. Tolerance 0 throughout."""

import hashlib

import numpy as np
import pytest
import torch

from zk_evm_tpu.field import GF as JGF
from zk_evm_tpu.stark.stark import ConstraintConsumer as JConsumer
from zk_evm_tpu.stark.stark import StarkFrame as JFrame
from zk_evm_tpu.tables import poseidon as jps
from zk_evm_tpu_torch import native
from zk_evm_tpu_torch.challenger import Challenger
from zk_evm_tpu_torch.field import GF, HExt, host
from zk_evm_tpu_torch.stark import (ConstraintConsumer, FriConfig,
                                    StarkConfig, StarkFrame, prove_stark,
                                    verify_stark)
from zk_evm_tpu_torch.stark.debug import check_constraints
from zk_evm_tpu_torch.stark.serialization import proof_to_json
from zk_evm_tpu_torch.tables import poseidon as ps
from zk_evm_tpu_torch.tables.segments import Segment

P = host.P
CFG_KW = dict(rate_bits=1, cap_height=2, proof_of_work_bits=0,
              num_query_rounds=1, arity_bits=2, final_poly_bits=2)
# sha256 of the JAX package's proof_to_json(prove_stark(PoseidonStark(),
# generate_trace(_ops(seed=73)), config of CFG_KW, Challenger())), made on
# the CPU (the JAX proof takes minutes of XLA compiles; the `slow` test
# below recomputes it)
POSEIDON_PROOF_SHA256 = (
    "428cd8bfb53cc4c402ed4245b061d02cb29100ba7e0bb6d033ca99a03c5f355c")


def _ops(seed=73, n_simple=1, pairs=True):
    rng = np.random.default_rng(seed)
    ops = [ps.PoseidonSimpleOp(tuple(
        int(x) for x in rng.integers(0, P, size=12, dtype=np.uint64)))
        for _ in range(n_simple)]
    if pairs:
        data = bytes(rng.integers(0, 256, size=2 * ps.BLOCK_BYTES,
                                  dtype=np.uint8))
        ops.append(ps.PoseidonGeneralOp(
            context=1, segment=Segment.KernelGeneral, virt=64,
            timestamp=11, input=data, len=len(data)))
    return ops


def _jax_ops(ops):
    """The same ops as the JAX package's dataclasses."""
    return [jps.PoseidonSimpleOp(op.input)
            if isinstance(op, ps.PoseidonSimpleOp)
            else jps.PoseidonGeneralOp(op.context, op.segment, op.virt,
                                       op.timestamp, op.input, op.len)
            for op in ops]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread proves these small tables faster than many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return StarkConfig(security_bits=1, fri_config=FriConfig(**CFG_KW))


def test_layout_equals_jax():
    for name in ("NUM_COLUMNS", "INPUT", "STATE_START", "CUBED_FULL_START",
                 "CUBED_PARTIAL_START", "DIGEST_COLS", "OUTPUT_PARTIAL",
                 "PINV", "INPUT_BYTES_START", "IS_FINAL_INPUT_LEN"):
        assert getattr(ps, name) == getattr(jps, name), name
    assert ps.NUM_COLUMNS == 576


@pytest.mark.parametrize("kind", ["mixed", "simple_native"])
def test_trace_equals_jax(kind):
    ops = _ops() if kind == "mixed" else _ops(seed=3, n_simple=37,
                                              pairs=False)
    trace = ps.generate_trace(ops, min_rows=4)
    assert np.array_equal(trace, jps.generate_trace(_jax_ops(ops),
                                                    min_rows=4))
    assert np.array_equal(trace, ps.generate_trace_py(ops, min_rows=4))


def test_native_witness_equals_python_rows():
    assert native.available()
    ops = _ops(seed=9, n_simple=5, pairs=False)
    assert np.array_equal(ps.generate_trace(ops, min_rows=8),
                          ps.generate_trace_py(ops, min_rows=8))


def test_ctl_views_equal_jax():
    ops = _ops()
    trace = ps.generate_trace(ops)
    views = [(ps.ctl_looked_simple_op(), jps.ctl_looked_simple_op()),
             (ps.ctl_looked_permutation(), jps.ctl_looked_permutation()),
             (ps.ctl_looked_general_output(),
              jps.ctl_looked_general_output()),
             (ps.ctl_looked_general_input(), jps.ctl_looked_general_input())]
    views += [(ps.ctl_looking_memory(i), jps.ctl_looking_memory(i))
              for i in (0, 1, 7, 8, 55)]
    for got, want in views:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(g.eval_np(trace), w.eval_np(trace))
    for got, want in ((ps.ctl_looked_simple_filter(),
                       jps.ctl_looked_simple_filter()),
                      (ps.ctl_looked_general_output_filter(),
                       jps.ctl_looked_general_output_filter()),
                      (ps.ctl_looked_general_input_filter(),
                       jps.ctl_looked_general_input_filter()),
                      (ps.ctl_looking_memory_filter(),
                       jps.ctl_looking_memory_filter())):
        assert np.array_equal(got.eval_np(trace), want.eval_np(trace))


def _selectors(n):
    z_last = np.zeros(n, dtype=np.uint64)
    z_last[:n - 1] = 1
    first = np.zeros(n, dtype=np.uint64)
    first[0] = 1
    last = np.zeros(n, dtype=np.uint64)
    last[n - 1] = 1
    return z_last, first, last


def test_vectorized_eval_equals_rowwise_and_jax():
    """The constraints folded by alphas over whole columns (torch GF, the
    prover's path) equal the row-wise fold in HExt (the verifier's path)
    at every row, and the JAX package's vectorized fold."""
    trace = ps.generate_trace(_ops(), min_rows=4)
    n = trace.shape[1]
    nxt = np.roll(np.arange(n), -1)
    alphas = [123456789, P - 5]
    z_last, first, last = _selectors(n)
    cc = ConstraintConsumer(
        alphas=alphas, zero=GF.zeros((n,)), z_last=GF.from_u64(z_last),
        lagrange_first=GF.from_u64(first), lagrange_last=GF.from_u64(last))
    ps.PoseidonStark().eval(StarkFrame(GF.from_u64(trace),
                                       GF.from_u64(trace[:, nxt])), cc)
    vec = [acc.to_u64() for acc in cc.accs]
    jcc = JConsumer(
        alphas=alphas, zero=JGF.zeros((n,)), z_last=JGF.from_u64(z_last),
        lagrange_first=JGF.from_u64(first),
        lagrange_last=JGF.from_u64(last))
    jps.PoseidonStark().eval(JFrame(JGF.from_u64(trace),
                                    JGF.from_u64(trace[:, nxt])), jcc)
    for acc, jacc in zip(vec, jcc.accs):
        assert np.array_equal(acc, np.asarray(jacc.to_u64()))
    for r in range(n):
        rc = ConstraintConsumer(
            alphas=alphas, zero=HExt.zero(), z_last=HExt(int(z_last[r])),
            lagrange_first=HExt(int(first[r])),
            lagrange_last=HExt(int(last[r])))
        ps.PoseidonStark().eval(StarkFrame(
            [HExt(int(v)) for v in trace[:, r]],
            [HExt(int(v)) for v in trace[:, nxt[r]]]), rc)
        assert [a.v for a in rc.accs] == [(int(v[r]), 0) for v in vec]


class _Violations:
    """Constraint consumer that records the index of every constraint
    that does not vanish on one row (all selectors on)."""

    def __init__(self):
        self.idx = 0
        self.bad = set()

    def constraint(self, c):
        if c.v != (0, 0):
            self.bad.add(self.idx)
        self.idx += 1

    constraint_transition = constraint_first_row = constraint_last_row = \
        constraint


def _violations(column):
    chk = _Violations()
    ps.PoseidonStark()._eval_rounds_scalar(
        StarkFrame([HExt(int(v)) for v in column], []), chk)
    return chk.bad


def test_tampered_round_and_noncanonical_digest_caught():
    trace = ps.generate_trace(_ops())
    stark = ps.PoseidonStark()
    check_constraints(stark, trace, rows=[0, 1, 2, 3, trace.shape[1] - 1])
    bad = trace.copy()
    bad[ps.state_col(17, 5), 1] ^= 1
    with pytest.raises(AssertionError):
        check_constraints(stark, bad, rows=[1])
    # digest element 0 as 0, canonically (0, 0) and as P = (1, 2^32 - 1):
    # both break the last round's lane-0 state constraint, and only the
    # non-canonical limbs break the canonicity constraint besides
    row = trace[:, 0].copy()
    row[ps.state_col(ps.N_ROUNDS - 1, 0)] = 0
    row[ps.DIGEST_COLS[0]], row[ps.DIGEST_COLS[1]] = 0, 0
    canonical = _violations(row)
    row[ps.DIGEST_COLS[0]], row[ps.DIGEST_COLS[1]] = 1, 0xFFFFFFFF
    non_canonical = _violations(row)
    assert len(canonical) == 1
    n_round = 8 * 12 * 2 + 22 + 22 * 12
    assert non_canonical - canonical == {n_round + 4 + 8 + 0}


@pytest.fixture(scope="module")
def pose_proof():
    trace = ps.generate_trace(_ops())
    proof = prove_stark(ps.PoseidonStark(), trace, _cfg(), Challenger(),
                        device="cpu")
    return trace, proof


def test_proof_equals_jax_and_verifies(pose_proof):
    _, proof = pose_proof
    verify_stark(ps.PoseidonStark(), proof, _cfg(), Challenger())
    digest = hashlib.sha256(proof_to_json(proof).encode()).hexdigest()
    assert digest == POSEIDON_PROOF_SHA256


def test_tampered_round_proof_rejected(pose_proof):
    trace, _ = pose_proof
    bad = trace.copy()
    bad[ps.state_col(17, 5), 1] ^= 1
    proof = prove_stark(ps.PoseidonStark(), bad, _cfg(), Challenger(),
                        device="cpu")
    with pytest.raises(AssertionError):
        verify_stark(ps.PoseidonStark(), proof, _cfg(), Challenger())


@pytest.mark.slow
def test_proof_constant_is_jax():
    """Recompute POSEIDON_PROOF_SHA256 with the JAX package."""
    from zk_evm_tpu.challenger import Challenger as JChallenger
    from zk_evm_tpu.stark import (StarkConfig as JStarkConfig,
                                  FriConfig as JFriConfig,
                                  prove_stark as jprove_stark)
    from zk_evm_tpu.stark.serialization import proof_to_json as jpj
    trace = jps.generate_trace(_jax_ops(_ops()))
    cfg = JStarkConfig(security_bits=1, fri_config=JFriConfig(**CFG_KW))
    proof = jprove_stark(jps.PoseidonStark(), trace, cfg, JChallenger())
    assert hashlib.sha256(jpj(proof).encode()).hexdigest() == \
        POSEIDON_PROOF_SHA256
