"""Single-table STARK proofs of the PyTorch port against the JAX package:
`proof_to_json` byte-identical for the Fibonacci-with-product AIR of
tests/test_stark.py, defined over the port's Stark, with and without
proof of work; each package's verifier accepts the other's proof.

The JAX package's proofs take XLA compiles of tens of seconds each on
the CPU, so tier-1 holds the port's proofs to their sha256 constants
(JAX_FIB_SHA256, JAX_RANGE_SHA256) and the `slow` tests (`-m slow`) make
the JAX proofs, check the constants and have the port's verifier accept
them."""

import hashlib

import pytest
import torch

from zk_evm_tpu.challenger import Challenger as JChallenger
from zk_evm_tpu.field import host
from zk_evm_tpu.stark import (StarkConfig as JStarkConfig,
                              FriConfig as JFriConfig,
                              prove_stark as jprove_stark,
                              verify_stark as jverify_stark)
from zk_evm_tpu.stark.serialization import proof_to_json as jproof_to_json
from zk_evm_tpu_torch import convert
from zk_evm_tpu_torch.challenger import Challenger
from zk_evm_tpu_torch.stark import (Stark, StarkConfig, FriConfig, Lookup,
                                    prove_stark, verify_stark)
from zk_evm_tpu_torch.stark.prover import resolve_device
from zk_evm_tpu_torch.stark.serialization import proof_to_json
from test_lookup_ctl import RangeStark as JRangeStark, range_trace
from test_stark import FibStark as JFibStark, fib_trace


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread runs these small CPU proofs and hashes as fast
    as many and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FibStark(Stark):
    """tests/test_stark.py's FibStark over the port's Stark. Columns:
    x0, x1, prod = x0*x1. transition: x0' = x1, x1' = x0 + x1; every row:
    prod = x0 * x1; first row: x0 = PI[0], x1 = PI[1]; last row:
    x1 = PI[2]."""
    name = "fib"
    num_columns = 3
    num_public_inputs = 3

    def eval(self, frame, cc):
        x0, x1, prod = frame.local
        n0, n1, _ = frame.next
        pi = frame.public_inputs
        cc.constraint(prod - x0 * x1)
        cc.constraint_transition(n0 - x1)
        cc.constraint_transition(n1 - (x0 + x1))
        cc.constraint_first_row(x0 - pi[0])
        cc.constraint_first_row(x1 - pi[1])
        cc.constraint_last_row(x1 - pi[2])


# sha256 of the JAX package's proof_to_json(prove_stark(...)) of the
# 64-row Fibonacci trace at _cfgs(pow_bits), by pow_bits, and of the
# 32-row one-lookup RangeStark at _cfgs(0)
JAX_FIB_SHA256 = {
    0: "688f120483ae0b63fc1e46685b811ceee1b3e881c853b6a3a366d56fb1512df0",
    8: "322123b2ea884d8bcd2494b35ac09c59747b8c4991104f802509910c4b268357"}
JAX_RANGE_SHA256 = (
    "4206d5d12fce942356f69636067ea45bece9a65c57c23088af1d46907e245728")


def _sha256(proof) -> str:
    return hashlib.sha256(proof_to_json(proof).encode()).hexdigest()


def _cfgs(pow_bits):
    kw = dict(rate_bits=1, cap_height=2, proof_of_work_bits=pow_bits,
              num_query_rounds=2, arity_bits=2, final_poly_bits=2)
    return (StarkConfig(security_bits=1, fri_config=FriConfig(**kw)),
            JStarkConfig(security_bits=1, fri_config=JFriConfig(**kw)))


@pytest.fixture(scope="module", params=[0, 8], ids=["no_pow", "pow8"])
def fib_proofs(request):
    """(port proof, pow_bits, cfg, jcfg, public inputs)."""
    trace, pis = fib_trace(64)
    cfg, jcfg = _cfgs(request.param)
    proof = prove_stark(FibStark(), trace, cfg, Challenger(), pis,
                        device="cpu")
    return proof, request.param, cfg, jcfg, pis


def test_fib_proof_json_identical(fib_proofs):
    proof, pow_bits, *_ = fib_proofs
    assert _sha256(proof) == JAX_FIB_SHA256[pow_bits]


def test_fib_port_verifier_accepts(fib_proofs):
    proof, _, cfg, _, pis = fib_proofs
    verify_stark(FibStark(), proof, cfg, Challenger(),
                 expected_public_inputs=pis)


def test_fib_jax_verifier_accepts_port_proof(fib_proofs):
    proof, _, _, jcfg, _ = fib_proofs
    from zk_evm_tpu.stark.serialization import stark_proof_from_json
    jverify_stark(JFibStark(), stark_proof_from_json(proof_to_json(proof)),
                  jcfg, JChallenger())


def test_fib_port_verifier_accepts_jax_proof(fib_proofs):
    """The JAX proof's text is the port's (test_fib_proof_json_identical;
    the `slow` test reads the JAX package's own)."""
    proof, _, cfg, _, _ = fib_proofs
    verify_stark(FibStark(), convert.proof_from_json(proof_to_json(proof)),
                 cfg, Challenger())


@pytest.mark.slow
@pytest.mark.parametrize("pow_bits", [0, 8], ids=["no_pow", "pow8"])
def test_jax_fib_proof_constants(pow_bits):
    trace, pis = fib_trace(64)
    cfg, jcfg = _cfgs(pow_bits)
    jjson = jproof_to_json(jprove_stark(JFibStark(), trace, jcfg,
                                        JChallenger(), pis))
    assert hashlib.sha256(jjson.encode()).hexdigest() == \
        JAX_FIB_SHA256[pow_bits]
    verify_stark(FibStark(), convert.proof_from_json(jjson), cfg,
                 Challenger(), expected_public_inputs=pis)


def _bump(v):
    return (v + 1) % host.P


def _tamper_leaf(fp):
    leaf = fp.query_rounds[1].initial.leaves[0]
    leaf[1] = _bump(leaf[1])


def _tamper_sibling(fp):
    sib = fp.query_rounds[0].initial.paths[0][-1]
    sib[0] = _bump(sib[0])


def _tamper_coset(fp):
    step = fp.query_rounds[1].steps[0]
    a, b = step.coset_values[-1]
    step.coset_values[-1] = (a, _bump(b))


def _tamper_step_path(fp):
    sib = fp.query_rounds[0].steps[0].path[0]
    sib[3] = _bump(sib[3])


def _tamper_final_poly(fp):
    a, b = fp.final_poly[0]
    fp.final_poly[0] = (_bump(a), b)


def _tamper_pow(fp):
    fp.pow_witness += 1


@pytest.mark.parametrize("tamper", [
    _tamper_leaf, _tamper_sibling, _tamper_coset, _tamper_step_path,
    _tamper_final_poly, _tamper_pow], ids=lambda f: f.__name__[8:])
def test_fib_fri_tampering_rejected_by_both(fib_proofs, tamper):
    """One FRI value changed in the port's proof: the port's verifier
    (each tree's openings checked as one batch, alpha's powers made once
    a proof) rejects it wherever the JAX package's verifier (opening by
    opening) does."""
    import copy
    from zk_evm_tpu.stark.serialization import stark_proof_from_json
    proof, _, cfg, jcfg, pis = fib_proofs
    bad = copy.deepcopy(proof)
    tamper(bad.fri_proof)
    with pytest.raises(AssertionError):
        jverify_stark(JFibStark(), stark_proof_from_json(proof_to_json(bad)),
                      jcfg, JChallenger())
    with pytest.raises(AssertionError):
        verify_stark(FibStark(), bad, cfg, Challenger(),
                     expected_public_inputs=pis)


def test_fib_rejects_bad_trace():
    trace, pis = fib_trace(64)
    trace[2, 10] = (int(trace[2, 10]) + 1) % host.P
    cfg, _ = _cfgs(0)
    proof = prove_stark(FibStark(), trace, cfg, Challenger(), pis,
                        device="cpu")
    with pytest.raises(AssertionError):
        verify_stark(FibStark(), proof, cfg, Challenger())


def test_challenger_carried_across():
    """A JAX challenger mid-transcript converts to a port challenger that
    draws the same challenges and grinds the same witness."""
    from zk_evm_tpu.stark.fri import _grind as jgrind
    from zk_evm_tpu_torch.stark.fri import _grind
    jch = JChallenger()
    jch.observe_elements([1, 2, 3, host.P - 1, 5, 6, 7, 8, 9])
    jch.get_challenge()
    jch.observe_elements([11, 12])
    ch = convert.challenger_from(jch)
    assert _grind(ch, 6) == jgrind(jch, 6)
    assert ch.get_n_challenges(5) == jch.get_n_challenges(5)
    assert ch.compact() == jch.compact()


class RangeStark(Stark):
    """tests/test_lookup_ctl.py's one-lookup RangeStark over the port's
    Stark: V0, V1 are looked up in the counter T with frequencies F."""
    name = "range"
    num_columns = 4

    def eval(self, frame, cc):
        t = frame.local[2]
        cc.constraint_first_row(t)
        cc.constraint_transition(frame.next[2] - t - 1)

    def lookups(self):
        return [Lookup(looking_columns=(0, 1), table_column=2,
                       frequencies_column=3)]


def test_lookups_refused():
    """Lookups, CTLs and preprocessed columns are proved now: a table
    that declares preprocessed columns without a program is refused, one
    with its program proves and verifies (byte-identity with the JAX
    package: tests/test_torch_scenarios.py), and a one-lookup table's CPU
    proof equals the JAX package's."""
    trace, pis = fib_trace(8)

    class WithPreprocessed(FibStark):
        num_preprocessed = 1

    class WithProgram(WithPreprocessed):
        def preprocessed(self):
            return trace[:1]
    cfg, _ = _cfgs(0)
    with pytest.raises(AssertionError):
        prove_stark(WithPreprocessed(), trace, cfg, Challenger(), pis,
                    device="cpu")
    proof = prove_stark(WithProgram(), trace, cfg, Challenger(), pis,
                        device="cpu")
    verify_stark(WithProgram(), proof, cfg, Challenger(), device="cpu")
    proof = prove_stark(RangeStark(), range_trace(32), cfg, Challenger(),
                        device="cpu")
    assert _sha256(proof) == JAX_RANGE_SHA256


@pytest.mark.slow
def test_jax_range_proof_constant():
    cfg, jcfg = _cfgs(0)
    jjson = jproof_to_json(jprove_stark(JRangeStark(), range_trace(32), jcfg,
                                        JChallenger()))
    assert hashlib.sha256(jjson.encode()).hexdigest() == JAX_RANGE_SHA256
    verify_stark(RangeStark(), convert.proof_from_json(jjson), cfg,
                 Challenger())


def test_prove_stark_needs_cuda_or_explicit_cpu():
    """Without `device`, prove_stark runs on CUDA; without a card it
    raises and never falls back to the CPU."""
    trace, pis = fib_trace(8)
    cfg, _ = _cfgs(0)
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prove_stark(FibStark(), trace, cfg, Challenger(), pis)


@pytest.mark.parametrize("a,b,same", [
    ("cpu", "cpu", True), ("cpu", "cpu:0", True), ("cuda:0", "cuda:0", True),
    ("cuda:1", "cuda:0", False), ("cpu", "cuda:0", False),
    ("cuda", "cuda", True)])
def test_same_device(a, b, same):
    """prove_stark's check that `device` names the trace batch's device:
    an index-free name means the current device of its type."""
    from zk_evm_tpu_torch.stark.prover import same_device
    assert same_device(a, b) is same
    assert same_device(b, a) is same


@pytest.mark.parametrize("degree_bits,rate_bits", [(2, 1), (5, 1), (6, 2),
                                                   (4, 3)])
def test_device_selectors_equal_host(degree_bits, rate_bits):
    """The prover's selector tables, built with tensor ops, equal the host
    numpy tables of `domains` (and so the JAX package's)."""
    from zk_evm_tpu_torch.stark import domains
    from zk_evm_tpu_torch.stark.prover import selector_tables
    want = domains.selector_tables_bitrev(degree_bits, rate_bits)
    got = selector_tables(degree_bits, rate_bits, "cpu")
    assert set(got) == set(want)
    for k in want:
        assert got[k].to_u64().tolist() == want[k].tolist(), k


def test_opening_powers_equal_host():
    from zk_evm_tpu_torch.stark.poly_batch import ext_powers
    z = (host.P - 5, 123456789)
    a, b = ext_powers(z, 45)
    want, cur = [], (1, 0)
    for _ in range(45):
        want.append(cur)
        cur = host.emul(cur, z)
    assert list(zip(a.to_u64().tolist(), b.to_u64().tolist())) == want
