"""The Logic table (523 columns) proved by the PyTorch port against the
JAX package at 8 rows: `proof_to_json` byte-identical, the JAX verifier
accepts the port's proof, and the port's verifier rejects a flipped result
limb (as tests/test_logic_table.py).

The JAX package's proof takes about a minute of XLA compiles on the CPU,
so tier-1 holds the port's proof to its sha256 (JAX_LOGIC_SHA256) and
the `slow` test (`-m slow`) makes the JAX proof, checks the constant and
has the port's verifier accept it."""

import hashlib

import numpy as np
import pytest
import torch

from zk_evm_tpu.challenger import Challenger as JChallenger
from zk_evm_tpu.stark import (StarkConfig as JStarkConfig,
                              FriConfig as JFriConfig,
                              prove_stark as jprove_stark,
                              verify_stark as jverify_stark)
from zk_evm_tpu.stark.serialization import (
    proof_to_json as jproof_to_json, stark_proof_from_json)
from zk_evm_tpu.tables import logic as jlogic
from zk_evm_tpu_torch import convert
from zk_evm_tpu_torch.challenger import Challenger
from zk_evm_tpu_torch.hash import poseidon_dense
from zk_evm_tpu_torch.stark import (StarkConfig, FriConfig, prove_stark,
                                    verify_stark)
from zk_evm_tpu_torch.stark.serialization import proof_to_json
from zk_evm_tpu_torch.tables import logic

rng = np.random.default_rng(11)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread runs these small CPU proofs and hashes as fast
    as many and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rand_u256():
    return int.from_bytes(rng.bytes(32), "little")


OPS = [(op, rand_u256(), rand_u256())
       for op in ("and", "or", "xor") for _ in range(2)]
CFG_KW = dict(rate_bits=1, cap_height=2, proof_of_work_bits=0,
              num_query_rounds=2, arity_bits=1, final_poly_bits=2)
CFG = StarkConfig(security_bits=1, fri_config=FriConfig(**CFG_KW))
JCFG = JStarkConfig(security_bits=1, fri_config=JFriConfig(**CFG_KW))
# sha256 of the JAX package's proof_to_json(prove_stark(...)) of the trace
JAX_LOGIC_SHA256 = (
    "53315934aa9904539ec667c46fba7603b1a19b9634411fb69c84ae637314bd32")


@pytest.fixture(scope="module")
def trace():
    return logic.generate_trace(OPS)                # 8 rows


@pytest.fixture(scope="module")
def port_proof(trace):
    return prove_stark(logic.LogicStark(), trace, CFG, Challenger(),
                       device="cpu")


def test_trace_matches_reference(trace):
    assert np.array_equal(trace, jlogic.generate_trace(OPS))
    logic.check_trace(trace)
    assert trace.shape == (logic.NUM_COLUMNS, 8) and logic.NUM_COLUMNS == 523


def test_logic_proof_json_identical(port_proof):
    assert hashlib.sha256(proof_to_json(port_proof).encode()).hexdigest() \
        == JAX_LOGIC_SHA256


@pytest.mark.slow
def test_jax_logic_proof_constant(trace):
    """The JAX package's proof (about a minute): its sha256 is
    JAX_LOGIC_SHA256, and the port's verifier accepts it."""
    jjson = jproof_to_json(jprove_stark(jlogic.LogicStark(), trace, JCFG,
                                        JChallenger()))
    assert hashlib.sha256(jjson.encode()).hexdigest() == JAX_LOGIC_SHA256
    verify_stark(logic.LogicStark(), convert.proof_from_json(jjson), CFG,
                 Challenger())


def test_jax_verifier_accepts_port_proof(port_proof):
    jverify_stark(jlogic.LogicStark(),
                  stark_proof_from_json(proof_to_json(port_proof)), JCFG,
                  JChallenger())


def test_port_verifier_accepts(port_proof):
    """The port's proof, and the same proof read back from its JSON (the
    JAX proof's text, by test_logic_proof_json_identical)."""
    verify_stark(logic.LogicStark(), port_proof, CFG, Challenger())
    verify_stark(logic.LogicStark(),
                 convert.proof_from_json(proof_to_json(port_proof)),
                 CFG, Challenger())


def test_port_verifier_rejects_bad_result(trace):
    bad = trace.copy()
    bad[logic.RESULT, 0] = int(bad[logic.RESULT, 0]) ^ 1
    proof = prove_stark(logic.LogicStark(), bad, CFG, Challenger(),
                        device="cpu")
    with pytest.raises(AssertionError):
        verify_stark(logic.LogicStark(), proof, CFG, Challenger())


def test_cpu_prove_launches_no_kernel(trace):
    before = dict(poseidon_dense.LAUNCHES)
    prove_stark(logic.LogicStark(), trace, CFG, Challenger(), device="cpu")
    assert poseidon_dense.LAUNCHES == before


@pytest.mark.cuda
def test_cuda_proof_equals_cpu_proof(trace, port_proof):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    before = dict(poseidon_dense.LAUNCHES)
    proof = prove_stark(logic.LogicStark(), trace, CFG, Challenger(),
                        device=torch.device("cuda", 0))
    assert proof_to_json(proof) == proof_to_json(port_proof)
    assert all(poseidon_dense.LAUNCHES[k] > before[k] for k in before)
