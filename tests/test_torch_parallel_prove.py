"""Proofs over the port's parallel layer on the CPU: `prove_stark(mesh=)`
of the JAX package's `tests/test_sharded_prove.py` WideStark at 2^12 rows
over 8 entries, and the memory chain MemBefore -> Memory -> MemAfter at
Memory 2^10 through `prove_all(parallel_commits=True)` (with and
without `devices`) and `prove_all(mesh=)`. Every proof's
`proof_to_json` must hash to the single-device proof's sha256. The
single-device proofs, the port's and the JAX package's (which take
minutes of XLA compiles), are pinned as sha256 constants that the `slow`
tests recompute. The `slow` tests also port the JAX package's
`tests/test_sharded_real_tables.py`: a real CPU table and a 2^14-row
Keccak table over the mesh."""

import hashlib

import numpy as np
import pytest
import torch

from zk_evm_tpu.field import host
from zk_evm_tpu_torch.challenger import Challenger
from zk_evm_tpu_torch.parallel import Mesh, make_mesh
from zk_evm_tpu_torch.stark import (FriConfig, Lookup, Stark, StarkConfig,
                                    col, prove_all, prove_stark, verify_all,
                                    verify_stark)
from zk_evm_tpu_torch.stark.serialization import proof_to_json
from zk_evm_tpu_torch.tables import all_stark as ast
from zk_evm_tpu_torch.tables.memory_chain import (chain_traces,
                                                  preinitialized_words)

# sha256 of proof_to_json of the single-device proof of WideStark at
# 2^12 rows at wide_cfg(), equal between the packages
WIDE_SHA256 = (
    "5e0ec4b07bc9da379f6a8b50e3be7e22e0ff74e10284b1f7ddaf9709d46e0fca")
# sha256 of proof_to_json of the single-device prove_all of the memory
# chain of preinitialized_words(700, seed=0) (Memory 2^10 rows) at
# StarkConfig.test_config(), equal between the packages
CHAIN_SHA256 = (
    "3a45277f665d26e90f3c6f310af3bee5a344101b7a1b8082db95604bdcb2e9f7")
CHAIN_WORDS = 700


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The CPU proofs here are small: one intra-op thread proves them
    faster than many and leaves the cores to the other test workers.
    Inference mode spares every small op autograd's bookkeeping."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.inference_mode():
        yield
    torch.set_num_threads(n)


class WideStark(Stark):
    """The JAX package's WideStark (tests/test_sharded_prove.py): c0
    counts rows, c3..c14 are c0 * (k + 1), c2 is a permutation of c1
    checked by a logUp lookup with frequencies in c15."""
    name = "wide"
    num_columns = 16
    num_public_inputs = 0

    def eval(self, frame, cc):
        lv = frame.local
        nv = frame.next
        cc.constraint_first_row(lv[0])
        cc.constraint_transition(nv[0] - lv[0] - 1)
        for k in range(3, 15):
            cc.constraint(lv[k] - lv[0] * (k + 1))

    def lookups(self):
        return [Lookup(looking_columns=(col(2),), table_column=1,
                       frequencies_column=15)]


def wide_trace(n):
    t = np.zeros((16, n), dtype=np.uint64)
    t[0] = np.arange(n, dtype=np.uint64)
    for k in range(1, 15):
        t[k] = (t[0] * (k + 1)) % np.uint64(host.P)
    t[2] = t[1][::-1].copy()
    freq = np.zeros(n, dtype=np.uint64)
    vals = {int(v): i for i, v in enumerate(t[1])}
    for v in t[2]:
        freq[vals[int(v)]] += 1
    t[15] = freq
    return t


def wide_cfg():
    return StarkConfig(
        security_bits=1,
        fri_config=FriConfig(rate_bits=1, cap_height=2,
                             proof_of_work_bits=0, num_query_rounds=2,
                             arity_bits=2, final_poly_bits=2))


def sha256(proof) -> str:
    return hashlib.sha256(proof_to_json(proof).encode()).hexdigest()


def test_wide_stark_over_8_entries():
    """Trace, aux, quotient and FRI trees over an 8-entry mesh: the
    single-device proof, which the port's verifier accepts."""
    mesh = make_mesh(8, device_type="cpu")
    proof = prove_stark(WideStark(), wide_trace(1 << 12), wide_cfg(),
                        Challenger(), mesh=mesh)
    assert sha256(proof) == WIDE_SHA256
    verify_stark(WideStark(), proof, wide_cfg(), Challenger(), device="cpu")


@pytest.mark.slow
def test_wide_stark_single_device_pinned():
    """The pinned constant is the port's single-device proof and the JAX
    package's."""
    from test_sharded_prove import WideStark as JWideStark, _cfg
    from zk_evm_tpu.challenger import Challenger as JChallenger
    from zk_evm_tpu.stark import prove_stark as jprove_stark
    from zk_evm_tpu.stark.serialization import proof_to_json as jjson
    trace = wide_trace(1 << 12)
    assert sha256(prove_stark(WideStark(), trace, wide_cfg(), Challenger(),
                              device="cpu")) == WIDE_SHA256
    jproof = jprove_stark(JWideStark(), trace, _cfg(), JChallenger())
    assert hashlib.sha256(jjson(jproof).encode()).hexdigest() == WIDE_SHA256


CHAIN_PATHS = {
    "parallel_commits": dict(parallel_commits=True, device="cpu"),
    "parallel_commits_devices": dict(parallel_commits=True,
                                     devices=["cpu"] * 3),
    "mesh": dict(mesh=Mesh(["cpu"] * 2)),
}


@pytest.fixture(scope="module")
def chain():
    traces = chain_traces(preinitialized_words(CHAIN_WORDS, seed=0))
    assert traces[ast.Table.Memory].shape[1] == 1 << 10
    return traces, ast.all_starks(), ast.all_cross_table_lookups()


@pytest.mark.parametrize("path", list(CHAIN_PATHS))
def test_chain_paths_equal_sequential(path, chain):
    """Each path's proof is the sequential one, and `verify_all`
    accepts it."""
    traces, starks, ctls = chain
    cfg = StarkConfig.test_config()
    proof = prove_all(starks, traces, ctls, cfg, **CHAIN_PATHS[path])
    assert sha256(proof) == CHAIN_SHA256
    optional = tuple(i for i, t in enumerate(traces) if t is None)
    verify_all(starks, proof, ctls, cfg, optional_tables=optional,
               device="cpu")


def test_mesh_with_other_devices_refused(chain):
    traces, starks, ctls = chain
    with pytest.raises(ValueError, match="mesh's first device"):
        prove_all(starks, traces, ctls, StarkConfig.test_config(),
                  device="cuda", mesh=Mesh(["cpu"]))
    with pytest.raises(ValueError, match="devices names others"):
        prove_all(starks, traces, ctls, StarkConfig.test_config(),
                  parallel_commits=True, devices=["cpu", "meta"],
                  mesh=Mesh(["cpu"]))


@pytest.mark.slow
def test_chain_single_device_pinned(chain):
    """The pinned constant is the port's sequential proof and the JAX
    package's."""
    from zk_evm_tpu.stark import (StarkConfig as JStarkConfig,
                                  prove_all as jprove_all)
    from zk_evm_tpu.stark.serialization import proof_to_json as jjson
    from zk_evm_tpu.tables import all_stark as jast
    traces, starks, ctls = chain
    assert sha256(prove_all(starks, traces, ctls, StarkConfig.test_config(),
                            device="cpu")) == CHAIN_SHA256
    jproof = jprove_all(jast.all_starks(), traces,
                        jast.all_cross_table_lookups(),
                        JStarkConfig.test_config())
    assert hashlib.sha256(jjson(jproof).encode()).hexdigest() == CHAIN_SHA256


def real_cfg():
    return StarkConfig(
        security_bits=1,
        fri_config=FriConfig(rate_bits=1, cap_height=2,
                             proof_of_work_bits=0, num_query_rounds=1,
                             arity_bits=2, final_poly_bits=2))


@pytest.mark.slow
def test_sharded_real_cpu_table():
    """The 85-column CPU table of a real simple-transfer segment over the
    8-entry mesh (tests/test_sharded_real_tables.py's twin)."""
    from zk_evm_tpu_torch.tables.all_stark import Table
    from zk_evm_tpu_torch.witness.kernel import combined_kernel
    from zk_evm_tpu_torch.witness.segments import generate_segment_tables
    from zk_evm_tpu_torch.witness.testing_fixtures import \
        build_simple_transfer_inputs

    _seg, gt = next(generate_segment_tables(
        combined_kernel(), build_simple_transfer_inputs(),
        max_cpu_len_log=14))
    trace = gt.traces[Table.Cpu]
    stark = gt.starks[Table.Cpu]
    assert trace.shape[0] == 85 and trace.shape[1] >= (1 << 14)
    p1 = prove_stark(stark, trace, real_cfg(), Challenger(), device="cpu")
    p2 = prove_stark(stark, trace, real_cfg(), Challenger(),
                     mesh=make_mesh(8, device_type="cpu"))
    assert proof_to_json(p1) == proof_to_json(p2)
    verify_stark(stark, p2, real_cfg(), Challenger(), device="cpu")


@pytest.mark.slow
def test_sharded_keccak_table_2_14():
    """The 2,431-column Keccak table at 2^14 rows over the 8-entry mesh."""
    from zk_evm_tpu_torch.tables import keccak

    rng = np.random.default_rng(11)
    inputs = [([int(x) for x in rng.integers(0, 1 << 64, 25,
                                             dtype=np.uint64)], 2 + i)
              for i in range(682)]
    trace = keccak.generate_trace(inputs, min_rows=1 << 14)
    assert trace.shape == (keccak.NUM_COLUMNS, 1 << 14)
    stark = keccak.KeccakStark()
    p1 = prove_stark(stark, trace, real_cfg(), Challenger(), device="cpu")
    p2 = prove_stark(stark, trace, real_cfg(), Challenger(),
                     mesh=make_mesh(8, device_type="cpu"))
    assert proof_to_json(p1) == proof_to_json(p2)
    verify_stark(stark, p2, real_cfg(), Challenger(), device="cpu")
