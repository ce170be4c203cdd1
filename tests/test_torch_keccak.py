"""The Keccak commitment config (StarkConfig.hasher="keccak" and
"keccak_host") of the PyTorch port against the JAX package: the twins of
tests/test_keccak_config.py.

- the jax-free copies (`hash/keccak_np.py`, `merkle/keccak_host.py`,
  `merkle/keccak_tree.py`) equal the originals on the same inputs and
  native keccak256;
- the plain keccak-f[1600] equals the JAX package's `keccak_f1600_pair`
  and the numpy permutation, on random states and on states of one
  boundary value in every lane;
- the Keccak device tree (on the CPU: the plain version) equals the host
  tree and the JAX package's device tree, cap for cap and path for path;
- a LogicStark and a MemBefore proof under "keccak" equal the proofs under
  "keccak_host" and the JAX package's, byte for byte; the JAX verifier
  accepts the port's proof; the Poseidon config, a tampered cap and the
  recursion layer reject it.

The JAX package's Keccak device hash is plain XLA whose 24 unrolled rounds
take minutes to compile on the CPU, so its trees and proofs are pinned as
sha256 constants that the `slow` tests recompute. The kernel itself
(csrc/keccak.cu) runs only on a card: its test is marked `cuda`.
Tolerance 0."""

import copy
import hashlib

import numpy as np
import pytest
import torch

from zk_evm_tpu.challenger import Challenger as JChallenger
from zk_evm_tpu.hash import keccak_np as jkeccak_np
from zk_evm_tpu.merkle import keccak_host as jkeccak_host
from zk_evm_tpu.merkle import keccak_tree as jkeccak_tree
from zk_evm_tpu.stark import (StarkConfig as JStarkConfig,
                              FriConfig as JFriConfig,
                              verify_stark as jverify_stark)
from zk_evm_tpu.stark.serialization import (
    stark_proof_from_json as jproof_from_json)
from zk_evm_tpu.tables import logic as jlogic
from zk_evm_tpu_torch import native
from zk_evm_tpu_torch.challenger import Challenger
from zk_evm_tpu_torch.field import GF, host
from zk_evm_tpu_torch.hash import keccak_device, keccak_np
from zk_evm_tpu_torch.merkle import (build_commitment_tree, keccak_host,
                                     keccak_tree, path_verifier)
from zk_evm_tpu_torch.stark import (FriConfig, StarkConfig, prove_stark,
                                    verify_stark)
from zk_evm_tpu_torch.stark.serialization import proof_to_json
from zk_evm_tpu_torch.tables import logic
from zk_evm_tpu_torch.tables import memory_continuation as mc
from zk_evm_tpu_torch.tables.segments import Segment

P = host.P
CFG_KW = dict(rate_bits=1, cap_height=1, proof_of_work_bits=0,
              num_query_rounds=2, arity_bits=2, final_poly_bits=2)
LOGIC_OPS = [("xor", 0x1234, 0xF00F), ("and", 2**64 - 1, 77),
             ("or", 1 << 255, 3)] * 4
MC_VALUES = [((0, int(Segment.MainMemory), i), 31 * i + 5)
             for i in range(6)]
BOUNDARY = (0, 1, P - 1, (1 << 32) - 1, 1 << 32, (1 << 64) - 1)
TREE_WIDTHS = (3, 7, 17, 20)          # noop leaf, 1 block, 2 blocks, 2
TREE_PATHS = (0, 9, 15)
# sha256 of the JAX package's proof_to_json of tests/test_keccak_config.py's
# LogicStark and MemBefore proofs under hasher="keccak" (equal to those
# under "keccak_host"), made on the CPU; the `slow` test recomputes them
LOGIC_KECCAK_SHA256 = (
    "f47ebc079c9ce0e1e8678ced423d198a6a7465e22c62b370069eb5599011a86a")
MC_KECCAK_SHA256 = (
    "4f5e58f2f3ad86fbbeed36875139fd314feb051c79c0a9002dbe35182787b007")
# sha256 over the JAX package's device trees (hasher="keccak") at
# TREE_WIDTHS: each cap, then the paths at TREE_PATHS (`_trees_sha256`)
DEVICE_TREES_SHA256 = (
    "8ff42922ec3b3cc06babaf8e1d6d9091a417716c1db03936d6024477b0809b31")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread proves these small tables faster than many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _cfg(hasher):
    return StarkConfig(security_bits=1, fri_config=FriConfig(**CFG_KW),
                       hasher=hasher)


def _jcfg(hasher):
    return JStarkConfig(security_bits=1, fri_config=JFriConfig(**CFG_KW),
                        hasher=hasher)


def _sha(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


# ---- keccak256 and the permutation ---------------------------------------

@pytest.mark.parametrize("length", [0, 1, 135, 136, 137, 512])
def test_keccak256_batch_vs_native(length):
    rng = np.random.default_rng(5 + length)
    msgs = rng.integers(0, 256, size=(5, length), dtype=np.uint8)
    got = keccak_np.keccak256_batch(msgs)
    for i in range(5):
        assert got[i].tobytes() == native.keccak256(msgs[i].tobytes())
    assert np.array_equal(got, jkeccak_np.keccak256_batch(msgs))


def test_keccak256_published_vector():
    assert keccak_np.keccak256_batch(np.zeros((1, 0), np.uint8))[0] \
        .tobytes().hex() == ("c5d2460186f7233c927e7db2dcc703c0"
                             "e500b653ca82273b7bfad8045d85a470")


def _states():
    """Random states, then one state of each boundary value."""
    rng = np.random.default_rng(11)
    rand = rng.integers(0, 2**64, size=(6, 5, 5), dtype=np.uint64)
    uniform = np.repeat(np.array(BOUNDARY, dtype=np.uint64), 25) \
        .reshape(len(BOUNDARY), 5, 5)
    return np.concatenate([rand, uniform])


@pytest.fixture(scope="module")
def permuted():
    """(states, the JAX package's keccak_f1600_pair of them)."""
    import jax.numpy as jnp
    from zk_evm_tpu.hash.keccak_device import keccak_f1600_pair
    states = _states()
    lo, hi = keccak_f1600_pair(
        jnp.asarray((states & 0xFFFFFFFF).astype(np.uint32)),
        jnp.asarray((states >> 32).astype(np.uint32)))
    return states, np.asarray(lo, dtype=np.uint64) \
        | (np.asarray(hi, dtype=np.uint64) << np.uint64(32))


@pytest.mark.parametrize("rows", ["random"] + [f"boundary {v:#x}"
                                               for v in BOUNDARY])
def test_keccak_f1600_plain_equals_jax_and_numpy(permuted, rows):
    states, jax_out = permuted
    sel = slice(0, 6) if rows == "random" else \
        [6 + [f"boundary {v:#x}" for v in BOUNDARY].index(rows)]
    s = states[sel]
    got = keccak_device.keccak_f1600_plain(
        torch.from_numpy(s.view(np.int64).copy())).numpy().view(np.uint64)
    assert np.array_equal(got, jax_out[sel])
    assert np.array_equal(got, keccak_np.keccak_f1600(s.copy()))
    assert np.array_equal(got, jkeccak_np.keccak_f1600(s.copy()))


@pytest.mark.parametrize("width", [1, 4, 5, 16, 17, 18, 34, 523])
def test_hash_rows_equal_host_law(width):
    """Leaf digests on the CPU: the plain version, against the host twin
    of the JAX package (hash_or_noop) on random and boundary rows."""
    rng = np.random.default_rng(width)
    m = rng.integers(0, P, size=(9, width), dtype=np.uint64)
    m[:len(BOUNDARY)] = np.array(BOUNDARY, dtype=np.uint64)[:, None] % P
    got = keccak_device.hash_rows(GF.from_u64(m)).to_u64()
    assert np.array_equal(got, keccak_device.hash_rows_plain(
        GF.from_u64(m)).to_u64())
    for i in range(len(m)):
        want = jkeccak_host.hash_or_noop([int(v) for v in m[i]])
        assert [int(v) for v in got[i]] == want


def test_compress_equals_host_law():
    rng = np.random.default_rng(3)
    level = rng.integers(0, P, size=(8, 4), dtype=np.uint64)
    got = keccak_device.compress(GF.from_u64(level)).to_u64()
    assert np.array_equal(got, keccak_device.compress_plain(
        GF.from_u64(level)).to_u64())
    for i in range(4):
        want = jkeccak_host.two_to_one([int(v) for v in level[2 * i]],
                                       [int(v) for v in level[2 * i + 1]])
        assert [int(v) for v in got[i]] == want


# ---- trees ---------------------------------------------------------------

def test_keccak_tree_matches_host_twin():
    rng = np.random.default_rng(9)
    leaves = rng.integers(0, P, size=(16, 7), dtype=np.uint64)
    tree = keccak_tree.build_tree_keccak(leaves, cap_height=1)
    rows = [list(map(int, r)) for r in leaves]
    _, cap = keccak_host.build_tree(rows, cap_height=1)
    assert tree.cap_ints() == cap
    assert (cap, tree.prove_many([0, 5, 15])) == (
        jkeccak_host.build_tree(rows, cap_height=1)[1],
        jkeccak_tree.build_tree_keccak(leaves, cap_height=1)
        .prove_many([0, 5, 15]))
    for idx in (0, 5, 15):
        path = tree.prove(idx)
        assert keccak_host.verify_path(rows[idx], idx, path, cap,
                                       path_len=3)
        assert not keccak_host.verify_path(rows[idx], idx ^ 1, path, cap,
                                           path_len=3)
    assert path_verifier("keccak") is keccak_host.verify_path
    assert path_verifier("keccak_host") is keccak_host.verify_path


def _tree_leaves(width):
    return np.random.default_rng(13 + width).integers(
        0, P, size=(16, width), dtype=np.uint64)


def _trees_sha256(build) -> str:
    """sha256 over each width's cap, then its paths at TREE_PATHS, of the
    trees `build(leaves)` makes; `build` returns (cap u64, prove)."""
    h = hashlib.sha256()
    for width in TREE_WIDTHS:
        cap, prove = build(_tree_leaves(width))
        h.update(np.ascontiguousarray(cap, dtype=np.uint64).tobytes())
        for idx in TREE_PATHS:
            h.update(np.asarray(prove(idx), dtype=np.uint64).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("width", TREE_WIDTHS)
def test_device_tree_equals_host_tree(width):
    """build_commitment_tree(hasher="keccak") on the CPU against the host
    numpy tree of both packages, cap for cap and path for path."""
    leaves = _tree_leaves(width)
    dev = build_commitment_tree(GF.from_u64(leaves), cap_height=1,
                                hasher="keccak")
    host_tree = build_commitment_tree(GF.from_u64(leaves), cap_height=1,
                                      hasher="keccak_host")
    jtree = jkeccak_tree.build_tree_keccak(leaves, cap_height=1)
    cap = [[int(x) for x in r] for r in dev.cap_u64()]
    assert cap == host_tree.cap_ints() == jtree.cap_ints()
    for idx in TREE_PATHS:
        assert dev.prove(idx) == host_tree.prove(idx) == jtree.prove(idx)
    assert np.array_equal(dev.leaves_at([1, 3]),
                          host_tree.leaves_at([1, 3]))


def test_device_trees_equal_jax_device_trees():
    def build(leaves):
        t = build_commitment_tree(GF.from_u64(leaves), cap_height=1,
                                  hasher="keccak")
        return t.cap_u64(), t.prove
    assert _trees_sha256(build) == DEVICE_TREES_SHA256


# ---- proofs --------------------------------------------------------------

@pytest.fixture(scope="module")
def logic_proofs():
    trace = logic.generate_trace(LOGIC_OPS)
    return {h: prove_stark(logic.LogicStark(), trace, _cfg(h), Challenger(),
                           device="cpu")
            for h in ("keccak", "keccak_host", "poseidon")}


def test_prove_verify_keccak_config(logic_proofs):
    proof = logic_proofs["keccak"]
    verify_stark(logic.LogicStark(), proof, _cfg("keccak"), Challenger())
    # not valid under the poseidon hasher config
    with pytest.raises(AssertionError):
        verify_stark(logic.LogicStark(), proof, _cfg("poseidon"),
                     Challenger())
    # caps differ from the poseidon-config proof, and a tampered cap is
    # rejected
    assert proof.trace_cap != logic_proofs["poseidon"].trace_cap
    bad = copy.deepcopy(proof)
    bad.trace_cap[0][0] ^= 1
    with pytest.raises(AssertionError):
        verify_stark(logic.LogicStark(), bad, _cfg("keccak"), Challenger())
    # the JAX verifier accepts the port's proof
    jverify_stark(jlogic.LogicStark(), jproof_from_json(proof_to_json(proof)),
                  _jcfg("keccak"), JChallenger())


@pytest.mark.parametrize("hasher", ["keccak", "keccak_host"])
def test_logic_keccak_proof_equals_jax(logic_proofs, hasher):
    text = proof_to_json(logic_proofs[hasher])
    assert text == proof_to_json(logic_proofs["keccak"])
    assert _sha(text) == LOGIC_KECCAK_SHA256


@pytest.mark.parametrize("hasher", ["keccak", "keccak_host"])
def test_mc_keccak_proof_equals_jax(hasher):
    """tests/test_keccak_config.py's device-against-host case: a MemBefore
    proof under each Keccak config, equal to the JAX package's."""
    trace = mc.generate_trace(MC_VALUES)
    stark = mc.MemoryContinuationStark()
    proof = prove_stark(stark, trace, _cfg(hasher), Challenger(),
                        device="cpu")
    assert _sha(proof_to_json(proof)) == MC_KECCAK_SHA256
    verify_stark(stark, proof, _cfg(hasher), Challenger())


def test_recursion_rejects_keccak_config():
    from zk_evm_tpu_torch.recursion.verify_tape import verify_stark_tape
    trace = logic.generate_trace([("xor", 1, 2)])
    proof = prove_stark(logic.LogicStark(), trace, _cfg("keccak"),
                        Challenger(), device="cpu")
    with pytest.raises(AssertionError, match="Poseidon"):
        verify_stark_tape(None, logic.LogicStark(), proof, _cfg("keccak"))


def test_keccak_rows_refuses_what_the_kernel_does_not_take():
    """Only a CPU tensor runs the plain version; any other device that is
    not CUDA, and any shape but a matrix, raise instead of falling back."""
    with pytest.raises(ValueError, match="CPU or CUDA"):
        keccak_device.keccak_rows(GF(torch.empty((4, 8), dtype=torch.int64,
                                                 device="meta")))
    with pytest.raises(ValueError, match="expected"):
        keccak_device.keccak_rows(GF.zeros((2, 4, 8)))


def test_keccak_host_takes_cpu_leaves_only():
    """"keccak_host" is the numpy tree: leaves off the CPU are refused,
    not copied to the host; on the card the Keccak tree is "keccak"."""
    leaves = GF(torch.empty((4, 8), dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError, match="CPU leaves"):
        build_commitment_tree(leaves, cap_height=0, hasher="keccak_host")


def test_cpu_tensor_never_launches():
    before = keccak_device.LAUNCHES["rows"]
    keccak_device.hash_rows(GF.from_u64(_tree_leaves(20)))
    assert keccak_device.LAUNCHES["rows"] == before


# ---- the JAX package's side of the pinned constants (minutes) ------------

@pytest.mark.slow
def test_jax_keccak_constants():
    """Recompute LOGIC_KECCAK_SHA256, MC_KECCAK_SHA256 and
    DEVICE_TREES_SHA256 with the JAX package, under both Keccak
    configs."""
    from zk_evm_tpu.field import GF as JGF
    from zk_evm_tpu.merkle import build_commitment_tree as jbuild
    from zk_evm_tpu.stark import prove_stark as jprove_stark
    from zk_evm_tpu.stark.serialization import proof_to_json as jpj
    from zk_evm_tpu.tables import memory_continuation as jmc
    for hasher in ("keccak", "keccak_host"):
        p = jprove_stark(jlogic.LogicStark(),
                         jlogic.generate_trace(LOGIC_OPS), _jcfg(hasher),
                         JChallenger())
        assert _sha(jpj(p)) == LOGIC_KECCAK_SHA256
        p = jprove_stark(jmc.MemoryContinuationStark(),
                         jmc.generate_trace(MC_VALUES), _jcfg(hasher),
                         JChallenger())
        assert _sha(jpj(p)) == MC_KECCAK_SHA256

    def build(leaves):
        t = jbuild(JGF.from_u64(leaves), cap_height=1, hasher="keccak")
        return t.cap_u64(), t.prove
    assert _trees_sha256(build) == DEVICE_TREES_SHA256


# ---- the kernel, on a card -----------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("width", [3, 5, 8, 16, 17, 34, 523])
def test_kernel_matches_plain(cuda_device, width):
    rng = np.random.default_rng(width)
    m = rng.integers(0, 2**64, size=(width, 1000), dtype=np.uint64)
    m[:, :len(BOUNDARY)] = np.array(BOUNDARY, dtype=np.uint64)[None, :]
    lde = GF.from_u64(m, cuda_device)          # (width, rows): as lde.T
    before = keccak_device.LAUNCHES["rows"]
    got = keccak_device.keccak_rows(lde.T).to_u64()
    assert keccak_device.LAUNCHES["rows"] == before + 1
    assert np.array_equal(got, keccak_device.keccak_rows_plain(
        GF.from_u64(m.T.copy())).to_u64())
    want = keccak_tree._digest_reduce(keccak_np.keccak256_batch(
        np.ascontiguousarray(m.T).view(np.uint8).reshape(1000, width * 8)))
    assert np.array_equal(got, want)
    level = GF(torch.from_numpy(got.view(np.int64)).to(cuda_device))
    assert np.array_equal(keccak_device.compress(level).to_u64(),
                          keccak_device.compress_plain(
                              GF.from_u64(got)).to_u64())


@pytest.mark.cuda
def test_keccak_host_refuses_cuda_leaves(cuda_device):
    with pytest.raises(ValueError, match="CPU leaves"):
        build_commitment_tree(GF.zeros((4, 8), cuda_device), cap_height=0,
                              hasher="keccak_host")
