"""The PyTorch port's Merkle trees and trace commitment against the JAX
package: `build_tree` caps, `prove_many`, `leaves_at`, the host path check,
and `commit_cap` at `entry()`'s shape (16 polys x 256 rows). Exact."""

import numpy as np
import pytest
import torch

from zk_evm_tpu import merkle as jmerkle
from zk_evm_tpu import ntt as jntt
from zk_evm_tpu.field import GF as JGF, host
from zk_evm_tpu.parallel import commit_cap as jcommit_cap
from zk_evm_tpu_torch import merkle
from zk_evm_tpu_torch.field import GF
from zk_evm_tpu_torch.hash import poseidon_dense
from zk_evm_tpu_torch.parallel import commit_cap
from test_torch_parallel import ENTRY_CAP_SHA256, caps_sha256

P = host.P
rng = np.random.default_rng(23)
ENTRY_VALUES = np.random.default_rng(0).integers(
    0, P, size=(16, 256), dtype=np.uint64)      # entry()'s input


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread runs these small CPU proofs and hashes as fast
    as many and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n_cols", [3, 12])
@pytest.mark.parametrize("cap_height", [0, 2])
def test_build_tree(n_cols, cap_height):
    leaves = rng.integers(0, P, size=(32, n_cols), dtype=np.uint64)
    tree = merkle.build_commitment_tree(GF.from_u64(leaves), cap_height)
    jtree = jmerkle.build_tree(JGF.from_u64(leaves), cap_height)
    assert np.array_equal(tree.cap_u64(), jtree.cap_u64())
    for lv, jlv in zip(tree.levels, jtree.levels):
        assert np.array_equal(lv.to_u64(), jlv.to_u64())
    _, host_cap = jmerkle.host_merkle.build_tree(
        [[int(v) for v in r] for r in leaves], cap_height)
    assert [[int(v) for v in d] for d in tree.cap_u64()] == host_cap

    idx = [0, 5, 31, 5, 16]
    assert tree.prove_many(idx) == jtree.prove_many(idx)
    assert np.array_equal(tree.leaves_at(np.array(idx)),
                          jtree.leaves_at(np.array(idx)))
    cap = [[int(v) for v in d] for d in tree.cap_u64()]
    for i, path in zip(idx, tree.prove_many(idx)):
        leaf = [int(v) for v in leaves[i]]
        assert merkle.host_merkle.verify_path(leaf, i, path, cap,
                                              path_len=5 - cap_height)
        bad = list(leaf)
        bad[0] = (bad[0] + 1) % P
        assert not merkle.host_merkle.verify_path(bad, i, path, cap,
                                                  path_len=5 - cap_height)


def _openings(n_cols, cap_height, idx, hasher="poseidon"):
    leaves = rng.integers(0, P, size=(32, n_cols), dtype=np.uint64)
    tree = merkle.build_commitment_tree(GF.from_u64(leaves), cap_height,
                                        hasher=hasher)
    cap = [[int(v) for v in d] for d in tree.cap_u64()]
    return ([[int(v) for v in leaves[i]] for i in idx], tree.prove_many(idx),
            cap)


def _outcome(fn, *args):
    """fn's answer, or the type of what it raised."""
    try:
        return fn(*args)
    except Exception as e:              # noqa: BLE001 - compared, not hidden
        return type(e)


def _tampered(leaves, paths, cap):
    """Each way one opening of five can be wrong, and the first opening's
    leaf changed by a multiple of P (values outside the field)."""
    yield "leaf", [[(leaves[0][0] + 1) % P] + leaves[0][1:]] + leaves[1:], \
        paths, cap
    if paths[2]:
        sib = [list(s) for s in paths[2]]
        sib[-1][3] = (sib[-1][3] + 1) % P
        yield "sibling", leaves, paths[:2] + [sib] + paths[3:], cap
        yield "short path", leaves, paths[:3] + [paths[3][:-1]] + paths[4:], \
            cap
    yield "long path", leaves, paths[:3] + [paths[3] + [cap[0]]] \
        + paths[4:], cap
    yield "cap", leaves, paths, [list(d) for d in cap[:-1]] + [
        [(cap[-1][0] + 1) % P] + cap[-1][1:]]
    yield "wide leaf", [leaves[0] + [0]] + leaves[1:], paths, cap
    yield "beyond P", [[leaves[0][0] + P] + leaves[0][1:]] + leaves[1:], \
        paths, cap
    yield "beyond u64", [[leaves[0][0] + (1 << 64)] + leaves[0][1:]] \
        + leaves[1:], paths, cap


@pytest.mark.parametrize("n_cols", [3, 4, 5, 8, 12, 523])
@pytest.mark.parametrize("cap_height", [0, 2, 5])
def test_verify_paths_equals_verify_path(n_cols, cap_height):
    """The FRI verifier's batched path check agrees with the JAX
    package's one-opening verify_path on every opening, honest or not
    (leaf, sibling, path length, cap, leaf width, values outside the
    field or outside u64), and on the empty batch."""
    idx = [0, 5, 31, 5, 16]
    path_len = 5 - cap_height
    leaves, paths, cap = _openings(n_cols, cap_height, idx)

    def one_by_one(lv, ps, cp):
        return all(jmerkle.host_merkle.verify_path(leaf, i, p, cp,
                                                   path_len=path_len)
                   for leaf, i, p in zip(lv, idx, ps))
    assert merkle.paths.verify_paths(leaves, idx, paths, cap, path_len)
    assert one_by_one(leaves, paths, cap)
    for what, lv, ps, cp in _tampered(leaves, paths, cap):
        got = _outcome(merkle.paths.verify_paths, lv, idx, ps, cp, path_len)
        assert got == _outcome(one_by_one, lv, ps, cp), what
    assert not merkle.paths.verify_paths(leaves, [0, 5, 32, 5, 16], paths,
                                         cap, path_len)
    assert merkle.paths.verify_paths([], [], [], cap, path_len)


def test_verify_paths_keccak_equals_verify_path():
    idx = [1, 7, 30, 7, 12]
    leaves, paths, cap = _openings(17, 1, idx, hasher="keccak_host")
    verify = merkle.paths_verifier("keccak")
    assert verify is merkle.paths_verifier("keccak_host")
    assert verify(leaves, idx, paths, cap, 4)
    for what, lv, ps, cp in _tampered(leaves, paths, cap):
        want = _outcome(lambda: all(
            jmerkle.keccak_merkle.verify_path(leaf, i, p, cp, path_len=4)
            for leaf, i, p in zip(lv, idx, ps)))
        assert _outcome(verify, lv, idx, ps, cp, 4) == want, what


def test_tree_over_transposed_view():
    """Leaves passed as lde.T (the LDE's own layout) build the same tree."""
    lde = rng.integers(0, P, size=(9, 16), dtype=np.uint64)
    tree = merkle.build_tree(GF.from_u64(lde).T, cap_height=1)
    jtree = jmerkle.build_tree(JGF.from_u64(lde).T, cap_height=1)
    assert np.array_equal(tree.cap_u64(), jtree.cap_u64())
    assert np.array_equal(tree.leaves_at([3, 7]), jtree.leaves_at(
        np.array([3, 7])))


def test_other_hashers_not_ported():
    """Poseidon and the two Keccak configs are the hashers there are (the
    Keccak trees are held to the JAX package in test_torch_keccak.py); the
    tree and the path verifier refuse any other name, as the JAX
    package's do."""
    with pytest.raises(AssertionError):
        merkle.build_commitment_tree(GF.zeros((4, 2)), 0, hasher="blake3")
    with pytest.raises(AssertionError):
        merkle.path_verifier("blake3")
    for hasher in ("keccak", "keccak_host"):
        tree = merkle.build_commitment_tree(GF.zeros((4, 2)), 0,
                                            hasher=hasher)
        assert tree.cap_u64().shape == (1, 4)


@pytest.fixture(scope="module")
def jax_entry_levels():
    """Every tree level of the JAX package's commitment of entry()'s
    input, by its uncompiled parts (the fused commit_cap program takes
    half a minute per cap height to compile on the CPU)."""
    lde = jntt.lde_bitrev(JGF.from_u64(ENTRY_VALUES), rate_bits=1)
    levels = jmerkle.build_tree(lde.T, cap_height=0).levels
    return {lv.shape[0]: lv.to_u64() for lv in levels}


@pytest.mark.parametrize("cap_height", [0, 1, 2, 3, 4])
def test_commit_cap_matches_entry(jax_entry_levels, cap_height):
    got = commit_cap(GF.from_u64(ENTRY_VALUES), cap_height=cap_height)
    assert got.shape == (1 << cap_height, 4)
    assert np.array_equal(got.to_u64(), jax_entry_levels[1 << cap_height])
    if cap_height == 2:     # entry()'s own call, the JAX cap pinned
        assert caps_sha256([got.to_u64()]) == ENTRY_CAP_SHA256


@pytest.mark.slow
def test_commit_cap_entry_equals_jax_commit_cap():
    """entry()'s cap against the JAX package's fused `commit_cap`, whose
    compile takes over a minute on the CPU (tier-1 holds the port's cap
    to its sha256, ENTRY_CAP_SHA256)."""
    got = commit_cap(GF.from_u64(ENTRY_VALUES), cap_height=2)
    want = jcommit_cap(JGF.from_u64(ENTRY_VALUES), cap_height=2)
    assert np.array_equal(got.to_u64(), want.to_u64())
    assert caps_sha256([want.to_u64()]) == ENTRY_CAP_SHA256


@pytest.mark.cuda
def test_commit_cap_cuda_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    before = dict(poseidon_dense.LAUNCHES)
    got = commit_cap(GF.from_u64(ENTRY_VALUES, dev), cap_height=2)
    assert np.array_equal(got.to_u64(), commit_cap(
        GF.from_u64(ENTRY_VALUES), cap_height=2).to_u64())
    assert all(poseidon_dense.LAUNCHES[k] > before[k] for k in before)
