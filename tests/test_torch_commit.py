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

P = host.P
rng = np.random.default_rng(23)
ENTRY_VALUES = np.random.default_rng(0).integers(
    0, P, size=(16, 256), dtype=np.uint64)      # entry()'s input


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
    if cap_height == 2:     # entry()'s own call
        want = jcommit_cap(JGF.from_u64(ENTRY_VALUES), cap_height=2)
        assert np.array_equal(got.to_u64(), want.to_u64())


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
