"""The planes-layout Poseidon wrappers of the PyTorch port
(`hash/poseidon_pallas.py`): on CPU tensors they compute what the JAX
package's round-3 Pallas kernels compute in interpret mode, at 1024
states and sponge widths 64, 13 and 6 (as tests/test_poseidon_pallas.py),
and launch nothing; on a CUDA device the kernels equal the plain version
and the dense kernels. All exact."""

import numpy as np
import pytest
import torch

from zk_evm_tpu.field import GF as JGF, host
from zk_evm_tpu.hash import poseidon_pallas as jppal
from zk_evm_tpu_torch.field import GF
from zk_evm_tpu_torch.hash import poseidon, poseidon_dense, poseidon_pallas

P = host.P
BOUNDARY = np.array([0, 1, P - 1, (1 << 32) - 1, 1 << 32, 1 << 63],
                    dtype=np.uint64)
rng = np.random.default_rng(92)


def rand_states(n):
    s = rng.integers(0, P, size=(n, 12), dtype=np.uint64)
    s[:8] = BOUNDARY[rng.integers(0, len(BOUNDARY), size=(8, 12))]
    return s


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def test_permute_equals_jax_interpret():
    s = rand_states(jppal.TILE)
    want = jppal.permute_pallas(JGF.from_u64(s), interpret=True).to_u64()
    before = dict(poseidon_pallas.LAUNCHES)
    got = poseidon_pallas.permute_pallas(GF.from_u64(s)).to_u64()
    assert np.array_equal(got, want)
    assert np.array_equal(poseidon.permute_plain(GF.from_u64(s)).to_u64(),
                          want)
    assert poseidon_pallas.LAUNCHES == before


@pytest.mark.parametrize("n_cols", [64, 13, 6])
def test_sponge_equals_jax_interpret(n_cols):
    """64: the bench's leaf width; 13: one full chunk and a 5-lane
    trailing overwrite; 6: a single partial chunk."""
    mat_t = rng.integers(0, P, size=(n_cols, jppal.TILE), dtype=np.uint64)
    want = jppal.sponge_pallas(JGF.from_u64(mat_t), interpret=True).to_u64()
    before = dict(poseidon_pallas.LAUNCHES)
    got = poseidon_pallas.sponge_pallas(GF.from_u64(mat_t)).to_u64()
    assert np.array_equal(got, want)
    assert np.array_equal(
        poseidon.hash_rows_plain(GF.from_u64(mat_t.T.copy())).to_u64(), want)
    assert poseidon_pallas.LAUNCHES == before


def test_wrappers_check_shapes():
    with pytest.raises(ValueError):
        poseidon_pallas.permute_pallas(GF.zeros((3, 11)))
    with pytest.raises(ValueError):
        poseidon_pallas.sponge_pallas(GF.zeros((4, 8)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1000, 1 << 18])
def test_permute_kernel_matches_plain(cuda_device, n):
    s = GF.from_u64(rand_states(n), cuda_device)
    before = poseidon_pallas.LAUNCHES["permute"]
    got = poseidon_pallas.permute_pallas(s).to_u64()
    assert poseidon_pallas.LAUNCHES["permute"] == before + 1
    assert np.array_equal(got, poseidon.permute_plain(s).to_u64())
    assert np.array_equal(got, poseidon_dense.permute_dense(s).to_u64())


@pytest.mark.cuda
@pytest.mark.parametrize("n_cols", [5, 6, 8, 13, 17, 32, 64, 523])
@pytest.mark.parametrize("n_rows", [1, 1000, 4096])
def test_sponge_kernel_matches_plain(cuda_device, n_cols, n_rows):
    m = GF.from_u64(rng.integers(0, P, size=(n_cols, n_rows),
                                 dtype=np.uint64), cuda_device)
    before = poseidon_pallas.LAUNCHES["sponge"]
    got = poseidon_pallas.sponge_pallas(m).to_u64()
    assert poseidon_pallas.LAUNCHES["sponge"] == before + 1
    assert np.array_equal(got, poseidon.hash_rows_plain(m.T).to_u64())
    assert np.array_equal(got, poseidon_dense.sponge_dense(m).to_u64())
