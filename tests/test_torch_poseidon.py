"""The PyTorch port's Poseidon (plain version, CPU tensors) against the JAX
package's `poseidon` on the CPU and the exact host twin; the CUDA kernels
against the plain version where a CUDA device exists. All exact."""

import dataclasses

import numpy as np
import pytest
import torch

from zk_evm_tpu.field import GF as JGF, host
from zk_evm_tpu.hash import host_poseidon as jhp
from zk_evm_tpu.hash import poseidon as jpos
from zk_evm_tpu.hash import poseidon_params as jpp
from zk_evm_tpu_torch.field import GF
from zk_evm_tpu_torch.hash import host_poseidon as hp
from zk_evm_tpu_torch.hash import poseidon, poseidon_dense
from zk_evm_tpu_torch.hash import poseidon_params as pp

P = host.P
BOUNDARY = np.array([0, 1, P - 1, (1 << 32) - 1, 1 << 32, 1 << 63],
                    dtype=np.uint64)
rng = np.random.default_rng(21)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread runs these small CPU proofs and hashes as fast
    as many and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rand_states(n):
    s = rng.integers(0, P, size=(n, pp.WIDTH), dtype=np.uint64)
    k = min(n, 8)
    s[:k] = BOUNDARY[rng.integers(0, len(BOUNDARY), size=(k, pp.WIDTH))]
    return s


def rows(x):
    return [[int(v) for v in r] for r in x]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def test_params_equal_reference():
    """The round constants and MDS are this system's weights."""
    assert dataclasses.astuple(pp.default_params()) == \
        dataclasses.astuple(jpp.default_params())
    assert np.array_equal(pp.round_constants_np(), jpp.round_constants_np())
    assert (pp.WIDTH, pp.RATE, pp.N_ROUNDS) == \
        (jpp.WIDTH, jpp.RATE, jpp.N_ROUNDS)


@pytest.mark.parametrize("n", [1, 5, 37])
def test_permute(n):
    s = rand_states(n)
    got = poseidon.permute(GF.from_u64(s)).to_u64()
    assert np.array_equal(got, jpos.permute(JGF.from_u64(s)).to_u64())
    assert np.array_equal(got, poseidon.permute_plain(GF.from_u64(s)).to_u64())
    assert rows(got) == [hp.permute_py([int(v) for v in r]) for r in s]
    assert rows(got) == [jhp.permute_py([int(v) for v in r]) for r in s]


def test_permute_batch_dims():
    s = rand_states(6).reshape(2, 3, pp.WIDTH)
    got = poseidon.permute(GF.from_u64(s)).to_u64()
    assert got.shape == (2, 3, pp.WIDTH)
    assert np.array_equal(got, jpos.permute(JGF.from_u64(s)).to_u64())


@pytest.mark.parametrize("n_cols", [1, 2, 3, 4, 6, 8, 13, 17, 64, 523])
def test_hash_rows(n_cols):
    n_rows = 5 if n_cols > 100 else 37      # not multiples of 1024
    m = rng.integers(0, P, size=(n_rows, n_cols), dtype=np.uint64)
    m[0, :min(n_cols, len(BOUNDARY))] = BOUNDARY[:n_cols]
    got = poseidon.hash_rows(GF.from_u64(m)).to_u64()
    assert got.shape == (n_rows, 4)
    assert np.array_equal(got, jpos.hash_rows(JGF.from_u64(m)).to_u64())
    assert rows(got[:3]) == [jhp.hash_or_noop([int(v) for v in r])
                             for r in m[:3]]
    assert rows(got[:3]) == [hp.hash_or_noop([int(v) for v in r])
                             for r in m[:3]]


def test_hash_rows_reads_transposed_view():
    """hash_rows(lde.T) on a (n_cols, n_rows) tensor: the sponge wrapper
    reads the view; the result equals hashing a contiguous copy."""
    lde = GF.from_u64(rng.integers(0, P, size=(13, 9), dtype=np.uint64))
    view = poseidon.hash_rows(lde.T).to_u64()
    copy = poseidon.hash_rows(GF(lde.T.v.contiguous())).to_u64()
    assert np.array_equal(view, copy)


def test_compress():
    left = rng.integers(0, P, size=(7, 4), dtype=np.uint64)
    right = rng.integers(0, P, size=(7, 4), dtype=np.uint64)
    got = poseidon.compress(GF.from_u64(left), GF.from_u64(right)).to_u64()
    want = jpos.compress(JGF.from_u64(left), JGF.from_u64(right)).to_u64()
    assert np.array_equal(got, want)
    assert rows(got) == [hp.two_to_one([int(v) for v in a],
                                       [int(v) for v in b])
                         for a, b in zip(left, right)]


def test_wrappers_check_shapes():
    with pytest.raises(ValueError):
        poseidon_dense.permute_dense(GF.zeros((3, 11)))
    with pytest.raises(ValueError):
        poseidon_dense.sponge_dense(GF.zeros((4, 8)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1000, 1 << 18])
def test_permute_kernel_matches_plain(cuda_device, n):
    s = GF.from_u64(rand_states(n), cuda_device)
    before = poseidon_dense.LAUNCHES["permute"]
    got = poseidon_dense.permute_dense(s).to_u64()
    assert poseidon_dense.LAUNCHES["permute"] == before + 1
    assert np.array_equal(got, poseidon.permute_plain(s).to_u64())


@pytest.mark.cuda
@pytest.mark.parametrize("n_cols", [5, 6, 8, 13, 17, 32, 64, 523])
@pytest.mark.parametrize("n_rows", [1, 1000, 4096])
def test_sponge_kernel_matches_plain(cuda_device, n_cols, n_rows):
    m = GF.from_u64(rng.integers(0, P, size=(n_cols, n_rows),
                                 dtype=np.uint64), cuda_device)
    before = poseidon_dense.LAUNCHES["sponge"]
    got = poseidon_dense.sponge_dense(m).to_u64()
    assert poseidon_dense.LAUNCHES["sponge"] == before + 1
    assert np.array_equal(got, poseidon.hash_rows_plain(m.T).to_u64())
    # a row-major matrix goes through the strides, not a copy
    row_major = GF(m.v.T.contiguous())
    assert np.array_equal(poseidon.hash_rows(row_major).to_u64(), got)


@pytest.mark.cuda
def test_kernels_on_boundary_states(cuda_device):
    """States made of one boundary value in every lane, through the
    fast partial-round kernels: equal to the plain version and the host
    twin; the sponge over leaves of those words likewise."""
    s = np.repeat(BOUNDARY[:, None], pp.WIDTH, axis=1)
    got = poseidon_dense.permute_dense(GF.from_u64(s, cuda_device)).to_u64()
    assert np.array_equal(got, poseidon.permute_plain(GF.from_u64(s))
                          .to_u64())
    assert rows(got) == [hp.permute_py([int(v) for v in r]) for r in s]
    for n_cols in (5, 8, 13, 30):
        m = np.repeat(BOUNDARY[:, None], n_cols, axis=1)   # (6, n_cols)
        mt = GF.from_u64(np.ascontiguousarray(m.T), cuda_device)
        got = poseidon_dense.sponge_dense(mt).to_u64()
        assert rows(got) == [hp.hash_or_noop([int(v) for v in r]) for r in m]


def test_host_permute_native_equals_python():
    """host_poseidon.permute runs the native library's permutation (the
    JAX package's dispatch); it equals the pure-python twin and the JAX
    package's on boundary and random states."""
    from zk_evm_tpu_torch import native
    assert native.available()
    for s in rows(rand_states(32)):
        want = hp.permute_py(s)
        assert hp.permute(s) == want == jhp.permute(s)
