"""The planes-layout Poseidon wrappers of the PyTorch port
(`hash/poseidon_pallas.py`): on CPU tensors they compute what the JAX
package's round-3 Pallas kernels compute in interpret mode, at 1024
states and sponge widths 64, 13 and 6 (as tests/test_poseidon_pallas.py),
and launch nothing; the sponge's layout decision (which matrices the
kernel's tensor map reads in place, and the aligned copy of the rest);
the python-int twin of the kernels' 32-bit Goldilocks arithmetic
(`hash/goldilocks32.py`) against the host twin; on a CUDA device the
kernels equal the plain version and the dense kernels, on contiguous
matrices and on views. All exact."""

import numpy as np
import pytest
import torch

from zk_evm_tpu.field import GF as JGF, host
from zk_evm_tpu.hash import poseidon_pallas as jppal
from zk_evm_tpu_torch.field import GF
from zk_evm_tpu_torch.hash import (goldilocks32, host_poseidon, poseidon,
                                   poseidon_dense, poseidon_pallas)

P = host.P
BOUNDARY = np.array([0, 1, P - 1, (1 << 32) - 1, 1 << 32, 1 << 63],
                    dtype=np.uint64)
rng = np.random.default_rng(92)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread runs these small CPU proofs and hashes as fast
    as many and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def test_layout_decision():
    """Read in place: contiguous rows that do not overlap, an even row
    stride, a 16-byte-aligned base (the LDE's layout, any slice of it that
    starts on an even column); anything else is copied."""
    copy_needed = poseidon_pallas.needs_aligned_copy
    base = torch.zeros((13, 2048), dtype=torch.int64)
    assert base.data_ptr() % 16 == 0
    assert not copy_needed(base)                     # the LDE's layout
    assert not copy_needed(base[:, 2:1002])          # 16 bytes on, ld even
    assert not copy_needed(base[3:9])                # a band of planes
    assert copy_needed(base[:, 1:1001])              # base 8 bytes off
    assert copy_needed(torch.zeros((13, 1001), dtype=torch.int64))  # odd ld
    assert copy_needed(torch.zeros((13, 2001), dtype=torch.int64)[:, 4:1004])
    assert copy_needed(torch.zeros((1000, 13), dtype=torch.int64).t())
    assert copy_needed(base[:1, :].expand(13, 2048))  # rows overlap


@pytest.mark.parametrize("ld,first,n_rows", [(1031, 3, 1024),
                                             (1030, 1, 1024),
                                             (1027, 2, 1024)])
def test_sponge_views_equal_jax_interpret(ld, first, n_rows):
    """A view the kernel could not read in place: its aligned copy is what
    the tensor map takes (even ld, aligned base, the same words), and the
    plain path's digests of the view, and of the copy, equal the JAX
    package's of the same leaves."""
    n_cols = 13
    m = rng.integers(0, P, size=(n_cols, ld), dtype=np.uint64)
    view = GF.from_u64(m).v[:, first:first + n_rows]
    assert poseidon_pallas.needs_aligned_copy(view)
    copied = poseidon_pallas.aligned_planes(view)
    assert not poseidon_pallas.needs_aligned_copy(copied)
    assert copied.stride(0) % 2 == 0 and copied.data_ptr() % 16 == 0
    assert torch.equal(copied, view)
    leaves = np.ascontiguousarray(m[:, first:first + n_rows])
    want = jppal.sponge_pallas(JGF.from_u64(leaves), interpret=True).to_u64()
    before = dict(poseidon_pallas.LAUNCHES)
    for x in (view, copied):
        got = poseidon_pallas.sponge_pallas(GF(x)).to_u64()
        assert np.array_equal(got, want)
    assert poseidon_pallas.LAUNCHES == before


WORDS = [0, 1, P - 1, (1 << 32) - 1, 1 << 32, 1 << 63]
LAZY = WORDS + [P, P + 1, (1 << 64) - 1, (1 << 64) - (1 << 32),
                ((1 << 32) - 1) << 32]


@pytest.mark.parametrize("a", LAZY)
def test_gl32_products_exact(a):
    """The 32-bit partial-product sequences and the carry-chain reductions
    on boundary words, lazy ones (any u64) among them: exact mod p, and
    every no-wrap claim of the header holds (the twin asserts them)."""
    for b in LAZY:
        assert goldilocks32.join(*goldilocks32.mul_words(a, b)[:2]) \
            + goldilocks32.join(*goldilocks32.mul_words(a, b)[2:]) \
            * (1 << 64) == a * b
        assert goldilocks32.mul(a, b) % P == a * b % P
        assert goldilocks32.mul(a, b) < 1 << 64
        for c in LAZY:
            assert goldilocks32.mul_add(a, b, c) % P == (a * b + c) % P
    r = goldilocks32.sqr_words(a)
    assert r == goldilocks32.mul_words(a, a)
    assert goldilocks32.sqr(a) % P == a * a % P
    m32 = (1 << 32) - 1
    for h0 in (0, 1, m32):
        assert goldilocks32.reduce_small(a, h0) % P \
            == (a + h0 * (1 << 64)) % P
        for h1 in (0, 1, m32):
            lo = goldilocks32.split(a)
            assert goldilocks32.reduce_words(*lo, h0, h1) % P \
                == (a + (h0 + h1 * (1 << 32)) * (1 << 64)) % P


def test_gl32_accumulator_exact():
    """Twelve products of the largest words: the top word's carries and
    the final borrow correction."""
    for a, b in [((1 << 64) - 1, (1 << 64) - 1), (P - 1, P - 1),
                 (1 << 63, (1 << 64) - 1), (0, 1)]:
        acc = goldilocks32.Acc()
        for _ in range(12):
            acc.mac(a, b)
        assert acc.reduce() % P == 12 * a * b % P


def test_gl32_permutation_equals_host_twin():
    """The planes kernels' arithmetic, the whole permutation: each boundary
    word in every lane, then 64 random states."""
    states = [[w] * 12 for w in WORDS] \
        + [[int(v) for v in row]
           for row in rng.integers(0, P, size=(64, 12), dtype=np.uint64)]
    for s in states:
        assert goldilocks32.permute_gl32(s) == host_poseidon.permute_py(s)


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


@pytest.mark.cuda
@pytest.mark.parametrize("ld,first,n_rows", [(2001, 3, 997), (2000, 1, 999),
                                             (2000, 2, 1000), (1001, 0, 1001),
                                             (4096, 0, 4000)])
def test_sponge_kernel_views(cuda_device, ld, first, n_rows):
    """Odd row strides and sliced views, read through the aligned copy or
    in place (even ld, base 16 bytes on), rows past n_rows never read."""
    base = GF.from_u64(rng.integers(0, P, size=(19, ld), dtype=np.uint64),
                       cuda_device)
    view = GF(base.v[:, first:first + n_rows])
    before = poseidon_pallas.LAUNCHES["sponge"]
    got = poseidon_pallas.sponge_pallas(view).to_u64()
    assert poseidon_pallas.LAUNCHES["sponge"] == before + 1
    assert np.array_equal(got, poseidon.hash_rows_plain(view.T).to_u64())
    assert np.array_equal(got, poseidon_dense.sponge_dense(view).to_u64())
