"""The port's parallel layer on CPU meshes: `sharded_commit_cap`,
`PolynomialBatch.from_values(mesh=)` and the trees over row blocks, the
refusals, `fft_bitrev`/`coset_fft`, the entry twins (`entry()`,
`dryrun_multichip`) and the launch counts under threads. Exact.

A mesh of k entries that all name `cpu` runs the code a mesh of k cards
runs: the polys split, one LDE a group, the all-to-all of row blocks, a
subtree an entry, the gathers onto the first entry. The JAX package's
sharded caps and `entry()` cap take minutes of XLA compiles over its
8-device virtual mesh, so they are pinned as sha256 constants that the
`slow` tests recompute."""

import hashlib
import sys
import threading

import numpy as np
import pytest
import torch

from zk_evm_tpu.field import GF as JGF, host
from zk_evm_tpu.ntt import ntt as jntt
from zk_evm_tpu_torch import cuda_build, ntt
from zk_evm_tpu_torch.entry import dryrun_multichip, entry
from zk_evm_tpu_torch.field import GF
from zk_evm_tpu_torch.merkle import build_commitment_tree
from zk_evm_tpu_torch.parallel import (Mesh, commit_cap, make_mesh,
                                       sharded_commit_cap)
from zk_evm_tpu_torch.stark import prove_stark
from zk_evm_tpu_torch.stark.multi import table_devices
from zk_evm_tpu_torch.stark.poly_batch import PolynomialBatch

P = host.P
CAP_VALUES = np.random.default_rng(29).integers(0, P, size=(8, 16),
                                                dtype=np.uint64)
CAP_HEIGHTS = range(5)
# sha256 over the little-endian bytes of the JAX package's
# sharded_commit_cap(CAP_VALUES, make_mesh(8), cap_height=h), h = 0..4 in
# turn, made on its 8-device CPU mesh
SHARDED_CAPS_SHA256 = (
    "6b2736111c6810441ab1b99fc57008acc58a1fbad65092c11559ebbd825f3f8f")
# sha256 over the little-endian bytes of the cap that the JAX package's
# `__graft_entry__.entry()` computes
ENTRY_CAP_SHA256 = (
    "b0f3393b02e6e4420824c4e65c743ba068d2ec332c296abb4cac9e8e077612f8")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The CPU work here is small: one intra-op thread runs it faster
    than many and leaves the cores to the other test workers.
    Inference mode spares every small op autograd's bookkeeping."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.inference_mode():
        yield
    torch.set_num_threads(n)


def cpu_mesh(k: int) -> Mesh:
    return make_mesh(k, device_type="cpu")


def caps_sha256(caps) -> str:
    return hashlib.sha256(b"".join(
        np.ascontiguousarray(c, dtype="<u8").tobytes()
        for c in caps)).hexdigest()


@pytest.fixture(scope="module")
def single_caps():
    values = GF.from_u64(CAP_VALUES)
    return {h: commit_cap(values, cap_height=h).to_u64()
            for h in CAP_HEIGHTS}


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_sharded_cap_equals_commit_cap(k, single_caps):
    """Meshes of 1-8 entries at cap heights 0-4: with 64 leaves over 8
    entries the cap has fewer entries than the mesh at heights 0-2 and
    more at height 4. Every cap equals `commit_cap`'s; together they
    hash to the JAX package's sharded caps."""
    values = GF.from_u64(CAP_VALUES)
    caps = []
    for h in CAP_HEIGHTS:
        cap = sharded_commit_cap(values, cpu_mesh(k), cap_height=h)
        assert cap.device.type == "cpu"
        caps.append(cap.to_u64())
        assert np.array_equal(caps[-1], single_caps[h]), (k, h)
    assert caps_sha256(caps) == SHARDED_CAPS_SHA256


@pytest.mark.slow
def test_jax_sharded_caps_pinned():
    """The pinned constant is the JAX package's sharded caps over its
    8-device mesh."""
    from zk_evm_tpu.parallel import (make_mesh as jmake_mesh,
                                     sharded_commit_cap as jsharded)
    mesh = jmake_mesh(8)
    caps = [jsharded(JGF.from_u64(CAP_VALUES), mesh, cap_height=h).to_u64()
            for h in CAP_HEIGHTS]
    assert caps_sha256(caps) == SHARDED_CAPS_SHA256


@pytest.mark.parametrize("polys", [1, 3, 12])
def test_sharded_cap_uneven_polys(polys):
    """Polys that do not divide over the mesh (fewer than its entries
    among them) split into uneven contiguous groups: the same cap."""
    values = GF.from_u64(np.random.default_rng(polys).integers(
        0, P, size=(polys, 16), dtype=np.uint64))
    want = commit_cap(values, cap_height=2).to_u64()
    for k in (4, 8):
        got = sharded_commit_cap(values, cpu_mesh(k), cap_height=2)
        assert np.array_equal(got.to_u64(), want), k


@pytest.mark.parametrize("hasher", ["poseidon", "keccak"])
def test_from_values_mesh_equals_single(hasher):
    """The mesh batch has the single-device batch's values, coeffs, LDE,
    tree levels, openings and leaves, all on the mesh's first entry."""
    values = GF.from_u64(np.random.default_rng(31).integers(
        0, P, size=(13, 32), dtype=np.uint64))
    one = PolynomialBatch.from_values(values, rate_bits=1, cap_height=2,
                                      hasher=hasher)
    many = PolynomialBatch.from_values(values, rate_bits=1, cap_height=2,
                                       hasher=hasher, mesh=cpu_mesh(4))
    for a, b in [(one.values, many.values), (one.coeffs, many.coeffs),
                 (one.lde, many.lde)]:
        assert np.array_equal(a.to_u64(), b.to_u64())
    assert len(one.tree.levels) == len(many.tree.levels)
    for a, b in zip(one.tree.levels, many.tree.levels):
        assert np.array_equal(a.to_u64(), b.to_u64())
    idx = [0, 7, 21, 63, 7]
    assert many.tree.prove_many(idx) == one.tree.prove_many(idx)
    assert np.array_equal(many.tree.leaves_at(idx), one.tree.leaves_at(idx))
    assert many.cap_ints() == one.cap_ints()


@pytest.mark.parametrize("hasher", ["poseidon", "keccak"])
@pytest.mark.parametrize("n_leaves", [4, 64])
def test_commitment_tree_mesh(hasher, n_leaves):
    """A tree over a mesh, the FRI commit phase's, equals the
    single-device tree, also with fewer leaves than mesh entries."""
    leaves = GF.from_u64(np.random.default_rng(n_leaves).integers(
        0, P, size=(n_leaves, 8), dtype=np.uint64))
    one = build_commitment_tree(leaves, 1, hasher)
    many = build_commitment_tree(leaves, 1, hasher, mesh=cpu_mesh(8))
    for a, b in zip(one.levels, many.levels):
        assert np.array_equal(a.to_u64(), b.to_u64())
    assert len(one.levels) == len(many.levels)


def test_keccak_host_refuses_mesh():
    values = GF.from_u64(CAP_VALUES)
    with pytest.raises(ValueError, match="keccak_host"):
        PolynomialBatch.from_values(values, hasher="keccak_host",
                                    mesh=cpu_mesh(2))
    with pytest.raises(ValueError, match="keccak_host"):
        PolynomialBatch.from_coeffs(values, hasher="keccak_host",
                                    mesh=cpu_mesh(2))
    with pytest.raises(ValueError, match="keccak_host"):
        build_commitment_tree(values.T, 1, "keccak_host", mesh=cpu_mesh(2))


@pytest.mark.parametrize("n", [0, 3, 6])
def test_mesh_size_must_be_power_of_two(n):
    with pytest.raises(ValueError, match="power of two"):
        Mesh(["cpu"] * n)


def test_make_mesh():
    mesh = make_mesh(8, device_type="cpu")
    assert len(mesh) == 8
    assert all(d == torch.device("cpu") for d in mesh)
    # more cards than the host has: no fallback, on any host
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="CUDA devices"):
        make_mesh(have + 1)
    with pytest.raises(ValueError, match="device_type"):
        make_mesh(2, device_type="tpu")


def test_mesh_and_other_device_refused():
    from test_torch_parallel_prove import WideStark, wide_trace, wide_cfg
    from zk_evm_tpu_torch.challenger import Challenger
    with pytest.raises(ValueError, match="mesh's first device"):
        prove_stark(WideStark(), wide_trace(8), wide_cfg(), Challenger(),
                    device="cuda", mesh=cpu_mesh(2))


BOUNDARY = (0, 1, P - 1, (1 << 32) - 1, 1 << 32)


def ntt_inputs(log_n: int) -> np.ndarray:
    rng = np.random.default_rng(log_n)
    x = rng.integers(0, P, size=(3, 1 << log_n), dtype=np.uint64)
    x[0] = np.array(BOUNDARY, dtype=np.uint64)[
        np.arange(1 << log_n) % len(BOUNDARY)]
    x[1, :] = P - 1
    return x


@pytest.mark.parametrize("log_n", [0, 1, 5, 6])
def test_fft_bitrev_and_coset_fft_equal_jax(log_n):
    x = ntt_inputs(log_n)
    for fn, jfn in [(ntt.fft_bitrev, jntt.fft_bitrev),
                    (ntt.coset_fft, jntt.coset_fft)]:
        got = fn(GF.from_u64(x)).to_u64()
        assert np.array_equal(got, jfn(JGF.from_u64(x)).to_u64()), fn
    # fft_bitrev is fft in bit-reversed order
    assert np.array_equal(
        ntt.bit_reverse(ntt.fft_bitrev(GF.from_u64(x))).to_u64(),
        ntt.fft(GF.from_u64(x)).to_u64())


def test_entry_cap():
    fn, args = entry("cpu")
    cap = fn(*args)
    assert tuple(cap.shape) == (4, 4) and cap.device.type == "cpu"
    want = commit_cap(GF.from_u64(np.random.default_rng(0).integers(
        0, P, size=(16, 256), dtype=np.uint64)), cap_height=2)
    assert torch.equal(cap, want.v)
    assert caps_sha256([GF(cap).to_u64()]) == ENTRY_CAP_SHA256


@pytest.mark.slow
def test_jax_entry_cap_pinned():
    import __graft_entry__
    fn, args = __graft_entry__.entry()
    lo, hi = fn(*args)
    cap = np.asarray(lo).astype(np.uint64) \
        | (np.asarray(hi).astype(np.uint64) << np.uint64(32))
    assert caps_sha256([cap]) == ENTRY_CAP_SHA256


def test_entry_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_dryrun_multichip_needs_the_cards():
    """A cuda dryrun builds its mesh with `make_mesh`: more entries than
    cards raise, and a mesh of another size is refused."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="CUDA devices"):
        dryrun_multichip(have + 1, device_type="cuda")
    with pytest.raises(ValueError, match="mesh of 2 entries"):
        dryrun_multichip(4, mesh=cpu_mesh(2))


def test_parallel_commit_devices_are_indexed(monkeypatch):
    """A `cuda` device with no index names the caller's current card: the
    tables' devices carry that index, since a pool thread starts on
    card 0."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    cuda = torch.device("cuda")
    assert table_devices(3, cuda, None) == [torch.device("cuda", 1)] * 3
    assert table_devices(3, None, ["cuda", "cuda:0"]) == [
        torch.device("cuda", 1), torch.device("cuda", 0),
        torch.device("cuda", 1)]
    assert table_devices(2, torch.device("cpu"), None) == [
        torch.device("cpu")] * 2


def test_dryrun_multichip_8(capsys):
    dryrun_multichip(8)
    out = capsys.readouterr().out
    assert "sharded commit cap matches single-device cap (4 digests)" in out
    assert "bit-identical over the mesh and verified" in out


def test_launch_counts_exact_under_threads():
    """`count_launch` is the one way a wrapper counts: more threads than
    cores adding at once, switching often, lose no count."""
    counts = {"k": 0}

    def add():
        for _ in range(5000):
            cuda_build.count_launch(counts, "k")

    threads = [threading.Thread(target=add) for _ in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert counts["k"] == 16 * 5000
