"""The fast partial-round form of the port's Poseidon
(`zk_evm_tpu_torch/hash/poseidon_fast.py`), whose constants the CUDA
kernels run: the derived constants have their shapes and are field
elements, and its python-int permutation equals the port's host twin and
the JAX package's `poseidon.permute` on the CPU, on states made of one
boundary value in every lane and on 64 seeded random states. Exact.

Also the pure helpers the chip measurements rest on: the restated bound,
the ptxas report parser and the SASS per-permutation count."""

import numpy as np
import pytest

from zk_evm_tpu.field import GF as JGF
from zk_evm_tpu.hash import poseidon as jpos
from zk_evm_tpu_torch import bench, cuda_build, poseidon_ab
from zk_evm_tpu_torch.hash import host_poseidon as hp
from zk_evm_tpu_torch.hash import poseidon_fast as pf

P = pf.P
BOUNDARY = (0, 1, P - 1, (1 << 32) - 1, 1 << 32, 1 << 63)


def states():
    uniform = [[v] * 12 for v in BOUNDARY]
    rng = np.random.default_rng(33)
    rand = rng.integers(0, P, size=(64, 12), dtype=np.uint64)
    return uniform + [[int(v) for v in r] for r in rand]


def test_constant_shapes():
    c = pf.fast_constants()
    assert len(c["FIRST_CONSTANTS"]) == 12
    assert [len(r) for r in c["INITIAL_MATRIX"]] == [11] * 11
    assert len(c["PARTIAL_CONSTANTS"]) == 22
    assert c["PARTIAL_CONSTANTS"][-1] == 0      # nothing follows round 22
    assert [len(r) for r in c["W_HATS"]] == [11] * 22
    assert [len(r) for r in c["VS"]] == [11] * 22
    flat = pf.fast_constants_np()
    assert flat.shape == (12 + 121 + 22 + 242 + 242,)
    assert all(0 <= int(v) < P for v in flat)


def test_mat_inv():
    m = [row[1:] for row in pf.mds_matrix()[1:]]
    inv = pf.mat_inv(m)
    prod = [[sum(a * b for a, b in zip(row, col)) % P for col in zip(*inv)]
            for row in m]
    assert prod == [[int(i == j) for j in range(11)] for i in range(11)]
    with pytest.raises(ValueError):
        pf.mat_inv([[1, 2], [2, 4]])


def test_permute_fast_equals_host_and_jax():
    s = states()
    got = [pf.permute_fast(row) for row in s]
    assert got == [hp.permute(row) for row in s]
    want = jpos.permute(JGF.from_u64(np.array(s, dtype=np.uint64))).to_u64()
    assert got == [[int(v) for v in r] for r in want]


def test_permute_fast_checks_width():
    with pytest.raises(ValueError):
        pf.permute_fast([0] * 11)


def test_bound_counts_fast_form():
    # 472 S-box products, 8 dense MDS layers, the initial matrix and 22
    # sparse layers, in 32-bit multiply-adds
    assert bench.IMAD_PER_PERMUTATION == 1888 + 2304 + 484 + 1980
    ms, by = bench.poseidon_bound_ms(*bench.permute_work(1 << 18), 1980.0,
                                     132)
    assert by == "operations"
    assert ms == pytest.approx((1 << 18) * 6656 / (132 * 64 * 1.98e9) * 1e3)
    assert bench.sponge_work(30, 8) == (8 * 4, 34 * 8 * 8)


def test_ptxas_report_and_sass_count():
    report = (
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_123poseidon_permute_kernelEPKmPml' for 'sm_90a'\n"
        "ptxas info    : Function properties for x\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 168 registers, 384 bytes cmem[0]\n")
    res = cuda_build.kernel_resources(report)
    (name, usage), = res.items()
    assert poseidon_ab.kernel_of(name) == "poseidon_permute"
    assert usage == {"registers": 168, "spill_stores": 8, "spill_loads": 4}
    assert poseidon_ab.kernel_of(
        "_ZN12_GLOBAL__N_130poseidon_planes_permute_kernelEPKmPmll") \
        == "poseidon_pallas_permute"
    # three loops whose bodies (branch included) are 2, 3 and 2
    # instructions, run 4, 22 and 4 times; two instructions outside them;
    # the closing self-branch and a NOP, which are not counted
    instrs = [(0x00, "IMAD", None),
              (0x10, "IADD3", None), (0x20, "BRA", 0x10),
              (0x30, "LOP3.LUT", None), (0x40, "IMAD.WIDE.U32", None),
              (0x50, "BRA", 0x30),
              (0x60, "SHF.R.U32.HI", None), (0x70, "BRA", 0x60),
              (0x80, "EXIT", None), (0x90, "BRA", 0x90), (0xa0, "NOP", None)]
    counts = poseidon_ab.per_permutation(instrs)
    assert counts["total"] == 1 + 2 * 4 + 3 * 22 + 2 * 4 + 1
    assert counts["integer"] == 1 + 1 * 4 + 2 * 22 + 1 * 4
    assert counts["imad"] == 1 + 1 * 22
    assert poseidon_ab.per_permutation(instrs[:3])["total"] is None
