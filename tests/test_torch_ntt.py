"""The PyTorch port's NTT / LDE against the JAX package's `ntt` (plain XLA
on the CPU), exact, for logn 1..10; outputs in the Pease network's
bit-reversed order."""

import numpy as np
import pytest

from zk_evm_tpu import ntt as jntt
from zk_evm_tpu.field import GF as JGF, host
from zk_evm_tpu_torch import ntt
from zk_evm_tpu_torch.field import GF

P = host.P
rng = np.random.default_rng(22)

FUNCS = {
    "fft": lambda m, x: m.fft(x),
    "ifft": lambda m, x: m.ifft(x),
    "bit_reverse": lambda m, x: m.bit_reverse(x),
    "lde_bitrev": lambda m, x: m.lde_bitrev(x, rate_bits=1),
    "lde_from_coeffs_bitrev":
        lambda m, x: m.lde_from_coeffs_bitrev(x, rate_bits=1),
    "coset_ifft_from_bitrev": lambda m, x: m.coset_ifft_from_bitrev(x),
}


@pytest.mark.parametrize("logn", range(1, 11))
@pytest.mark.parametrize("func", sorted(FUNCS))
def test_matches_jax(func, logn):
    x = rng.integers(0, P, size=(3, 1 << logn), dtype=np.uint64)
    x[0, :4] = [0, 1, P - 1, 1 << 32][:x.shape[1]]
    got = FUNCS[func](ntt, GF.from_u64(x)).to_u64()
    want = FUNCS[func](jntt, JGF.from_u64(x)).to_u64()
    assert got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("logn", [1, 6])
def test_lde_rate2_matches_jax(logn):
    x = rng.integers(0, P, size=(2, 1 << logn), dtype=np.uint64)
    got = ntt.lde_bitrev(GF.from_u64(x), rate_bits=2).to_u64()
    want = jntt.lde_bitrev(JGF.from_u64(x), rate_bits=2).to_u64()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("logn", [0, 3, 6])
def test_against_host_oracle(logn):
    c = rng.integers(0, P, size=1 << logn, dtype=np.uint64)
    ci = [int(v) for v in c]
    assert [int(v) for v in ntt.fft(GF.from_u64(c)).to_u64()] == \
        jntt.host_ntt.fft(ci)
    lde = ntt.lde_bitrev(GF.from_u64(c), rate_bits=1).to_u64()
    assert [int(v) for v in lde] == jntt.host_ntt.bit_reverse(
        jntt.host_ntt.lde(ci, 1, host.MULT_GENERATOR))
    assert np.array_equal(ntt.ifft(ntt.fft(GF.from_u64(c))).to_u64(), c)
