"""The PyTorch port's Goldilocks GF / GFE against the JAX package's GF and
the exact host twin (python ints), on random and boundary inputs. All
comparisons are exact."""

import functools

import numpy as np
import pytest

from zk_evm_tpu.field import GF as JGF, GFE as JGFE, host
from zk_evm_tpu_torch import convert
from zk_evm_tpu_torch.field import GF, GFE

P = host.P
BOUNDARY = np.array([0, 1, 2, P - 1, P - 2, (1 << 32) - 1, 1 << 32, P >> 1,
                     1 << 63, 0xFFFFFFFF00000000, (1 << 63) - 1,
                     P - (1 << 32)], dtype=np.uint64)
rng = np.random.default_rng(20)

# every pair of boundary values, then random elements
_bx, _by = np.meshgrid(BOUNDARY, BOUNDARY)
A = np.concatenate([_bx.reshape(-1),
                    rng.integers(0, P, size=200, dtype=np.uint64)])
B = np.concatenate([_by.reshape(-1),
                    rng.integers(0, P, size=200, dtype=np.uint64)])


def ints(x):
    return [int(v) for v in np.asarray(x).reshape(-1)]


BINARY = {
    "add": (lambda x, y: x + y, host.fadd),
    "sub": (lambda x, y: x - y, host.fsub),
    "mul": (lambda x, y: x * y, host.fmul),
    "rsub": (lambda x, y: y.__rsub__(x), host.fsub),
}


@pytest.mark.parametrize("op", sorted(BINARY))
def test_binary_op(op):
    fn, ref = BINARY[op]
    got = fn(GF.from_u64(A), GF.from_u64(B)).to_u64()
    jax_got = fn(JGF.from_u64(A), JGF.from_u64(B)).to_u64()
    assert ints(got) == [ref(int(a), int(b)) for a, b in zip(A, B)]
    assert np.array_equal(got, jax_got)


@pytest.mark.parametrize("k", [0, 1, 7, 65535, 1 << 16, 1 << 31, P - 1])
def test_mul_int(k):
    """Small ints take mul_small (gf.py:139-145), others a full multiply."""
    got = (GF.from_u64(A) * k).to_u64()
    jax_got = (JGF.from_u64(A) * k).to_u64()
    assert ints(got) == [host.fmul(int(a), k) for a in A]
    assert np.array_equal(got, jax_got)
    assert np.array_equal((k * GF.from_u64(A)).to_u64(), got)
    assert np.array_equal((GF.from_u64(A) + k).to_u64(),
                          (JGF.from_u64(A) + k).to_u64())


UNARY = {
    "neg": (lambda x: -x, host.fneg),
    "square": (lambda x: x.square(), lambda a: host.fmul(a, a)),
    "exp7": (lambda x: x.exp(7), lambda a: host.fexp(a, 7)),
    "exp_big": (lambda x: x.exp(P - 3), lambda a: host.fexp(a, P - 3)),
    "inv": (lambda x: x.inv(), lambda a: host.finv(a) if a else 0),
}


@pytest.mark.parametrize("op", sorted(UNARY))
def test_unary_op(op):
    fn, ref = UNARY[op]
    x = A[:80]
    got = fn(GF.from_u64(x)).to_u64()
    jax_got = fn(JGF.from_u64(x)).to_u64()
    assert ints(got) == [ref(int(a)) for a in x]
    assert np.array_equal(got, jax_got)


@pytest.mark.parametrize("axis", [None, 0, 1, -1])
def test_sum(axis):
    m = np.concatenate([A[:144], B[:144]]).reshape(12, 24)
    got = GF.from_u64(m).sum(axis=axis).to_u64()
    assert np.array_equal(got, JGF.from_u64(m).sum(axis=axis).to_u64())
    if axis is None:
        assert int(got) == functools.reduce(host.fadd, ints(m))
    else:
        rows = m if axis == 1 or axis == -1 else m.T
        assert ints(got) == [functools.reduce(host.fadd, ints(r))
                             for r in rows]


def test_sum_all_max():
    """Many copies of p - 1: the limb sums carry as far as they can."""
    m = np.full(5000, P - 1, dtype=np.uint64)
    assert int(GF.from_u64(m).sum().to_u64()) == (5000 * (P - 1)) % P


SHAPE_OPS = {
    "take_numpy": lambda G, x: x.take(np.array([[3, 0], [5, 5]]), axis=1),
    "take_rows": lambda G, x: x.take(np.array([4, 1, 1]), axis=0),
    "stack": lambda G, x: G.stack([x[0], x[1], x[2]], axis=1),
    "concatenate": lambda G, x: G.concatenate([x, x[:2]], axis=0),
    "roll": lambda G, x: x.roll(-3, axis=-1),
    "select": lambda G, x: x.select(np.arange(6 * 8).reshape(6, 8) % 3 == 0,
                                    -x),
    "broadcast_to": lambda G, x: x[0].broadcast_to((4, 8)),
    "reshape": lambda G, x: x.reshape(4, 12),
    "T": lambda G, x: x.T,
    "getitem": lambda G, x: x[1:5:2, ::3],
    "row_iter": lambda G, x: G.stack(list(x), axis=0),
}


@pytest.mark.parametrize("op", sorted(SHAPE_OPS))
def test_shape_op(op):
    m = A[:48].reshape(6, 8)
    got = SHAPE_OPS[op](GF, GF.from_u64(m)).to_u64()
    want = SHAPE_OPS[op](JGF, JGF.from_u64(m)).to_u64()
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def test_take_index_types():
    """take accepts numpy indices, lists and tensors alike."""
    import torch
    x = GF.from_u64(A[:48].reshape(6, 8))
    want = x.take(np.array([4, 1, 1]), axis=0).to_u64()
    assert np.array_equal(x.take([4, 1, 1], axis=0).to_u64(), want)
    assert np.array_equal(x.take(torch.tensor([4, 1, 1]), axis=0).to_u64(),
                          want)
    assert np.array_equal(
        x.take(np.array([4, 1, 1], dtype=np.uint32), axis=0).to_u64(), want)


def test_constructors():
    assert np.array_equal(GF.zeros((3, 2)).to_u64(),
                          JGF.zeros((3, 2)).to_u64())
    assert np.array_equal(GF.ones((4,)).to_u64(), JGF.ones((4,)).to_u64())
    for v in (0, 5, P - 1, P, P + 3, 1 << 63, -1):
        assert np.array_equal(GF.const(v, (2,)).to_u64(),
                              JGF.const(v, (2,)).to_u64()), v
    assert np.array_equal(GF.from_u64(A).to_u64(), A)
    assert len(GF.from_u64(A)) == len(A)


def test_predicates():
    x = GF.from_u64(A)
    assert np.array_equal(x.is_zero().numpy(),
                          np.asarray(JGF.from_u64(A).is_zero()))
    assert np.array_equal(x.equals(GF.from_u64(B)).numpy(), A == B)


def test_convert_from_jax_limbs():
    j = JGF.from_u64(A.reshape(-1, 4))
    assert np.array_equal(convert.gf_from_limbs(j).to_u64(), j.to_u64())
    assert np.array_equal(
        convert.u64_from_limbs(np.asarray(j.lo), np.asarray(j.hi)),
        A.reshape(-1, 4))


def _gfe(G, E, a, b):
    return E(G.from_u64(a), G.from_u64(b))


EXT_OPS = {
    "add": (lambda x, y: x + y, host.eadd),
    "sub": (lambda x, y: x - y, host.esub),
    "mul": (lambda x, y: x * y, host.emul),
}


@pytest.mark.parametrize("op", sorted(EXT_OPS))
def test_ext_binary_op(op):
    fn, ref = EXT_OPS[op]
    x, y = A[:100], B[:100]
    xr, yr = B[100:200], A[100:200]
    got = fn(_gfe(GF, GFE, x, xr), _gfe(GF, GFE, y, yr)).to_u64_pair()
    jax_got = fn(_gfe(JGF, JGFE, x, xr), _gfe(JGF, JGFE, y, yr)).to_u64_pair()
    want = [ref((int(a), int(b)), (int(c), int(d)))
            for a, b, c, d in zip(x, xr, y, yr)]
    assert list(zip(ints(got[0]), ints(got[1]))) == want
    assert all(np.array_equal(g, j) for g, j in zip(got, jax_got))


EXT_UNARY = {
    "square": (lambda x: x.square(), lambda v: host.emul(v, v)),
    "inv": (lambda x: x.inv(), host.einv),
    "exp": (lambda x: x.exp(11), lambda v: host.eexp(v, 11)),
    "neg": (lambda x: -x, host.eneg),
    "mul_base": (lambda x: x * x.a, lambda v: host.emul(v, (v[0], 0))),
    "mul_int": (lambda x: x * 9 + 2, lambda v: host.eadd(
        host.escalar(v, 9), (2, 0))),
}


@pytest.mark.parametrize("op", sorted(EXT_UNARY))
def test_ext_unary_op(op):
    fn, ref = EXT_UNARY[op]
    x, xr = A[12:60], B[12:60]          # nonzero norms for inv
    got = fn(_gfe(GF, GFE, x, xr)).to_u64_pair()
    jax_got = fn(_gfe(JGF, JGFE, x, xr)).to_u64_pair()
    want = [ref((int(a), int(b))) for a, b in zip(x, xr)]
    assert list(zip(ints(got[0]), ints(got[1]))) == want
    assert all(np.array_equal(g, j) for g, j in zip(got, jax_got))


def test_ext_sum_select():
    x, xr = A[:64].reshape(8, 8), B[:64].reshape(8, 8)
    e, je = _gfe(GF, GFE, x, xr), _gfe(JGF, JGFE, x, xr)
    for axis in (None, 0, 1):
        got, want = e.sum(axis=axis), je.sum(axis=axis)
        assert all(np.array_equal(g, w) for g, w in
                   zip(got.to_u64_pair(), want.to_u64_pair()))
    mask = (np.arange(64).reshape(8, 8) % 5) == 1
    got = e.select(mask, -e).to_u64_pair()
    want = je.select(mask, -je).to_u64_pair()
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
