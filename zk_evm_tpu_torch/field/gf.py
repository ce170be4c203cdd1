"""GF — an array of Goldilocks elements held as one int64 tensor.

The tensor holds the u64 bit pattern of each canonical element. All
arithmetic dispatches to the elementwise ops in ``goldilocks.py``; the
wrapper adds the shape plumbing (indexing, reshape, concatenate, stack,
take) the STARK engine and the table constraint code call, with the same
method surface as the JAX package's GF.
"""

from __future__ import annotations

import numpy as np
import torch

from . import goldilocks as gl


def _pattern(value: int) -> int:
    """A canonical field element as the int64 with the same bit pattern."""
    value %= gl.P
    return value - (1 << 64) if value >= (1 << 63) else value


class GF:
    """An array of Goldilocks field elements (canonical, < p)."""

    __slots__ = ("v",)

    def __init__(self, v: torch.Tensor):
        self.v = v

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_u64(cls, x, device=None) -> "GF":
        return cls(gl.from_u64(x, device))

    @classmethod
    def zeros(cls, shape, device=None) -> "GF":
        return cls(torch.zeros(shape, dtype=torch.int64, device=device))

    @classmethod
    def ones(cls, shape, device=None) -> "GF":
        return cls(torch.ones(shape, dtype=torch.int64, device=device))

    @classmethod
    def const(cls, value: int, shape=(), device=None) -> "GF":
        return cls(torch.full(shape, _pattern(value), dtype=torch.int64,
                              device=device))

    def to_u64(self) -> np.ndarray:
        return gl.to_u64(self.v)

    # -- shape plumbing -----------------------------------------------------
    @property
    def shape(self):
        return tuple(self.v.shape)

    @property
    def ndim(self):
        return self.v.ndim

    @property
    def device(self):
        return self.v.device

    def __len__(self):
        return self.v.shape[0]

    def __iter__(self):
        for i in range(self.v.shape[0]):
            yield self[i]

    def reshape(self, *shape) -> "GF":
        return GF(self.v.reshape(*shape))

    def __getitem__(self, idx) -> "GF":
        return GF(self.v[idx])

    @property
    def T(self) -> "GF":
        return GF(self.v.permute(*reversed(range(self.v.ndim))))

    def broadcast_to(self, shape) -> "GF":
        return GF(torch.broadcast_to(self.v, tuple(shape)))

    @staticmethod
    def concatenate(parts, axis=0) -> "GF":
        return GF(torch.cat([p.v for p in parts], dim=axis))

    @staticmethod
    def stack(parts, axis=0) -> "GF":
        return GF(torch.stack([p.v for p in parts], dim=axis))

    def roll(self, shift, axis=-1) -> "GF":
        return GF(torch.roll(self.v, shift, dims=axis))

    def take(self, indices, axis=0) -> "GF":
        """jnp.take semantics: the index array's shape replaces `axis`.
        `indices` may be a numpy array, a list or a tensor."""
        if not isinstance(indices, torch.Tensor):
            indices = torch.from_numpy(
                np.asarray(indices).astype(np.int64, copy=False))
        idx = indices.to(device=self.v.device, dtype=torch.int64)
        axis = axis % self.v.ndim
        out = torch.index_select(self.v, axis, idx.reshape(-1))
        shape = self.v.shape[:axis] + idx.shape + self.v.shape[axis + 1:]
        return GF(out.reshape(shape))

    # -- arithmetic ---------------------------------------------------------
    def _coerce(self, other) -> "GF":
        if isinstance(other, GF):
            return other
        if isinstance(other, int):
            return GF.const(other, device=self.v.device)
        raise TypeError(f"cannot coerce {type(other)} to GF")

    def __add__(self, other) -> "GF":
        return GF(gl.add(self.v, self._coerce(other).v))

    __radd__ = __add__

    def __sub__(self, other) -> "GF":
        return GF(gl.sub(self.v, self._coerce(other).v))

    def __rsub__(self, other) -> "GF":
        return self._coerce(other) - self

    def __mul__(self, other) -> "GF":
        if isinstance(other, int) and 0 <= other < (1 << 16):
            return GF(gl.mul_small(self.v, other))
        return GF(gl.mul(self.v, self._coerce(other).v))

    __rmul__ = __mul__

    def __neg__(self) -> "GF":
        return GF(gl.neg(self.v))

    def square(self) -> "GF":
        return GF(gl.square(self.v))

    def exp(self, e: int) -> "GF":
        return GF(gl.exp_u64(self.v, e))

    def inv(self) -> "GF":
        return GF(gl.inv(self.v))

    def sum(self, axis=None) -> "GF":
        """Field sum along an axis. The 32-bit halves of the elements are
        summed as exact integers and reduced once; a field sum is the same
        element in any order, so this equals the JAX package's log-tree."""
        v = self.v.reshape(-1) if axis is None else self.v
        dim = 0 if axis is None else axis
        assert v.shape[dim] < (1 << 31), "limb sums would overflow int64"
        s_lo = (v & gl.M32).sum(dim=dim)
        s_hi = ((v >> 32) & gl.M32).sum(dim=dim)
        return GF(gl.reduce_limb_sums(s_lo, s_hi))

    # -- predicates / misc --------------------------------------------------
    def is_zero(self):
        return self.v == 0

    def equals(self, other):
        return self.v == self._coerce(other).v

    def select(self, mask, other: "GF") -> "GF":
        """Where mask (bool array) is true take self, else other."""
        mask = torch.as_tensor(mask, device=self.v.device)
        return GF(torch.where(mask, self.v, other.v))

    def __repr__(self):
        return f"GF({self.to_u64()!r})"
