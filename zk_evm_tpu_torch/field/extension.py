"""Quadratic extension GF(p^2) = F_p[X] / (X^2 - 7).

Elements are pairs (a, b) = a + b*X of GF arrays; W = 7 is the non-residue
plonky2's QuadraticExtension of Goldilocks uses.
"""

from __future__ import annotations

from .gf import GF
from . import goldilocks as gl

W = 7  # non-residue: X^2 = 7

# DTH_ROOT = W^((p-1)/2) = p - 1: the Frobenius constant for D=2.
DTH_ROOT = gl.P - 1


class GFE:
    """Array of GF(p^2) elements as a pair of GF arrays."""

    __slots__ = ("a", "b")

    def __init__(self, a: GF, b: GF):
        self.a = a
        self.b = b

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_base(cls, x: GF) -> "GFE":
        return cls(x, GF.zeros(x.shape, device=x.device))

    @classmethod
    def zeros(cls, shape, device=None) -> "GFE":
        return cls(GF.zeros(shape, device), GF.zeros(shape, device))

    @classmethod
    def ones(cls, shape, device=None) -> "GFE":
        return cls(GF.ones(shape, device), GF.zeros(shape, device))

    @classmethod
    def const(cls, a: int, b: int = 0, shape=(), device=None) -> "GFE":
        return cls(GF.const(a, shape, device), GF.const(b, shape, device))

    def to_u64_pair(self):
        return self.a.to_u64(), self.b.to_u64()

    # -- shape --------------------------------------------------------------
    @property
    def shape(self):
        return self.a.shape

    @property
    def ndim(self):
        return self.a.ndim

    @property
    def device(self):
        return self.a.device

    def reshape(self, *shape) -> "GFE":
        return GFE(self.a.reshape(*shape), self.b.reshape(*shape))

    def __getitem__(self, idx) -> "GFE":
        return GFE(self.a[idx], self.b[idx])

    @staticmethod
    def concatenate(parts, axis=0) -> "GFE":
        return GFE(GF.concatenate([p.a for p in parts], axis=axis),
                   GF.concatenate([p.b for p in parts], axis=axis))

    @staticmethod
    def stack(parts, axis=0) -> "GFE":
        return GFE(GF.stack([p.a for p in parts], axis=axis),
                   GF.stack([p.b for p in parts], axis=axis))

    def broadcast_to(self, shape) -> "GFE":
        return GFE(self.a.broadcast_to(shape), self.b.broadcast_to(shape))

    # -- arithmetic ---------------------------------------------------------
    def _coerce(self, other) -> "GFE":
        if isinstance(other, GFE):
            return other
        if isinstance(other, GF):
            return GFE.from_base(other)
        if isinstance(other, int):
            return GFE.const(other, device=self.device)
        raise TypeError(f"cannot coerce {type(other)} to GFE")

    def __add__(self, other) -> "GFE":
        o = self._coerce(other)
        return GFE(self.a + o.a, self.b + o.b)

    __radd__ = __add__

    def __sub__(self, other) -> "GFE":
        o = self._coerce(other)
        return GFE(self.a - o.a, self.b - o.b)

    def __rsub__(self, other) -> "GFE":
        return self._coerce(other) - self

    def __mul__(self, other) -> "GFE":
        if isinstance(other, GF):
            return GFE(self.a * other, self.b * other)
        o = self._coerce(other)
        # (a + bX)(c + dX) = (ac + 7bd) + (ad + bc)X
        ac = self.a * o.a
        bd = self.b * o.b
        ad = self.a * o.b
        bc = self.b * o.a
        return GFE(ac + bd * W, ad + bc)

    __rmul__ = __mul__

    def __neg__(self) -> "GFE":
        return GFE(-self.a, -self.b)

    def square(self) -> "GFE":
        # (a + bX)^2 = (a^2 + 7 b^2) + 2ab X
        a2 = self.a.square()
        b2 = self.b.square()
        ab = self.a * self.b
        return GFE(a2 + b2 * W, ab + ab)

    def exp(self, e: int) -> "GFE":
        r = GFE.ones(self.shape, self.device)
        base = self
        while e > 0:
            if e & 1:
                r = r * base
            e >>= 1
            if e:
                base = base.square()
        return r

    def inv(self) -> "GFE":
        # (a + bX)^-1 = (a - bX) / (a^2 - 7 b^2)
        norm = self.a.square() - self.b.square() * W
        ninv = norm.inv()
        return GFE(self.a * ninv, -(self.b * ninv))

    def sum(self, axis=None) -> "GFE":
        return GFE(self.a.sum(axis=axis), self.b.sum(axis=axis))

    def select(self, mask, other: "GFE") -> "GFE":
        return GFE(self.a.select(mask, other.a), self.b.select(mask, other.b))

    def is_zero(self):
        return self.a.is_zero() & self.b.is_zero()

    def equals(self, other):
        o = self._coerce(other)
        return self.a.equals(o.a) & self.b.equals(o.b)

    def __repr__(self):
        return f"GFE(a={self.a!r}, b={self.b!r})"
