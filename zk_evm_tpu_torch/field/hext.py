"""HExt — host-exact GF(p^2) scalar with operator syntax.

The same constraint-evaluation code runs in two algebras: on device over GF
arrays (whole-LDE vectorized, the prover) and on host over HExt scalars at
the out-of-domain point zeta (the verifier). Anything written against the
shared operator surface (+ - * with int coercion) evaluates identically in
both — that is the packed/ext duality the reference encodes as
eval_packed_generic / eval_ext_circuit pairs (SURVEY.md Appendix B).
"""

from __future__ import annotations

from . import host


class HExt:
    __slots__ = ("v",)

    def __init__(self, v):
        if isinstance(v, HExt):
            self.v = v.v
        elif isinstance(v, int):
            self.v = (v % host.P, 0)
        else:
            a, b = v
            self.v = (int(a), int(b))

    @staticmethod
    def zero() -> "HExt":
        return HExt((0, 0))

    @staticmethod
    def one() -> "HExt":
        return HExt((1, 0))

    def _c(self, o) -> "HExt":
        return o if isinstance(o, HExt) else HExt(o)

    def __add__(self, o):
        return HExt(host.eadd(self.v, self._c(o).v))

    __radd__ = __add__

    def __sub__(self, o):
        return HExt(host.esub(self.v, self._c(o).v))

    def __rsub__(self, o):
        return HExt(host.esub(self._c(o).v, self.v))

    def __mul__(self, o):
        return HExt(host.emul(self.v, self._c(o).v))

    __rmul__ = __mul__

    def __neg__(self):
        return HExt(host.eneg(self.v))

    def square(self) -> "HExt":
        return HExt(host.emul(self.v, self.v))

    def inv(self) -> "HExt":
        return HExt(host.einv(self.v))

    def exp(self, e: int) -> "HExt":
        return HExt(host.eexp(self.v, e))

    def __eq__(self, o):
        return self.v == self._c(o).v

    def __hash__(self):
        return hash(self.v)

    def __repr__(self):
        return f"HExt{self.v}"
