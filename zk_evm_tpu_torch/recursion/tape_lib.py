"""Tape-level building blocks for the verification program: quadratic
extension arithmetic, hint-backed inverses, bit decompositions,
select-by-index, and the Fiat-Shamir challenger replay.

Everything here appends ops to a recursion.vm.Tape; the concrete values
are computed as the program is laid down, so a tape both IS the program
(known columns) and carries the witness. Semantics mirror the host twins
exactly: challenger/challenger.py (duplex order, pop-last squeeze),
field/host.py ext ops (x^2 = 7), merkle/host.py path walks.
"""

from __future__ import annotations

from ..field import host
from ..hash import poseidon_params as pp
from .vm import Cell, Tape

P = host.P
W_EXT = 7
RATE = pp.RATE
WIDTH = pp.WIDTH


class ECell:
    """Extension element as a pair of RAM cells.

    Carries its tape so it can overload +,-,* against ECell / base Cell /
    int — the same operator surface as HExt, which lets the child
    stark.eval and ConstraintConsumer run UNCHANGED on the tape algebra
    (the whole point of the verifier AIR: one constraint system, three
    algebras — GF vectors, HExt scalars, tape cells)."""

    __slots__ = ("a", "b", "t")

    def __init__(self, a: Cell, b: Cell, t: Tape | None = None):
        self.a = a
        self.b = b
        self.t = t

    def _tape(self, other=None) -> Tape:
        if self.t is not None:
            return self.t
        if isinstance(other, ECell) and other.t is not None:
            return other.t
        raise ValueError("ECell without tape in operator position")

    def __add__(self, other):
        t = self._tape(other)
        if isinstance(other, ECell):
            return ECell(t.add(self.a, other.a), t.add(self.b, other.b), t)
        if isinstance(other, Cell):
            return ECell(t.add(self.a, other), self.b, t)
        return ECell(t.scale(self.a, 1, c1=int(other) % P), self.b, t)

    __radd__ = __add__

    def __sub__(self, other):
        t = self._tape(other)
        if isinstance(other, ECell):
            return ECell(t.sub(self.a, other.a), t.sub(self.b, other.b), t)
        if isinstance(other, Cell):
            return ECell(t.sub(self.a, other), self.b, t)
        return ECell(t.scale(self.a, 1, c1=(-int(other)) % P), self.b, t)

    def __rsub__(self, other):
        t = self._tape(other)
        neg_b = t.scale(self.b, P - 1)
        if isinstance(other, ECell):
            return other - self
        if isinstance(other, Cell):
            return ECell(t.arith(self.a, t.one(), other, c2=P - 1, c0=1),
                         neg_b, t)
        return ECell(t.scale(self.a, P - 1, c1=int(other) % P), neg_b, t)

    def __neg__(self):
        t = self._tape()
        return ECell(t.scale(self.a, P - 1), t.scale(self.b, P - 1), t)

    def __mul__(self, other):
        t = self._tape(other)
        if isinstance(other, ECell):
            return e_mul(t, self, other)
        if isinstance(other, Cell):
            return ECell(t.mul(self.a, other), t.mul(self.b, other), t)
        k = int(other) % P
        return ECell(t.scale(self.a, k), t.scale(self.b, k), t)

    __rmul__ = __mul__


# -- extension arithmetic ------------------------------------------------------

def e_from_base(t: Tape, c: Cell) -> ECell:
    return ECell(c, t.zero(), t)


def e_const(t: Tape, v: tuple[int, int]) -> ECell:
    return ECell(t.const(v[0]), t.const(v[1]), t)


def e_load(t: Tape, v: tuple[int, int]) -> ECell:
    return ECell(t.load(v[0]), t.load(v[1]), t)


def e_value(t: Tape, x: ECell) -> tuple[int, int]:
    return (t.value(x.a), t.value(x.b))


def e_add(t: Tape, x: ECell, y: ECell) -> ECell:
    return ECell(t.add(x.a, y.a), t.add(x.b, y.b), t)


def e_sub(t: Tape, x: ECell, y: ECell) -> ECell:
    return ECell(t.sub(x.a, y.a), t.sub(x.b, y.b), t)


def e_mul(t: Tape, x: ECell, y: ECell) -> ECell:
    """(a+bX)(c+dX) = (ac + 7bd) + (ad + bc)X — 4 rows."""
    bd = t.mul(x.b, y.b)
    r0 = t.arith(x.a, y.a, bd, c2=1, c0=W_EXT)
    ad = t.mul(x.a, y.b)
    r1 = t.arith(x.b, y.a, ad, c2=1, c0=1)
    return ECell(r0, r1, t)


def e_scalar(t: Tape, x: ECell, k: int) -> ECell:
    return ECell(t.scale(x.a, k), t.scale(x.b, k), t)


def e_mul_base(t: Tape, x: ECell, c: Cell) -> ECell:
    return ECell(t.mul(x.a, c), t.mul(x.b, c), t)


def e_assert_eq(t: Tape, x: ECell, y: ECell) -> None:
    t.assert_eq(x.a, y.a)
    t.assert_eq(x.b, y.b)


def e_inv(t: Tape, x: ECell) -> ECell:
    """Hint-backed inverse: load 1/x, assert x * inv == 1."""
    xv = e_value(t, x)
    inv = host.einv(xv) if xv != (0, 0) else (0, 0)
    assert xv != (0, 0), "tape ext inverse of zero"
    ic = e_load(t, inv)
    prod = e_mul(t, x, ic)
    e_assert_eq(t, prod, e_const(t, (1, 0)))
    return ic


def e_div(t: Tape, x: ECell, y: ECell) -> ECell:
    return e_mul(t, x, e_inv(t, y))


# -- bits ----------------------------------------------------------------------

def decompose_bits(t: Tape, c: Cell, nbits: int) -> list[Cell]:
    """Hint-load nbits bits of value(c), assert booleanity and exact
    recomposition (sound only when nbits < 64 so no wrap past p is
    representable; the recomposed range [0, 2^nbits) is then unique)."""
    assert nbits < 64
    v = t.value(c)
    assert v < (1 << nbits), f"value {v} exceeds {nbits} bits"
    bits = []
    for i in range(nbits):
        b = t.load((v >> i) & 1)
        t.assert_bool(b)
        bits.append(b)
    acc = t.scale(bits[0], 1)
    for i in range(1, nbits):
        acc = t.arith(bits[i], t.one(), acc, c2=1 << i, c0=1)
    t.assert_eq(acc, c)
    return bits


def select(t: Tape, bit: Cell, a: Cell, b: Cell) -> Cell:
    return t.sel(bit, a, b)


def select_by_bits(t: Tape, bits: list[Cell], items: list) -> object:
    """Binary-tree select of items[index] where index = sum bits<<i.
    Items may be Cells or (recursively) lists/tuples of Cells."""
    cur = list(items)
    for b in bits:
        nxt = []
        for i in range(0, len(cur), 2):
            lo = cur[i]
            hi = cur[i + 1] if i + 1 < len(cur) else lo
            nxt.append(_sel_rec(t, b, hi, lo))
        cur = nxt
    assert len(cur) == 1
    return cur[0]


def _sel_rec(t: Tape, bit: Cell, a, b):
    if isinstance(a, Cell):
        return t.sel(bit, a, b)
    if isinstance(a, ECell):
        return ECell(t.sel(bit, a.a, b.a), t.sel(bit, a.b, b.b), t)
    return type(a)(_sel_rec(t, bit, x, y) for x, y in zip(a, b))


def sponge_hash(t: Tape, cells: list[Cell]) -> list[Cell]:
    """hash_no_pad twin (hash/host_poseidon.py:57): overwrite-mode
    rate-8 sponge, 4-cell digest. Used to compress a large statement
    (e.g. a block's 2217 public-value elements) into 4 bindable public
    inputs; the outer verifier recomputes the digest on host."""
    state = [t.zero()] * WIDTH
    for off in range(0, len(cells), RATE):
        chunk = cells[off:off + RATE]
        state = list(chunk) + state[len(chunk):]
        state = t.pose(state)
    return state[:4]


# -- challenger ---------------------------------------------------------------

class TapeChallenger:
    """Byte-for-byte replay of challenger/challenger.py on the tape."""

    def __init__(self, t: Tape):
        self.t = t
        z = t.zero()
        self.state: list[Cell] = [z] * WIDTH
        self.input_buffer: list[Cell] = []
        self.output_buffer: list[Cell] = []

    def observe(self, c: Cell) -> None:
        self.output_buffer.clear()
        self.input_buffer.append(c)
        if len(self.input_buffer) == RATE:
            self._duplex()

    def observe_many(self, cs) -> None:
        for c in cs:
            self.observe(c)

    def observe_extension(self, e: ECell) -> None:
        self.observe(e.a)
        self.observe(e.b)

    def observe_cap(self, cap_cells) -> None:
        for digest in cap_cells:
            self.observe_many(digest)

    def get_challenge(self) -> Cell:
        if self.input_buffer or not self.output_buffer:
            self._duplex()
        return self.output_buffer.pop()

    def get_n_challenges(self, n: int) -> list[Cell]:
        return [self.get_challenge() for _ in range(n)]

    def get_extension_challenge(self) -> ECell:
        a = self.get_challenge()
        b = self.get_challenge()
        return ECell(a, b, self.t)

    def compact(self) -> list[Cell]:
        """Flush pending observations (challenger.compact twin)."""
        if self.input_buffer:
            self._duplex()
        self.output_buffer.clear()
        return list(self.state)

    def _duplex(self) -> None:
        for i, c in enumerate(self.input_buffer):
            self.state[i] = c
        self.input_buffer.clear()
        self.state = self.t.pose(self.state)
        self.output_buffer = self.state[:RATE]
