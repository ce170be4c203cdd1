"""Rvm: the verifier VM — a straight-line machine whose trace is the
execution of this package's own STARK verifier (the JAX package's
stark/DESIGN.md "L2 recursion / aggregation roadmap", step 2; the analog
of zk_evm's recursive verifier circuits,
fixed_recursive_verifier.rs:110-141).

The machine has no branches: verification control flow is fixed per
(child stark, config, degree) shape, so the whole verifier unrolls into a
*program* — one operation per row. Program columns (op flags, operand
RAM addresses, immediates) are KNOWN columns: the outer verifier
recomputes their openings at zeta from the program itself
(recursion/known.py), so the prover commits them but cannot choose them.
Witness columns carry the operand values, bound to the RvmMem RAM table
by CTL, and every hash runs through the Poseidon table via the
full-permutation CTL view.

Ops (one-hot known flags):
- LOAD:   write an unconstrained witness value (proof data, hints)
- ARITH:  vout = C2*v0*v1 + C0*v2 + C1   (via the v01 helper column)
- SEL:    vout = v0 + v2*(v1 - v0)       (v2 a bit: branchless select)
- ASSERT: v0 == v1
- POSE:   one Poseidon permutation, 12 reads + 12 writes, CTL-checked
- PUB:    v0 == public_inputs[k]         (k via the PUBSEL one-hot)

Unused operand values are pinned to zero ((1-USEi)*Vi = 0) so disabled
multiplier inputs cannot leak prover-chosen values into results.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..field import host
from ..hash import host_poseidon
from ..stark import Stark, Filter, ColExpr, col
from . import ram

P = host.P

# -- known (program) columns -------------------------------------------------
F_LOAD = 0
F_ARITH = 1
F_SEL = 2
F_ASSERT = 3
F_POSE = 4
F_PUB = 5
A0 = 6
A1 = 7
A2 = 8
AOUT = 9
C2 = 10
C0 = 11
C1 = 12
USE0 = 13
USE1 = 14
USE2 = 15
USEW = 16
PADDR = list(range(17, 29))           # 12 permutation input addresses
POADDR = list(range(29, 41))          # 12 permutation output addresses
PUBSEL_START = 41                     # one-hot over num_public_inputs

# -- witness columns (offsets relative to the end of the known block) --------
# CLK, V0, V1, V2, VOUT, V01, PIN[12], POUT_LIMB[8], POUT_PARTIAL[8]

N_SLOTS = 28    # per-row timestamp slots: v-reads 0-2, v-write 3,
                # pose reads 4-15, pose writes 16-27


def layout(npub: int) -> dict:
    k = PUBSEL_START + npub
    lay = {
        "NUM_KNOWN": k,
        "CLK": k, "V0": k + 1, "V1": k + 2, "V2": k + 3, "VOUT": k + 4,
        "V01": k + 5,
        "PIN": list(range(k + 6, k + 18)),
        "POUT_LIMB": list(range(k + 18, k + 26)),
        "POUT_PARTIAL": list(range(k + 26, k + 34)),
    }
    lay["NUM_COLUMNS"] = k + 34
    return lay


@dataclass
class Cell:
    """Handle to a RAM address holding one field element."""
    addr: int


class _TapeOps:
    """Composite helpers shared by the python and native tape builders;
    every one bottoms out in the primitive ops (load/const/arith/sel/
    assert_eq/pose/bind_public/value)."""

    def zero(self) -> Cell:
        return self.const(0)

    def one(self) -> Cell:
        return self.const(1)

    def add(self, a: Cell, b: Cell) -> Cell:
        return self.arith(a, self.one(), b, c2=1, c0=1)

    def sub(self, a: Cell, b: Cell) -> Cell:
        return self.arith(a, self.one(), b, c2=1, c0=P - 1)

    def mul(self, a: Cell, b: Cell) -> Cell:
        return self.arith(a, b, c2=1)

    def mul_add(self, a: Cell, b: Cell, c: Cell) -> Cell:
        return self.arith(a, b, c, c2=1, c0=1)

    def scale(self, a: Cell, k: int, c1: int = 0) -> Cell:
        return self.arith(a, self.one(), c2=k % P, c1=c1)

    def lin(self, k1: int, a: Cell, k2: int, b: Cell) -> Cell:
        return self.arith(a, self.one(), b, c2=k1 % P, c0=k2 % P)

    def assert_zero(self, a: Cell) -> None:
        self.assert_eq(a, self.zero())

    def assert_bool(self, a: Cell) -> None:
        """a*(a-1) == 0."""
        t = self.arith(a, a, a, c2=1, c0=P - 1)
        self.assert_zero(t)


class PyTape(_TapeOps):
    """Single-pass program + witness builder. Ops append one program row
    and execute concretely; re-building with a different same-shape proof
    yields the identical program (asserted in tests)."""

    def __init__(self, npub: int = 0):
        self.npub = npub
        self.lay = layout(npub)
        self.rows: list[dict] = []          # per-row column -> value
        self.ram_ops: list[ram.RamOp] = []
        self.pose_inputs: list[list[int]] = []   # for the Poseidon table
        self.mem: dict[int, int] = {}       # concrete RAM state
        self.n_alloc = 0
        self.public_inputs: list[int | None] = [None] * npub
        self._const_cache: dict[int, Cell] = {}

    # -- low-level ---------------------------------------------------------
    def _ts(self, clk: int, slot: int) -> int:
        return clk * N_SLOTS + slot + 1

    def _alloc(self) -> int:
        a = self.n_alloc
        self.n_alloc += 1
        return a

    def _read(self, clk: int, slot: int, cell: Cell) -> int:
        v = self.mem[cell.addr]
        self.ram_ops.append(ram.RamOp(self._ts(clk, slot), cell.addr,
                                      True, v))
        return v

    def _write(self, clk: int, slot: int, addr: int, value: int) -> None:
        self.mem[addr] = value
        self.ram_ops.append(ram.RamOp(self._ts(clk, slot), addr,
                                      False, value))

    # -- ops -----------------------------------------------------------------
    def load(self, value: int) -> Cell:
        """Unconstrained witness write (proof data / hints)."""
        value = int(value) % P
        clk = len(self.rows)
        addr = self._alloc()
        self.rows.append({F_LOAD: 1, AOUT: addr, USEW: 1,
                          self.lay["VOUT"]: value})
        self._write(clk, 3, addr, value)
        return Cell(addr)

    def const(self, value: int) -> Cell:
        """Program-fixed constant (an ARITH row computing C1)."""
        value = int(value) % P
        if value in self._const_cache:
            return self._const_cache[value]
        clk = len(self.rows)
        addr = self._alloc()
        self.rows.append({F_ARITH: 1, AOUT: addr, USEW: 1, C1: value,
                          self.lay["VOUT"]: value})
        self._write(clk, 3, addr, value)
        cell = Cell(addr)
        self._const_cache[value] = cell
        return cell

    def arith(self, a: Cell | None, b: Cell | None, c: Cell | None = None,
              c2: int = 0, c0: int = 0, c1: int = 0) -> Cell:
        """vout = c2*a*b + c0*c + c1."""
        clk = len(self.rows)
        row = {F_ARITH: 1, C2: c2 % P, C0: c0 % P, C1: c1 % P}
        va = vb = vc = 0
        if a is not None:
            row[A0] = a.addr
            row[USE0] = 1
            va = self._read(clk, 0, a)
        if b is not None:
            row[A1] = b.addr
            row[USE1] = 1
            vb = self._read(clk, 1, b)
        if c is not None:
            row[A2] = c.addr
            row[USE2] = 1
            vc = self._read(clk, 2, c)
        v01 = va * vb % P
        vout = (c2 * v01 + c0 * vc + c1) % P
        addr = self._alloc()
        row[AOUT] = addr
        row[USEW] = 1
        row[self.lay["V0"]] = va
        row[self.lay["V1"]] = vb
        row[self.lay["V2"]] = vc
        row[self.lay["V01"]] = v01
        row[self.lay["VOUT"]] = vout
        self.rows.append(row)
        self._write(clk, 3, addr, vout)
        return Cell(addr)

    def sel(self, bit: Cell, a: Cell, b: Cell) -> Cell:
        """bit ? a : b (bit must be a 0/1 cell, asserted by the caller
        via assert_bool when it comes from a hint)."""
        clk = len(self.rows)
        vb = self._read(clk, 0, b)
        va = self._read(clk, 1, a)
        vbit = self._read(clk, 2, bit)
        vout = (vb + vbit * (va - vb)) % P
        addr = self._alloc()
        self.rows.append({F_SEL: 1, A0: b.addr, A1: a.addr, A2: bit.addr,
                          AOUT: addr, USE0: 1, USE1: 1, USE2: 1, USEW: 1,
                          self.lay["V0"]: vb, self.lay["V1"]: va,
                          self.lay["V2"]: vbit,
                          self.lay["V01"]: vb * va % P,
                          self.lay["VOUT"]: vout})
        self._write(clk, 3, addr, vout)
        return Cell(addr)

    def assert_eq(self, a: Cell, b: Cell) -> None:
        clk = len(self.rows)
        va = self._read(clk, 0, a)
        vb = self._read(clk, 1, b)
        assert va == vb, f"tape assert_eq failed: {va} != {vb}"
        self.rows.append({F_ASSERT: 1, A0: a.addr, A1: b.addr,
                          USE0: 1, USE1: 1,
                          self.lay["V0"]: va, self.lay["V1"]: vb,
                          self.lay["V01"]: va * vb % P})

    def pose(self, cells: list[Cell]) -> list[Cell]:
        """One Poseidon permutation; returns 12 output cells."""
        assert len(cells) == 12
        clk = len(self.rows)
        row = {F_POSE: 1}
        inp = []
        for i, c in enumerate(cells):
            row[PADDR[i]] = c.addr
            v = self._read(clk, 4 + i, c)
            row[self.lay["PIN"][i]] = v
            inp.append(v)
        out = host_poseidon.permute(inp)
        out_cells = []
        for j in range(4):
            lo, hi = out[j] & 0xFFFFFFFF, out[j] >> 32
            row[self.lay["POUT_LIMB"][2 * j]] = lo
            row[self.lay["POUT_LIMB"][2 * j + 1]] = hi
        for j in range(8):
            row[self.lay["POUT_PARTIAL"][j]] = out[4 + j]
        for j in range(12):
            addr = self._alloc()
            row[POADDR[j]] = addr
            self._write(clk, 16 + j, addr, out[j])
            out_cells.append(Cell(addr))
        self.rows.append(row)
        self.pose_inputs.append(inp)
        return out_cells

    def bind_public(self, cell: Cell, k: int) -> None:
        """Expose RAM[cell] as public_inputs[k]."""
        assert 0 <= k < self.npub
        clk = len(self.rows)
        v = self._read(clk, 0, cell)
        self.rows.append({F_PUB: 1, A0: cell.addr, USE0: 1,
                          PUBSEL_START + k: 1,
                          self.lay["V0"]: v})
        assert self.public_inputs[k] is None, f"public input {k} rebound"
        self.public_inputs[k] = v

    def value(self, cell: Cell) -> int:
        return self.mem[cell.addr]

    # -- trace generation ------------------------------------------------
    def finalize(self, min_rows: int = 2):
        """Returns (RvmStark, rvm_trace, ram_trace, poseidon_ops,
        public_inputs)."""
        from ..tables.poseidon import PoseidonSimpleOp
        assert all(v is not None for v in self.public_inputs), \
            "unbound public inputs"
        lay = self.lay
        n = max(min_rows, 2)
        while n < len(self.rows):
            n *= 2
        trace = np.zeros((lay["NUM_COLUMNS"], n), dtype=np.uint64)
        for r, row in enumerate(self.rows):
            for c, v in row.items():
                trace[c, r] = v % P
        trace[lay["CLK"]] = np.arange(n, dtype=np.uint64)
        known = trace[:lay["NUM_KNOWN"]].copy()
        stark = RvmStark(npub=self.npub, known=known)
        ram_trace = ram.generate_trace(self.ram_ops)
        pose_ops = [PoseidonSimpleOp(tuple(i)) for i in self.pose_inputs]
        return (stark, trace, ram_trace, pose_ops,
                [int(v) for v in self.public_inputs])


class _LenOnly:
    """Shim standing in for NativeTape.rows (length queries only; row
    payloads live in the C++ core)."""

    def __init__(self, n: int):
        self._n = n

    def __len__(self) -> int:
        return self._n


class NativeTape(_TapeOps):
    """Tape builder backed by the C++ core (native/tapecore.cpp): rows,
    single-assignment RAM, liveness and the RAM-trace builder all live in
    struct-of-array C++ storage; each op is one ctypes call. Semantics
    are an exact twin of PyTape (tests/test_tapecore.py asserts
    bit-identical traces)."""

    def __init__(self, npub: int = 0):
        import ctypes
        from .. import native
        from ..hash import poseidon_params as pp
        lib = native.require()
        self._lib = lib
        self.npub = npub
        self.lay = layout(npub)
        params = pp.default_params()
        rc = np.array(params.round_constants, dtype=np.uint64)
        circ = np.array(params.mds_circ, dtype=np.uint64)
        diag = np.array(params.mds_diag, dtype=np.uint64)
        self._h = lib.tape_new(npub, rc, len(rc), circ, diag,
                               params.half_full_rounds,
                               params.n_partial_rounds)
        self._const_cache: dict[int, Cell] = {}
        self._publics: list[int | None] = [None] * npub
        self._i64x12 = ctypes.c_int64 * 12
        self._empty_u64 = np.empty(0, dtype=np.uint64)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.tape_free(h)
            self._h = None

    # -- primitives --------------------------------------------------------
    def load(self, value: int) -> Cell:
        return Cell(self._lib.tape_load(self._h, int(value) % P))

    def const(self, value: int) -> Cell:
        value = int(value) % P
        cell = self._const_cache.get(value)
        if cell is None:
            cell = Cell(self._lib.tape_const(self._h, value))
            self._const_cache[value] = cell
        return cell

    def arith(self, a: Cell | None, b: Cell | None, c: Cell | None = None,
              c2: int = 0, c0: int = 0, c1: int = 0) -> Cell:
        return Cell(self._lib.tape_arith(
            self._h,
            a.addr if a is not None else -1,
            b.addr if b is not None else -1,
            c.addr if c is not None else -1,
            c2 % P, c0 % P, c1 % P))

    def sel(self, bit: Cell, a: Cell, b: Cell) -> Cell:
        return Cell(self._lib.tape_sel(self._h, bit.addr, a.addr, b.addr))

    def assert_eq(self, a: Cell, b: Cell) -> None:
        if self._lib.tape_assert_eq(self._h, a.addr, b.addr) != 0:
            raise AssertionError(
                f"tape assert_eq failed: {self.value(a)} != "
                f"{self.value(b)}")

    def pose(self, cells: list[Cell]) -> list[Cell]:
        assert len(cells) == 12
        base = self._lib.tape_pose(
            self._h, self._i64x12(*[c.addr for c in cells]))
        return [Cell(base + j) for j in range(12)]

    def bind_public(self, cell: Cell, k: int) -> None:
        assert 0 <= k < self.npub
        if self._lib.tape_bind_public(self._h, cell.addr, k) != 0:
            raise AssertionError(f"public input {k} rebound")
        self._publics[k] = self.value(cell)

    def value(self, cell: Cell) -> int:
        return int(self._lib.tape_value(self._h, cell.addr))

    # -- introspection (compat with PyTape consumers) -----------------------
    @property
    def rows(self) -> _LenOnly:
        return _LenOnly(int(self._lib.tape_n_rows(self._h)))

    @property
    def public_inputs(self) -> list[int | None]:
        return list(self._publics)

    @property
    def ram_ops(self) -> list:
        """Materialized (test/debug only — production paths use the
        in-core RAM trace builder)."""
        from . import ram
        n_rows = len(self.rows)
        n = int(self._lib.tape_count_ops(self._h, 0, n_rows))
        out = np.zeros((n, 4), dtype=np.uint64)
        self._lib.tape_export_ops(self._h, 0, n_rows, out)
        return [ram.RamOp(int(ts), int(addr), bool(rd), int(val))
                for ts, addr, rd, val in out]

    # -- bulk exports --------------------------------------------------------
    def export_trace(self, lo: int, hi: int, n_pad: int) -> np.ndarray:
        trace = np.zeros((self.lay["NUM_COLUMNS"], n_pad), dtype=np.uint64)
        self._lib.tape_export_trace(self._h, lo, hi, trace, n_pad)
        trace[self.lay["CLK"]] = np.arange(n_pad, dtype=np.uint64)
        return trace

    def export_pose_ops(self, lo: int, hi: int) -> list:
        from ..tables.poseidon import PoseidonSimpleOp
        n = int(self._lib.tape_count_pose(self._h, lo, hi))
        out = np.zeros((n, 12), dtype=np.uint64)
        if n:
            self._lib.tape_export_pose(self._h, lo, hi, out)
        return [PoseidonSimpleOp(tuple(int(v) for v in row))
                for row in out]

    def live_at(self, boundary: int) -> tuple[np.ndarray, np.ndarray]:
        """(addrs, values) of cells written before `boundary` and read at
        or after it — ascending-address order."""
        n = int(self._lib.tape_live_at(self._h, boundary, None, None))
        addrs = np.zeros(n, dtype=np.uint64)
        vals = np.zeros(n, dtype=np.uint64)
        if n:
            self._lib.tape_live_at(self._h, boundary,
                                   addrs.ctypes.data, vals.ctypes.data)
        return addrs, vals

    def ram_trace(self, lo: int, hi: int,
                  before_addrs: np.ndarray | None = None,
                  export_addrs: np.ndarray | None = None,
                  min_rows: int = 2) -> np.ndarray:
        before = np.ascontiguousarray(
            before_addrs if before_addrs is not None else self._empty_u64,
            dtype=np.uint64)
        export = np.sort(np.ascontiguousarray(
            export_addrs if export_addrs is not None else self._empty_u64,
            dtype=np.uint64))
        n = int(self._lib.tape_ram_size(self._h, lo, hi, before,
                                        len(before), min_rows))
        assert n > 0, "no RAM ops"
        out = np.zeros((10, n), dtype=np.uint64)
        marked = int(self._lib.tape_ram_fill(
            self._h, lo, hi, before, len(before), min_rows,
            export, len(export), out, n))
        assert marked == len(export), "export addresses never touched"
        return out

    # -- trace generation ----------------------------------------------------
    def finalize(self, min_rows: int = 2):
        """Returns (RvmStark, rvm_trace, ram_trace, poseidon_ops,
        public_inputs) — same contract as PyTape.finalize."""
        assert all(v is not None for v in self._publics), \
            "unbound public inputs"
        lay = self.lay
        n_ops = len(self.rows)
        n = max(min_rows, 2)
        while n < n_ops:
            n *= 2
        trace = self.export_trace(0, n_ops, n)
        known = trace[:lay["NUM_KNOWN"]].copy()
        stark = RvmStark(npub=self.npub, known=known)
        ram_trace = self.ram_trace(0, n_ops)
        pose_ops = self.export_pose_ops(0, n_ops)
        return (stark, trace, ram_trace, pose_ops,
                [int(v) for v in self._publics])


def Tape(npub: int = 0):
    """Tape builder factory: the C++-core builder. It raises when the
    native host library does not build or load (`native.require()`)
    rather than falling back to PyTape, whose wall-clock on a wrap tape
    is larger by orders of magnitude; PyTape stays the exact twin the
    tests hold NativeTape against."""
    return NativeTape(npub)


# -- CTL views ----------------------------------------------------------------

def ctl_looking_ram(npub: int, channel: int, clk_base: int = 0):
    """RAM bus channels, mirroring ram.ctl_data's (is_read, addr, value,
    timestamp). Channels 0-2: operand reads; 3: result write; 4-15: pose
    input reads; 16-27: pose output writes. `clk_base` rebases a chunked
    tape's local clock onto the global timeline (continuation.py)."""
    lay = layout(npub)
    ts = ColExpr(terms=((lay["CLK"], N_SLOTS),),
                 const=channel + 1 + clk_base * N_SLOTS)
    if channel < 3:
        a = (A0, A1, A2)[channel]
        v = (lay["V0"], lay["V1"], lay["V2"])[channel]
        return (ColExpr(const=1), col(a), col(v), ts)
    if channel == 3:
        return (ColExpr(const=0), col(AOUT), col(lay["VOUT"]), ts)
    if channel < 16:
        i = channel - 4
        return (ColExpr(const=1), col(PADDR[i]), col(lay["PIN"][i]), ts)
    j = channel - 16
    if j < 4:
        value = ColExpr(terms=((lay["POUT_LIMB"][2 * j], 1),
                               (lay["POUT_LIMB"][2 * j + 1], 1 << 32)))
    else:
        value = col(lay["POUT_PARTIAL"][j - 4])
    return (ColExpr(const=0), col(POADDR[j]), value, ts)


def ctl_looking_ram_filter(channel: int) -> Filter:
    if channel < 3:
        return Filter(column=(USE0, USE1, USE2)[channel])
    if channel == 3:
        return Filter(column=USEW)
    return Filter(column=F_POSE)


def ctl_looking_poseidon(npub: int):
    """(input[12], digest limbs[8], output_partial[8]) — matches the
    Poseidon table's full-permutation looked view."""
    lay = layout(npub)
    return tuple(col(c) for c in lay["PIN"]) \
        + tuple(col(c) for c in lay["POUT_LIMB"]) \
        + tuple(col(c) for c in lay["POUT_PARTIAL"])


def ctl_looking_poseidon_filter() -> Filter:
    return Filter(column=F_POSE)


class RvmStark(Stark):
    name = "rvm"

    def __init__(self, npub: int = 0, known: np.ndarray | None = None,
                 clk_base: int = 0):
        self.npub = npub
        self.lay = layout(npub)
        self.num_columns = self.lay["NUM_COLUMNS"]
        self.num_public_inputs = npub
        self.known = known
        self.clk_base = clk_base    # chunked tapes: global clock offset
        # program columns live in their own preprocessed oracle whose
        # Merkle cap is a verification-key constant — the binding is
        # cap equality via FRI, which a recursion tape can check for
        # free (the JAX package's stark/DESIGN.md, L2 step 3)
        self.num_preprocessed = \
            self.lay["NUM_KNOWN"] if known is not None else 0

    def preprocessed(self) -> np.ndarray | None:
        return self.known

    def eval(self, frame, cc):
        lay = self.lay
        lv, nv = frame.local, frame.next
        pis = frame.public_inputs

        clk = lv[lay["CLK"]]
        cc.constraint_first_row(clk)
        cc.constraint_transition(nv[lay["CLK"]] - clk - 1)

        v0, v1, v2 = lv[lay["V0"]], lv[lay["V1"]], lv[lay["V2"]]
        vout, v01 = lv[lay["VOUT"]], lv[lay["V01"]]
        # pin unused operands so disabled inputs cannot feed products
        cc.constraint((1 - lv[USE0]) * v0)
        cc.constraint((1 - lv[USE1]) * v1)
        cc.constraint((1 - lv[USE2]) * v2)
        # the product helper (degree-3 budget for C2*v0*v1)
        cc.constraint(v01 - v0 * v1)
        # ARITH: vout = C2*v01 + C0*v2 + C1
        cc.constraint(lv[F_ARITH] * (vout - lv[C2] * v01)
                      - lv[F_ARITH] * (lv[C0] * v2 + lv[C1]))
        # SEL: vout = v0 + v2*(v1 - v0)   (v0=else, v1=then, v2=bit)
        cc.constraint(lv[F_SEL] * (vout - v0 - v2 * v1 + v2 * v0))
        # ASSERT: v0 == v1
        cc.constraint(lv[F_ASSERT] * (v0 - v1))
        # PUB: v0 == selected public input. One code path for every
        # algebra (ints/GF/HExt/tape cells) keeps the fold order
        # identical; pis entries are ints on host paths and RAM cells
        # when this stark is itself being wrapped (self-recursion).
        if self.npub:
            acc = lv[PUBSEL_START] * pis[0]
            for k in range(1, self.npub):
                acc = acc + lv[PUBSEL_START + k] * pis[k]
            cc.constraint(lv[F_PUB] * (v0 - acc))

    def requires_ctls(self):
        return True
