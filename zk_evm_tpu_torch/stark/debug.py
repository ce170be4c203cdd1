"""Debug-mode constraint checking over raw traces (host-exact).

Analog of the reference's `debug_assertions` internal checks
(prover.rs:167-184): evaluate the full constraint system row by row with
exact ints and report the first violated constraint — far cheaper than a
failed proof for locating trace-generation bugs.
"""

from __future__ import annotations

import numpy as np

from ..field import HExt
from .stark import Stark, StarkFrame


class _RowChecker:
    def __init__(self, row: int, n: int):
        self.row = row
        self.n = n
        self.idx = 0

    def _check(self, c, active: bool):
        if active and isinstance(c, HExt) and c.v != (0, 0):
            raise AssertionError(
                f"constraint #{self.idx} violated at row {self.row}: {c}")
        self.idx += 1

    def constraint(self, c):
        self._check(c, True)

    def constraint_transition(self, c):
        self._check(c, self.row < self.n - 1)

    def constraint_first_row(self, c):
        self._check(c, self.row == 0)

    def constraint_last_row(self, c):
        self._check(c, self.row == self.n - 1)


class _NpF:
    """Whole-column field element for vectorized raw-trace checking."""
    __slots__ = ("v",)

    def __init__(self, v):
        self.v = np.asarray(v, dtype=np.uint64)

    @staticmethod
    def _coerce(x):
        if isinstance(x, _NpF):
            return x.v
        return np.uint64(int(x) % np_field.P)

    def __add__(self, o):
        return _NpF(np_field.add(self.v, self._coerce(o)))
    __radd__ = __add__

    def __sub__(self, o):
        return _NpF(np_field.sub(self.v, self._coerce(o)))

    def __rsub__(self, o):
        return _NpF(np_field.sub(self._coerce(o), self.v))

    def __mul__(self, o):
        return _NpF(np_field.mul(self.v, self._coerce(o)))
    __rmul__ = __mul__

    def __neg__(self):
        return _NpF(np_field.sub(np.uint64(0), self.v))


class _NpChecker:
    def __init__(self, n: int):
        self.n = n
        self.idx = 0

    def _check(self, c, mask):
        v = c.v if isinstance(c, _NpF) else None
        if v is not None:
            bad = np.nonzero(v[mask] if mask is not None else v)[0]
            if len(bad):
                r = int(bad[0])
                raise AssertionError(
                    f"constraint #{self.idx} violated at row {r} "
                    f"(value {int((v[mask] if mask is not None else v)[r])})")
        self.idx += 1

    def constraint(self, c):
        self._check(c, None)

    def constraint_transition(self, c):
        self._check(c, slice(0, self.n - 1))

    def constraint_first_row(self, c):
        self._check(c, slice(0, 1))

    def constraint_last_row(self, c):
        self._check(c, slice(self.n - 1, self.n))


from ..field import np_field


def check_constraints_np(stark: Stark, trace: np.ndarray,
                         public_inputs: list[int] | None = None) -> None:
    """Vectorized all-rows raw-trace check (uint64 numpy field ops) —
    the fast path for wide/long traces like the CPU table."""
    n = trace.shape[1]
    nxt = np.roll(np.arange(n), -1)
    frame = StarkFrame(
        local=[_NpF(trace[i]) for i in range(trace.shape[0])],
        next_=[_NpF(trace[i][nxt]) for i in range(trace.shape[0])],
        public_inputs=list(public_inputs or []))
    stark.eval(frame, _NpChecker(n))


def check_constraints(stark: Stark, trace: np.ndarray,
                      rows: list[int] | None = None,
                      public_inputs: list[int] | None = None,
                      aux: np.ndarray | None = None,
                      eval_extra=None) -> None:
    """Check stark.eval row-by-row on the raw trace (wrap-around next
    row). `rows=None` checks every row; pass a subset for wide traces.
    `aux`/`eval_extra` allow checking lookup/CTL constraints too."""
    n = trace.shape[1]
    if rows is None:
        rows = list(range(n))
    for r in rows:
        nxt = (r + 1) % n
        frame = StarkFrame(
            local=[HExt(int(v)) for v in trace[:, r]],
            next_=[HExt(int(v)) for v in trace[:, nxt]],
            public_inputs=list(public_inputs or []),
            aux_local=[HExt(int(v)) for v in aux[:, r]]
            if aux is not None else [],
            aux_next=[HExt(int(v)) for v in aux[:, nxt]]
            if aux is not None else [])
        cc = _RowChecker(r, n)
        stark.eval(frame, cc)
        if eval_extra is not None:
            eval_extra(frame, cc)


# ---------------------------------------------------------------------------
# Exact CTL multiset balance checking (debugging aid for witness gen)
# ---------------------------------------------------------------------------

def _view_multiset(trace: np.ndarray, view):
    """Counter of combined-column tuples over filter-selected rows."""
    from collections import Counter
    from .lookup import _coerce_expr
    cols = [_coerce_expr(c).eval_np(trace) for c in view.columns]
    f = view.filter.eval_np(trace)
    out = Counter()
    for r in np.nonzero(f)[0]:
        out[tuple(int(c[r]) for c in cols)] += int(f[r])
    return out


def check_ctl_balance(ctls, traces, extra_looking_values=None,
                      max_report: int = 8) -> None:
    """Exact multiset comparison of every CTL's looking vs looked side
    over raw traces — far more diagnostic than an unbalanced-proof error
    (the reference's debug_utils::check_ctls, verifier.rs tests).

    `extra_looking_values`: {ctl_index: [row tuple, ...]} for values the
    verifier injects from public inputs (memory metadata writes)."""
    from collections import Counter
    extra_looking_values = extra_looking_values or {}
    errors = []
    for idx, ctl in enumerate(ctls):
        looking = Counter()
        for view in ctl.looking:
            t = traces[view.table]
            if t is None:
                continue
            looking += _view_multiset(t, view)
        for row in extra_looking_values.get(idx, ()):
            looking[tuple(int(v) % 0xFFFFFFFF00000001 for v in row)] += 1
        t = traces[ctl.looked.table]
        looked = _view_multiset(t, ctl.looked) if t is not None \
            else Counter()
        if looking != looked:
            only_looking = looking - looked
            only_looked = looked - looking
            msg = [f"CTL '{ctl.name}': {sum(only_looking.values())} "
                   f"unmatched looking, {sum(only_looked.values())} "
                   f"unmatched looked"]
            for tup, cnt in list(only_looking.items())[:max_report]:
                msg.append(f"  looking x{cnt}: {tup}")
            for tup, cnt in list(only_looked.items())[:max_report]:
                msg.append(f"  looked  x{cnt}: {tup}")
            errors.append("\n".join(msg))
    if errors:
        raise AssertionError("\n".join(errors))


# ---------------------------------------------------------------------------
# Constraint-degree audit (catch quotient aliasing before proving)
# ---------------------------------------------------------------------------

class _Deg:
    """Max-plus degree element: mul adds degrees, add takes the max."""
    __slots__ = ("d",)

    def __init__(self, d=0):
        self.d = d

    def _c(self, o):
        return o.d if isinstance(o, _Deg) else 0

    def __add__(self, o):
        return _Deg(max(self.d, self._c(o)))
    __radd__ = __add__

    def __sub__(self, o):
        return _Deg(max(self.d, self._c(o)))

    def __rsub__(self, o):
        return _Deg(max(self.d, self._c(o)))

    def __mul__(self, o):
        return _Deg(self.d + self._c(o))
    __rmul__ = __mul__

    def __neg__(self):
        return _Deg(self.d)


class _DegChecker:
    def __init__(self, max_degree: int):
        self.max_degree = max_degree
        self.idx = 0
        self.violations = []

    def _check(self, c, extra: int):
        d = (c.d if isinstance(c, _Deg) else 0) + extra
        if d > self.max_degree:
            self.violations.append((self.idx, d))
        self.idx += 1

    def constraint(self, c):
        self._check(c, 0)

    def constraint_transition(self, c):
        self._check(c, 0)   # z_last multiplier is budgeted separately

    constraint_first_row = constraint
    constraint_last_row = constraint


def check_constraint_degrees(stark: Stark, max_degree: int = 3,
                             num_aux: int = 0, eval_extra=None):
    """Evaluate the constraint system over max-plus degree elements and
    return [(constraint_index, degree)] exceeding `max_degree` — the
    quotient-aliasing budget (2^rate_bits + 1 with rate_bits=1, the
    reference's starky degree bound)."""
    frame = StarkFrame(
        local=[_Deg(1) for _ in range(stark.num_columns)],
        next_=[_Deg(1) for _ in range(stark.num_columns)],
        public_inputs=[_Deg(0) for _ in range(64)],
        aux_local=[_Deg(1) for _ in range(num_aux)],
        aux_next=[_Deg(1) for _ in range(num_aux)])
    cc = _DegChecker(max_degree)
    stark.eval(frame, cc)
    if eval_extra is not None:
        eval_extra(frame, cc)
    return cc.violations
