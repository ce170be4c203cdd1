"""logUp lookups and cross-table lookup (CTL) machinery.

Twin of the JAX package's `stark/lookup.py` (starky's lookup/CTL
arguments: in-table range checks, the AllStark CTLs).

Design (suffix-sum form):
- challenge set: per global challenge c, a pair (beta_c, gamma_c);
  columns combine as gamma^0 v0 + gamma^1 v1 + ... and denominators are
  (beta + combined).
- in-table lookup: looking columns paired into helpers
  h = 1/(b+C1) + 1/(b+C2), table side ht = freq/(b+T); running column
  Z(x) = delta(x) + Z(g x), delta = sum(h) - ht, with Z(first) == 0.
- CTL view (one side of a cross-table lookup in one table): helper
  h = filter/(b+combined), running Z with delta = h; Z(first) is the
  view's exported total, opened at x=1 ("ctl_zs_first") and summed across
  tables by the global verifier.

The specs (ColExpr ... num_aux_columns, ctl_view_sum_np,
ctl_z_first_indices) are the JAX package's host code. Aux trace
generation runs on the trace tensors' device in plain PyTorch: one
batched Fermat inverse of every denominator row and an exact suffix sum;
constraint evaluation is one generic routine over either algebra (GF
arrays / HExt scalars).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..field import GF, host, np_field
from ..field import goldilocks as gl


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ColExpr:
    """Linear combination of trace columns (current and/or next row) plus a
    constant — the reference's `Column` (starky::lookup::Column; e.g. the
    Memory table looks up next-row addr_virtual, BytePacking's CTL exposes
    packed u32 limbs as byte combinations)."""
    terms: tuple[tuple[int, int], ...] = ()        # (column, coeff)
    next_terms: tuple[tuple[int, int], ...] = ()   # next-row (column, coeff)
    const: int = 0

    def eval(self, local, nxt=None):
        acc = None
        for c, k in self.terms:
            t = local[c] * (k % host.P)
            acc = t if acc is None else acc + t
        for c, k in self.next_terms:
            t = nxt[c] * (k % host.P)
            acc = t if acc is None else acc + t
        if self.const:
            acc = self.const if acc is None else acc + self.const
        if acc is None:
            return 0
        return acc

    def eval_np(self, trace: np.ndarray) -> np.ndarray:
        n = trace.shape[1]
        acc = np.full(n, np.uint64(self.const % host.P), dtype=np.uint64)
        for c, k in self.terms:
            acc = np_field.add(acc, np_field.mul(trace[c],
                                                 np.uint64(k % host.P)))
        for c, k in self.next_terms:
            rolled = np.roll(trace[c], -1)
            acc = np_field.add(acc, np_field.mul(rolled,
                                                 np.uint64(k % host.P)))
        return acc

    def uses_next(self) -> bool:
        return bool(self.next_terms)


def col(c: int) -> ColExpr:
    return ColExpr(terms=((c, 1),))


def col_next(c: int) -> ColExpr:
    return ColExpr(next_terms=((c, 1),))


def _coerce_expr(x) -> ColExpr:
    return x if isinstance(x, ColExpr) else col(x)


@dataclass(frozen=True)
class Lookup:
    """In-table logUp: every value of each looking column (expression)
    appears in `table_column`; `frequencies_column` holds the
    multiplicities. `filters` (optional, per looking column) restrict
    which rows contribute."""
    looking_columns: tuple
    table_column: int | ColExpr = 0
    frequencies_column: int = 0
    filters: tuple | None = None           # per looking column, or None

    def num_helpers(self) -> int:
        return (len(self.looking_columns) + 1) // 2 + 1  # + table helper


@dataclass(frozen=True)
class Filter:
    """Row filter. General form (starky's Filter): value =
    sum of ColExpr-pair products + sum of ColExpr constants.
    Convenience fields cover the common cases: a single column, a product
    of two columns, a sum of columns, or constant-1 (all fields empty)."""
    column: int | None = None
    product: tuple[int, int] | None = None
    sum_cols: tuple[int, ...] | None = None
    products: tuple = ()        # ((ColExpr, ColExpr), ...)
    constants: tuple = ()       # (ColExpr, ...)

    def eval(self, local):
        """In either algebra, from local column values."""
        if self.products or self.constants:
            acc = None
            for a, b in self.products:
                t = _coerce_expr(a).eval(local) * _coerce_expr(b).eval(local)
                acc = t if acc is None else acc + t
            for c in self.constants:
                t = _coerce_expr(c).eval(local)
                acc = t if acc is None else acc + t
            return acc
        if self.product is not None:
            a, b = self.product
            return local[a] * local[b]
        if self.sum_cols is not None:
            acc = local[self.sum_cols[0]]
            for c in self.sum_cols[1:]:
                acc = acc + local[c]
            return acc
        if self.column is not None:
            return local[self.column]
        return None  # constant 1

    def eval_np(self, trace: np.ndarray) -> np.ndarray:
        if self.products or self.constants:
            acc = np.zeros(trace.shape[1], dtype=np.uint64)
            for a, b in self.products:
                acc = np_field.add(acc, np_field.mul(
                    _coerce_expr(a).eval_np(trace),
                    _coerce_expr(b).eval_np(trace)))
            for c in self.constants:
                acc = np_field.add(acc, _coerce_expr(c).eval_np(trace))
            return acc
        if self.product is not None:
            a, b = self.product
            return np_field.mul(trace[a], trace[b])
        if self.sum_cols is not None:
            acc = trace[self.sum_cols[0]].astype(np.uint64)
            for c in self.sum_cols[1:]:
                acc = np_field.add(acc, trace[c])
            return acc
        if self.column is not None:
            return trace[self.column].astype(np.uint64)
        return np.ones(trace.shape[1], dtype=np.uint64)


@dataclass(frozen=True)
class CtlView:
    """One side of a CTL inside one table: the filtered rows contribute
    their combined column tuple to the multiset."""
    table: int                     # table index in the AllStark registry
    columns: tuple[int, ...]
    filter: Filter = field(default_factory=Filter)


@dataclass(frozen=True)
class CrossTableLookup:
    """Multiset equality: union of looking views' rows == looked view's
    rows (the reference's 1:1 coprocessor dispatch CTLs)."""
    name: str
    looking: tuple[CtlView, ...]
    looked: CtlView


@dataclass(frozen=True)
class ChallengeSet:
    """num_challenges (beta, gamma) pairs, drawn once globally."""
    pairs: tuple[tuple[int, int], ...]


def get_challenge_set(challenger, num_challenges: int) -> ChallengeSet:
    return ChallengeSet(tuple(
        (challenger.get_challenge(), challenger.get_challenge())
        for _ in range(num_challenges)))


def ctl_groups_for_table(ctls: list[CrossTableLookup], table: int):
    """CTL views living in `table`, grouped per (ctl, side) in canonical
    aux order. Each group shares paired helper columns and ONE running-sum
    Z column (starky's layout — one Z per CTL per table per side), whose
    Z(first) total is exported via ctl_zs_first."""
    groups = []
    for ci, ctl in enumerate(ctls):
        looking_here = [v for v in ctl.looking if v.table == table]
        if looking_here:
            groups.append((ci, "looking", looking_here))
        if ctl.looked.table == table:
            groups.append((ci, "looked", [ctl.looked]))
    return groups


def num_aux_columns(lookups: list[Lookup], groups,
                    num_challenges: int) -> int:
    per = sum(lk.num_helpers() + 1 for lk in lookups)
    for _ci, _side, views in groups:
        per += (len(views) + 1) // 2 + 1
    return per * num_challenges


# ---------------------------------------------------------------------------
# Aux trace generation (device)
# ---------------------------------------------------------------------------

def _gf_suffix_sum(x: GF) -> GF:
    """Z[i] = sum_{j >= i} x[j] along the last axis, exactly.

    The 32-bit halves of the elements are suffix-summed as plain int64
    integers (each partial sum < n * 2^32, exact for n < 2^31) and every
    prefix is reduced once, so no sum wraps mod 2^64."""
    v = x.v
    assert v.shape[-1] < (1 << 31), "limb suffix sums would overflow int64"
    rev = torch.flip(v, dims=(-1,))
    s_lo = torch.flip(torch.cumsum(rev & gl.M32, dim=-1), dims=(-1,))
    s_hi = torch.flip(torch.cumsum((rev >> 32) & gl.M32, dim=-1),
                      dims=(-1,))
    return GF(gl.reduce_limb_sums(s_lo, s_hi))


def _combine(local, nxt, columns, gamma):
    """gamma-weighted combination of column expressions (scalar path)."""
    exprs = [_coerce_expr(c) for c in columns]
    acc = exprs[0].eval(local, nxt)
    gp = gamma
    for e in exprs[1:]:
        acc = acc + e.eval(local, nxt) * gp
        gp = host.fmul(gp, gamma) if isinstance(gamma, int) else gp * gamma
    return acc


def _flatten_combo_pos(columns):
    """A view's column expressions as (cur, nxt, consts) with entries
    (col, coeff, pos) / (coeff, pos): pos is the gamma power the term is
    weighted by."""
    cur, nxt, consts = [], [], []
    for pos, c in enumerate(columns):
        e = _coerce_expr(c)
        for col_i, k in e.terms:
            cur.append((col_i, k % host.P, pos))
        for col_i, k in e.next_terms:
            nxt.append((col_i, k % host.P, pos))
        if e.const:
            consts.append((e.const % host.P, pos))
    return cur, nxt, consts


def _combo_plan(lookups, groups):
    """Static per-table combo plan shared by aux generation and the
    constraint evaluation: padded (idx, coeff, gamma-pos) arrays for
    every looking/looked view, in the canonical order (per lookup:
    looking columns then the table column; then every CTL view)."""
    combos = []
    for lk in lookups:
        for e in lk.looking_columns:
            combos.append(_flatten_combo_pos((e,)))
        combos.append(_flatten_combo_pos((lk.table_column,)))
    for _ci, _side, views in groups:
        for v in views:
            combos.append(_flatten_combo_pos(v.columns))
    v_count = len(combos)
    k_cur = max((len(c[0]) for c in combos), default=0)
    k_nxt = max((len(c[1]) for c in combos), default=0)
    k_cst = max((len(c[2]) for c in combos), default=0)
    idx_c = np.zeros((v_count, k_cur), dtype=np.int64)
    cf_c = np.zeros((v_count, k_cur), dtype=np.uint64)
    ps_c = np.zeros((v_count, k_cur), dtype=np.int64)
    idx_n = np.zeros((v_count, k_nxt), dtype=np.int64)
    cf_n = np.zeros((v_count, k_nxt), dtype=np.uint64)
    ps_n = np.zeros((v_count, k_nxt), dtype=np.int64)
    cf_k = np.zeros((v_count, k_cst), dtype=np.uint64)
    ps_k = np.zeros((v_count, k_cst), dtype=np.int64)
    max_pos = 0
    for i, (cur, nxt_t, consts) in enumerate(combos):
        for j, (col_i, k, p) in enumerate(cur):
            idx_c[i, j], cf_c[i, j], ps_c[i, j] = col_i, k, p
            max_pos = max(max_pos, p)
        for j, (col_i, k, p) in enumerate(nxt_t):
            idx_n[i, j], cf_n[i, j], ps_n[i, j] = col_i, k, p
            max_pos = max(max_pos, p)
        for j, (k, p) in enumerate(consts):
            cf_k[i, j], ps_k[i, j] = k, p
            max_pos = max(max_pos, p)
    return (idx_c, cf_c, ps_c, idx_n, cf_n, ps_n, cf_k, ps_k, max_pos,
            v_count)


def _batch_combined_pos(trace_gf: GF, nxt_gf: GF, plan, beta: int,
                        gamma: int) -> GF:
    """(V, m) rows of beta + the gamma-weighted combination, one per view
    of `plan`. The weights coeff * gamma^pos are exact host products;
    each padded term position is one gather and one multiply-add over all
    views (padding terms have coefficient 0)."""
    (idx_c, cf_c, ps_c, idx_n, cf_n, ps_n, cf_k, ps_k, max_pos,
     v_count) = plan
    m = trace_gf.shape[-1]
    dev = trace_gf.device
    gp = np_field.powers(gamma, max_pos + 1)
    const = np.full(v_count, np.uint64(beta % host.P), dtype=np.uint64)
    for k in range(cf_k.shape[1]):
        const = np_field.add(const, np_field.mul(cf_k[:, k], gp[ps_k[:, k]]))
    acc = GF.from_u64(const.reshape(v_count, 1), dev).broadcast_to(
        (v_count, m))
    for src, idx, cf, ps in ((trace_gf, idx_c, cf_c, ps_c),
                             (nxt_gf, idx_n, cf_n, ps_n)):
        for k in range(cf.shape[1]):
            w = np_field.mul(cf[:, k], gp[ps[:, k]])
            rows = src.take(idx[:, k], axis=0)
            acc = acc + rows * GF.from_u64(w.reshape(v_count, 1), dev)
    return acc


def _make_aux_fn(lookups, groups):
    """Aux-trace builder for one table's lookup/CTL plan: the returned
    fn(trace_gf, nxt_gf, beta, gamma) computes all helper columns and
    running sums for ONE challenge pair."""
    ids_cursor = 0
    lk_plan = []
    for lk in lookups:
        ids = list(range(ids_cursor, ids_cursor + len(lk.looking_columns)))
        ids_cursor += len(lk.looking_columns)
        tid = ids_cursor
        ids_cursor += 1
        lk_plan.append((lk, ids, tid))
    grp_plan = []
    for _ci, _side, views in groups:
        vids = list(range(ids_cursor, ids_cursor + len(views)))
        ids_cursor += len(views)
        grp_plan.append((views, vids))
    plan = _combo_plan(lookups, groups)

    def fn(trace_gf, nxt_gf, beta, gamma):
        # every denominator of this challenge, inverted in one batch
        inv_rows = _batch_combined_pos(trace_gf, nxt_gf, plan,
                                       beta, gamma).inv()

        def term(idx, filt):
            h = inv_rows[idx]
            f = filt.eval(trace_gf) if filt is not None else None
            return h if f is None else h * f

        out: list[GF] = []
        entries = []
        for lk, ids, tid in lk_plan:
            filts = list(lk.filters) if lk.filters \
                else [None] * len(ids)
            helpers = []
            delta = None
            for i in range(0, len(ids) - 1, 2):
                h = term(ids[i], filts[i]) + term(ids[i + 1],
                                                  filts[i + 1])
                helpers.append(h)
                delta = h if delta is None else delta + h
            if len(ids) % 2 == 1:
                h = term(ids[-1], filts[-1])
                helpers.append(h)
                delta = h if delta is None else delta + h
            ht = trace_gf[lk.frequencies_column] * inv_rows[tid]
            helpers.append(ht)
            delta = delta - ht
            entries.append((helpers, delta))
        for views, vids in grp_plan:
            terms = [term(vid, v.filter) for v, vid in zip(views, vids)]
            helpers = []
            delta = None
            for i in range(0, len(terms) - 1, 2):
                h = terms[i] + terms[i + 1]
                helpers.append(h)
                delta = h if delta is None else delta + h
            if len(terms) % 2 == 1:
                h = terms[-1]
                helpers.append(h)
                delta = h if delta is None else delta + h
            entries.append((helpers, delta))

        zs = _gf_suffix_sum(GF.stack([d for _h, d in entries], axis=0))
        for i, (helpers, _d) in enumerate(entries):
            out.extend(helpers)
            out.append(zs[i])
        return GF.stack(out, axis=0)

    return fn


def generate_aux_trace(trace_gf: GF, lookups: list[Lookup],
                       groups, challenges: ChallengeSet) -> GF | None:
    """Build all aux columns for one table, on trace_gf's device.
    trace_gf: (cols, n); `groups` from ctl_groups_for_table. Returns
    (num_aux, n) GF or None."""
    has_items = bool(lookups) or any(views for _c, _s, views in groups)
    if not has_items:
        return None
    uses_next = any(
        _coerce_expr(e).uses_next()
        for lk in lookups for e in list(lk.looking_columns)
        + [lk.table_column]) or any(
        _coerce_expr(c).uses_next()
        for _ci, _s, views in groups for v in views for c in v.columns)
    nxt_gf = trace_gf.roll(-1, axis=-1) if uses_next else trace_gf
    fn = _make_aux_fn(lookups, groups)
    return GF.concatenate([fn(trace_gf, nxt_gf, beta, gamma)
                           for beta, gamma in challenges.pairs], axis=0)


# ---------------------------------------------------------------------------
# Generic constraint evaluation (runs in both algebras)
# ---------------------------------------------------------------------------

def eval_aux_constraints(lookups: list[Lookup], groups,
                         challenges: ChallengeSet, frame, cc) -> None:
    """Append all lookup/CTL constraints to the consumer. `frame` must
    carry aux_local / aux_next aligned with generate_aux_trace's layout."""
    local = frame.local
    nxt = frame.next
    aux = frame.aux_local
    aux_next = frame.aux_next
    is_vec = isinstance(local, GF)
    plan = _combo_plan(lookups, groups) if is_vec else None
    k = 0
    for beta, gamma in challenges.pairs:
        # Vector path: all beta+combined denominators of this challenge in
        # one batched evaluation (mirrors generate_aux_trace's order).
        drows = None
        dpos = [0]
        if is_vec:
            drows = _batch_combined_pos(local, nxt, plan, beta, gamma)

        def next_denom(scalar_fn):
            if drows is not None:
                row = drows[dpos[0]]
                dpos[0] += 1
                return row
            return scalar_fn() + beta

        for lk in lookups:
            delta = None
            lc = list(lk.looking_columns)
            filts = list(lk.filters) if lk.filters else [None] * len(lc)

            def cf(i):
                c = next_denom(
                    lambda: _coerce_expr(lc[i]).eval(local, nxt))
                f = filts[i].eval(local) if filts[i] is not None else 1
                return c, f

            for i in range(0, len(lc) - 1, 2):
                h = aux[k]
                c1, f1 = cf(i)
                c2, f2 = cf(i + 1)
                cc.constraint(h * c1 * c2 - (f1 * c2 + f2 * c1))
                delta = h if delta is None else delta + h
                k += 1
            if len(lc) % 2 == 1:
                h = aux[k]
                c1, f1 = cf(len(lc) - 1)
                cc.constraint(h * c1 - f1)
                delta = h if delta is None else delta + h
                k += 1
            ht = aux[k]
            tdenom = next_denom(
                lambda: _coerce_expr(lk.table_column).eval(local, nxt))
            cc.constraint(ht * tdenom - local[lk.frequencies_column])
            delta = delta - ht
            k += 1
            z = aux[k]
            z_next = aux_next[k]
            cc.constraint_transition(z - delta - z_next)
            cc.constraint_last_row(z - delta)
            cc.constraint_first_row(z)      # in-table lookups balance to 0
            k += 1
        for _ci, _side, views in groups:

            def vf(v):
                c = next_denom(
                    lambda: _combine(local, nxt, v.columns, gamma))
                f = v.filter.eval(local)
                return c, (1 if f is None else f)

            delta = None
            for i in range(0, len(views) - 1, 2):
                h = aux[k]
                c1, f1 = vf(views[i])
                c2, f2 = vf(views[i + 1])
                cc.constraint(h * c1 * c2 - (f1 * c2 + f2 * c1))
                delta = h if delta is None else delta + h
                k += 1
            if len(views) % 2 == 1:
                h = aux[k]
                c1, f1 = vf(views[-1])
                cc.constraint(h * c1 - f1)
                delta = h if delta is None else delta + h
                k += 1
            z = aux[k]
            z_next = aux_next[k]
            cc.constraint_transition(z - delta - z_next)
            cc.constraint_last_row(z - delta)
            # Z(first) is exported (ctl_zs_first), not constrained to 0
            k += 1


def ctl_view_sum_np(trace: np.ndarray, view: CtlView, beta: int,
                    gamma: int) -> int:
    """Host-exact logUp sum of one CTL view over a raw trace:
    sum_rows filter / (beta + gamma-combine(columns)). Used for the
    verifier's extra looking sums (the reference's
    get_memory_extra_looking_sum mechanism, verifier.rs:319)."""
    exprs = [_coerce_expr(c) for c in view.columns]
    combined = exprs[0].eval_np(trace)
    gp = gamma
    for e in exprs[1:]:
        combined = np_field.add(combined,
                                np_field.mul(e.eval_np(trace),
                                             np.uint64(gp)))
        gp = host.fmul(gp, gamma)
    f = view.filter.eval_np(trace)
    inv = np_field.inv(np_field.add(combined, np.uint64(beta)))
    total = 0
    for v in np_field.mul(f, inv):
        total = host.fadd(total, int(v))
    return total


def ctl_z_first_indices(lookups: list[Lookup], groups,
                        challenges: ChallengeSet) -> list[int]:
    """Aux-column indices of the CTL Z columns (whose x=1 openings are the
    exported totals), in (challenge, group) order."""
    out = []
    k = 0
    per_lookup = sum(lk.num_helpers() + 1 for lk in lookups)
    for _ in challenges.pairs:
        k += per_lookup
        for _ci, _side, views in groups:
            k += (len(views) + 1) // 2     # helpers
            out.append(k)                  # Z
            k += 1
    return out
