"""Memory table: the ordered memory argument.

Functional twin of the reference's memory table (30 columns; zk_evm's
evm_arithmetization/src/memory/{columns.rs,memory_stark.rs},
spec book/src/tables/memory.md). Rows are memory operations sorted by
(context, segment, virtual, timestamp); consecutive-row constraints
enforce the ordering via first-change flags and a range-checked delta
column; reads repeat the previous value; fresh addresses outside the
preinitialized segments read zero. Context pruning marks stale contexts
through an in-table lookup; surviving final values feed MemAfter.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..stark import Stark, Lookup, Filter, ColExpr, col, col_next
from .segments import Segment, PREINITIALIZED_SEGMENTS

VALUE_LIMBS = 8

FILTER = 0
TIMESTAMP = 1
TIMESTAMP_INV = 2
IS_READ = 3
ADDR_CONTEXT = 4
ADDR_SEGMENT = 5
ADDR_VIRTUAL = 6
VALUE_COLS = list(range(7, 7 + VALUE_LIMBS))
CONTEXT_FIRST_CHANGE = VALUE_COLS[-1] + 1
SEGMENT_FIRST_CHANGE = CONTEXT_FIRST_CHANGE + 1
VIRTUAL_FIRST_CHANGE = SEGMENT_FIRST_CHANGE + 1
INITIALIZE_AUX = VIRTUAL_FIRST_CHANGE + 1
PREINITIALIZED_SEGMENTS_COL = INITIALIZE_AUX + 1
PREINITIALIZED_SEGMENTS_AUX = PREINITIALIZED_SEGMENTS_COL + 1
STALE_CONTEXTS = PREINITIALIZED_SEGMENTS_AUX + 1
IS_PRUNED = STALE_CONTEXTS + 1
STALE_CONTEXT_FREQUENCIES = IS_PRUNED + 1
IS_STALE = STALE_CONTEXT_FREQUENCIES + 1
MAYBE_IN_MEM_AFTER = IS_STALE + 1
MEM_AFTER_FILTER = MAYBE_IN_MEM_AFTER + 1
RANGE_CHECK = MEM_AFTER_FILTER + 1
COUNTER = RANGE_CHECK + 1
FREQUENCIES = COUNTER + 1
NUM_COLUMNS = FREQUENCIES + 1


@dataclass
class MemoryOp:
    filter: bool
    timestamp: int
    context: int
    segment: int          # unscaled index
    virt: int
    is_read: bool
    value: int            # u256

    def sorting_key(self):
        return (self.context, self.segment, self.virt, self.timestamp)


def dummy_read(context, segment, virt, timestamp, value=0) -> MemoryOp:
    return MemoryOp(False, timestamp, context, segment, virt, True, value)


def fill_gaps(ops: list[MemoryOp]) -> None:
    """Insert dummy reads so every ordering delta fits the range check
    (memory_stark.rs:296-355)."""
    if ops[0].virt != 0:
        ops.insert(0, dummy_read(0, 0, 0, 1))
    max_rc = (1 << (len(ops) - 1).bit_length()) - 1 if len(ops) > 1 else 0
    snapshot = list(ops)
    for i in range(len(snapshot) - 1):
        curr, nxt = snapshot[i], snapshot[i + 1]
        if curr.context != nxt.context or curr.segment != nxt.segment:
            while nxt.virt > max_rc:
                d = dummy_read(nxt.context, nxt.segment, nxt.virt - max_rc,
                               curr.timestamp + 1)
                ops.append(d)
                nxt = d
        elif curr.virt != nxt.virt:
            while nxt.virt - curr.virt - 1 > max_rc:
                d = dummy_read(curr.context, curr.segment,
                               curr.virt + max_rc + 1, curr.timestamp + 1)
                ops.append(d)
                curr = d
        else:
            while nxt.timestamp - curr.timestamp > max_rc:
                d = dummy_read(curr.context, curr.segment, curr.virt,
                               curr.timestamp + max_rc, curr.value)
                ops.append(d)
                curr = d


def _sorted_padded_ops(memory_ops, mem_before_values):
    ops = list(memory_ops)
    for (ctx, seg, virt), val in mem_before_values:
        ops.append(MemoryOp(True, 0, ctx, seg, virt, False, val))
    assert ops, "no memory ops"
    ops.sort(key=MemoryOp.sorting_key)
    fill_gaps(ops)
    ops.sort(key=MemoryOp.sorting_key)
    # pad with dummy reads one past the last address
    last = ops[-1]
    pad = dummy_read(last.context, last.segment, last.virt + 1,
                     last.timestamp + 1)
    n = 1 << len(ops).bit_length()      # >= len+1 padding row
    while len(ops) < n:
        ops.append(pad)
    ops.sort(key=MemoryOp.sorting_key)
    return ops, n


class MemOpsArrays:
    """Struct-of-arrays memory ops (the array-native fast path the
    object pipeline converts into): filter/ts/ctx/seg/virt uint64,
    is_read uint64(0/1), limbs (n, 8) uint32."""

    __slots__ = ("filter", "ts", "ctx", "seg", "virt", "is_read", "limbs")

    def __init__(self, filter, ts, ctx, seg, virt, is_read, limbs):
        self.filter = filter
        self.ts = ts
        self.ctx = ctx
        self.seg = seg
        self.virt = virt
        self.is_read = is_read
        self.limbs = limbs

    def __len__(self):
        return len(self.ts)

    @staticmethod
    def concat(parts):
        return MemOpsArrays(
            *[np.concatenate([getattr(p, f) for p in parts])
              for f in ("filter", "ts", "ctx", "seg", "virt", "is_read")],
            np.concatenate([p.limbs for p in parts], axis=0))

    def take(self, idx):
        return MemOpsArrays(self.filter[idx], self.ts[idx], self.ctx[idx],
                            self.seg[idx], self.virt[idx],
                            self.is_read[idx], self.limbs[idx])


def _ops_to_arrays(ops: list[MemoryOp]) -> MemOpsArrays:
    n = len(ops)
    return MemOpsArrays(
        np.fromiter((op.filter for op in ops), np.uint64, n),
        np.fromiter((op.timestamp for op in ops), np.uint64, n),
        np.fromiter((op.context for op in ops), np.uint64, n),
        np.fromiter((op.segment for op in ops), np.uint64, n),
        np.fromiter((op.virt for op in ops), np.uint64, n),
        np.fromiter((op.is_read for op in ops), np.uint64, n),
        np.frombuffer(
            b"".join(int(op.value).to_bytes(32, "little") for op in ops),
            dtype=np.uint32).reshape(n, VALUE_LIMBS).copy())


def _pairs_to_arrays(pairs) -> MemOpsArrays:
    """((ctx, seg, virt), value) pairs -> timestamp-0 write ops."""
    n = len(pairs)
    return MemOpsArrays(
        np.ones(n, dtype=np.uint64),
        np.zeros(n, dtype=np.uint64),
        np.fromiter((a[0] for a, _ in pairs), np.uint64, n),
        np.fromiter((a[1] for a, _ in pairs), np.uint64, n),
        np.fromiter((a[2] for a, _ in pairs), np.uint64, n),
        np.zeros(n, dtype=np.uint64),
        np.frombuffer(
            b"".join(int(v).to_bytes(32, "little") for _, v in pairs),
            dtype=np.uint32).reshape(n, VALUE_LIMBS).copy())


def _lexsorted(a: MemOpsArrays) -> MemOpsArrays:
    return a.take(np.lexsort((a.ts, a.virt, a.seg, a.ctx)))


def _fill_gaps_arrays(a: MemOpsArrays) -> MemOpsArrays:
    """Vectorized fill_gaps: same dummy-insertion semantics over sorted
    arrays (twin of fill_gaps; equality asserted in tests)."""
    if a.virt[0] != 0:
        front = MemOpsArrays(
            np.zeros(1, np.uint64), np.ones(1, np.uint64),
            np.zeros(1, np.uint64), np.zeros(1, np.uint64),
            np.zeros(1, np.uint64), np.ones(1, np.uint64),
            np.zeros((1, VALUE_LIMBS), np.uint32))
        a = MemOpsArrays.concat([front, a])
    n = len(a)
    max_rc = (1 << (n - 1).bit_length()) - 1 if n > 1 else 0
    if n < 2:
        return a
    i64 = np.int64
    ctx0, ctx1 = a.ctx[:-1].astype(i64), a.ctx[1:].astype(i64)
    seg0, seg1 = a.seg[:-1].astype(i64), a.seg[1:].astype(i64)
    v0, v1 = a.virt[:-1].astype(i64), a.virt[1:].astype(i64)
    t0, t1 = a.ts[:-1].astype(i64), a.ts[1:].astype(i64)
    cs = (ctx0 != ctx1) | (seg0 != seg1)
    vdiff = ~cs & (v0 != v1)
    same = ~cs & ~vdiff
    gap = v1 - v0 - 1
    dt = t1 - t0
    m = np.where(cs & (v1 > max_rc), (np.maximum(v1, 1) - 1) // max(max_rc, 1),
                 0)
    m = np.where(vdiff & (gap > max_rc),
                 -(-(gap - max_rc) // (max_rc + 1)), m)
    m = np.where(same & (dt > max_rc),
                 (np.maximum(dt, 1) - 1) // max(max_rc, 1), m)
    tot = int(m.sum())
    if tot == 0:
        return a
    rep = np.repeat(np.arange(n - 1), m)
    starts = np.cumsum(m) - m
    j = (np.arange(tot) - np.repeat(starts, m) + 1).astype(i64)
    b_cs, b_vd = cs[rep], vdiff[rep]
    d_ctx = np.where(b_cs, ctx1[rep], ctx0[rep])
    d_seg = np.where(b_cs, seg1[rep], seg0[rep])
    d_virt = np.where(b_cs, v1[rep] - j * max_rc,
                      np.where(b_vd, v0[rep] + j * (max_rc + 1), v0[rep]))
    d_ts = np.where(b_cs, t0[rep] + 1,
                    np.where(b_vd, t0[rep] + j, t0[rep] + j * max_rc))
    d_limbs = np.where((b_cs | b_vd)[:, None],
                       np.zeros((1, VALUE_LIMBS), np.uint32),
                       a.limbs[:-1][rep])

    # Every dummy group sorts strictly inside its (row i, row i+1)
    # interval — cs dummies carry row i+1's ctx/seg with virt < v1,
    # vdiff/same dummies stay strictly between on virt/ts — so instead
    # of re-lexsorting the concatenation (the old path: a full 4-key
    # sort + gather), scatter rows straight to their merged positions.
    # Within a group ascending sort order is ascending j, EXCEPT cs
    # groups where virt = v1 - j*max_rc descends with j.
    m_rep = m[rep]
    rank = np.where(b_cs, m_rep - j, j - 1)
    starts_rep = starts[rep]
    dest_dummy = rep + 1 + starts_rep + rank
    dest_orig = np.arange(n, dtype=np.int64)
    dest_orig[1:] += np.cumsum(m)
    out_n = n + tot

    def merge(orig, dummy, dtype):
        out = np.empty(out_n, dtype)
        out[dest_orig] = orig
        out[dest_dummy] = dummy
        return out

    limbs = np.empty((out_n, VALUE_LIMBS), np.uint32)
    limbs[dest_orig] = a.limbs
    limbs[dest_dummy] = d_limbs.astype(np.uint32)
    return MemOpsArrays(
        merge(a.filter, np.zeros(tot, np.uint64), np.uint64),
        merge(a.ts, d_ts.astype(np.uint64), np.uint64),
        merge(a.ctx, d_ctx.astype(np.uint64), np.uint64),
        merge(a.seg, d_seg.astype(np.uint64), np.uint64),
        merge(a.virt, d_virt.astype(np.uint64), np.uint64),
        merge(a.is_read, np.ones(tot, np.uint64), np.uint64),
        limbs)


def generate_trace_arrays(ops: MemOpsArrays,
                          mem_before_values=(),
                          stale_contexts: list[int] = (),
                          min_rows: int = 2):
    """Array-native trace generation engine (same output contract as
    generate_trace_py). mem_before_values: ((ctx, seg, virt), value)
    pairs written at timestamp 0."""
    from ..field import host
    from .. import native
    parts = [ops]
    if mem_before_values:
        parts.append(_pairs_to_arrays(list(mem_before_values)))
    a = MemOpsArrays.concat(parts) if len(parts) > 1 else ops
    assert len(a), "no memory ops"
    a = _fill_gaps_arrays(_lexsorted(a))
    # pad with dummy reads one past the last address
    n = max(1 << len(a).bit_length(), min_rows)
    k = n - len(a)
    pad = MemOpsArrays(
        np.zeros(k, np.uint64),
        np.full(k, a.ts[-1] + 1, np.uint64),
        np.full(k, a.ctx[-1], np.uint64),
        np.full(k, a.seg[-1], np.uint64),
        np.full(k, a.virt[-1] + 1, np.uint64),
        np.ones(k, np.uint64),
        np.zeros((k, VALUE_LIMBS), np.uint32))
    a = MemOpsArrays.concat([a, pad])

    trace = np.zeros((NUM_COLUMNS, n), dtype=np.uint64)
    ts, ctx, seg, virt, limbs = a.ts, a.ctx, a.seg, a.virt, a.limbs
    trace[FILTER] = a.filter
    trace[TIMESTAMP] = ts
    trace[TIMESTAMP_INV] = native.gl_batch_inv(ts)
    trace[IS_READ] = a.is_read
    trace[ADDR_CONTEXT], trace[ADDR_SEGMENT], trace[ADDR_VIRTUAL] = \
        ctx, seg, virt
    trace[VALUE_COLS[0]:VALUE_COLS[-1] + 1] = limbs.T

    # first-change flags + range check (cyclic next row)
    nctx, nseg = np.roll(ctx, -1), np.roll(seg, -1)
    nvirt, nts = np.roll(virt, -1), np.roll(ts, -1)
    cfc = ctx != nctx
    sfc = ~cfc & (seg != nseg)
    vfc = ~cfc & ~sfc & (virt != nvirt)
    trace[CONTEXT_FIRST_CHANGE] = cfc
    trace[SEGMENT_FIRST_CHANGE] = sfc
    trace[VIRTUAL_FIRST_CHANGE] = vfc
    i64 = np.int64
    rc = np.where(
        cfc, nctx.astype(i64) - ctx.astype(i64) - 1,
        np.where(sfc, nseg.astype(i64) - seg.astype(i64) - 1,
                 np.where(vfc, nvirt.astype(i64) - virt.astype(i64) - 1,
                          nts.astype(i64) - ts.astype(i64))))
    rc[n - 1] = 0
    assert ((rc >= 0) & (rc < n)).all(), \
        "range check out of bounds; fill_gaps bug"
    trace[RANGE_CHECK] = rc.astype(np.uint64)

    # aux columns for zero-initialization constraints (small signed
    # products of unscaled segment indices, reduced into the field)
    sn = nseg.astype(i64)
    aux2 = ((sn - Segment.AccountsLinkedList)
            * (sn - Segment.StorageLinkedList))
    pre = (sn - Segment.Code) * (sn - Segment.TrieData) * aux2
    addr_changed = cfc | sfc | vfc
    init_aux = pre * addr_changed * np.roll(trace[IS_READ], -1).astype(i64)

    def _mod_p(x):
        out = np.where(x >= 0, x, 0).astype(np.uint64)
        neg = x < 0
        out[neg] = np.uint64(host.P) - (-x[neg]).astype(np.uint64)
        return out

    trace[PREINITIALIZED_SEGMENTS_AUX] = _mod_p(aux2)
    trace[PREINITIALIZED_SEGMENTS_COL] = _mod_p(pre)
    trace[INITIALIZE_AUX] = _mod_p(init_aux)

    # stale contexts (context pruning)
    stale_rows = np.zeros(n, dtype=bool)
    for c in stale_contexts:
        trace[STALE_CONTEXTS, c] = c + 1
        trace[IS_PRUNED, c] = 1
        mask = ctx == c
        stale_rows |= mask
        trace[STALE_CONTEXT_FREQUENCIES, c] = mask.sum()
    trace[IS_STALE] = stale_rows

    # counter / frequencies / mem_after
    trace[COUNTER] = np.arange(n, dtype=np.uint64)
    freq = np.bincount(rc, minlength=n)
    cs_rows = np.flatnonzero(cfc | sfc)
    looked_virt = nvirt[cs_rows].astype(np.int64)
    if len(cs_rows) and cs_rows[-1] == n - 1:
        looked_virt[-1] = 0
    assert (looked_virt < n).all(), "first-change virt out of range"
    freq += np.bincount(looked_virt, minlength=n)[:n]
    trace[FREQUENCIES] = freq.astype(np.uint64)

    maybe = trace[FILTER].astype(bool) & addr_changed & ~stale_rows
    trace[MAYBE_IN_MEM_AFTER] = maybe
    nonzero = limbs.any(axis=1)
    preinit = np.zeros(n, dtype=bool)
    for s in PREINITIALIZED_SEGMENTS:
        preinit |= seg == s
    after = maybe & (nonzero | preinit)
    trace[MEM_AFTER_FILTER] = after
    mem_after = []
    for r in np.flatnonzero(after):
        v = 0
        for j in range(VALUE_LIMBS):
            v |= int(limbs[r, j]) << (32 * j)
        mem_after.append(((int(ctx[r]), int(seg[r]), int(virt[r])), v))
    return trace, mem_after


def generate_trace(memory_ops: list[MemoryOp],
                   mem_before_values=(),
                   stale_contexts: list[int] = ()):
    """Returns (trace, mem_after_values). mem_before_values: list of
    ((context, segment, virt), value) written at timestamp 0.

    Object-API front of the array engine (bit-identical to
    generate_trace_py; asserted in tests)."""
    return generate_trace_arrays(_ops_to_arrays(list(memory_ops)),
                                 mem_before_values, stale_contexts)


def generate_trace_py(memory_ops: list[MemoryOp],
                      mem_before_values=(),
                      stale_contexts: list[int] = ()):
    """Row-at-a-time reference twin of generate_trace (kept as the
    ground-truth oracle for the vectorized path)."""
    ops, n = _sorted_padded_ops(memory_ops, mem_before_values)

    trace = np.zeros((NUM_COLUMNS, n), dtype=np.uint64)
    for r, op in enumerate(ops):
        trace[FILTER, r] = int(op.filter)
        trace[TIMESTAMP, r] = op.timestamp
        if op.timestamp:
            from ..field import host
            trace[TIMESTAMP_INV, r] = host.finv(op.timestamp)
        trace[IS_READ, r] = int(op.is_read)
        trace[ADDR_CONTEXT, r] = op.context
        trace[ADDR_SEGMENT, r] = op.segment
        trace[ADDR_VIRTUAL, r] = op.virt
        for j in range(VALUE_LIMBS):
            trace[VALUE_COLS[j], r] = (op.value >> (32 * j)) & 0xFFFFFFFF

    # first-change flags + range check (cyclic next row)
    for r in range(n):
        nr = (r + 1) % n
        cfc = trace[ADDR_CONTEXT, r] != trace[ADDR_CONTEXT, nr]
        sfc = (not cfc) and trace[ADDR_SEGMENT, r] != trace[ADDR_SEGMENT, nr]
        vfc = (not cfc and not sfc) and \
            trace[ADDR_VIRTUAL, r] != trace[ADDR_VIRTUAL, nr]
        trace[CONTEXT_FIRST_CHANGE, r] = cfc
        trace[SEGMENT_FIRST_CHANGE, r] = sfc
        trace[VIRTUAL_FIRST_CHANGE, r] = vfc
        if r == n - 1:
            rc = 0
        elif cfc:
            rc = int(trace[ADDR_CONTEXT, nr]) - int(trace[ADDR_CONTEXT, r]) - 1
        elif sfc:
            rc = int(trace[ADDR_SEGMENT, nr]) - int(trace[ADDR_SEGMENT, r]) - 1
        elif vfc:
            rc = int(trace[ADDR_VIRTUAL, nr]) - int(trace[ADDR_VIRTUAL, r]) - 1
        else:
            rc = int(trace[TIMESTAMP, nr]) - int(trace[TIMESTAMP, r])
        assert 0 <= rc < n, f"range check {rc} out of bounds; fill_gaps bug"
        trace[RANGE_CHECK, r] = rc
        # aux columns for zero-initialization constraints
        next_seg = int(trace[ADDR_SEGMENT, nr])
        aux2 = ((next_seg - Segment.AccountsLinkedList)
                * (next_seg - Segment.StorageLinkedList))
        pre = ((next_seg - Segment.Code) * (next_seg - Segment.TrieData)
               * aux2)
        from ..field import host
        trace[PREINITIALIZED_SEGMENTS_AUX, r] = aux2 % host.P
        trace[PREINITIALIZED_SEGMENTS_COL, r] = pre % host.P
        addr_changed = cfc or sfc or vfc
        trace[INITIALIZE_AUX, r] = (pre * int(addr_changed)
                                    * int(trace[IS_READ, nr])) % host.P

    # stale contexts (context pruning)
    for ctx in stale_contexts:
        trace[STALE_CONTEXTS, ctx] = ctx + 1
        trace[IS_PRUNED, ctx] = 1

    # counter / frequencies / stale marking / mem_after
    trace[COUNTER] = np.arange(n, dtype=np.uint64)
    freq = np.zeros(n, dtype=np.uint64)
    mem_after = []
    for r in range(n):
        freq[int(trace[RANGE_CHECK, r])] += 1
        if trace[CONTEXT_FIRST_CHANGE, r] or trace[SEGMENT_FIRST_CHANGE, r]:
            nr = (r + 1) % n
            v = int(trace[ADDR_VIRTUAL, nr]) if r < n - 1 else 0
            freq[v] += 1
        ctx = int(trace[ADDR_CONTEXT, r])
        if ctx + 1 == int(trace[STALE_CONTEXTS, ctx]):
            trace[IS_STALE, r] = 1
            trace[STALE_CONTEXT_FREQUENCIES, ctx] += 1
        elif trace[FILTER, r] and (trace[CONTEXT_FIRST_CHANGE, r]
                                   or trace[SEGMENT_FIRST_CHANGE, r]
                                   or trace[VIRTUAL_FIRST_CHANGE, r]):
            trace[MAYBE_IN_MEM_AFTER, r] = 1
            seg = int(trace[ADDR_SEGMENT, r])
            nonzero = any(trace[VALUE_COLS[j], r] for j in range(VALUE_LIMBS))
            if nonzero or seg in PREINITIALIZED_SEGMENTS:
                trace[MEM_AFTER_FILTER, r] = 1
                addr = (ctx, seg, int(trace[ADDR_VIRTUAL, r]))
                val = sum(int(trace[VALUE_COLS[j], r]) << (32 * j)
                          for j in range(VALUE_LIMBS))
                mem_after.append((addr, val))
    trace[FREQUENCIES] = freq
    return trace, mem_after


# ---------------------------------------------------------------------------
# CTL views (all_stark.rs ctl_memory / ctl_mem_before / ctl_mem_after /
# ctl_context_pruning)
# ---------------------------------------------------------------------------

def ctl_data():
    """(is_read, ctx, seg, virt, 8 value limbs, timestamp)."""
    return (col(IS_READ), col(ADDR_CONTEXT), col(ADDR_SEGMENT),
            col(ADDR_VIRTUAL)) \
        + tuple(col(c) for c in VALUE_COLS) + (col(TIMESTAMP),)


def ctl_filter() -> Filter:
    return Filter(column=FILTER)


def ctl_looking_mem():
    """(ctx, seg, virt, 8 value limbs) for MemBefore/MemAfter."""
    return (col(ADDR_CONTEXT), col(ADDR_SEGMENT), col(ADDR_VIRTUAL)) \
        + tuple(col(c) for c in VALUE_COLS)


def ctl_filter_mem_before() -> Filter:
    """Initial values: rows with timestamp 0 (1 - ts * ts_inv)."""
    return Filter(products=((col(TIMESTAMP),
                             ColExpr(terms=((TIMESTAMP_INV, -1),))),),
                  constants=(ColExpr(const=1),))


def ctl_filter_mem_after() -> Filter:
    return Filter(column=MEM_AFTER_FILTER)


def ctl_context_pruning_looking():
    """(stale_contexts - 1) with is_pruned filter: the Memory table's
    pruning rows look up the CPU's SET_CONTEXT-with-pruning-flag rows
    (memory_stark.rs ctl_context_pruning_looking:68-77)."""
    return (ColExpr(terms=((STALE_CONTEXTS, 1),), const=-1),)


def ctl_context_pruning_looking_filter() -> Filter:
    return Filter(constants=(col(IS_PRUNED),))


class MemoryStark(Stark):
    name = "memory"
    num_columns = NUM_COLUMNS

    def eval(self, frame, cc):
        lv = frame.local
        nv = frame.next

        filt = lv[FILTER]
        cc.constraint(filt * (filt - 1))
        # dummy rows must be reads
        cc.constraint((1 - filt) * (1 - lv[IS_READ]))

        cfc = lv[CONTEXT_FIRST_CHANGE]
        sfc = lv[SEGMENT_FIRST_CHANGE]
        vfc = lv[VIRTUAL_FIRST_CHANGE]
        unchanged = 1 - cfc - sfc - vfc
        for flag in (cfc, sfc, vfc, unchanged):
            cc.constraint(flag * (1 - flag))

        dc = nv[ADDR_CONTEXT] - lv[ADDR_CONTEXT]
        ds = nv[ADDR_SEGMENT] - lv[ADDR_SEGMENT]
        dv = nv[ADDR_VIRTUAL] - lv[ADDR_VIRTUAL]
        dt = nv[TIMESTAMP] - lv[TIMESTAMP]
        cc.constraint_transition(sfc * dc)
        cc.constraint_transition(vfc * dc)
        cc.constraint_transition(vfc * ds)
        cc.constraint_transition(unchanged * dc)
        cc.constraint_transition(unchanged * ds)
        cc.constraint_transition(unchanged * dv)

        computed_rc = cfc * (dc - 1) + sfc * (ds - 1) + vfc * (dv - 1) \
            + unchanged * dt
        cc.constraint_transition(lv[RANGE_CHECK] - computed_rc)

        # preinitialized-segment helper columns
        aux2 = lv[PREINITIALIZED_SEGMENTS_AUX]
        cc.constraint_transition(
            aux2 - (nv[ADDR_SEGMENT] - Segment.AccountsLinkedList)
            * (nv[ADDR_SEGMENT] - Segment.StorageLinkedList))
        pre = lv[PREINITIALIZED_SEGMENTS_COL]
        cc.constraint_transition(
            pre - (nv[ADDR_SEGMENT] - Segment.Code)
            * (nv[ADDR_SEGMENT] - Segment.TrieData) * aux2)
        init_aux = lv[INITIALIZE_AUX]
        cc.constraint_transition(
            init_aux - pre * (1 - unchanged) * nv[IS_READ])

        for j in range(VALUE_LIMBS):
            cc.constraint_transition(
                nv[IS_READ] * unchanged
                * (nv[VALUE_COLS[j]] - lv[VALUE_COLS[j]]))
            cc.constraint_transition(init_aux * nv[VALUE_COLS[j]])

        # mem_after plumbing
        cc.constraint_transition(
            lv[MAYBE_IN_MEM_AFTER]
            + filt * (1 - unchanged) * (lv[IS_STALE] - 1))
        maf = lv[MEM_AFTER_FILTER]
        cc.constraint(maf * (maf - 1))
        for j in range(VALUE_LIMBS):
            cc.constraint((maf - lv[MAYBE_IN_MEM_AFTER]) * pre
                          * lv[VALUE_COLS[j]])

        # timestamp inverse (CTL filter soundness)
        ts = lv[TIMESTAMP]
        cc.constraint(ts * (ts * lv[TIMESTAMP_INV] - 1))

        # counter: 0, +1 each row
        cc.constraint_first_row(lv[COUNTER])
        cc.constraint_transition(nv[COUNTER] - lv[COUNTER] - 1)

    def lookups(self):
        return [
            Lookup(
                looking_columns=(col(RANGE_CHECK), col_next(ADDR_VIRTUAL)),
                table_column=COUNTER,
                frequencies_column=FREQUENCIES,
                filters=(None, Filter(sum_cols=(CONTEXT_FIRST_CHANGE,
                                                SEGMENT_FIRST_CHANGE)))),
            Lookup(
                looking_columns=(ColExpr(terms=((ADDR_CONTEXT, 1),),
                                         const=1),),
                table_column=STALE_CONTEXTS,
                frequencies_column=STALE_CONTEXT_FREQUENCIES,
                filters=(Filter(column=IS_STALE),)),
        ]

    def requires_ctls(self):
        return True
