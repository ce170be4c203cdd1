"""RvmMem: the verifier VM's RAM argument (ordered memory, scalar cells).

Single-felt-per-cell specialization of the Memory table's ordered-memory
argument (tables/memory.py; reference memory_stark.rs): rows sorted by
(addr, timestamp), boolean first-change flag, range-checked ordering
deltas against a row-counter logUp, reads repeat the previous value, and
a fresh address either begins with a write or reads ZERO (the EVM
memory table's read-zero semantics). Read-zero is sound here because
the VM's program is verifier-known (preprocessed oracle) and built
single-assignment: it never reads an address before writing it, so the
zero-default is only ever exercised by gap-bridging dummy rows. Dummy
(unfiltered) rows must be reads — every nonzero cell value is rooted in
an explicit VM write or an imported boundary value. This is the L2
verifier-AIR's operand bus (stark/DESIGN.md "L2 recursion /
aggregation roadmap", step 2)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..stark import Stark, Lookup, Filter, col

FILTER = 0
ADDR = 1
TIMESTAMP = 2
IS_READ = 3
VALUE = 4
ADDR_CHANGE = 5
RANGE_CHECK = 6
COUNTER = 7
FREQUENCIES = 8
FINAL_EXPORT = 9
NUM_COLUMNS = 10


@dataclass
class RamOp:
    timestamp: int
    addr: int
    is_read: bool
    value: int


def generate_trace(ops: list[RamOp], min_rows: int = 2,
                   before_values: dict[int, int] | None = None,
                   export_addrs=None) -> np.ndarray:
    """Sort by (addr, timestamp), insert dummy reads so every delta fits
    the row-counter range check, pad with terminal dummy reads.

    Chunked (zk-continuation) wraps: `before_values` inject the previous
    chunk's exported cells as timestamp-0 writes (balanced by the
    RvmBoundary MemBefore table's looking view, recursion/continuation
    .py), and `export_addrs` marks each listed address's final row with
    FINAL_EXPORT — the (addr, value) pairs the MemAfter boundary CTL
    carries to the next chunk."""
    ops = list(ops)
    for addr, value in (before_values or {}).items():
        ops.append(RamOp(0, addr, False, value))
    assert ops, "no RAM ops"
    rows = sorted(ops, key=lambda o: (o.addr, o.timestamp))

    # Bound deltas: with n total rows the range check covers 0..n-1.
    # Address deltas are 1 by construction (tape allocates densely), so
    # only timestamp gaps within an address may need filling.
    def build(n_budget: int) -> list[RamOp] | None:
        out: list[RamOp] = []
        max_rc = n_budget - 1
        for op in rows:
            if out:
                prev = out[-1]
                if op.addr == prev.addr:
                    t = prev.timestamp
                    while op.timestamp - t > max_rc:
                        t += max_rc
                        out.append(RamOp(t, prev.addr, True, prev.value))
                else:
                    # bridge address gaps with fresh-address dummy reads
                    # of zero (read-zero semantics; chunked tapes import
                    # sparse address sets, continuation.py)
                    a = prev.addr
                    while op.addr - a - 1 > max_rc:
                        a += max_rc + 1
                        out.append(RamOp(0, a, True, 0))
            out.append(op)
            if len(out) > n_budget:
                return None
        return out

    n = max(min_rows, 2)
    while True:
        while n < len(rows):
            n *= 2
        filled = build(n)
        if filled is not None and len(filled) <= n:
            break
        n *= 2
    rows = filled

    trace = np.zeros((NUM_COLUMNS, n), dtype=np.uint64)
    last = rows[-1]
    orig = {id(o) for o in ops}
    for r in range(n):
        op = rows[r] if r < len(rows) else \
            RamOp(last.timestamp, last.addr, True, last.value)
        # FILTER marks exactly the original ops (dummies/padding are 0).
        trace[FILTER, r] = 1 if id(op) in orig else 0
        trace[ADDR, r] = op.addr
        trace[TIMESTAMP, r] = op.timestamp
        trace[IS_READ, r] = 1 if op.is_read else 0
        trace[VALUE, r] = op.value
    # first-change flags + range check
    for r in range(n - 1):
        a0, a1 = int(trace[ADDR, r]), int(trace[ADDR, r + 1])
        if a1 != a0:
            trace[ADDR_CHANGE, r] = 1
            trace[RANGE_CHECK, r] = a1 - a0 - 1
        else:
            trace[RANGE_CHECK, r] = \
                int(trace[TIMESTAMP, r + 1]) - int(trace[TIMESTAMP, r])
    trace[COUNTER] = np.arange(n, dtype=np.uint64)
    # the lookup covers every row's RANGE_CHECK (incl. the pinned-zero
    # last row), so frequencies must count all n rows
    freq = np.bincount(trace[RANGE_CHECK].astype(np.int64), minlength=n)
    trace[FREQUENCIES] = freq[:n].astype(np.uint64)
    if export_addrs:
        export = set(export_addrs)
        # an address's final row: the row whose next row changes address
        # (ADDR_CHANGE=1), or the global last row
        for r in range(n):
            a = int(trace[ADDR, r])
            if a in export and (r == n - 1 or trace[ADDR_CHANGE, r]):
                trace[FINAL_EXPORT, r] = 1
                export.discard(a)
        assert not export, f"export addresses never touched: {export}"
    return trace


def ctl_data():
    """(is_read, addr, value, timestamp) — the VM side mirrors this."""
    return (col(IS_READ), col(ADDR), col(VALUE), col(TIMESTAMP))


def ctl_filter() -> Filter:
    return Filter(column=FILTER)


def ctl_export_data():
    """(addr, final value) pairs carried to the next chunk's boundary."""
    return (col(ADDR), col(VALUE))


def ctl_export_filter() -> Filter:
    return Filter(column=FINAL_EXPORT)


class RvmMemStark(Stark):
    name = "rvm_mem"
    num_columns = NUM_COLUMNS

    def eval(self, frame, cc):
        lv = frame.local
        nv = frame.next

        filt = lv[FILTER]
        cc.constraint(filt * (filt - 1))
        # dummy (unfiltered) rows must be reads: only VM-driven rows may
        # write, so every cell's value is rooted in an explicit VM write
        cc.constraint((1 - filt) * (1 - lv[IS_READ]))
        ac = lv[ADDR_CHANGE]
        cc.constraint(ac * (ac - 1))
        rd = lv[IS_READ]
        cc.constraint(rd * (rd - 1))

        da = nv[ADDR] - lv[ADDR]
        dt = nv[TIMESTAMP] - lv[TIMESTAMP]
        # same-address runs keep the address fixed
        cc.constraint_transition((1 - ac) * da)
        # the range-checked delta: addr gap - 1 on change, ts delta inside
        cc.constraint_transition(
            lv[RANGE_CHECK] - ac * (da - 1) - (1 - ac) * dt)
        # a fresh address begins with a write or reads zero
        cc.constraint_first_row(lv[IS_READ] * lv[VALUE])
        cc.constraint_transition(ac * nv[IS_READ] * nv[VALUE])
        # reads repeat the previous value within an address
        cc.constraint_transition(
            (1 - ac) * nv[IS_READ] * (nv[VALUE] - lv[VALUE]))
        # FINAL_EXPORT only on an address's last row (next row changes
        # address; the global last row is always a run's end)
        fe = lv[FINAL_EXPORT]
        cc.constraint(fe * (fe - 1))
        cc.constraint_transition(fe * (1 - ac))

        cc.constraint_first_row(lv[COUNTER])
        cc.constraint_transition(nv[COUNTER] - lv[COUNTER] - 1)
        # last row's RANGE_CHECK is unconstrained by transition; pin it
        cc.constraint_last_row(lv[RANGE_CHECK])

    def lookups(self):
        return [Lookup(looking_columns=(col(RANGE_CHECK),),
                       table_column=COUNTER,
                       frequencies_column=FREQUENCIES)]

    def requires_ctls(self):
        return True
