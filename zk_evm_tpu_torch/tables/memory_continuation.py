"""MemBefore / MemAfter tables (zk-continuations).

Functional twin of the reference's MemoryContinuationStark (one type, two
instances; zk_evm's evm_arithmetization/src/memory_continuation/
{memory_continuation_stark.rs,columns.rs}, spec book/src/tables/
mem_continuations.md). Rows are (filter, context, segment, virtual,
8 value limbs) dictionaries of live memory at segment boundaries; the only
in-table constraint is a boolean filter — the content is bound by CTLs
(copied into Memory as timestamp-0 writes / final-value reads) and by the
Merkle caps exported into public values and chained across segments.
"""

from __future__ import annotations

import numpy as np

from ..stark import Stark, Filter, ColExpr, col

FILTER = 0
ADDR_CONTEXT = 1
ADDR_SEGMENT = 2
ADDR_VIRTUAL = 3
VALUE_COLS = list(range(4, 12))
NUM_COLUMNS = 12


def generate_trace(propagated_values, min_rows: int = 128) -> np.ndarray:
    """propagated_values: list of ((context, segment, virt), value)."""
    rows = len(propagated_values)
    n = max(min_rows, 128,
            1 << max(rows - 1, 0).bit_length() if rows else 1)
    trace = np.zeros((NUM_COLUMNS, n), dtype=np.uint64)
    if rows:
        trace[FILTER, :rows] = 1
        trace[ADDR_CONTEXT, :rows] = np.fromiter(
            (a[0] for a, _ in propagated_values), np.uint64, rows)
        trace[ADDR_SEGMENT, :rows] = np.fromiter(
            (a[1] for a, _ in propagated_values), np.uint64, rows)
        trace[ADDR_VIRTUAL, :rows] = np.fromiter(
            (a[2] for a, _ in propagated_values), np.uint64, rows)
        limbs = np.frombuffer(
            b"".join(int(v).to_bytes(32, "little")
                     for _, v in propagated_values),
            dtype=np.uint32).reshape(rows, 8)
        trace[VALUE_COLS[0]:VALUE_COLS[-1] + 1, :rows] = limbs.T
    return trace


def kernel_initial_memory_values(code: bytes):
    """The exact MemBefore content of a first segment: every kernel code
    byte (zeros included) then the 256-entry shift table — the verifier
    recomputes this trace's Merkle cap from the kernel identity alone
    (verifier.rs:14-79 initial_memory_merkle_cap)."""
    from .segments import Segment
    values = [((0, int(Segment.Code), i), b) for i, b in enumerate(code)]
    values += [((0, int(Segment.ShiftTable), i), 1 << i)
               for i in range(256)]
    return values


def ctl_data():
    """(ctx, seg, virt, 8 value limbs) — looked by Memory."""
    return (col(ADDR_CONTEXT), col(ADDR_SEGMENT), col(ADDR_VIRTUAL)) \
        + tuple(col(c) for c in VALUE_COLS)


def ctl_filter() -> Filter:
    return Filter(column=FILTER)


def ctl_data_memory():
    """MemBefore rows injected into Memory as timestamp-0 writes."""
    return (ColExpr(const=0), col(ADDR_CONTEXT), col(ADDR_SEGMENT),
            col(ADDR_VIRTUAL)) + tuple(col(c) for c in VALUE_COLS) \
        + (ColExpr(const=0),)


class MemoryContinuationStark(Stark):
    name = "mem_continuation"
    num_columns = NUM_COLUMNS

    def eval(self, frame, cc):
        f = frame.local[FILTER]
        cc.constraint(f * (f - 1))

    def requires_ctls(self):
        return True
