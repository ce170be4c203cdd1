"""BytePacking table: memory <-> 256-bit word (un)packing.

Functional twin of the reference's byte_packing table (71 columns =
is_read + 32 index_len flags + 3 address cols + timestamp + 32 value
bytes + range counter/frequencies; zk_evm's evm_arithmetization/
src/byte_packing/{columns.rs,byte_packing_stark.rs}, spec
book/src/tables/byte_packing.md). One row per MLOAD_32BYTES /
MSTORE_32BYTES operation; bytes stored big-endian-reversed; each byte is
range-checked to 8 bits via logUp. The CPU table looks up the packed u32
limbs; the Memory table is looked per byte (wired in all_stark).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..stark import Stark, Lookup, Filter, ColExpr, col

NUM_BYTES = 32
BYTE_RANGE_MAX = 1 << 8

IS_READ = 0
INDEX_LEN = list(range(1, 1 + NUM_BYTES))
ADDR_CONTEXT = INDEX_LEN[-1] + 1
ADDR_SEGMENT = ADDR_CONTEXT + 1
ADDR_VIRTUAL = ADDR_SEGMENT + 1
TIMESTAMP = ADDR_VIRTUAL + 1
VALUE_BYTES = list(range(TIMESTAMP + 1, TIMESTAMP + 1 + NUM_BYTES))
RANGE_COUNTER = VALUE_BYTES[-1] + 1
RC_FREQUENCIES = RANGE_COUNTER + 1
NUM_COLUMNS = RC_FREQUENCIES + 1


@dataclass
class BytePackingOp:
    is_read: bool
    context: int
    segment: int
    virt: int
    timestamp: int
    bytes: bytes        # 1..=32 bytes, big-endian as seen by the CPU


def generate_trace(ops: list[BytePackingOp],
                   min_rows: int = BYTE_RANGE_MAX) -> np.ndarray:
    n = max(max((len(ops), BYTE_RANGE_MAX, min_rows)), 1)
    n = 1 << (n - 1).bit_length()
    trace = np.zeros((NUM_COLUMNS, n), dtype=np.uint64)
    r = 0
    for op in ops:
        if not op.bytes:
            continue
        trace[IS_READ, r] = int(op.is_read)
        trace[ADDR_CONTEXT, r] = op.context
        trace[ADDR_SEGMENT, r] = op.segment
        trace[ADDR_VIRTUAL, r] = op.virt
        trace[TIMESTAMP, r] = op.timestamp
        trace[INDEX_LEN[len(op.bytes) - 1], r] = 1
        for i, b in enumerate(reversed(op.bytes)):
            trace[VALUE_BYTES[i], r] = b
        r += 1
    trace[RANGE_COUNTER, :BYTE_RANGE_MAX] = np.arange(BYTE_RANGE_MAX,
                                                      dtype=np.uint64)
    trace[RANGE_COUNTER, BYTE_RANGE_MAX:] = BYTE_RANGE_MAX - 1
    freq = np.zeros(n, dtype=np.uint64)
    for c in VALUE_BYTES:
        counts = np.bincount(trace[c].astype(np.int64),
                             minlength=BYTE_RANGE_MAX)
        assert len(counts) <= BYTE_RANGE_MAX, "byte value out of range"
        freq[:len(counts)] += counts.astype(np.uint64)
    trace[RC_FREQUENCIES] = freq
    return trace


# ---------------------------------------------------------------------------
# CTL views (all_stark.rs ctl_byte_packing / ctl_memory)
# ---------------------------------------------------------------------------

def ctl_looked_data():
    """(is_read, ctx, seg, virt, sequence_len, timestamp, 8 packed u32
    limbs) — looked up by the CPU's (un)packing operations."""
    limbs = []
    for i in range(8):
        limbs.append(ColExpr(terms=tuple(
            (VALUE_BYTES[4 * i + j], 1 << (8 * j)) for j in range(4))))
    seq_len = ColExpr(terms=tuple(
        (INDEX_LEN[i], i + 1) for i in range(NUM_BYTES)))
    return (col(IS_READ), col(ADDR_CONTEXT), col(ADDR_SEGMENT),
            col(ADDR_VIRTUAL), seq_len, col(TIMESTAMP)) + tuple(limbs)


def ctl_looked_filter() -> Filter:
    return Filter(sum_cols=tuple(INDEX_LEN))


def ctl_looking_memory(i: int):
    """Memory op for byte i: address virt + sequence_len - 1 - i."""
    addr = ColExpr(terms=((ADDR_VIRTUAL, 1),)
                   + tuple((INDEX_LEN[j], j) for j in range(NUM_BYTES)),
                   const=-i)
    return (col(IS_READ), col(ADDR_CONTEXT), col(ADDR_SEGMENT), addr,
            col(VALUE_BYTES[i])) \
        + tuple(ColExpr() for _ in range(7)) + (col(TIMESTAMP),)


def ctl_looking_memory_filter(i: int) -> Filter:
    return Filter(sum_cols=tuple(INDEX_LEN[i:]))


class BytePackingStark(Stark):
    name = "byte_packing"
    num_columns = NUM_COLUMNS

    def eval(self, frame, cc):
        lv = frame.local
        nv = frame.next

        rc1 = lv[RANGE_COUNTER]
        rc2 = nv[RANGE_COUNTER]
        cc.constraint_first_row(rc1)
        incr = rc2 - rc1
        cc.constraint_transition(incr * incr - incr)
        cc.constraint_last_row(rc1 - (BYTE_RANGE_MAX - 1))

        cur_filter = lv[INDEX_LEN[0]]
        for i in INDEX_LEN[1:]:
            cur_filter = cur_filter + lv[i]
        cc.constraint(cur_filter * (cur_filter - 1))
        cc.constraint_first_row(cur_filter - 1)

        is_read = lv[IS_READ]
        cc.constraint(is_read * (is_read - 1))

        for i in INDEX_LEN:
            cc.constraint(lv[i] * (lv[i] - 1))

        next_filter = nv[INDEX_LEN[0]]
        for i in INDEX_LEN[1:]:
            next_filter = next_filter + nv[i]
        cc.constraint_transition(next_filter * (next_filter - cur_filter))

        # bytes beyond the sequence length are zero
        for i in range(NUM_BYTES - 1):
            for j in range(i + 1, NUM_BYTES):
                cc.constraint(lv[INDEX_LEN[i]] * lv[VALUE_BYTES[j]])

    def lookups(self):
        return [Lookup(looking_columns=tuple(VALUE_BYTES),
                       table_column=RANGE_COUNTER,
                       frequencies_column=RC_FREQUENCIES)]

    def requires_ctls(self):
        return True
