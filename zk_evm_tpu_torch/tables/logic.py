"""Logic table: AND / OR / XOR over 256-bit words.

Functional twin of the reference's logic table (523 columns = 3 op flags +
2x256 input bits + 8 packed 32-bit result limbs; zk_evm's
evm_arithmetization/src/logic.rs:26-71, constraints :249-305; spec
book/src/tables/logic.md). Serves the CPU and KeccakSponge tables via CTL.

Packed-operation identity (one degree-3 constraint set for all three ops):
    op(x,y) = A*x*y + B*(x+y),  A = f_and - f_or - 2*f_xor, B = f_or + f_xor
so AND = xy, OR = x + y - xy, XOR = x + y - 2xy, bit by bit, summed into
32-bit limbs with power-of-two weights.
"""

from __future__ import annotations

import numpy as np

from ..field import host
from ..stark import Stark, StarkFrame, ConstraintConsumer, Filter, ColExpr, col

# column layout
IS_AND = 0
IS_OR = 1
IS_XOR = 2
INPUT0 = 3                       # 256 bit columns
INPUT1 = INPUT0 + 256            # 256 bit columns
RESULT = INPUT1 + 256            # 8 x 32-bit limb columns
NUM_COLUMNS = RESULT + 8

PACKED_LIMB_BITS = 32


def ctl_data():
    """Looked by CPU and KeccakSponge: opcode (0x16/0x17/0x18 from flags),
    input0/input1 as 8 packed u32 limbs each (from bits), result limbs."""
    out = [ColExpr(terms=((IS_AND, 0x16), (IS_OR, 0x17), (IS_XOR, 0x18)))]
    for base in (INPUT0, INPUT1):
        for j in range(8):
            out.append(ColExpr(terms=tuple(
                (base + 32 * j + t, 1 << t) for t in range(32))))
    out.extend(col(RESULT + j) for j in range(8))
    return tuple(out)


def ctl_filter() -> Filter:
    return Filter(sum_cols=(IS_AND, IS_OR, IS_XOR))


class LogicStark(Stark):
    name = "logic"
    num_columns = NUM_COLUMNS

    def eval(self, frame: StarkFrame, cc: ConstraintConsumer) -> None:
        lv = frame.local
        f_and, f_or, f_xor = lv[IS_AND], lv[IS_OR], lv[IS_XOR]
        # flags are boolean and mutually exclusive
        for f in (f_and, f_or, f_xor):
            cc.constraint(f * f - f)
        s = f_and + f_or + f_xor
        cc.constraint(s * s - s)
        # input bits are boolean
        for i in range(256):
            b = lv[INPUT0 + i]
            cc.constraint(b * b - b)
            b = lv[INPUT1 + i]
            cc.constraint(b * b - b)
        # packed result limbs
        # A = f_and - f_or - 2 f_xor ; B = f_or + f_xor  (degree 1 each)
        a_coef = f_and - f_or - (f_xor + f_xor)
        b_coef = f_or + f_xor
        for j in range(8):
            acc = None
            for i in range(PACKED_LIMB_BITS):
                bit = j * PACKED_LIMB_BITS + i
                x = lv[INPUT0 + bit]
                y = lv[INPUT1 + bit]
                term = x * y * (1 << i)
                sum_term = (x + y) * (1 << i)
                acc = term if acc is None else acc + term
                acc_sum = sum_term if bit % PACKED_LIMB_BITS == 0 \
                    else acc_sum + sum_term
            limb = a_coef * acc + b_coef * acc_sum
            cc.constraint(lv[RESULT + j] - limb)


def generate_trace(ops: list[tuple[str, int, int]],
                   min_rows: int = 8) -> np.ndarray:
    """ops: list of (op_name, x, y) with 256-bit ints. Returns a
    (NUM_COLUMNS, n) uint64 trace padded to a power of two."""
    n = max(min_rows, 1)
    while n < len(ops):
        n *= 2
    cols = np.zeros((NUM_COLUMNS, n), dtype=np.uint64)
    k = len(ops)
    if not k:
        return cols
    flag_of = {"and": IS_AND, "or": IS_OR, "xor": IS_XOR}
    flags = np.array([flag_of[op] for op, _, _ in ops], dtype=np.int64)
    xb = np.frombuffer(b"".join(x.to_bytes(32, "little")
                                for _, x, _ in ops),
                       dtype=np.uint8).reshape(k, 32)
    yb = np.frombuffer(b"".join(y.to_bytes(32, "little")
                                for _, _, y in ops),
                       dtype=np.uint8).reshape(k, 32)
    rows = np.arange(k)
    cols[flags, rows] = 1
    cols[INPUT0:INPUT0 + 256, :k] = \
        np.unpackbits(xb, axis=1, bitorder="little").T
    cols[INPUT1:INPUT1 + 256, :k] = \
        np.unpackbits(yb, axis=1, bitorder="little").T
    is_and = (flags == IS_AND)[:, None]
    is_or = (flags == IS_OR)[:, None]
    resb = np.where(is_and, xb & yb, np.where(is_or, xb | yb, xb ^ yb))
    w = (np.uint64(1) << (np.uint64(8) * np.arange(4, dtype=np.uint64)))
    limbs = (resb.reshape(k, 8, 4).astype(np.uint64) * w).sum(axis=2)
    cols[RESULT:RESULT + 8, :k] = limbs.T
    return cols


def check_trace(trace: np.ndarray) -> None:
    """Host-exact constraint check over raw trace rows (the reference's
    debug check_ctls analog for a single table)."""
    n = trace.shape[1]
    for r in range(n):
        f_and, f_or, f_xor = (int(trace[IS_AND, r]), int(trace[IS_OR, r]),
                              int(trace[IS_XOR, r]))
        assert f_and in (0, 1) and f_or in (0, 1) and f_xor in (0, 1)
        assert f_and + f_or + f_xor <= 1
        x = sum(int(trace[INPUT0 + i, r]) << i for i in range(256))
        y = sum(int(trace[INPUT1 + i, r]) << i for i in range(256))
        a = (f_and - f_or - 2 * f_xor) % host.P
        b = (f_or + f_xor) % host.P
        for j in range(8):
            want = 0
            for i in range(32):
                bit = 32 * j + i
                xb = (x >> bit) & 1
                yb = (y >> bit) & 1
                want = (want + (1 << i) * (a * xb * yb + b * (xb + yb))) \
                    % host.P
            assert int(trace[RESULT + j, r]) == want, (r, j)
