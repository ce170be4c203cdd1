"""KeccakSponge table: absorb/pad/squeeze driving the Keccak table.

Functional twin of the reference's keccak_sponge table (438 columns;
zk_evm's evm_arithmetization/src/keccak_sponge/{columns.rs,
keccak_sponge_stark.rs}, spec book/src/tables/keccak_sponge.md). One row
per absorbed rate-block (136 bytes); reads input bytes from Memory via
CTL, sends the xored rate to the Keccak table, XORs via the Logic table,
and exposes the digest to the CPU. Block bytes are range-checked to 8
bits via logUp. Legacy Keccak 10*1 padding (0x01 ... 0x80), i.e.
Ethereum's keccak256.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..stark import Stark, Lookup, Filter, ColExpr, col
from .keccak import keccak_f

RATE_BYTES = 136
RATE_U32S = RATE_BYTES // 4
CAPACITY_U32S = 16
WIDTH_U32S = 50
DIGEST_BYTES = 32
DIGEST_U32S = 8
WIDTH_MINUS_DIGEST_U32S = WIDTH_U32S - DIGEST_U32S   # 42
BYTE_RANGE_MAX = 256

IS_FULL_INPUT_BLOCK = 0
CONTEXT = 1
SEGMENT = 2
VIRT = 3
TIMESTAMP = 4
ALREADY_ABSORBED_BYTES = 5
IS_PADDING_BYTE = list(range(6, 6 + RATE_BYTES))
ORIGINAL_RATE_U32S = list(range(IS_PADDING_BYTE[-1] + 1,
                                IS_PADDING_BYTE[-1] + 1 + RATE_U32S))
ORIGINAL_CAPACITY_U32S = list(range(ORIGINAL_RATE_U32S[-1] + 1,
                                    ORIGINAL_RATE_U32S[-1] + 1
                                    + CAPACITY_U32S))
BLOCK_BYTES = list(range(ORIGINAL_CAPACITY_U32S[-1] + 1,
                         ORIGINAL_CAPACITY_U32S[-1] + 1 + RATE_BYTES))
XORED_RATE_U32S = list(range(BLOCK_BYTES[-1] + 1,
                             BLOCK_BYTES[-1] + 1 + RATE_U32S))
PARTIAL_UPDATED_STATE_U32S = list(range(
    XORED_RATE_U32S[-1] + 1,
    XORED_RATE_U32S[-1] + 1 + WIDTH_MINUS_DIGEST_U32S))
UPDATED_DIGEST_STATE_BYTES = list(range(
    PARTIAL_UPDATED_STATE_U32S[-1] + 1,
    PARTIAL_UPDATED_STATE_U32S[-1] + 1 + DIGEST_BYTES))
RANGE_COUNTER = UPDATED_DIGEST_STATE_BYTES[-1] + 1
RC_FREQUENCIES = RANGE_COUNTER + 1
NUM_COLUMNS = RC_FREQUENCIES + 1


@dataclass
class KeccakSpongeOp:
    context: int
    segment: int
    virt: int
    timestamp: int
    input: bytes


def _keccakf_u32s(state_u32s):
    lanes = [state_u32s[2 * i] | (state_u32s[2 * i + 1] << 32)
             for i in range(25)]
    out = keccak_f(lanes)
    res = []
    for lane in out:
        res.append(lane & 0xFFFFFFFF)
        res.append(lane >> 32)
    return res


def keccak256(data: bytes) -> bytes:
    """Host reference digest (for tests / trie hashing)."""
    state = [0] * WIDTH_U32S
    blocks = [data[i:i + RATE_BYTES]
              for i in range(0, len(data), RATE_BYTES)]
    if not blocks or len(blocks[-1]) == RATE_BYTES:
        blocks.append(b"")
    final = bytearray(blocks[-1])
    if len(final) == RATE_BYTES - 1:
        final.append(0b10000001)
    else:
        final.append(0x01)
        final.extend(b"\x00" * (RATE_BYTES - len(final)))
        final[-1] |= 0b10000000
    blocks[-1] = bytes(final)
    for block in blocks:
        for i in range(RATE_U32S):
            state[i] ^= int.from_bytes(block[4 * i:4 * i + 4], "little")
        state = _keccakf_u32s(state)
    out = b"".join(state[i].to_bytes(4, "little")
                   for i in range(DIGEST_U32S))
    return out


def generate_trace(ops: list[KeccakSpongeOp],
                   min_rows: int = BYTE_RANGE_MAX) -> np.ndarray:
    rows = []
    for op in ops:
        state = [0] * WIDTH_U32S
        absorbed = 0
        data = op.input
        n_full = len(data) // RATE_BYTES
        for b in range(n_full):
            block = data[b * RATE_BYTES:(b + 1) * RATE_BYTES]
            row, state = _make_row(op, absorbed, state, block,
                                   is_full=True)
            rows.append(row)
            absorbed += RATE_BYTES
        final_inputs = data[n_full * RATE_BYTES:]
        block = bytearray(final_inputs)
        if len(block) == RATE_BYTES - 1:
            block.append(0b10000001)
        else:
            block.append(0x01)
            block.extend(b"\x00" * (RATE_BYTES - len(block)))
            block[-1] |= 0b10000000
        row, state = _make_row(op, absorbed, state, bytes(block),
                               is_full=False,
                               padding_from=len(final_inputs))
        rows.append(row)
    n = max(min_rows, BYTE_RANGE_MAX, 1)
    while n < len(rows):
        n *= 2
    trace = np.zeros((NUM_COLUMNS, n), dtype=np.uint64)
    for r, row in enumerate(rows):
        for c, v in row.items():
            trace[c, r] = v
    trace[RANGE_COUNTER, :BYTE_RANGE_MAX] = np.arange(BYTE_RANGE_MAX,
                                                      dtype=np.uint64)
    trace[RANGE_COUNTER, BYTE_RANGE_MAX:] = BYTE_RANGE_MAX - 1
    freq = np.zeros(n, dtype=np.uint64)
    for c in BLOCK_BYTES:
        counts = np.bincount(trace[c].astype(np.int64),
                             minlength=BYTE_RANGE_MAX)
        freq[:len(counts)] += counts.astype(np.uint64)
    trace[RC_FREQUENCIES] = freq
    return trace


def _make_row(op, absorbed, state, block, is_full, padding_from=None):
    row = {}
    if is_full:
        row[IS_FULL_INPUT_BLOCK] = 1
    else:
        for i in range(padding_from, RATE_BYTES):
            row[IS_PADDING_BYTE[i]] = 1
    row[CONTEXT] = op.context
    row[SEGMENT] = op.segment
    row[VIRT] = op.virt
    row[TIMESTAMP] = op.timestamp
    row[ALREADY_ABSORBED_BYTES] = absorbed
    for i, c in enumerate(ORIGINAL_RATE_U32S):
        row[c] = state[i]
    for i, c in enumerate(ORIGINAL_CAPACITY_U32S):
        row[c] = state[RATE_U32S + i]
    for i, c in enumerate(BLOCK_BYTES):
        row[c] = block[i]
    new_state = list(state)
    for i in range(RATE_U32S):
        word = int.from_bytes(block[4 * i:4 * i + 4], "little")
        new_state[i] ^= word
        row[XORED_RATE_U32S[i]] = new_state[i]
    new_state = _keccakf_u32s(new_state)
    for i, c in enumerate(PARTIAL_UPDATED_STATE_U32S):
        row[c] = new_state[DIGEST_U32S + i]
    digest_bytes = b"".join(new_state[i].to_bytes(4, "little")
                            for i in range(DIGEST_U32S))
    for i, c in enumerate(UPDATED_DIGEST_STATE_BYTES):
        row[c] = digest_bytes[i]
    return row, new_state


# ---------------------------------------------------------------------------
# CTL views (all_stark.rs ctl_keccak_sponge / ctl_keccak_inputs/outputs /
# ctl_logic / ctl_memory)
# ---------------------------------------------------------------------------

def ctl_looked_data():
    """What the CPU looks up: addr, input length, timestamp, digest as 8
    big-endian u32 limbs in reversed order (CPU convention)."""
    out = []
    for i in reversed(range(8)):
        terms = tuple(
            (UPDATED_DIGEST_STATE_BYTES[4 * i + j], 1 << (24 - 8 * j))
            for j in range(4))
        out.append(ColExpr(terms=terms))
    len_col = ColExpr(
        terms=((ALREADY_ABSORBED_BYTES, 1),)
        + tuple((IS_PADDING_BYTE[i], -1) for i in range(RATE_BYTES)),
        const=RATE_BYTES)
    return (col(CONTEXT), col(SEGMENT), col(VIRT), len_col,
            col(TIMESTAMP)) + tuple(out)


def ctl_looked_filter() -> Filter:
    return Filter(column=IS_PADDING_BYTE[-1])


def ctl_looking_keccak_inputs():
    return tuple(col(c) for c in XORED_RATE_U32S) \
        + tuple(col(c) for c in ORIGINAL_CAPACITY_U32S) \
        + (col(TIMESTAMP),)


def ctl_looking_keccak_outputs():
    out = []
    for i in range(DIGEST_U32S):
        terms = tuple((UPDATED_DIGEST_STATE_BYTES[4 * i + j], 1 << (8 * j))
                      for j in range(4))
        out.append(ColExpr(terms=terms))
    return tuple(out) + tuple(col(c) for c in PARTIAL_UPDATED_STATE_U32S) \
        + (col(TIMESTAMP),)


def ctl_looking_keccak_filter() -> Filter:
    return Filter(sum_cols=(IS_FULL_INPUT_BLOCK, IS_PADDING_BYTE[-1]))


NUM_LOGIC_CTLS = (RATE_BYTES + 31) // 32      # 5


def ctl_looking_logic(i: int):
    """XOR dispatch to the Logic table: opcode 0x18, 8 u32 limbs each of
    input0 (original rate), input1 (block bytes), output (xored rate)."""
    zero = ColExpr()
    out = [ColExpr(const=0x18)]
    for j in range(8):
        k = i * 8 + j
        out.append(col(ORIGINAL_RATE_U32S[k]) if k < RATE_U32S else zero)
    for j in range(8):
        k = i * 32 + 4 * j
        if k < RATE_BYTES:
            out.append(ColExpr(terms=tuple(
                (BLOCK_BYTES[k + t], 1 << (8 * t))
                for t in range(4) if k + t < RATE_BYTES)))
        else:
            out.append(zero)
    for j in range(8):
        k = i * 8 + j
        out.append(col(XORED_RATE_U32S[k]) if k < RATE_U32S else zero)
    return tuple(out)


def ctl_looking_logic_filter() -> Filter:
    return Filter(sum_cols=(IS_FULL_INPUT_BLOCK, IS_PADDING_BYTE[-1]))


def ctl_looking_memory(i: int):
    """Read of input byte i: (is_read=1, ctx, seg, virt+absorbed+i, byte,
    0*7, timestamp) — matches memory.ctl_data's shape."""
    return (ColExpr(const=1), col(CONTEXT), col(SEGMENT),
            ColExpr(terms=((VIRT, 1), (ALREADY_ABSORBED_BYTES, 1)),
                    const=i),
            col(BLOCK_BYTES[i])) \
        + tuple(ColExpr() for _ in range(7)) + (col(TIMESTAMP),)


def ctl_looking_memory_filter(i: int) -> Filter:
    if i == RATE_BYTES - 1:
        return Filter(column=IS_FULL_INPUT_BLOCK)
    return Filter(constants=(ColExpr(terms=(
        (IS_FULL_INPUT_BLOCK, 1),
        (IS_PADDING_BYTE[-1], 1),
        (IS_PADDING_BYTE[i], -1))),))


class KeccakSpongeStark(Stark):
    name = "keccak_sponge"
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

        full = lv[IS_FULL_INPUT_BLOCK]
        cc.constraint(full * (full - 1))
        for c in IS_PADDING_BYTE:
            cc.constraint(lv[c] * (lv[c] - 1))
        is_final = lv[IS_PADDING_BYTE[-1]]
        for i in range(1, RATE_BYTES):
            cc.constraint(lv[IS_PADDING_BYTE[i - 1]]
                          * (lv[IS_PADDING_BYTE[i]] - 1))
        cc.constraint(is_final * full)

        absorbed = lv[ALREADY_ABSORBED_BYTES]
        cc.constraint_first_row(absorbed)
        for c in ORIGINAL_RATE_U32S:
            cc.constraint_first_row(lv[c])
        for c in ORIGINAL_CAPACITY_U32S:
            cc.constraint_first_row(lv[c])

        cc.constraint_transition(is_final * nv[ALREADY_ABSORBED_BYTES])
        for c in ORIGINAL_RATE_U32S:
            cc.constraint_transition(is_final * nv[c])
        for c in ORIGINAL_CAPACITY_U32S:
            cc.constraint_transition(is_final * nv[c])

        for c in (CONTEXT, SEGMENT, VIRT, TIMESTAMP):
            cc.constraint_transition(full * (lv[c] - nv[c]))

        # full-block chaining: our "after" is next row's "before"
        for j in range(DIGEST_U32S):
            cur = lv[UPDATED_DIGEST_STATE_BYTES[4 * j]]
            for i in range(1, 4):
                cur = cur + lv[UPDATED_DIGEST_STATE_BYTES[4 * j + i]] \
                    * (1 << (8 * i))
            cc.constraint_transition(full * (nv[ORIGINAL_RATE_U32S[j]]
                                             - cur))
        for i in range(RATE_U32S - DIGEST_U32S):
            cc.constraint_transition(
                full * (nv[ORIGINAL_RATE_U32S[DIGEST_U32S + i]]
                        - lv[PARTIAL_UPDATED_STATE_U32S[i]]))
        for i in range(CAPACITY_U32S):
            cc.constraint_transition(
                full * (nv[ORIGINAL_CAPACITY_U32S[i]]
                        - lv[PARTIAL_UPDATED_STATE_U32S[
                            RATE_U32S - DIGEST_U32S + i]]))

        cc.constraint_transition(
            full * (absorbed + RATE_BYTES - nv[ALREADY_ABSORBED_BYTES]))

        # 10*1 padding rules
        single_pad = lv[IS_PADDING_BYTE[-1]] - lv[IS_PADDING_BYTE[-2]]
        cc.constraint_transition(
            single_pad * (lv[BLOCK_BYTES[-1]] - 0b10000001))
        for i in range(RATE_BYTES - 1):
            first_pad = lv[IS_PADDING_BYTE[i]] if i == 0 else \
                lv[IS_PADDING_BYTE[i]] - lv[IS_PADDING_BYTE[i - 1]]
            cc.constraint_transition(first_pad * (lv[BLOCK_BYTES[i]] - 1))
            cc.constraint_transition(lv[IS_PADDING_BYTE[i]]
                                     * (first_pad - 1)
                                     * lv[BLOCK_BYTES[i]])
        cc.constraint_transition(
            is_final * (single_pad - 1)
            * (lv[BLOCK_BYTES[-1]] - 0b10000000))

        # dummy rows are terminal
        is_dummy = 1 - full - is_final
        next_final = nv[IS_PADDING_BYTE[-1]]
        cc.constraint_transition(
            is_dummy * (nv[IS_FULL_INPUT_BLOCK] + next_final))

    def lookups(self):
        return [Lookup(looking_columns=tuple(BLOCK_BYTES),
                       table_column=RANGE_COUNTER,
                       frequencies_column=RC_FREQUENCIES)]

    def requires_ctls(self):
        return True
