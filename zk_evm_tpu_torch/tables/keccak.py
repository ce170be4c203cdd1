"""Keccak table: the keccak-f[1600] permutation as a bitwise AIR.

Functional twin of the reference's keccak table (2,431 columns = 24 round
flags + timestamp + A(50 u32 limbs) + C(320 bits) + C'(320) + A'(1600) +
A''(50 limbs) + A''[0,0] bits(64) + A'''[0,0](2); layout zk_evm's
evm_arithmetization/src/keccak/columns.rs, constraints keccak_stark.rs
:266-424 + round_flags.rs, spec book/src/tables/keccak.md). One
permutation spans 24 rows (one per round).

The constraint set is identical in two executions:
- scalar path (verifier at zeta, row-wise debug checks): direct loops;
- vector path (prover over the LDE): the same constraints as stacked GF
  blocks — gathers over precomputed index tables + cc.constraint_block —
  because ~25k per-bit constraint dispatches per evaluation would swamp
  any backend. Both paths emit constraints in the same order, so the
  alpha-folded accumulators agree.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..field import GF
from ..stark import Stark, Filter, col

NUM_ROUNDS = 24
NUM_INPUTS = 25

# permutations per trace-generation chunk: bounds the round-major build
# cube to ~230 MB no matter how code-hash-heavy the block is
TRACE_CHUNK = 512

TIMESTAMP = NUM_ROUNDS
START_A = TIMESTAMP + 1                      # 50: (x*5+y)*2 pairs lo/hi
START_C = START_A + 50                       # 320: x*64+z
START_C_PRIME = START_C + 320
START_A_PRIME = START_C_PRIME + 320          # 1600: x*320+y*64+z
START_APP = START_A_PRIME + 1600             # 50: (x*5+y)*2
APP00_BITS = START_APP + 50                  # 64
APPP00_LO = APP00_BITS + 64
APPP00_HI = APPP00_LO + 1
NUM_COLUMNS = APPP00_HI + 1


def reg_step(i):
    return i


def reg_a(x, y):
    return START_A + (x * 5 + y) * 2


def reg_c(x, z):
    return START_C + x * 64 + z


def reg_c_prime(x, z):
    return START_C_PRIME + x * 64 + z


def reg_a_prime(x, y, z):
    return START_A_PRIME + x * 320 + y * 64 + z


def reg_app(x, y):
    return START_APP + (x * 5 + y) * 2


def reg_appp(x, y):
    return (APPP00_LO, APPP00_HI) if (x, y) == (0, 0) \
        else (reg_app(x, y), reg_app(x, y) + 1)


# rotation offsets r[x][y] and round constants (public Keccak parameters)
R = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

MASK64 = (1 << 64) - 1


def _rotl(v, n):
    return ((v << n) | (v >> (64 - n))) & MASK64


def reg_b(x, y, z):
    """B is an alias into A': B[x,y,z] = A'[a,b,(z + 64 - R[a][b]) % 64]
    with a=(x+3y)%5, b=x."""
    a = (x + 3 * y) % 5
    b = x
    rot = R[a][b]
    return reg_a_prime(a, b, (z + 64 - rot) % 64)


# ---------------------------------------------------------------------------
# CTL views (all_stark.rs ctl_keccak_inputs / ctl_keccak_outputs)
# ---------------------------------------------------------------------------

def ctl_data_inputs():
    """50 input u32 limbs in y-major lane order + timestamp."""
    out = []
    for i in range(2 * NUM_INPUTS):
        lane = i // 2
        y, x = lane // 5, lane % 5
        out.append(col(reg_a(x, y) + (i % 2)))
    out.append(col(TIMESTAMP))
    return tuple(out)


def ctl_data_outputs():
    out = []
    for i in range(2 * NUM_INPUTS):
        lane = i // 2
        y, x = lane // 5, lane % 5
        lo, hi = reg_appp(x, y)
        out.append(col(lo if i % 2 == 0 else hi))
    out.append(col(TIMESTAMP))
    return tuple(out)


def ctl_filter_inputs() -> Filter:
    return Filter(column=reg_step(0))


def ctl_filter_outputs() -> Filter:
    return Filter(column=reg_step(NUM_ROUNDS - 1))


# ---------------------------------------------------------------------------
# Trace generation
# ---------------------------------------------------------------------------

def generate_trace(inputs: list[tuple[list[int], int]],
                   min_rows: int = 128) -> np.ndarray:
    """inputs: list of (25 u64 lanes [lane(x,y)=state[5y+x]], timestamp).

    Vectorized over the permutation batch (bit-identical to the
    row-at-a-time generate_trace_py; asserted in tests)."""
    rows_used = len(inputs) * NUM_ROUNDS
    n = max(min_rows, 1)
    while n < rows_used:
        n *= 2
    trace = np.zeros((NUM_COLUMNS, n), dtype=np.uint64)
    if not inputs:
        return trace
    all_state = np.array([l for l, _ in inputs],
                         dtype=np.uint64).reshape(-1, 5, 5)  # [i, y, x]
    all_ts = np.array([t for _, t in inputs], dtype=np.uint64)
    # chunk the batch so the round-major cube stays cache/RAM friendly
    # (at 2431 columns a 1024-perm cube is ~460 MB; code-hash-heavy
    # mainnet blocks reach tens of thousands of permutations)
    for c0 in range(0, len(inputs), TRACE_CHUNK):
        _fill_chunk(trace, all_state[c0:c0 + TRACE_CHUNK],
                    all_ts[c0:c0 + TRACE_CHUNK], c0 * NUM_ROUNDS)
    return trace


def _fill_chunk(trace, state, ts, row0):
    k = state.shape[0]
    state = state.copy()
    Z = np.arange(64, dtype=np.uint64)
    M32, S32, ONE = (np.uint64(0xFFFFFFFF), np.uint64(32), np.uint64(1))

    # Rows for input i are the contiguous block i*24 .. i*24+23. Writing
    # per-round vectors straight into that layout puts a 24-row stride
    # inside every store (one cache line per element, ~640MB of traffic
    # for a 10M-element table). Instead the cube is built round-major —
    # (C, round, input), every per-round write contiguous over inputs —
    # and transposed once at the end as per-column (24, k) tiles that fit
    # in L2.
    block = np.zeros((NUM_COLUMNS, NUM_ROUNDS, k), dtype=np.uint64)

    def rotl(v, nn):
        nn %= 64
        if nn == 0:
            return v
        return (v << np.uint64(nn)) | (v >> np.uint64(64 - nn))

    for r in range(NUM_ROUNDS):
        blk = block[:, r, :]
        blk[reg_step(r)] = 1
        blk[TIMESTAMP] = ts
        for x in range(5):
            for y in range(5):
                a = state[:, y, x]
                ra = reg_a(x, y)
                blk[ra] = a & M32
                blk[ra + 1] = a >> S32
        c = np.bitwise_xor.reduce(state, axis=1)      # [i, x]
        d = np.empty_like(c)
        for x in range(5):
            d[:, x] = c[:, (x + 4) % 5] ^ rotl(c[:, (x + 1) % 5], 1)
            cp = c[:, x] ^ d[:, x]
            rc0 = reg_c(x, 0)
            blk[rc0:rc0 + 64] = ((c[:, x, None] >> Z) & ONE).T
            rcp0 = reg_c_prime(x, 0)
            blk[rcp0:rcp0 + 64] = ((cp[:, None] >> Z) & ONE).T
        ap = state ^ d[:, None, :]                    # [i, y, x]
        # A' bits: one (k, 5y, 5x, 64z) shift -> transpose to the
        # column layout x*320 + y*64 + z in a single strided write
        bits = (ap[:, :, :, None] >> Z) & ONE          # [i, y, x, z]
        blk[START_A_PRIME:START_A_PRIME + 1600] = \
            bits.transpose(2, 1, 3, 0).reshape(1600, k)
        b = {}
        for x in range(5):
            for y in range(5):
                b[(y, (2 * x + 3 * y) % 5)] = rotl(ap[:, y, x], R[x][y])
        app = np.empty_like(state)
        for x in range(5):
            for y in range(5):
                v = b[(x, y)] ^ (~b[((x + 1) % 5, y)]
                                 & b[((x + 2) % 5, y)])
                app[:, y, x] = v
                rapp = reg_app(x, y)
                blk[rapp] = v & M32
                blk[rapp + 1] = v >> S32
        blk[APP00_BITS:APP00_BITS + 64] = \
            ((app[:, 0, 0, None] >> Z) & ONE).T
        out00 = app[:, 0, 0] ^ np.uint64(RC[r])
        blk[APPP00_LO] = out00 & M32
        blk[APPP00_HI] = out00 >> S32
        state = app
        state[:, 0, 0] = out00
    rows = k * NUM_ROUNDS
    np.copyto(trace[:, row0:row0 + rows].reshape(NUM_COLUMNS, k,
                                                 NUM_ROUNDS),
              block.transpose(0, 2, 1))


def generate_trace_py(inputs: list[tuple[list[int], int]],
                      min_rows: int = 128) -> np.ndarray:
    """Row-at-a-time reference twin of generate_trace (ground truth)."""
    rows = []
    for lanes, timestamp in inputs:
        state = {(x, y): lanes[5 * y + x] for x in range(5)
                 for y in range(5)}
        for r in range(NUM_ROUNDS):
            row = [0] * NUM_COLUMNS
            row[reg_step(r)] = 1
            row[TIMESTAMP] = timestamp
            c = {x: 0 for x in range(5)}
            for x in range(5):
                for y in range(5):
                    row[reg_a(x, y)] = state[(x, y)] & 0xFFFFFFFF
                    row[reg_a(x, y) + 1] = state[(x, y)] >> 32
                    c[x] ^= state[(x, y)]
            cp = {x: c[x] ^ c[(x + 4) % 5] ^ _rotl(c[(x + 1) % 5], 1)
                  for x in range(5)}
            for x in range(5):
                for z in range(64):
                    row[reg_c(x, z)] = (c[x] >> z) & 1
                    row[reg_c_prime(x, z)] = (cp[x] >> z) & 1
            # theta: A' = A ^ D, D[x] = C[x-1] ^ rotl(C[x+1], 1)
            ap = {}
            for x in range(5):
                d = c[(x + 4) % 5] ^ _rotl(c[(x + 1) % 5], 1)
                for y in range(5):
                    ap[(x, y)] = state[(x, y)] ^ d
                    for z in range(64):
                        row[reg_a_prime(x, y, z)] = (ap[(x, y)] >> z) & 1
            # rho/pi: B[y, 2x+3y] = rotl(A'[x,y], R[x][y])
            b = {}
            for x in range(5):
                for y in range(5):
                    b[(y, (2 * x + 3 * y) % 5)] = _rotl(ap[(x, y)], R[x][y])
            # chi: A'' = B ^ (~B[x+1] & B[x+2])
            app = {}
            for x in range(5):
                for y in range(5):
                    app[(x, y)] = b[(x, y)] ^ (
                        ~b[((x + 1) % 5, y)] & b[((x + 2) % 5, y)]
                        & MASK64)
                    row[reg_app(x, y)] = app[(x, y)] & 0xFFFFFFFF
                    row[reg_app(x, y) + 1] = app[(x, y)] >> 32
            for z in range(64):
                row[APP00_BITS + z] = (app[(0, 0)] >> z) & 1
            # iota
            out00 = app[(0, 0)] ^ RC[r]
            row[APPP00_LO] = out00 & 0xFFFFFFFF
            row[APPP00_HI] = out00 >> 32
            rows.append(row)
            state = dict(app)
            state[(0, 0)] = out00
    n = max(min_rows, 1)
    while n < len(rows):
        n *= 2
    trace = np.zeros((NUM_COLUMNS, n), dtype=np.uint64)
    for r, row in enumerate(rows):
        for cidx, v in enumerate(row):
            if v:
                trace[cidx, r] = v
    return trace


def keccak_f(lanes: list[int]) -> list[int]:
    """Reference permutation (for tests): 25 lanes in/out."""
    state = {(x, y): lanes[5 * y + x] for x in range(5) for y in range(5)}
    for r in range(NUM_ROUNDS):
        c = {x: 0 for x in range(5)}
        for x in range(5):
            for y in range(5):
                c[x] ^= state[(x, y)]
        ap = {}
        for x in range(5):
            d = c[(x + 4) % 5] ^ _rotl(c[(x + 1) % 5], 1)
            for y in range(5):
                ap[(x, y)] = state[(x, y)] ^ d
        b = {}
        for x in range(5):
            for y in range(5):
                b[(y, (2 * x + 3 * y) % 5)] = _rotl(ap[(x, y)], R[x][y])
        for x in range(5):
            for y in range(5):
                state[(x, y)] = b[(x, y)] ^ (
                    ~b[((x + 1) % 5, y)] & b[((x + 2) % 5, y)] & MASK64)
        state[(0, 0)] ^= RC[r]
    return [state[(x, y)] for y in range(5) for x in range(5)]


# ---------------------------------------------------------------------------
# Constraint helpers
# ---------------------------------------------------------------------------

def _xor(a, b):
    return a + b - a * b * 2


def _xor3(a, b, c):
    return _xor(a, _xor(b, c))


def _andn(a, b):
    return (1 - a) * b


@lru_cache(maxsize=1)
def _index_tables():
    """Numpy gather tables for the vectorized path."""
    c2 = np.empty(320, dtype=np.int64)      # C[(x+4)%5, z]
    c3 = np.empty(320, dtype=np.int64)      # C[(x+1)%5, (z+63)%64]
    for x in range(5):
        for z in range(64):
            v = x * 64 + z
            c2[v] = ((x + 4) % 5) * 64 + z
            c3[v] = ((x + 1) % 5) * 64 + (z + 63) % 64
    cu = np.empty(1600, dtype=np.int64)     # (x,y,z) -> C index
    for x in range(5):
        for y in range(5):
            for z in range(64):
                cu[x * 320 + y * 64 + z] = x * 64 + z
    # chi gathers into the A'-block (offsets relative to START_A_PRIME)
    b0 = np.empty(1600, dtype=np.int64)
    b1 = np.empty(1600, dtype=np.int64)
    b2 = np.empty(1600, dtype=np.int64)
    for x in range(5):
        for y in range(5):
            for z in range(64):
                u = x * 320 + y * 64 + z
                b0[u] = reg_b(x, y, z) - START_A_PRIME
                b1[u] = reg_b((x + 1) % 5, y, z) - START_A_PRIME
                b2[u] = reg_b((x + 2) % 5, y, z) - START_A_PRIME
    out_idx = np.empty(50, dtype=np.int64)  # A''' limb columns, (x,y,lo/hi)
    for x in range(5):
        for y in range(5):
            lo, hi = reg_appp(x, y)
            out_idx[(x * 5 + y) * 2] = lo
            out_idx[(x * 5 + y) * 2 + 1] = hi
    rcb = np.zeros((NUM_ROUNDS, 64), dtype=np.uint64)
    for r in range(NUM_ROUNDS):
        for i in range(64):
            rcb[r, i] = (RC[r] >> i) & 1
    return c2, c3, cu, b0, b1, b2, out_idx, rcb


def _weights_lo_hi():
    lo = np.array([1 << z for z in range(32)], dtype=np.uint64)
    return lo  # same weights for both halves


class KeccakStark(Stark):
    name = "keccak"
    num_columns = NUM_COLUMNS

    def eval(self, frame, cc):
        if isinstance(frame.local, GF):
            self._eval_vec(frame, cc)
        else:
            self._eval_scalar(frame, cc)

    # -- scalar path (verifier / debug) ---------------------------------
    def _eval_scalar(self, frame, cc):
        lv = frame.local
        nv = frame.next

        # round flags
        flags = [lv[reg_step(i)] for i in range(NUM_ROUNDS)]
        for f in flags:
            cc.constraint(f * f - f)
        any_flag = flags[0]
        for f in flags[1:]:
            any_flag = any_flag + f
        cc.constraint_first_row(any_flag * (flags[0] - 1))
        for f in flags[1:]:
            cc.constraint_first_row(any_flag * f)
        next_flags = [nv[reg_step(i)] for i in range(NUM_ROUNDS)]
        next_any = next_flags[0]
        for f in next_flags[1:]:
            next_any = next_any + f
        last_flag = flags[NUM_ROUNDS - 1]
        padding_constraint = (next_any - 1) * any_flag * (last_flag - 1)
        for i in range(NUM_ROUNDS):
            cc.constraint_transition(
                next_any * (next_flags[(i + 1) % NUM_ROUNDS] - flags[i])
                + padding_constraint)
        cc.constraint_transition(next_any * (any_flag - 1))

        # timestamp consistency
        not_final = 1 - last_flag
        cc.constraint(any_flag * not_final * (nv[TIMESTAMP] - lv[TIMESTAMP]))

        # C' = xor3(C[x], C[x-1], C[x+1] rot 1)
        for x in range(5):
            for z in range(64):
                xor = _xor3(lv[reg_c(x, z)], lv[reg_c((x + 4) % 5, z)],
                            lv[reg_c((x + 1) % 5, (z + 63) % 64)])
                cc.constraint(lv[reg_c_prime(x, z)] - xor)

        # A limbs match xor3(A', C, C')
        for x in range(5):
            for y in range(5):
                bits = [_xor3(lv[reg_a_prime(x, y, z)], lv[reg_c(x, z)],
                              lv[reg_c_prime(x, z)]) for z in range(64)]
                lo = self._recompose(bits[:32])
                hi = self._recompose(bits[32:])
                cc.constraint(lo - lv[reg_a(x, y)])
                cc.constraint(hi - lv[reg_a(x, y) + 1])

        # xor_y A'[x,y,z] = C'[x,z] parity
        for x in range(5):
            for z in range(64):
                s = lv[reg_a_prime(x, 0, z)]
                for y in range(1, 5):
                    s = s + lv[reg_a_prime(x, y, z)]
                diff = s - lv[reg_c_prime(x, z)]
                cc.constraint(diff * (diff - 2) * (diff - 4))

        # chi
        for x in range(5):
            for y in range(5):
                bits = [_xor(lv[reg_b(x, y, z)],
                             _andn(lv[reg_b((x + 1) % 5, y, z)],
                                   lv[reg_b((x + 2) % 5, y, z)]))
                        for z in range(64)]
                lo = self._recompose(bits[:32])
                hi = self._recompose(bits[32:])
                cc.constraint(lo - lv[reg_app(x, y)])
                cc.constraint(hi - lv[reg_app(x, y) + 1])

        # A''[0,0] bit decomposition
        bits00 = [lv[APP00_BITS + z] for z in range(64)]
        cc.constraint(self._recompose(bits00[:32]) - lv[reg_app(0, 0)])
        cc.constraint(self._recompose(bits00[32:]) - lv[reg_app(0, 0) + 1])

        # iota
        def xored(i):
            rc_bit = None
            for r in range(NUM_ROUNDS):
                if (RC[r] >> i) & 1:
                    rc_bit = flags[r] if rc_bit is None else rc_bit + flags[r]
            if rc_bit is None:
                return bits00[i]
            return _xor(bits00[i], rc_bit)

        cc.constraint(self._recompose([xored(z) for z in range(32)])
                      - lv[APPP00_LO])
        cc.constraint(self._recompose([xored(z) for z in range(32, 64)])
                      - lv[APPP00_HI])

        # output feeds next round's input
        not_last = 1 - last_flag
        for x in range(5):
            for y in range(5):
                lo, hi = reg_appp(x, y)
                cc.constraint_transition(not_last * (lv[lo] - nv[reg_a(x, y)]))
                cc.constraint_transition(
                    not_last * (lv[hi] - nv[reg_a(x, y) + 1]))

    @staticmethod
    def _recompose(bits):
        acc = None
        for z in reversed(range(len(bits))):
            acc = bits[z] if acc is None else acc * 2 + bits[z]
        return acc

    # -- vector path (prover over the LDE) -------------------------------
    def _eval_vec(self, frame, cc):
        lv: GF = frame.local
        nv: GF = frame.next
        m = lv.shape[-1]
        dev = lv.device
        c2i, c3i, cui, b0i, b1i, b2i, out_idx, rcb = _index_tables()

        flags = lv[0:NUM_ROUNDS]                      # (24, m)
        cc.constraint_block(flags * flags - flags)
        any_flag = flags.sum(axis=0)
        first_rows = GF.concatenate(
            [(flags[0:1] - GF.ones((1, m), dev)), flags[1:NUM_ROUNDS]], axis=0)
        cc.constraint_block((first_rows * any_flag) * cc.lagrange_first)
        next_flags = nv[0:NUM_ROUNDS]
        next_any = next_flags.sum(axis=0)
        last_flag = flags[NUM_ROUNDS - 1]
        padding_constraint = (next_any - 1) * any_flag * (last_flag - 1)
        rot_next = next_flags.take(
            (np.arange(NUM_ROUNDS) + 1) % NUM_ROUNDS, axis=0)
        cc.constraint_block_transition(
            (rot_next - flags) * next_any + padding_constraint)
        cc.constraint_transition(next_any * (any_flag - 1))

        not_final = 1 - last_flag
        cc.constraint(any_flag * not_final * (nv[TIMESTAMP] - lv[TIMESTAMP]))

        c_blk = lv[START_C:START_C + 320]
        cp_blk = lv[START_C_PRIME:START_C_PRIME + 320]
        cc.constraint_block(
            cp_blk - _xor3(c_blk, c_blk.take(c2i, axis=0),
                           c_blk.take(c3i, axis=0)))

        ap_blk = lv[START_A_PRIME:START_A_PRIME + 1600]
        bits = _xor3(ap_blk, c_blk.take(cui, axis=0),
                     cp_blk.take(cui, axis=0)).reshape(5, 5, 2, 32, m)
        w = GF.from_u64(_weights_lo_hi().reshape(1, 1, 1, 32, 1), dev)
        limbs = (bits * w).sum(axis=3)                # (5,5,2,m)
        a_blk = lv[START_A:START_A + 50].reshape(5, 5, 2, m)
        cc.constraint_block((limbs - a_blk).reshape(50, m))

        parity = ap_blk.reshape(5, 5, 64, m).sum(axis=1).reshape(320, m)
        diff = parity - cp_blk
        cc.constraint_block(diff * (diff - 2) * (diff - 4))

        b0 = ap_blk.take(b0i, axis=0)
        b1 = ap_blk.take(b1i, axis=0)
        b2 = ap_blk.take(b2i, axis=0)
        chi_bits = _xor(b0, _andn(b1, b2)).reshape(5, 5, 2, 32, m)
        chi_limbs = (chi_bits * w).sum(axis=3)
        app_blk = lv[START_APP:START_APP + 50].reshape(5, 5, 2, m)
        cc.constraint_block((chi_limbs - app_blk).reshape(50, m))

        bits00 = lv[APP00_BITS:APP00_BITS + 64]
        w32 = GF.from_u64(_weights_lo_hi().reshape(32, 1), dev)
        cc.constraint((bits00[:32] * w32).sum(axis=0) - lv[reg_app(0, 0)])
        cc.constraint((bits00[32:] * w32).sum(axis=0)
                      - lv[reg_app(0, 0) + 1])

        # iota: rc_bits (64, m) = sum_r flags[r] * RCB[r, i]
        rc_bits = []
        for i in range(64):
            rs = np.nonzero(rcb[:, i])[0]
            if len(rs) == 0:
                rc_bits.append(None)
            else:
                acc = flags[int(rs[0])]
                for r in rs[1:]:
                    acc = acc + flags[int(r)]
                rc_bits.append(acc)
        xored = [bits00[i] if rc_bits[i] is None
                 else _xor(bits00[i], rc_bits[i]) for i in range(64)]
        xored_lo = GF.stack(xored[:32], axis=0)
        xored_hi = GF.stack(xored[32:], axis=0)
        cc.constraint((xored_lo * w32).sum(axis=0) - lv[APPP00_LO])
        cc.constraint((xored_hi * w32).sum(axis=0) - lv[APPP00_HI])

        out_blk = lv.take(out_idx, axis=0)        # (50, m)
        next_a = nv[START_A:START_A + 50]
        not_last = 1 - last_flag
        cc.constraint_block_transition((out_blk - next_a) * not_last)