"""Poseidon table: the cdk-erigon flavor's hash coprocessor.

Functional twin of zk_evm's Poseidon STARK
(evm_arithmetization/src/poseidon/{columns.rs, poseidon_stark.rs};
registered at all_stark.rs:85,166-170,345-349 for the
type-2 / cdk-erigon chain flavor). One row per Poseidon permutation, driven
by two op kinds (poseidon_stark.rs:137-157):

- ``PoseidonSimpleOp``: the full 12-element input comes from the stack
  (CPU mem channels); one row, digest returned to the CPU.
- ``PoseidonGeneralOp``: a byte string is read from memory (7 bytes packed
  per field element, FELT_MAX_BYTES at poseidon_stark.rs:31), absorbed in
  rate-8 blocks of 56 bytes; the capacity of each following block is the
  previous block's digest (poseidon_stark.rs:268-274).

The permutation proven here is this package's Poseidon instance
(hash/poseidon_params.py): plonky2-shaped (w=12, 4+4 full rounds, 22
partial rounds, x^7 S-box, small-circulant MDS) with this repo's
documented round constants, in the naive round form of
hash/host_poseidon.py (constants added to all lanes each round) rather
than plonky2's equivalent fast-partial-round reparametrization — the
constraint count is the same, and on TPU the per-round state columns make
every round constraint a uniform gather + small-int MDS combination that
evaluates as one block over the whole LDE coset.

Column groups: sponge metadata mirroring PoseidonColumnsView (columns.rs:
17-86), the 12 permutation inputs, the state after each of the 30 rounds
(the vectorization handle; 360 columns), the S-box cube witnesses (x^3, so
x^7 = cube * cube * x stays degree 3; columns.rs:47-51), the split-limb
digest with canonicity pseudo-inverses, and the 7-byte input decomposition
used by the memory CTL (columns.rs:74-76).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..field import host
from ..hash import host_poseidon
from ..hash import poseidon_params as pp
from ..stark import Stark, Filter, ColExpr, col

P = host.P

WIDTH = pp.WIDTH                  # 12
RATE = pp.RATE                    # 8
DIGEST = 4
HALF_FULL = pp.HALF_FULL_ROUNDS   # 4
N_PARTIAL = pp.N_PARTIAL_ROUNDS   # 22
N_ROUNDS = pp.N_ROUNDS            # 30
FELT_MAX_BYTES = 7                # bytes packed per felt without overflow
BLOCK_BYTES = FELT_MAX_BYTES * RATE   # 56

# Rounds 0..3 and 26..29 are full; 4..25 are partial.
FULL_ROUNDS = tuple(range(HALF_FULL)) \
    + tuple(range(HALF_FULL + N_PARTIAL, N_ROUNDS))
PARTIAL_ROUNDS = tuple(range(HALF_FULL, HALF_FULL + N_PARTIAL))

CONTEXT = 0
SEGMENT = 1
VIRT = 2
TIMESTAMP = 3
LEN = 4
ALREADY_ABSORBED = 5
IS_FINAL_INPUT_LEN = list(range(6, 6 + RATE))
IS_FULL_INPUT_BLOCK = IS_FINAL_INPUT_LEN[-1] + 1
IS_SIMPLE_OP = IS_FULL_INPUT_BLOCK + 1
IS_FIRST_ROW_GENERAL_OP = IS_SIMPLE_OP + 1
NOT_PADDING = IS_FIRST_ROW_GENERAL_OP + 1
INPUT = list(range(NOT_PADDING + 1, NOT_PADDING + 1 + WIDTH))
# State after round r: STATE_START + r*WIDTH + lane.
STATE_START = INPUT[-1] + 1
CUBED_FULL_START = STATE_START + N_ROUNDS * WIDTH        # 8*12 entries
CUBED_PARTIAL_START = CUBED_FULL_START + len(FULL_ROUNDS) * WIDTH
DIGEST_COLS = list(range(CUBED_PARTIAL_START + N_PARTIAL,
                         CUBED_PARTIAL_START + N_PARTIAL + 2 * DIGEST))
OUTPUT_PARTIAL = list(range(DIGEST_COLS[-1] + 1,
                            DIGEST_COLS[-1] + 1 + (WIDTH - DIGEST)))
PINV = list(range(OUTPUT_PARTIAL[-1] + 1, OUTPUT_PARTIAL[-1] + 1 + DIGEST))
INPUT_BYTES_START = PINV[-1] + 1                         # 8 x 6 bytes
NUM_COLUMNS = INPUT_BYTES_START + RATE * (FELT_MAX_BYTES - 1)


def state_col(rnd: int, lane: int) -> int:
    return STATE_START + rnd * WIDTH + lane


def cubed_full_col(full_pos: int, lane: int) -> int:
    return CUBED_FULL_START + full_pos * WIDTH + lane


def cubed_partial_col(par_pos: int) -> int:
    return CUBED_PARTIAL_START + par_pos


def input_byte_col(felt: int, byte: int) -> int:
    """byte in 0..5 — the decomposition skips the least-significant byte,
    which the memory CTL recovers as input - sum(bytes << 8(j+1))."""
    return INPUT_BYTES_START + felt * (FELT_MAX_BYTES - 1) + byte


@dataclass
class PoseidonSimpleOp:
    input: tuple            # 12 canonical field elements (from the stack)


@dataclass
class PoseidonGeneralOp:
    context: int
    segment: int
    virt: int
    timestamp: int
    input: bytes            # padded to a multiple of 56 bytes
    len: int                # original (unpadded) byte length


def _mds_host(state):
    out = []
    for j in range(WIDTH):
        acc = pp.MDS_DIAG[j] * state[j]
        for i in range(WIDTH):
            acc += pp.MDS_CIRC[i] * state[(i + j) % WIDTH]
        out.append(acc % P)
    return out


def _perm_into_row(row: dict, inp: list[int], params) -> list[int]:
    """Run the permutation, recording per-round states and cube witnesses.
    Twin of generate_perm (poseidon_stark.rs:330-398)."""
    for i, c in enumerate(INPUT):
        row[c] = inp[i]
    s = list(inp)
    full_pos = 0
    par_pos = 0
    for rnd in range(N_ROUNDS):
        rc = params.rc(rnd)
        x = [(v + c) % P for v, c in zip(s, rc)]
        if rnd in FULL_ROUNDS:
            y = []
            for i in range(WIDTH):
                cube = pow(x[i], 3, P)
                row[cubed_full_col(full_pos, i)] = cube
                y.append(cube * cube % P * x[i] % P)
            full_pos += 1
        else:
            cube = pow(x[0], 3, P)
            row[cubed_partial_col(par_pos)] = cube
            y = [cube * cube % P * x[0] % P] + x[1:]
            par_pos += 1
        s = _mds_host(y)
        for i in range(WIDTH):
            row[state_col(rnd, i)] = s[i]
    for i in range(DIGEST):
        lo = s[i] & 0xFFFFFFFF
        hi = s[i] >> 32
        row[DIGEST_COLS[2 * i]] = lo
        row[DIGEST_COLS[2 * i + 1]] = hi
        d = (hi - 0xFFFFFFFF) % P
        row[PINV[i]] = pow(d, P - 2, P) if d else 0
    for i in range(WIDTH - DIGEST):
        row[OUTPUT_PARTIAL[i]] = s[DIGEST + i]
    return s


def _felts_from_block(block: bytes) -> list[int]:
    return [int.from_bytes(block[7 * k:7 * k + 7], "little")
            for k in range(RATE)]


def generate_trace(ops: list, min_rows: int = 2) -> np.ndarray:
    """(NUM_COLUMNS, n) uint64 trace; padding rows are real permutations of
    the zero state with all flags clear (poseidon_stark.rs:198-210).

    Simple ops (the verifier-VM's hashing workload — tens of thousands
    per wrap tape) run through the native batched witness permutation;
    general (byte-sponge) ops and a host without the native library use
    the python path. Bit-identical to generate_trace_py (asserted in
    tests)."""
    from .. import native
    simple = [op for op in ops if isinstance(op, PoseidonSimpleOp)]
    if simple and len(simple) == len(ops):
        params = pp.default_params()
        inp = np.array([[v % P for v in op.input] for op in simple],
                       dtype=np.uint64)
        wit = native.poseidon_witness_batch(inp, params)
        if wit is not None:
            rs, cf, cp, pinv = wit
            k = len(simple)
            n = max(min_rows, 2)
            while n < k:
                n *= 2
            trace = np.zeros((NUM_COLUMNS, n), dtype=np.uint64)
            rows = np.arange(k)
            trace[NOT_PADDING, :k] = 1
            trace[IS_SIMPLE_OP, :k] = 1
            trace[IS_FINAL_INPUT_LEN[RATE - 1], :k] = 1
            trace[INPUT[0]:INPUT[-1] + 1, :k] = inp.T
            trace[STATE_START:STATE_START + N_ROUNDS * WIDTH, :k] = rs.T
            trace[CUBED_FULL_START:CUBED_FULL_START
                  + len(FULL_ROUNDS) * WIDTH, :k] = cf.T
            trace[CUBED_PARTIAL_START:CUBED_PARTIAL_START + N_PARTIAL,
                  :k] = cp.T
            final = rs[:, -WIDTH:]
            for i in range(DIGEST):
                trace[DIGEST_COLS[2 * i], :k] = \
                    final[:, i] & np.uint64(0xFFFFFFFF)
                trace[DIGEST_COLS[2 * i + 1], :k] = \
                    final[:, i] >> np.uint64(32)
            trace[PINV[0]:PINV[-1] + 1, :k] = pinv.T
            trace[OUTPUT_PARTIAL[0]:OUTPUT_PARTIAL[-1] + 1, :k] = \
                final[:, DIGEST:].T
            if n > k:
                # padding rows: one real zero-state permutation broadcast
                pad = np.zeros((1, WIDTH), dtype=np.uint64)
                prs, pcf, pcp, ppinv = native.poseidon_witness_batch(
                    pad, params)
                pvec = np.zeros(NUM_COLUMNS, dtype=np.uint64)
                pvec[STATE_START:STATE_START + N_ROUNDS * WIDTH] = prs[0]
                pvec[CUBED_FULL_START:CUBED_FULL_START
                     + len(FULL_ROUNDS) * WIDTH] = pcf[0]
                pvec[CUBED_PARTIAL_START:CUBED_PARTIAL_START
                     + N_PARTIAL] = pcp[0]
                pfinal = prs[0, -WIDTH:]
                for i in range(DIGEST):
                    pvec[DIGEST_COLS[2 * i]] = \
                        pfinal[i] & np.uint64(0xFFFFFFFF)
                    pvec[DIGEST_COLS[2 * i + 1]] = \
                        pfinal[i] >> np.uint64(32)
                pvec[PINV[0]:PINV[-1] + 1] = ppinv[0]
                pvec[OUTPUT_PARTIAL[0]:OUTPUT_PARTIAL[-1] + 1] = \
                    pfinal[DIGEST:]
                trace[:, k:] = pvec[:, None]
            return trace
    return generate_trace_py(ops, min_rows)


def generate_trace_py(ops: list, min_rows: int = 2) -> np.ndarray:
    """Row-at-a-time reference twin of generate_trace (ground truth;
    also the only path for general byte-sponge ops)."""
    params = pp.default_params()
    rows: list[dict] = []
    for op in ops:
        if isinstance(op, PoseidonSimpleOp):
            row: dict = {NOT_PADDING: 1, IS_SIMPLE_OP: 1,
                         IS_FINAL_INPUT_LEN[RATE - 1]: 1}
            _perm_into_row(row, [v % P for v in op.input], params)
            rows.append(row)
            continue
        assert len(op.input) % BLOCK_BYTES == 0, \
            "general-op input must be padded to 56-byte blocks"
        n_blocks = len(op.input) // BLOCK_BYTES
        state = [0] * WIDTH
        absorbed = 0
        op_rows = []
        for b in range(n_blocks):
            block = op.input[b * BLOCK_BYTES:(b + 1) * BLOCK_BYTES]
            row = {NOT_PADDING: 1, CONTEXT: op.context,
                   SEGMENT: op.segment, VIRT: op.virt,
                   TIMESTAMP: op.timestamp, LEN: op.len,
                   ALREADY_ABSORBED: absorbed}
            if b == n_blocks - 1:
                row[IS_FINAL_INPUT_LEN[op.len % BLOCK_BYTES]] = 1
            else:
                row[IS_FULL_INPUT_BLOCK] = 1
            state[:RATE] = _felts_from_block(block)
            for k in range(RATE):
                for j in range(FELT_MAX_BYTES - 1):
                    row[input_byte_col(k, j)] = block[7 * k + 1 + j]
            out = _perm_into_row(row, state, params)
            state = [0] * RATE + out[:DIGEST]
            absorbed += BLOCK_BYTES
            op_rows.append(row)
        op_rows[0][IS_FIRST_ROW_GENERAL_OP] = 1
        rows.extend(op_rows)

    n = max(min_rows, 2)
    while n < len(rows):
        n *= 2
    pad_row: dict = {}
    _perm_into_row(pad_row, [0] * WIDTH, params)
    trace = np.zeros((NUM_COLUMNS, n), dtype=np.uint64)
    for r in range(n):
        src = rows[r] if r < len(rows) else pad_row
        for c, v in src.items():
            trace[c, r] = v
    return trace


def digest_of_simple(inp: list[int]) -> list[int]:
    """Host twin for tests: digest (4 elems) of a simple op."""
    return host_poseidon.permute([v % P for v in inp])[:DIGEST]


def digest_of_general(data: bytes) -> list[int]:
    """Host twin for tests: digest of a padded general input."""
    assert len(data) % BLOCK_BYTES == 0
    state = [0] * WIDTH
    for b in range(0, len(data), BLOCK_BYTES):
        state[:RATE] = _felts_from_block(data[b:b + BLOCK_BYTES])
        out = host_poseidon.permute(state)
        state = [0] * RATE + out[:DIGEST]
    return state[RATE:]


# ---------------------------------------------------------------------------
# CTL views (poseidon_stark.rs:34-137; wired at all_stark.rs:166-170,345-349)
# ---------------------------------------------------------------------------

def _is_final_block_expr() -> ColExpr:
    return ColExpr(terms=tuple((c, 1) for c in IS_FINAL_INPUT_LEN))


def ctl_looked_simple_op():
    """input[12] + digest limbs[8], filter is_simple_op."""
    return tuple(col(c) for c in INPUT) + tuple(col(c) for c in DIGEST_COLS)


def ctl_looked_simple_filter() -> Filter:
    return Filter(column=IS_SIMPLE_OP)


def ctl_looked_permutation():
    """Full-permutation view for the recursion VM (recursion/vm.py):
    input[12] + digest limbs[8] + output_partial[8] under the simple-op
    filter — the verifier AIR needs all 12 outputs (duplex state), not
    just the digest."""
    return tuple(col(c) for c in INPUT) \
        + tuple(col(c) for c in DIGEST_COLS) \
        + tuple(col(c) for c in OUTPUT_PARTIAL)


def ctl_looked_general_output():
    """digest limbs[8] + timestamp, filter is_final * (1 - is_simple)."""
    return tuple(col(c) for c in DIGEST_COLS) + (col(TIMESTAMP),)


def ctl_looked_general_output_filter() -> Filter:
    return Filter(products=((
        _is_final_block_expr(),
        ColExpr(terms=((IS_SIMPLE_OP, -1),), const=1)),))


def ctl_looked_general_input():
    return (col(CONTEXT), col(SEGMENT), col(VIRT), col(LEN), col(TIMESTAMP))


def ctl_looked_general_input_filter() -> Filter:
    return Filter(column=IS_FIRST_ROW_GENERAL_OP)


def ctl_looking_memory(i: int):
    """Read of input byte i (0..56): (is_read=1, ctx, seg,
    virt+absorbed+i, byte, 0*7, timestamp) — memory ctl_data shape.
    Byte 7k is recovered from the felt minus its upper-byte decomposition
    (poseidon_stark.rs:78-120)."""
    k, j = divmod(i, FELT_MAX_BYTES)
    if j == 0:
        value = ColExpr(terms=((INPUT[k], 1),) + tuple(
            (input_byte_col(k, t), -(1 << (8 * (t + 1))))
            for t in range(FELT_MAX_BYTES - 1)))
    else:
        value = col(input_byte_col(k, j - 1))
    return (ColExpr(const=1), col(CONTEXT), col(SEGMENT),
            ColExpr(terms=((VIRT, 1), (ALREADY_ABSORBED, 1)), const=i),
            value) + tuple(ColExpr() for _ in range(7)) + (col(TIMESTAMP),)


def ctl_looking_memory_filter() -> Filter:
    return Filter(products=((
        col(NOT_PADDING),
        ColExpr(terms=((IS_SIMPLE_OP, -1),), const=1)),))


# ---------------------------------------------------------------------------
# Constraints
# ---------------------------------------------------------------------------

class PoseidonStark(Stark):
    name = "poseidon"
    num_columns = NUM_COLUMNS

    def eval(self, frame, cc):
        from ..field import GF
        if isinstance(frame.local, GF):
            self._eval_sponge_vec(frame, cc)
            self._eval_rounds_vec(frame, cc)
        else:
            self._eval_sponge_scalar(frame, cc)
            self._eval_rounds_scalar(frame, cc)

    # -- sponge / flag constraints (poseidon_stark.rs:451-537) -----------
    # Both paths emit in this order:
    #   booleans (is_full, is_final_block, is_final_len*8, is_first_row,
    #   is_simple, not_padding), final*full exclusion, first-row absorbed
    #   and capacity, final->next-op resets, full-block copy-forward
    #   (ctx,seg,virt,ts), absorbed increment, digest->capacity chaining,
    #   dummy-terminal, final-len offset match.

    def _eval_sponge_scalar(self, frame, cc):
        lv, nv = frame.local, frame.next
        full = lv[IS_FULL_INPUT_BLOCK]
        cc.constraint(full * full - full)
        final = lv[IS_FINAL_INPUT_LEN[0]]
        for c in IS_FINAL_INPUT_LEN[1:]:
            final = final + lv[c]
        cc.constraint(final * final - final)
        for c in IS_FINAL_INPUT_LEN:
            cc.constraint(lv[c] * lv[c] - lv[c])
        first_gen = lv[IS_FIRST_ROW_GENERAL_OP]
        cc.constraint(first_gen * first_gen - first_gen)
        simple = lv[IS_SIMPLE_OP]
        cc.constraint(simple * simple - simple)
        np_ = lv[NOT_PADDING]
        cc.constraint(np_ * np_ - np_)
        cc.constraint(final * full)

        absorbed = lv[ALREADY_ABSORBED]
        cc.constraint_first_row(absorbed)
        for i in range(RATE, WIDTH):
            cc.constraint_first_row(lv[LEN] * lv[INPUT[i]])
        cc.constraint_transition(final * nv[ALREADY_ABSORBED])
        for i in range(RATE, WIDTH):
            cc.constraint_transition(nv[LEN] * final * nv[INPUT[i]])
        for c in (CONTEXT, SEGMENT, VIRT, TIMESTAMP):
            cc.constraint_transition(full * (lv[c] - nv[c]))
        cc.constraint_transition(
            full * (absorbed + BLOCK_BYTES - nv[ALREADY_ABSORBED]))
        for i in range(WIDTH - RATE):
            recombined = lv[DIGEST_COLS[2 * i]] \
                + lv[DIGEST_COLS[2 * i + 1]] * (1 << 32)
            cc.constraint_transition(
                full * (recombined - nv[INPUT[RATE + i]]))
        next_final = nv[IS_FINAL_INPUT_LEN[0]]
        for c in IS_FINAL_INPUT_LEN[1:]:
            next_final = next_final + nv[c]
        is_dummy = 1 - full - final
        cc.constraint_transition(
            is_dummy * (nv[IS_FULL_INPUT_BLOCK] + next_final))
        offset = lv[LEN] - absorbed
        for i, c in enumerate(IS_FINAL_INPUT_LEN):
            cc.constraint(lv[LEN] * lv[c] * (offset - (BLOCK_BYTES - i)))

    def _eval_sponge_vec(self, frame, cc):
        from ..field import GF
        lv, nv = frame.local, frame.next
        dev = lv.device
        full = lv[IS_FULL_INPUT_BLOCK]
        cc.constraint(full * full - full)
        fin_flags = lv[IS_FINAL_INPUT_LEN[0]:IS_FINAL_INPUT_LEN[-1] + 1]
        final = fin_flags.sum(axis=0)
        cc.constraint(final * final - final)
        cc.constraint_block(fin_flags * fin_flags - fin_flags)
        first_gen = lv[IS_FIRST_ROW_GENERAL_OP]
        cc.constraint(first_gen * first_gen - first_gen)
        simple = lv[IS_SIMPLE_OP]
        cc.constraint(simple * simple - simple)
        np_ = lv[NOT_PADDING]
        cc.constraint(np_ * np_ - np_)
        cc.constraint(final * full)

        absorbed = lv[ALREADY_ABSORBED]
        cc.constraint_first_row(absorbed)
        cap = lv[INPUT[RATE]:INPUT[RATE] + (WIDTH - RATE)]
        cc.constraint_block(cap * lv[LEN] * cc.lagrange_first)
        cc.constraint_transition(final * nv[ALREADY_ABSORBED])
        ncap = nv[INPUT[RATE]:INPUT[RATE] + (WIDTH - RATE)]
        cc.constraint_block_transition(ncap * nv[LEN] * final)
        addr = lv[CONTEXT:TIMESTAMP + 1]
        naddr = nv[CONTEXT:TIMESTAMP + 1]
        cc.constraint_block_transition((addr - naddr) * full)
        cc.constraint_transition(
            full * (absorbed + BLOCK_BYTES - nv[ALREADY_ABSORBED]))
        dig = lv[DIGEST_COLS[0]:DIGEST_COLS[-1] + 1].reshape(DIGEST, 2, -1)
        recombined = dig[:, 0] + dig[:, 1] * (1 << 32)       # (4, m)
        cc.constraint_block_transition((recombined - ncap) * full)
        next_final = nv[IS_FINAL_INPUT_LEN[0]:IS_FINAL_INPUT_LEN[-1] + 1] \
            .sum(axis=0)
        is_dummy = 1 - full - final
        cc.constraint_transition(
            is_dummy * (nv[IS_FULL_INPUT_BLOCK] + next_final))
        offset = lv[LEN] - absorbed
        offs = GF.from_u64(np.array(
            [BLOCK_BYTES - i for i in range(RATE)],
            dtype=np.uint64).reshape(RATE, 1), dev)
        cc.constraint_block(fin_flags * lv[LEN] * (offset - offs))

    # -- permutation round constraints ------------------------------------
    # Order: full-round cube checks (round-major, 96), full-round state
    # checks (96), partial cube checks (22), partial state checks (264),
    # digest recombination (4), output_partial binding (8), canonical
    # pseudo-inverse (4).

    def _eval_rounds_scalar(self, frame, cc):
        lv = frame.local
        params = pp.default_params()
        rcs = pp.round_constants_np()

        def mds(y):
            out = []
            for j in range(WIDTH):
                acc = y[j] * pp.MDS_DIAG[j] if pp.MDS_DIAG[j] else None
                for i in range(WIDTH):
                    t = y[(i + j) % WIDTH] * pp.MDS_CIRC[i]
                    acc = t if acc is None else acc + t
                out.append(acc)
            return out

        # full-round cubes
        for fp, rnd in enumerate(FULL_ROUNDS):
            for i in range(WIDTH):
                prev = lv[INPUT[i]] if rnd == 0 \
                    else lv[state_col(rnd - 1, i)]
                x = prev + int(rcs[rnd, i])
                cc.constraint(lv[cubed_full_col(fp, i)] - x * x * x)
        # full-round states
        for fp, rnd in enumerate(FULL_ROUNDS):
            y = []
            for i in range(WIDTH):
                prev = lv[INPUT[i]] if rnd == 0 \
                    else lv[state_col(rnd - 1, i)]
                x = prev + int(rcs[rnd, i])
                cube = lv[cubed_full_col(fp, i)]
                y.append(cube * cube * x)
            out = mds(y)
            for i in range(WIDTH):
                cc.constraint(lv[state_col(rnd, i)] - out[i])
        # partial-round cubes
        for pk, rnd in enumerate(PARTIAL_ROUNDS):
            x0 = lv[state_col(rnd - 1, 0)] + int(rcs[rnd, 0])
            cc.constraint(lv[cubed_partial_col(pk)] - x0 * x0 * x0)
        # partial-round states
        for pk, rnd in enumerate(PARTIAL_ROUNDS):
            x0 = lv[state_col(rnd - 1, 0)] + int(rcs[rnd, 0])
            cube = lv[cubed_partial_col(pk)]
            y = [cube * cube * x0]
            for i in range(1, WIDTH):
                y.append(lv[state_col(rnd - 1, i)] + int(rcs[rnd, i]))
            out = mds(y)
            for i in range(WIDTH):
                cc.constraint(lv[state_col(rnd, i)] - out[i])
        # digest + output binding + canonicity
        last = N_ROUNDS - 1
        for i in range(DIGEST):
            cc.constraint(lv[state_col(last, i)]
                          - (lv[DIGEST_COLS[2 * i]]
                             + lv[DIGEST_COLS[2 * i + 1]] * (1 << 32)))
        for i in range(WIDTH - DIGEST):
            cc.constraint(lv[state_col(last, DIGEST + i)]
                          - lv[OUTPUT_PARTIAL[i]])
        for i in range(DIGEST):
            cc.constraint(
                ((lv[DIGEST_COLS[2 * i + 1]] - 0xFFFFFFFF) * lv[PINV[i]]
                 - 1) * lv[DIGEST_COLS[2 * i]])

    def _eval_rounds_vec(self, frame, cc):
        from ..field import GF
        lv = frame.local
        dev = lv.device
        m = lv.shape[-1]
        rcs = pp.round_constants_np()                     # (30, 12)

        inp = lv[INPUT[0]:INPUT[0] + WIDTH]               # (12, m)
        states = lv[STATE_START:STATE_START + N_ROUNDS * WIDTH] \
            .reshape(N_ROUNDS, WIDTH, m)
        nf = len(FULL_ROUNDS)
        cubed_full = lv[CUBED_FULL_START:CUBED_FULL_START + nf * WIDTH] \
            .reshape(nf, WIDTH, m)
        cubed_part = lv[CUBED_PARTIAL_START:CUBED_PARTIAL_START + N_PARTIAL]

        circ = [int(c) for c in pp.MDS_CIRC]
        diag0 = int(pp.MDS_DIAG[0])

        def mds_vec(y):
            # out[:, j] = sum_i circ[i] * y[:, (i+j)%12] + diag[j]*y[:, j];
            # roll(-i) aligns lane (i+j)%12 onto j. diag is (8,0,...,0).
            acc = y * circ[0]
            for i in range(1, WIDTH):
                acc = acc + y.roll(-i, axis=1) * circ[i]
            d = np.zeros(WIDTH, dtype=np.uint64)
            d[0] = diag0
            return acc + y * GF.from_u64(d.reshape(1, WIDTH, 1), dev)

        # full rounds
        prev_idx = np.asarray([r - 1 for r in FULL_ROUNDS[1:]])
        prev_full = GF.concatenate(
            [inp.reshape(1, WIDTH, m), states.take(prev_idx, axis=0)],
            axis=0)                                       # (8, 12, m)
        rc_full = GF.from_u64(rcs[list(FULL_ROUNDS)].reshape(nf, WIDTH, 1),
                              dev)
        x = prev_full + rc_full
        cc.constraint_block(
            (cubed_full - x * x * x).reshape(nf * WIDTH, m))
        y = cubed_full * cubed_full * x
        st_full = states.take(np.asarray(FULL_ROUNDS), axis=0)
        cc.constraint_block(
            (st_full - mds_vec(y)).reshape(nf * WIDTH, m))

        # partial rounds: inputs are states after rounds 3..24
        prev_p = states.take(np.asarray([r - 1 for r in PARTIAL_ROUNDS]),
                             axis=0)                      # (22, 12, m)
        rc_p = GF.from_u64(rcs[list(PARTIAL_ROUNDS)]
                           .reshape(N_PARTIAL, WIDTH, 1), dev)
        xp = prev_p + rc_p
        x0 = xp.take(np.asarray(0), axis=1)               # (22, m)
        cc.constraint_block(cubed_part - x0 * x0 * x0)
        y0 = (cubed_part * cubed_part * x0).reshape(N_PARTIAL, 1, m)
        yp = GF.concatenate(
            [y0, xp[:, 1:]], axis=1)                      # (22, 12, m)
        st_p = states.take(np.asarray(PARTIAL_ROUNDS), axis=0)
        cc.constraint_block(
            (st_p - mds_vec(yp)).reshape(N_PARTIAL * WIDTH, m))

        # digest + output binding + canonicity
        last_state = states.take(np.asarray(N_ROUNDS - 1), axis=0)
        dig = lv[DIGEST_COLS[0]:DIGEST_COLS[-1] + 1].reshape(DIGEST, 2, m)
        recombined = dig[:, 0] + dig[:, 1] * (1 << 32)
        cc.constraint_block(last_state[:DIGEST] - recombined)
        outp = lv[OUTPUT_PARTIAL[0]:OUTPUT_PARTIAL[0] + (WIDTH - DIGEST)]
        cc.constraint_block(last_state[DIGEST:] - outp)
        pinv = lv[PINV[0]:PINV[0] + DIGEST]
        cc.constraint_block(
            ((dig[:, 1] - 0xFFFFFFFF) * pinv - 1) * dig[:, 0])

    def requires_ctls(self):
        return True
