"""Arithmetic table: ADD..BYTE, SHL/SHR, ADDMOD/MULMOD/SUBMOD, FP254 ops,
plus CPU-dispatched range-check rows.

Functional twin of the reference's arithmetic unit (116 columns = 17 op
flags + OPCODE_COL + 6x16 shared 16-bit-limb registers + RANGE_COUNTER +
RC_FREQUENCIES; layout zk_evm's evm_arithmetization/src/arithmetic/
columns.rs, semantics addcy.rs / mul.rs / modular.rs / divmod.rs / byte.rs
/ shift.rs, spec book/src/tables/arithmetic.md). All 256-bit values are 16
little-endian 16-bit limbs; every shared column is range-checked to 16
bits via the logUp argument against RANGE_COUNTER.

Constraint strategy (same math, one generic implementation):
- ADD/SUB/LT/GT: the add-with-carry identity X + Y = Z + CY*2^256 checked
  limb-wise with carry chain t*(2^16 - t) == 0.
- MUL/SHL: polynomial identity a(x)b(x) - c(x) - (x-B)s(x) == 0 at each
  coefficient, with the carry polynomial s offset by 2^20 and split into
  16-bit halves.
- Modular ops (two rows): op(a,b) - c - q*m - (x-B)s == 0 with
  mod-is-zero handling and reducedness check via the addcy identity.
- BYTE: 5-bit multiplexer tree over the 16 limbs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..field import host
from ..stark import Stark, Lookup

P = host.P
LIMB_BITS = 16
N_LIMBS = 16
BASE = 1 << LIMB_BITS
# 2^-16 mod p
BASE_INV = host.finv(BASE)
AUX_COEFF_ABS_MAX = 1 << 20
RANGE_MAX = 1 << 16

# BN254 base-field modulus (public parameter; reference keeps it in
# extension_tower.rs as BN_BASE)
BN_BASE = 21888242871839275222246405745257275088696311157297823662689037894645226208583

# ---------------------------------------------------------------------------
# Column layout (mirrors columns.rs)
# ---------------------------------------------------------------------------
IS_ADD = 0
IS_MUL = 1
IS_SUB = 2
IS_DIV = 3
IS_MOD = 4
IS_ADDMOD = 5
IS_MULMOD = 6
IS_ADDFP254 = 7
IS_MULFP254 = 8
IS_SUBFP254 = 9
IS_SUBMOD = 10
IS_LT = 11
IS_GT = 12
IS_BYTE = 13
IS_SHL = 14
IS_SHR = 15
IS_RANGE_CHECK = 16
OPCODE_COL = 17
START_SHARED_COLS = 18
NUM_SHARED_COLS = 6 * N_LIMBS

def _r(start, n=N_LIMBS):
    return list(range(start, start + n))

INPUT_REGISTER_0 = _r(START_SHARED_COLS)
INPUT_REGISTER_1 = _r(INPUT_REGISTER_0[-1] + 1)
INPUT_REGISTER_2 = _r(INPUT_REGISTER_1[-1] + 1)
OUTPUT_REGISTER = _r(INPUT_REGISTER_2[-1] + 1)
AUX_INPUT_REGISTER_0 = _r(OUTPUT_REGISTER[-1] + 1)
AUX_INPUT_REGISTER_1 = _r(AUX_INPUT_REGISTER_0[-1] + 1)
AUX_INPUT_REGISTER_DBL = AUX_INPUT_REGISTER_0 + AUX_INPUT_REGISTER_1

AUX_REGISTER_0 = _r(START_SHARED_COLS)
AUX_REGISTER_1 = _r(AUX_REGISTER_0[-1] + 1, 2 * N_LIMBS)
AUX_REGISTER_2 = _r(AUX_REGISTER_1[-1] + 1, 2 * N_LIMBS - 1)

MUL_AUX_INPUT_LO = AUX_INPUT_REGISTER_0
MUL_AUX_INPUT_HI = AUX_INPUT_REGISTER_1
MODULAR_QUO_INPUT = AUX_INPUT_REGISTER_DBL
MODULAR_OUT_AUX_RED = AUX_REGISTER_0
MODULAR_MOD_IS_ZERO = AUX_REGISTER_1[0]
MODULAR_AUX_INPUT_LO = AUX_REGISTER_1[1:]           # 31 cols
MODULAR_AUX_INPUT_HI = AUX_REGISTER_2               # 31 cols
MODULAR_DIV_DENOM_IS_ZERO = AUX_REGISTER_2[-1] + 1

RANGE_COUNTER = START_SHARED_COLS + NUM_SHARED_COLS
RC_FREQUENCIES = RANGE_COUNTER + 1
NUM_COLUMNS = RANGE_COUNTER + 2
SHARED_COLS = list(range(START_SHARED_COLS, RANGE_COUNTER))
OP_FLAGS = list(range(IS_ADD, IS_RANGE_CHECK + 1))

# byte-op column names inside AUX registers
BYTE_IDX_DECOMP = AUX_INPUT_REGISTER_0[0:6]
BYTE_IDX_DECOMP_HI = AUX_INPUT_REGISTER_0[5]
BYTE_LAST_LIMB_LO = AUX_INPUT_REGISTER_0[6]
BYTE_LAST_LIMB_HI = AUX_INPUT_REGISTER_0[7]
BYTE_IDX_IS_LARGE = AUX_INPUT_REGISTER_0[8]
BYTE_IDX_HI_LIMB_SUM_INV = AUX_INPUT_REGISTER_0[9:13]

U256_MASK = (1 << 256) - 1


def _to_limbs(x: int, n: int = N_LIMBS) -> list[int]:
    return [(x >> (LIMB_BITS * i)) & 0xFFFF for i in range(n)]


def _signed_limbs(num: int, n: int) -> list[int]:
    """bigint_to_columns semantics: limbs of |num|, negated if num < 0."""
    a = abs(num)
    limbs = [(a >> (LIMB_BITS * i)) & 0xFFFF for i in range(n)]
    if num < 0:
        limbs = [-c for c in limbs]
    return limbs


def _f(x: int) -> int:
    """Encode a (possibly negative) int as a canonical field element."""
    return x % P


# ---------------------------------------------------------------------------
# Polynomial helpers (generation side: python ints; eval side: algebra)
# ---------------------------------------------------------------------------

def pol_mul_lo(a, b, n):
    out = [0] * n if isinstance(a[0], int) else [a[0] * 0 for _ in range(n)]
    for deg in range(n):
        acc = None
        for i in range(deg + 1):
            t = a[i] * b[deg - i]
            acc = t if acc is None else acc + t
        out[deg] = acc
    return out


def pol_mul_wide(a, b):
    """(16,16) -> 31 coefficients."""
    out = [None] * (2 * N_LIMBS - 1)
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            t = ai * bj
            out[i + j] = t if out[i + j] is None else out[i + j] + t
    return out


def pol_mul_wide2(a, b):
    """(32,16) -> 47 coefficients."""
    out = [None] * (3 * N_LIMBS - 1)
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            t = ai * bj
            out[i + j] = t if out[i + j] is None else out[i + j] + t
    return out


def pol_adjoin_root(a, root_int):
    """(x - root) * a(x), root a small int constant."""
    n = len(a)
    res = [None] * n
    res[0] = a[0] * (P - root_int)       # -root * a[0]
    for deg in range(1, n):
        res[deg] = a[deg - 1] - a[deg] * root_int
    return res


def pol_remove_root_2exp(a, exp, n):
    """Exact division by (x - 2^exp) on integer coefficient lists."""
    q = [0] * n
    q[0] = -(a[0] >> exp)
    for deg in range(1, n - 1):
        q[deg] = (q[deg - 1] - a[deg]) >> exp
    return q


# ---------------------------------------------------------------------------
# Operations (witness API)
# ---------------------------------------------------------------------------

BINARY_FLAG = {
    "add": IS_ADD, "mul": IS_MUL, "sub": IS_SUB, "div": IS_DIV,
    "mod": IS_MOD, "lt": IS_LT, "gt": IS_GT, "byte": IS_BYTE,
    "shl": IS_SHL, "shr": IS_SHR, "addfp254": IS_ADDFP254,
    "mulfp254": IS_MULFP254, "subfp254": IS_SUBFP254,
}
TERNARY_FLAG = {"addmod": IS_ADDMOD, "mulmod": IS_MULMOD,
                "submod": IS_SUBMOD}
TWO_ROW_FLAGS = {IS_DIV, IS_MOD, IS_SHR, IS_ADDMOD, IS_MULMOD, IS_SUBMOD,
                 IS_ADDFP254, IS_MULFP254, IS_SUBFP254}


def binary_result(op: str, in0: int, in1: int) -> int:
    if op == "add":
        return (in0 + in1) & U256_MASK
    if op == "mul":
        return (in0 * in1) & U256_MASK
    if op == "sub":
        return (in0 - in1) & U256_MASK
    if op == "div":
        return 0 if in1 == 0 else in0 // in1
    if op == "mod":
        return 0 if in1 == 0 else in0 % in1
    if op == "lt":
        return int(in0 < in1)
    if op == "gt":
        return int(in0 > in1)
    if op == "byte":
        return 0 if in0 >= 32 else (in1 >> (8 * (31 - in0))) & 0xFF
    if op == "shl":
        return (in1 << in0) & U256_MASK if in0 < 256 else 0
    if op == "shr":
        return (in1 >> in0) if in0 < 256 else 0
    if op == "addfp254":
        return (in0 + in1) % BN_BASE
    if op == "mulfp254":
        return (in0 * in1) % BN_BASE
    if op == "subfp254":
        return (in0 - in1) % BN_BASE
    raise ValueError(op)


def ternary_result(op: str, in0: int, in1: int, in2: int) -> int:
    if in2 == 0:
        return 0
    if op == "addmod":
        return (in0 + in1) % in2
    if op == "mulmod":
        return (in0 * in1) % in2
    if op == "submod":
        return (in0 - in1) % in2
    raise ValueError(op)


@dataclass
class Op:
    kind: str                   # name in BINARY_FLAG/TERNARY_FLAG or "range_check"
    in0: int = 0
    in1: int = 0
    in2: int = 0
    opcode: int = 0
    result: int | None = None


# ---------------------------------------------------------------------------
# Trace generation (rows of python ints -> uint64 trace)
# ---------------------------------------------------------------------------

def _set(row, cols, vals):
    for c, v in zip(cols, vals):
        row[c] = _f(v)


def _gen_addcy(row, flag, left, right):
    _set(row, INPUT_REGISTER_0, _to_limbs(left))
    _set(row, INPUT_REGISTER_1, _to_limbs(right))
    _set(row, INPUT_REGISTER_2, [0] * N_LIMBS)
    if flag == IS_ADD:
        result = (left + right) & U256_MASK
        cy = (left + right) >> 256
        _set(row, AUX_INPUT_REGISTER_0, _to_limbs(cy))
        _set(row, OUTPUT_REGISTER, _to_limbs(result))
    elif flag == IS_SUB:
        diff = (left - right) & U256_MASK
        cy = int(left < right)
        _set(row, AUX_INPUT_REGISTER_0, _to_limbs(cy))
        _set(row, OUTPUT_REGISTER, _to_limbs(diff))
    elif flag == IS_LT:
        diff = (left - right) & U256_MASK
        cy = int(left < right)
        _set(row, AUX_INPUT_REGISTER_0, _to_limbs(diff))
        _set(row, OUTPUT_REGISTER, _to_limbs(cy))
    elif flag == IS_GT:
        diff = (right - left) & U256_MASK
        cy = int(right < left)
        _set(row, AUX_INPUT_REGISTER_0, _to_limbs(diff))
        _set(row, OUTPUT_REGISTER, _to_limbs(cy))


def _gen_mul_core(row, a_limbs, b_limbs):
    unreduced = pol_mul_lo(a_limbs, b_limbs, N_LIMBS)
    out = [0] * N_LIMBS
    cy = 0
    for col in range(N_LIMBS):
        t = unreduced[col] + cy
        cy = t >> LIMB_BITS
        out[col] = t & 0xFFFF
    _set(row, OUTPUT_REGISTER, out)
    diff = [u - o for u, o in zip(unreduced, out)]
    aux = pol_remove_root_2exp(diff, LIMB_BITS, N_LIMBS)
    aux[N_LIMBS - 1] = -cy
    aux = [c + AUX_COEFF_ABS_MAX for c in aux]
    _set(row, MUL_AUX_INPUT_LO, [c & 0xFFFF for c in aux])
    _set(row, MUL_AUX_INPUT_HI, [(c >> 16) & 0xFFFF for c in aux])


def _gen_mul(row, left, right):
    _set(row, INPUT_REGISTER_0, _to_limbs(left))
    _set(row, INPUT_REGISTER_1, _to_limbs(right))
    _set(row, INPUT_REGISTER_2, [0] * N_LIMBS)
    _gen_mul_core(row, _to_limbs(left), _to_limbs(right))


def _gen_modular_op(row, row2, flag, pol_input, modulus_limbs):
    """Port of generate_modular_op (modular.rs:211-341). pol_input: 31
    integer coefficients. Returns (output_limbs, quot_limbs)."""
    modulus = sum(c << (LIMB_BITS * i) for i, c in enumerate(modulus_limbs))
    constr_poly = list(pol_input) + [0]          # 32
    mod_is_zero = 0
    if modulus == 0:
        if flag in (IS_DIV, IS_SHR):
            modulus = 1 << 256
        else:
            modulus = 1
            modulus_limbs = list(modulus_limbs)
            modulus_limbs[0] = 1
        mod_is_zero = 1
    input_val = sum(c << (LIMB_BITS * i) for i, c in enumerate(constr_poly))
    output = input_val % modulus
    output_limbs = _to_limbs(output)
    quot = (input_val - output) // modulus
    quot_limbs = _signed_limbs(quot, 2 * N_LIMBS)
    out_aux_red = _to_limbs((1 << 256) - modulus + output)

    constr_poly = [c - o for c, o in zip(constr_poly,
                                         output_limbs + [0] * N_LIMBS)]
    prod = pol_mul_wide2(quot_limbs, modulus_limbs)
    assert all(x == 0 for x in prod[2 * N_LIMBS:]), "quot*mod overflow"
    constr_poly = [c - p for c, p in zip(constr_poly, prod[:2 * N_LIMBS])]

    aux_limbs = pol_remove_root_2exp(constr_poly, LIMB_BITS, 2 * N_LIMBS)
    aux_limbs = [c + AUX_COEFF_ABS_MAX for c in aux_limbs]
    assert all(0 <= c <= 2 * AUX_COEFF_ABS_MAX for c in aux_limbs)
    _set(row2, MODULAR_AUX_INPUT_LO,
         [c & 0xFFFF for c in aux_limbs[:2 * N_LIMBS - 1]])
    _set(row2, MODULAR_AUX_INPUT_HI,
         [(c >> 16) & 0xFFFF for c in aux_limbs[:2 * N_LIMBS - 1]])

    if flag in (IS_SUBMOD, IS_SUBFP254):
        lo = quot_limbs[:N_LIMBS]
        hi = quot_limbs[N_LIMBS:]
        assert all(c <= 0xFFFF for c in lo)
        assert all(d == 0 for d in hi)
        if quot < 0:
            lo = [c + 0xFFFF for c in lo]
            hi = [1] + [0] * (N_LIMBS - 1)
        quot_limbs = lo + hi

    row2[MODULAR_MOD_IS_ZERO] = _f(mod_is_zero)
    _set(row2, MODULAR_OUT_AUX_RED, out_aux_red)
    row2[MODULAR_DIV_DENOM_IS_ZERO] = _f(
        mod_is_zero * (1 if flag in (IS_DIV, IS_SHR) else 0))
    return output_limbs, quot_limbs


def _gen_ternary(row, row2, flag, in0, in1, in2):
    _set(row, INPUT_REGISTER_0, _to_limbs(in0))
    _set(row, INPUT_REGISTER_1, _to_limbs(in1))
    _set(row, INPUT_REGISTER_2, _to_limbs(in2))
    a = _to_limbs(in0)
    b = _to_limbs(in1)
    if flag in (IS_ADDMOD, IS_ADDFP254):
        pol_input = [x + y for x, y in zip(a, b)] + [0] * (N_LIMBS - 1)
    elif flag in (IS_SUBMOD, IS_SUBFP254):
        pol_input = [x - y for x, y in zip(a, b)] + [0] * (N_LIMBS - 1)
    else:
        pol_input = pol_mul_wide(a, b)
    out, quot = _gen_modular_op(row, row2, flag, pol_input,
                                _to_limbs(in2))
    _set(row, OUTPUT_REGISTER, out)
    _set(row, MODULAR_QUO_INPUT, quot)


def _gen_divmod(row, row2, flag, num_limbs, den_limbs):
    pol_input = list(num_limbs) + [0] * (N_LIMBS - 1)
    out, quot = _gen_modular_op(row, row2, flag, pol_input, den_limbs)
    assert all(c == 0 for c in quot[N_LIMBS:])
    if flag in (IS_DIV, IS_SHR):
        _set(row, AUX_INPUT_REGISTER_0, out)          # remainder
        _set(row, OUTPUT_REGISTER, quot[:N_LIMBS])    # quotient (output)
    else:  # IS_MOD
        _set(row, AUX_INPUT_REGISTER_0, quot[:N_LIMBS])
        _set(row, OUTPUT_REGISTER, out)


def _gen_byte(row, idx, val):
    _set(row, INPUT_REGISTER_0, _to_limbs(idx))
    _set(row, INPUT_REGISTER_1, _to_limbs(val))
    for i in range(5):
        row[BYTE_IDX_DECOMP[i]] = (idx >> i) & 1
    row[BYTE_IDX_DECOMP_HI] = ((idx & 0xFFFF) >> 5)
    idx_limbs = _to_limbs(idx)
    hi_limb_sum = row[BYTE_IDX_DECOMP_HI] + sum(idx_limbs[1:])
    hi_inv = host.finv(_f(hi_limb_sum)) if hi_limb_sum % P else 1
    for k in range(4):
        row[BYTE_IDX_HI_LIMB_SUM_INV[k]] = (hi_inv >> (16 * k)) & 0xFFFF
    row[BYTE_IDX_IS_LARGE] = int(hi_limb_sum != 0)

    val_limbs = _to_limbs(val)
    # mux tree over limbs, using low 5 bits of idx
    tree = []
    bit = (idx >> 4) & 1
    lvl = val_limbs[8:] if bit == 0 else val_limbs[:8]
    # Mirrors the generation loop (byte.rs:150-171): level selected by
    # !bit (reversed byte indexing), appended to tree.
    tree += lvl
    bit = (idx >> 3) & 1
    lvl = lvl[4:] if bit == 0 else lvl[:4]
    tree += lvl
    bit = (idx >> 2) & 1
    lvl = lvl[2:] if bit == 0 else lvl[:2]
    tree += lvl
    bit = (idx >> 1) & 1
    limb = lvl[1] if bit == 0 else lvl[0]
    tree += [limb]
    lo = limb & 0xFF
    hi = limb >> 8
    row[BYTE_LAST_LIMB_LO] = lo << 8
    row[BYTE_LAST_LIMB_HI] = hi
    out_byte = lo if (idx & 1) else hi
    tree += [out_byte]
    _set(row, AUX_INPUT_REGISTER_1, tree)
    result = out_byte if idx < 32 else 0
    _set(row, OUTPUT_REGISTER, _to_limbs(result))


def op_to_rows(op: Op) -> list[list[int]]:
    row = [0] * NUM_COLUMNS
    if op.kind == "range_check":
        row[IS_RANGE_CHECK] = 1
        row[OPCODE_COL] = _f(op.opcode)
        _set(row, INPUT_REGISTER_0, _to_limbs(op.in0))
        _set(row, INPUT_REGISTER_1, _to_limbs(op.in1))
        _set(row, INPUT_REGISTER_2, _to_limbs(op.in2))
        _set(row, OUTPUT_REGISTER, _to_limbs(op.result or 0))
        return [row]
    if op.kind in TERNARY_FLAG:
        flag = TERNARY_FLAG[op.kind]
        row[flag] = 1
        row2 = [0] * NUM_COLUMNS
        _gen_ternary(row, row2, flag, op.in0, op.in1, op.in2)
        return [row, row2]
    flag = BINARY_FLAG[op.kind]
    row[flag] = 1
    if flag in (IS_ADD, IS_SUB, IS_LT, IS_GT):
        _gen_addcy(row, flag, op.in0, op.in1)
        return [row]
    if flag == IS_MUL:
        _gen_mul(row, op.in0, op.in1)
        return [row]
    if flag == IS_BYTE:
        _gen_byte(row, op.in0, op.in1)
        return [row]
    if flag in (IS_ADDFP254, IS_MULFP254, IS_SUBFP254):
        row2 = [0] * NUM_COLUMNS
        _gen_ternary(row, row2, flag, op.in0, op.in1, BN_BASE)
        return [row, row2]
    if flag in (IS_DIV, IS_MOD):
        row2 = [0] * NUM_COLUMNS
        _set(row, INPUT_REGISTER_0, _to_limbs(op.in0))
        _set(row, INPUT_REGISTER_1, _to_limbs(op.in1))
        result = binary_result(op.kind, op.in0, op.in1)
        _set(row, OUTPUT_REGISTER, _to_limbs(result))
        _gen_divmod(row, row2, flag, _to_limbs(op.in0), _to_limbs(op.in1))
        return [row, row2]
    if flag == IS_SHL:
        shift, value = op.in0, op.in1
        _set(row, INPUT_REGISTER_0, _to_limbs(shift))
        _set(row, INPUT_REGISTER_1, _to_limbs(value))
        disp = (1 << shift) & U256_MASK if shift < 256 else 0
        _set(row, INPUT_REGISTER_2, _to_limbs(disp))
        _gen_mul_core(row, _to_limbs(value), _to_limbs(disp))
        return [row]
    if flag == IS_SHR:
        shift, value = op.in0, op.in1
        row2 = [0] * NUM_COLUMNS
        _set(row, INPUT_REGISTER_0, _to_limbs(shift))
        _set(row, INPUT_REGISTER_1, _to_limbs(value))
        disp = (1 << shift) & U256_MASK if shift < 256 else 0
        _set(row, INPUT_REGISTER_2, _to_limbs(disp))
        result = binary_result("shr", shift, value)
        _set(row, OUTPUT_REGISTER, _to_limbs(result))
        _gen_divmod(row, row2, IS_SHR, _to_limbs(value), _to_limbs(disp))
        return [row, row2]
    raise ValueError(op.kind)


# ---------------------------------------------------------------------------
# Vectorized trace generation: ops arrive as a (n, 20) uint64 array
# [step, kind, opcode, has_result, in0[4], in1[4], in2[4], res[4]] (the
# native core's export layout) and whole op families build their rows as
# numpy batches. Python big-ints appear only where 512-bit division is
# genuinely needed (the modular quotients). Bit-identical to op_to_rows
# (asserted in tests/test_arithmetic_table.py).
# ---------------------------------------------------------------------------

# the VM's arithmetic operation kinds, in its export order
ARITH_KINDS = ["add", "mul", "sub", "div", "mod", "addmod", "mulmod",
               "submod", "addfp254", "mulfp254", "subfp254", "lt", "gt",
               "byte", "shl", "shr", "range_check"]

_KIND_TO_FLAG = None


def _kind_flag_table():
    global _KIND_TO_FLAG
    if _KIND_TO_FLAG is None:
        t = np.zeros(len(ARITH_KINDS), dtype=np.int64)
        for i, k in enumerate(ARITH_KINDS):
            t[i] = IS_RANGE_CHECK if k == "range_check" else \
                BINARY_FLAG.get(k, TERNARY_FLAG.get(k, -1))
        assert (t >= 0).all()
        _KIND_TO_FLAG = t
    return _KIND_TO_FLAG


def _raw_from_ops(ops: list) -> np.ndarray:
    kind_id = {k: i for i, k in enumerate(ARITH_KINDS)}
    raw = np.zeros((len(ops), 20), dtype=np.uint64)
    for i, op in enumerate(ops):
        raw[i, 1] = kind_id[op.kind]
        raw[i, 2] = op.opcode
        raw[i, 3] = op.result is not None
        for base, v in ((4, op.in0), (8, op.in1), (12, op.in2),
                        (16, op.result or 0)):
            for w in range(4):
                raw[i, base + w] = (v >> (64 * w)) & 0xFFFFFFFFFFFFFFFF
    return raw


def _words_to_limbs(words: np.ndarray) -> np.ndarray:
    """(n, 4) uint64 words -> (n, 16) int64 16-bit limbs."""
    n = words.shape[0]
    out = np.empty((n, 16), dtype=np.int64)
    for w in range(4):
        v = words[:, w]
        for k in range(4):
            out[:, 4 * w + k] = ((v >> np.uint64(16 * k))
                                 & np.uint64(0xFFFF)).astype(np.int64)
    return out


def _words_to_ints(words: np.ndarray) -> list[int]:
    """(n, 4) uint64 -> python ints."""
    b = np.ascontiguousarray(words.astype("<u8")).tobytes()
    return [int.from_bytes(b[32 * i:32 * i + 32], "little")
            for i in range(words.shape[0])]


def _ints_to_limbs(vals: list[int], n_limbs: int) -> np.ndarray:
    nb = 2 * n_limbs
    buf = b"".join(v.to_bytes(nb, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u2").astype(np.int64) \
        .reshape(len(vals), n_limbs) if vals else \
        np.zeros((0, n_limbs), dtype=np.int64)


def _carry_prop(sums: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Propagate 16-bit carries along axis 1. Returns (limbs, carry_out)."""
    out = np.empty_like(sums)
    carry = np.zeros(sums.shape[0], dtype=sums.dtype)
    for i in range(sums.shape[1]):
        t = sums[:, i] + carry
        out[:, i] = t & 0xFFFF
        carry = t >> 16
    return out, carry


def _pol_mul_lo_vec(a: np.ndarray, b: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((a.shape[0], n), dtype=np.int64)
    for deg in range(n):
        for i in range(deg + 1):
            out[:, deg] += a[:, i] * b[:, deg - i]
    return out


def _pol_mul_wide_vec(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(n,16) x (n,16) -> (n,31)."""
    out = np.zeros((a.shape[0], 2 * N_LIMBS - 1), dtype=np.int64)
    for i in range(N_LIMBS):
        out[:, i:i + N_LIMBS] += a[:, i:i + 1] * b
    return out


def _pol_mul_wide2_vec(q: np.ndarray, m: np.ndarray) -> np.ndarray:
    """(n,32) x (n,16) -> (n,47)."""
    out = np.zeros((q.shape[0], 3 * N_LIMBS - 1), dtype=np.int64)
    for i in range(N_LIMBS):
        out[:, i:i + 2 * N_LIMBS] += m[:, i:i + 1] * q
    return out


def _pol_remove_root_vec(a: np.ndarray, n: int) -> np.ndarray:
    """Vector pol_remove_root_2exp (exact division by x - 2^16; numpy's
    arithmetic >> matches python's floor shift on negatives)."""
    q = np.zeros((a.shape[0], n), dtype=np.int64)
    q[:, 0] = -(a[:, 0] >> 16)
    for deg in range(1, n - 1):
        q[:, deg] = (q[:, deg - 1] - a[:, deg]) >> 16
    return q


def _gen_mul_core_vec(M, r, a_limbs, b_limbs):
    unreduced = _pol_mul_lo_vec(a_limbs, b_limbs, N_LIMBS)
    out, cy = _carry_prop(unreduced)
    M[r[:, None], np.array(OUTPUT_REGISTER)] = out
    aux = _pol_remove_root_vec(unreduced - out, N_LIMBS)
    aux[:, N_LIMBS - 1] = -cy
    aux += AUX_COEFF_ABS_MAX
    M[r[:, None], np.array(MUL_AUX_INPUT_LO)] = aux & 0xFFFF
    M[r[:, None], np.array(MUL_AUX_INPUT_HI)] = (aux >> 16) & 0xFFFF


def _modular_batch(M, r, flags, in_poly, mod_limbs, input_vals, moduli,
                   div_like):
    """Shared two-row modular machinery (generate_modular_op,
    modular.rs:211-341) for a family batch. `r` are first-row indices
    (second row = r+1). Returns (output_limbs, quot_limbs_stored)."""
    n = len(input_vals)
    mod_is_zero = np.array([m == 0 for m in moduli], dtype=np.int64)
    eff_mod, eff_limbs = [], mod_limbs.copy()
    for i, m in enumerate(moduli):
        if m == 0:
            if div_like[i]:
                eff_mod.append(1 << 256)
            else:
                eff_mod.append(1)
                eff_limbs[i, 0] = 1
        else:
            eff_mod.append(m)
    outputs, quots = [], []
    for iv, m in zip(input_vals, eff_mod):
        o = iv % m
        outputs.append(o)
        quots.append((iv - o) // m)
    out_limbs = _ints_to_limbs(outputs, N_LIMBS)
    negq = np.array([q < 0 for q in quots], dtype=bool)
    quot_abs = _ints_to_limbs([abs(q) for q in quots], 2 * N_LIMBS)
    quot_signed = np.where(negq[:, None], -quot_abs, quot_abs)
    out_aux_red = _ints_to_limbs(
        [(1 << 256) - m + o for m, o in zip(eff_mod, outputs)], N_LIMBS)

    constr = np.zeros((n, 2 * N_LIMBS), dtype=np.int64)
    constr[:, :in_poly.shape[1]] = in_poly
    constr[:, :N_LIMBS] -= out_limbs
    prod = _pol_mul_wide2_vec(quot_signed, eff_limbs)
    assert not prod[:, 2 * N_LIMBS:].any(), "quot*mod overflow"
    constr -= prod[:, :2 * N_LIMBS]
    aux = _pol_remove_root_vec(constr, 2 * N_LIMBS) + AUX_COEFF_ABS_MAX
    assert aux.min(initial=AUX_COEFF_ABS_MAX) >= 0 \
        and aux.max(initial=0) <= 2 * AUX_COEFF_ABS_MAX
    r2 = r + 1
    M[r2[:, None], np.array(MODULAR_AUX_INPUT_LO)] = \
        aux[:, :2 * N_LIMBS - 1] & 0xFFFF
    M[r2[:, None], np.array(MODULAR_AUX_INPUT_HI)] = \
        (aux[:, :2 * N_LIMBS - 1] >> 16) & 0xFFFF

    is_sub = np.isin(flags, (IS_SUBMOD, IS_SUBFP254))
    if is_sub.any():
        assert not quot_abs[is_sub, N_LIMBS:].any()
        lo = quot_signed[:, :N_LIMBS]
        lo = np.where((is_sub & negq)[:, None], lo + 0xFFFF, lo)
        hi = quot_signed[:, N_LIMBS:].copy()
        hi[is_sub & negq, :] = 0
        hi[is_sub & negq, 0] = 1
        quot_signed = np.concatenate([lo, hi], axis=1)

    M[r2, MODULAR_MOD_IS_ZERO] = mod_is_zero
    M[r2[:, None], np.array(MODULAR_OUT_AUX_RED)] = out_aux_red
    M[r2, MODULAR_DIV_DENOM_IS_ZERO] = mod_is_zero * div_like
    return out_limbs, quot_signed


def _rows_from_raw(raw: np.ndarray) -> np.ndarray:
    """(n_ops, 20) raw ops -> (n_rows, NUM_COLUMNS) int64 row block,
    in op order (two-row families occupy consecutive rows)."""
    n_ops = raw.shape[0]
    flags = _kind_flag_table()[raw[:, 1].astype(np.int64)]
    two_row = np.isin(flags, list(TWO_ROW_FLAGS))
    r0 = np.zeros(n_ops, dtype=np.int64)
    if n_ops:
        np.cumsum(1 + two_row[:-1], out=r0[1:])
    n_rows = int(r0[-1] + 1 + two_row[-1]) if n_ops else 0
    M = np.zeros((n_rows, NUM_COLUMNS), dtype=np.int64)
    M[r0, flags] = 1

    in0_l = _words_to_limbs(raw[:, 4:8])
    in1_l = _words_to_limbs(raw[:, 8:12])
    in2_l = _words_to_limbs(raw[:, 12:16])
    IN0 = np.array(INPUT_REGISTER_0)
    IN1 = np.array(INPUT_REGISTER_1)
    IN2 = np.array(INPUT_REGISTER_2)
    OUT = np.array(OUTPUT_REGISTER)
    AUX0 = np.array(AUX_INPUT_REGISTER_0)
    QUO = np.array(MODULAR_QUO_INPUT)

    def ints(sel, words):
        return _words_to_ints(raw[sel, words[0]:words[1]])

    # ---- range_check: single row, inputs + result verbatim
    sel = flags == IS_RANGE_CHECK
    if sel.any():
        r = r0[sel]
        M[r, OPCODE_COL] = raw[sel, 2].astype(np.int64)
        M[r[:, None], IN0] = in0_l[sel]
        M[r[:, None], IN1] = in1_l[sel]
        M[r[:, None], IN2] = in2_l[sel]
        res = _words_to_limbs(raw[:, 16:20])
        res[raw[:, 3] == 0] = 0
        M[r[:, None], OUT] = res[sel]

    # ---- add/sub/lt/gt: carry identity
    sel = np.isin(flags, (IS_ADD, IS_SUB, IS_LT, IS_GT))
    if sel.any():
        r = r0[sel]
        f = flags[sel]
        a, b = in0_l[sel], in1_l[sel]
        M[r[:, None], IN0] = a
        M[r[:, None], IN1] = b
        add_res, add_cy = _carry_prop(a + b)
        # x - y mod 2^256 via (x + (2^16-1-y) + 1): borrow-free form
        sub_res, sub_k = _carry_prop(a - b + 0xFFFF + (np.arange(16) == 0))
        sub_cy = 1 - sub_k                       # 1 iff a < b
        gt_res, gt_k = _carry_prop(b - a + 0xFFFF + (np.arange(16) == 0))
        gt_cy = 1 - gt_k
        cy_limbs = np.zeros_like(a)
        is_add = (f == IS_ADD)[:, None]
        is_sub = (f == IS_SUB)[:, None]
        is_lt = (f == IS_LT)[:, None]
        is_gt = (f == IS_GT)[:, None]
        cy = np.where(f == IS_ADD, add_cy,
                      np.where(f == IS_GT, gt_cy, sub_cy))
        cy_limbs[:, 0] = cy
        out = np.where(is_add, add_res,
                       np.where(is_sub, sub_res,
                                np.where(is_lt, cy_limbs,
                                         np.where(is_gt, cy_limbs, 0))))
        aux = np.where(is_add | is_sub, cy_limbs,
                       np.where(is_lt, sub_res, gt_res))
        M[r[:, None], AUX0] = aux
        M[r[:, None], OUT] = out

    # ---- mul
    sel = flags == IS_MUL
    if sel.any():
        r = r0[sel]
        M[r[:, None], IN0] = in0_l[sel]
        M[r[:, None], IN1] = in1_l[sel]
        _gen_mul_core_vec(M, r, in0_l[sel], in1_l[sel])

    # ---- byte: multiplexer tree
    sel = flags == IS_BYTE
    if sel.any():
        r = r0[sel]
        idx_l, val_l = in0_l[sel], in1_l[sel]
        idx0 = idx_l[:, 0]
        M[r[:, None], IN0] = idx_l
        M[r[:, None], IN1] = val_l
        for i in range(5):
            M[r, BYTE_IDX_DECOMP[i]] = (idx0 >> i) & 1
        M[r, BYTE_IDX_DECOMP_HI] = idx0 >> 5
        hi_sum = (idx0 >> 5) + idx_l[:, 1:].sum(axis=1)
        hi_inv = np.array(
            [pow(int(h) % P, P - 2, P) if int(h) % P else 1
             for h in hi_sum],
            dtype=np.uint64)
        for k in range(4):
            M[r, BYTE_IDX_HI_LIMB_SUM_INV[k]] = \
                ((hi_inv >> np.uint64(16 * k))
                 & np.uint64(0xFFFF)).astype(np.int64)
        M[r, BYTE_IDX_IS_LARGE] = (hi_sum != 0).astype(np.int64)
        tree_cols = []
        lvl = np.where(((idx0 >> 4) & 1)[:, None] == 0,
                       val_l[:, 8:], val_l[:, :8])
        tree_cols.append(lvl)
        lvl = np.where(((idx0 >> 3) & 1)[:, None] == 0,
                       lvl[:, 4:], lvl[:, :4])
        tree_cols.append(lvl)
        lvl = np.where(((idx0 >> 2) & 1)[:, None] == 0,
                       lvl[:, 2:], lvl[:, :2])
        tree_cols.append(lvl)
        limb = np.where(((idx0 >> 1) & 1) == 0, lvl[:, 1], lvl[:, 0])
        tree_cols.append(limb[:, None])
        lo, hi = limb & 0xFF, limb >> 8
        M[r, BYTE_LAST_LIMB_LO] = lo << 8
        M[r, BYTE_LAST_LIMB_HI] = hi
        out_byte = np.where((idx0 & 1) != 0, lo, hi)
        tree_cols.append(out_byte[:, None])
        M[r[:, None], np.array(AUX_INPUT_REGISTER_1)] = \
            np.concatenate(tree_cols, axis=1)
        # result = out_byte if idx < 32 else 0 (idx >= 32 iff any higher
        # limb or idx0 >= 32)
        small = (hi_sum == 0) & (idx0 < 32)
        M[r[:, None], OUT] = 0
        M[r, OUT[0]] = np.where(small, out_byte, 0)

    # ---- shl: value * (1 << shift) via the mul core
    sel = flags == IS_SHL
    if sel.any():
        r = r0[sel]
        shift_i = ints(sel, (4, 8))
        disp = [(1 << s) & U256_MASK if s < 256 else 0 for s in shift_i]
        disp_l = _ints_to_limbs(disp, N_LIMBS)
        M[r[:, None], IN0] = in0_l[sel]
        M[r[:, None], IN1] = in1_l[sel]
        M[r[:, None], IN2] = disp_l
        _gen_mul_core_vec(M, r, in1_l[sel], disp_l)

    # ---- ternary modular + fp254 (two rows)
    sel = np.isin(flags, (IS_ADDMOD, IS_MULMOD, IS_SUBMOD,
                          IS_ADDFP254, IS_MULFP254, IS_SUBFP254))
    if sel.any():
        r = r0[sel]
        f = flags[sel]
        a_l, b_l, m_l = in0_l[sel], in1_l[sel], in2_l[sel].copy()
        a_i = ints(sel, (4, 8))
        b_i = ints(sel, (8, 12))
        m_i = ints(sel, (12, 16))
        # fp254 ops fix the modulus to BN_BASE regardless of the
        # recorded third operand (op_to_rows/_gen_ternary contract)
        fp = np.isin(f, (IS_ADDFP254, IS_MULFP254, IS_SUBFP254))
        if fp.any():
            m_l[fp] = np.array(_to_limbs(BN_BASE), dtype=np.int64)
            m_i = [BN_BASE if is_fp else m
                   for m, is_fp in zip(m_i, fp)]
        M[r[:, None], IN0] = a_l
        M[r[:, None], IN1] = b_l
        M[r[:, None], IN2] = m_l
        in_poly = np.zeros((len(r), 2 * N_LIMBS - 1), dtype=np.int64)
        ivs = []
        for k, (fl, ai, bi) in enumerate(zip(f, a_i, b_i)):
            if fl in (IS_ADDMOD, IS_ADDFP254):
                ivs.append(ai + bi)
            elif fl in (IS_SUBMOD, IS_SUBFP254):
                ivs.append(ai - bi)
            else:
                ivs.append(ai * bi)
        add_m = np.isin(f, (IS_ADDMOD, IS_ADDFP254))
        sub_m = np.isin(f, (IS_SUBMOD, IS_SUBFP254))
        mul_m = ~(add_m | sub_m)
        in_poly[add_m, :N_LIMBS] = (a_l + b_l)[add_m]
        in_poly[sub_m, :N_LIMBS] = (a_l - b_l)[sub_m]
        if mul_m.any():
            in_poly[mul_m] = _pol_mul_wide_vec(a_l[mul_m], b_l[mul_m])
        out_limbs, quot = _modular_batch(
            M, r, f, in_poly, m_l, ivs, m_i,
            np.zeros(len(r), dtype=np.int64))
        M[r[:, None], OUT] = out_limbs
        M[r[:, None], QUO] = quot

    # ---- div / mod / shr (two rows)
    sel = np.isin(flags, (IS_DIV, IS_MOD, IS_SHR))
    if sel.any():
        r = r0[sel]
        f = flags[sel]
        is_shr = f == IS_SHR
        M[r[:, None], IN0] = in0_l[sel]
        M[r[:, None], IN1] = in1_l[sel]
        in0_i = ints(sel, (4, 8))
        in1_i = ints(sel, (8, 12))
        num_i = [b if s else a
                 for a, b, s in zip(in0_i, in1_i, is_shr)]
        den_i = [((1 << a) & U256_MASK if a < 256 else 0) if s else b
                 for a, b, s in zip(in0_i, in1_i, is_shr)]
        num_l = np.where(is_shr[:, None], in1_l[sel], in0_l[sel])
        den_l = _ints_to_limbs(den_i, N_LIMBS)
        if is_shr.any():
            M[r[is_shr][:, None], IN2] = den_l[is_shr]
        in_poly = np.zeros((len(r), 2 * N_LIMBS - 1), dtype=np.int64)
        in_poly[:, :N_LIMBS] = num_l
        out_limbs, quot = _modular_batch(
            M, r, f, in_poly, den_l, num_i, den_i,
            np.where(f == IS_MOD, 0, 1).astype(np.int64))
        assert not quot[:, N_LIMBS:].any()
        div_like = (f != IS_MOD)[:, None]
        M[r[:, None], AUX0] = np.where(div_like, out_limbs,
                                       quot[:, :N_LIMBS])
        M[r[:, None], OUT] = np.where(div_like, quot[:, :N_LIMBS],
                                      out_limbs)
    return M


def generate_trace(ops, min_rows: int = RANGE_MAX,
                   range_max: int = RANGE_MAX) -> np.ndarray:
    """`range_max` parameterizes the 16-bit range check table size
    (production: 2^16, forcing >= 2^16 rows as in the reference's degree
    range 2^16..2^23; tests may shrink it together with matching small
    operand values). `ops` is a list[Op] or the native (n, 20) raw
    export; both build rows through the same vectorized path."""
    raw = ops if isinstance(ops, np.ndarray) else _raw_from_ops(ops)
    M = _rows_from_raw(raw)
    n_rows_used = M.shape[0]
    n = max(min_rows, range_max, 1)
    while n < n_rows_used:
        n *= 2
    trace = np.zeros((NUM_COLUMNS, n), dtype=np.uint64)
    if n_rows_used:
        neg = M < 0
        Mu = M.astype(np.uint64)
        if neg.any():
            Mu[neg] = np.uint64(P) - (-M[neg]).astype(np.uint64)
        trace[:, :n_rows_used] = Mu.T
    # range counter: 0..range_max-1 then clamped
    trace[RANGE_COUNTER, :range_max] = np.arange(range_max, dtype=np.uint64)
    trace[RANGE_COUNTER, range_max:] = range_max - 1
    # frequencies of every shared-column value
    freq = np.zeros(n, dtype=np.uint64)
    for col in SHARED_COLS:
        vals = trace[col]
        assert vals.max(initial=0) < range_max, \
            f"column {col} value exceeds range-check bound {range_max}"
        counts = np.bincount(vals.astype(np.int64), minlength=range_max)
        freq[:len(counts)] += counts.astype(np.uint64)
    trace[RC_FREQUENCIES] = freq
    return trace


# ---------------------------------------------------------------------------
# Constraints (generic algebra: GF arrays on LDE, HExt at zeta)
# ---------------------------------------------------------------------------

def _eval_addcy(cc, filt, x, y, z, given_cy, two_row):
    cy = None
    for xi, yi, zi in zip(x, y, z):
        t = xi + yi - zi if cy is None else cy + xi + yi - zi
        if two_row:
            cc.constraint_transition(filt * t * (BASE - t))
        else:
            cc.constraint(filt * t * (BASE - t))
        cy = t * BASE_INV
    if two_row:
        cc.constraint_transition(filt * (cy - given_cy[0]))
        for c in given_cy[1:]:
            cc.constraint_transition(filt * c)
    else:
        cc.constraint(filt * given_cy[0] * (given_cy[0] - 1))
        cc.constraint(filt * (cy - given_cy[0]))
        for c in given_cy[1:]:
            cc.constraint(filt * c)


def _eval_mul(cc, lv, filt, a, b):
    out = [lv[i] for i in OUTPUT_REGISTER]
    aux = [lv[lo] + lv[hi] * BASE - AUX_COEFF_ABS_MAX
           for lo, hi in zip(MUL_AUX_INPUT_LO, MUL_AUX_INPUT_HI)]
    constr = pol_mul_lo(a, b, N_LIMBS)
    adjoin = pol_adjoin_root(aux, BASE)
    for i in range(N_LIMBS):
        cc.constraint(filt * (constr[i] - out[i] - adjoin[i]))


def _modular_constr_poly(cc, lv, nv, filt, output, modulus, quot):
    """Returns c(x) + q(x)m(x) + (x-B)s(x) as 32 coefficients; emits the
    mod-is-zero and reducedness checks (modular.rs:427-497)."""
    mod_is_zero = nv[MODULAR_MOD_IS_ZERO]
    cc.constraint_transition(filt * (mod_is_zero * mod_is_zero
                                     - mod_is_zero))
    limb_sum = modulus[0]
    for mi in modulus[1:]:
        limb_sum = limb_sum + mi
    cc.constraint_transition(filt * limb_sum * mod_is_zero)
    modulus = [modulus[0] + mod_is_zero] + list(modulus[1:])

    div_denom_is_zero = nv[MODULAR_DIV_DENOM_IS_ZERO]
    cc.constraint_transition(
        filt * (mod_is_zero * (lv[IS_DIV] + lv[IS_SHR])
                - div_denom_is_zero))
    out_adj = [output[0] + div_denom_is_zero] + list(output[1:])

    # reducedness: modulus + out_aux_red == output + is_less_than*2^256
    out_aux_red = [nv[i] for i in MODULAR_OUT_AUX_RED]
    zero = filt * 0
    ilt = [1 - mod_is_zero * (lv[IS_DIV] + lv[IS_SHR])] \
        + [zero] * (N_LIMBS - 1)
    _eval_addcy(cc, filt, modulus, out_aux_red, out_adj, ilt, True)

    prod = pol_mul_wide2(quot, modulus)
    for x in prod[2 * N_LIMBS:]:
        cc.constraint_transition(filt * x)
    constr = list(prod[:2 * N_LIMBS])
    for i in range(N_LIMBS):
        constr[i] = constr[i] + output[i]

    aux = [nv[lo] - AUX_COEFF_ABS_MAX + nv[hi] * BASE
           for lo, hi in zip(MODULAR_AUX_INPUT_LO, MODULAR_AUX_INPUT_HI)]
    aux.append(zero)                                  # 32nd coeff is 0
    adjoin = pol_adjoin_root(aux, BASE)
    return [c + r for c, r in zip(constr, adjoin)]


def _submod_constr_poly(cc, lv, nv, filt, output, modulus, quot):
    quot = list(quot)
    sign = quot[N_LIMBS]
    cc.constraint(filt * sign * (sign - 1))
    for i in range(N_LIMBS):
        quot[i] = quot[i] - sign * 0xFFFF
    quot[N_LIMBS] = filt * 0
    for d in quot[N_LIMBS:]:
        cc.constraint(filt * d)
    return _modular_constr_poly(cc, lv, nv, filt, output, modulus, quot)


def _eval_divmod_helper(cc, lv, nv, filt, num_cols, den_cols, quo_cols,
                        rem_cols):
    cc.constraint_last_row(filt)
    num = [lv[i] for i in num_cols]
    den = [lv[i] for i in den_cols]
    zero = filt * 0
    quo = [lv[i] for i in quo_cols] + [zero] * N_LIMBS
    rem = [lv[i] for i in rem_cols]
    constr = _modular_constr_poly(cc, lv, nv, filt, rem, den, quo)
    for i in range(2 * N_LIMBS):
        c = constr[i] - num[i] if i < N_LIMBS else constr[i]
        cc.constraint_transition(filt * c)


def _eval_byte(cc, lv):
    is_byte = lv[IS_BYTE]
    idx = [lv[i] for i in INPUT_REGISTER_0]
    val = [lv[i] for i in INPUT_REGISTER_1]
    out = [lv[i] for i in OUTPUT_REGISTER]
    decomp = [lv[i] for i in AUX_INPUT_REGISTER_0[:6]]
    tree = [lv[i] for i in AUX_INPUT_REGISTER_1]

    idx0_lo5 = None
    for i in range(5):
        bit = decomp[i]
        cc.constraint(is_byte * (bit * bit - bit))
        t = bit * (1 << i)
        idx0_lo5 = t if idx0_lo5 is None else idx0_lo5 + t
    cc.constraint(is_byte * (idx[0] - (idx0_lo5 + decomp[5] * 32)))

    bit = decomp[4]
    for i in range(8):
        limb = bit * val[i] + (1 - bit) * val[i + 8]
        cc.constraint(is_byte * (tree[i] - limb))
    bit = decomp[3]
    for i in range(4):
        limb = bit * tree[i] + (1 - bit) * tree[i + 4]
        cc.constraint(is_byte * (tree[i + 8] - limb))
    bit = decomp[2]
    for i in range(2):
        limb = bit * tree[i + 8] + (1 - bit) * tree[i + 10]
        cc.constraint(is_byte * (tree[i + 12] - limb))
    bit = decomp[1]
    limb = bit * tree[12] + (1 - bit) * tree[13]
    cc.constraint(is_byte * (tree[14] - limb))

    lo_byte = lv[BYTE_LAST_LIMB_LO]
    hi_byte = lv[BYTE_LAST_LIMB_HI]
    cc.constraint(is_byte * (lo_byte + (hi_byte * 256 - limb) * 256))
    bit = decomp[0]
    t = bit * lo_byte + (1 - bit) * hi_byte * 256
    cc.constraint(is_byte * (tree[15] * 256 - t))
    expected_out_byte = tree[15]

    hi_limb_sum = decomp[5]
    for x in idx[1:]:
        hi_limb_sum = hi_limb_sum + x
    idx_is_large = lv[BYTE_IDX_IS_LARGE]
    cc.constraint(is_byte * (idx_is_large * idx_is_large - idx_is_large))
    cc.constraint(is_byte * hi_limb_sum * (idx_is_large - 1))
    hi_inv = lv[BYTE_IDX_HI_LIMB_SUM_INV[0]] \
        + lv[BYTE_IDX_HI_LIMB_SUM_INV[1]] * (1 << 16) \
        + lv[BYTE_IDX_HI_LIMB_SUM_INV[2]] * (1 << 32) \
        + lv[BYTE_IDX_HI_LIMB_SUM_INV[3]] * ((1 << 48) % P)
    cc.constraint(is_byte * (hi_limb_sum * hi_inv - idx_is_large))
    cc.constraint(is_byte * (out[0] - (1 - idx_is_large)
                             * expected_out_byte))
    for i in range(1, N_LIMBS):
        cc.constraint(is_byte * out[i])


class ArithmeticStark(Stark):
    name = "arithmetic"
    num_columns = NUM_COLUMNS

    def __init__(self, range_max: int = RANGE_MAX):
        self.range_max = range_max

    def eval(self, frame, cc):
        lv = frame.local
        nv = frame.next

        # flags boolean, at most one active
        for f in OP_FLAGS:
            cc.constraint(lv[f] * lv[f] - lv[f])
        all_flags = lv[OP_FLAGS[0]]
        for f in OP_FLAGS[1:]:
            all_flags = all_flags + lv[f]
        cc.constraint(all_flags * all_flags - all_flags)
        # OPCODE_COL is zero unless range-check
        cc.constraint((1 - lv[IS_RANGE_CHECK]) * lv[OPCODE_COL])

        # range counter: starts 0, increments by 0/1, ends at RANGE_MAX-1
        rc1 = lv[RANGE_COUNTER]
        rc2 = nv[RANGE_COUNTER]
        cc.constraint_first_row(rc1)
        incr = rc2 - rc1
        cc.constraint_transition(incr * incr - incr)
        cc.constraint_last_row(rc1 - (self.range_max - 1))

        in0 = [lv[i] for i in INPUT_REGISTER_0]
        in1 = [lv[i] for i in INPUT_REGISTER_1]
        in2 = [lv[i] for i in INPUT_REGISTER_2]
        out = [lv[i] for i in OUTPUT_REGISTER]
        aux0 = [lv[i] for i in AUX_INPUT_REGISTER_0]

        # MUL and SHL
        _eval_mul(cc, lv, lv[IS_MUL], in0, in1)
        _eval_mul(cc, lv, lv[IS_SHL], in1, in2)
        # ADD/SUB/LT/GT
        _eval_addcy(cc, lv[IS_ADD], in0, in1, out, aux0, False)
        _eval_addcy(cc, lv[IS_SUB], in1, out, in0, aux0, False)
        _eval_addcy(cc, lv[IS_LT], in1, aux0, in0, out, False)
        _eval_addcy(cc, lv[IS_GT], in0, aux0, in1, out, False)
        # DIV / MOD / SHR
        _eval_divmod_helper(cc, lv, nv, lv[IS_DIV], INPUT_REGISTER_0,
                            INPUT_REGISTER_1, OUTPUT_REGISTER,
                            AUX_INPUT_REGISTER_0)
        _eval_divmod_helper(cc, lv, nv, lv[IS_MOD], INPUT_REGISTER_0,
                            INPUT_REGISTER_1, AUX_INPUT_REGISTER_0,
                            OUTPUT_REGISTER)
        _eval_divmod_helper(cc, lv, nv, lv[IS_SHR], INPUT_REGISTER_1,
                            INPUT_REGISTER_2, OUTPUT_REGISTER,
                            AUX_INPUT_REGISTER_0)
        # modular family
        bn254_filter = lv[IS_ADDFP254] + lv[IS_MULFP254] + lv[IS_SUBFP254]
        filt = lv[IS_ADDMOD] + lv[IS_SUBMOD] + lv[IS_MULMOD] + bn254_filter
        cc.constraint_last_row(filt)
        bn_limbs = _to_limbs(BN_BASE)
        for mi, bi in zip(in2, bn_limbs):
            cc.constraint_transition(bn254_filter * (mi - bi))
        quo_input = [lv[i] for i in MODULAR_QUO_INPUT]
        add_filter = lv[IS_ADDMOD] + lv[IS_ADDFP254]
        sub_filter = lv[IS_SUBMOD] + lv[IS_SUBFP254]
        mul_filter = lv[IS_MULMOD] + lv[IS_MULFP254]
        addmul_filter = add_filter + mul_filter

        sub_constr = _submod_constr_poly(cc, lv, nv, sub_filter, out, in2,
                                         quo_input)
        mod_constr = _modular_constr_poly(cc, lv, nv, addmul_filter, out,
                                          in2, quo_input)
        add_input = [x + y for x, y in zip(in0, in1)]
        sub_input = [x - y for x, y in zip(in0, in1)]
        mul_input = pol_mul_wide(in0, in1)
        for inp, f, constr in ((add_input, add_filter, mod_constr),
                               (sub_input, sub_filter, sub_constr),
                               (mul_input, mul_filter, mod_constr)):
            for i in range(2 * N_LIMBS):
                c = constr[i] - inp[i] if i < len(inp) else constr[i]
                cc.constraint_transition(f * c)
        # BYTE
        _eval_byte(cc, lv)

    def lookups(self):
        return [Lookup(looking_columns=tuple(SHARED_COLS),
                       table_column=RANGE_COUNTER,
                       frequencies_column=RC_FREQUENCIES)]

    def requires_ctls(self):
        return True
