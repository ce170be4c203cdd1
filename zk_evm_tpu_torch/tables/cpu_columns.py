"""CPU table column layout: the 85-column register/bus view.

Index-map twin of the reference's CpuColumnsView (evm_arithmetization/
src/cpu/columns/mod.rs:55-99), OpsColumnsView (columns/ops.rs, 18
eth_mainnet flags), and the 8-column CpuGeneralColumnsView union
(columns/general.rs) whose per-operation views (exception, logic,
jumps, shift, stack, push, context-pruning) alias the same 8 slots.
Memory bus: 3 general-purpose channels of 13 columns (used, is_read,
3-part address, 8 value limbs; membus.rs:11, memory VALUE_LIMBS=8) plus
one 5-column partial channel sharing the GP0 value.

Layout is a flat index namespace so trace generation writes numpy
columns and constraint evaluation indexes GF matrices directly — the
same pattern as the other tables in this package.
"""

from __future__ import annotations

N_GP_CHANNELS = 3
VALUE_LIMBS = 8
N_SHARED = 8            # size of the general-columns union
MAX_USER_STACK_SIZE = 1024


class _Alloc:
    def __init__(self):
        self.n = 0

    def one(self):
        i = self.n
        self.n += 1
        return i

    def many(self, k):
        r = list(range(self.n, self.n + k))
        self.n += k
        return r


_a = _Alloc()

CONTEXT = _a.one()
CODE_CONTEXT = _a.one()
PROGRAM_COUNTER = _a.one()
STACK_LEN = _a.one()
IS_KERNEL_MODE = _a.one()
GAS = _a.one()

# operation flags (ops.rs; eth_mainnet set — no poseidon)
OP_NAMES = [
    "binary_op",                  # ADD MUL SUB DIV MOD LT GT BYTE
    "ternary_op",                 # ADDMOD MULMOD SUBMOD
    "fp254_op",                   # ADD/MUL/SUB_FP254
    "eq_iszero",                  # EQ ISZERO
    "logic_op",                   # AND OR XOR
    "not_pop",                    # NOT POP
    "shift",                      # SHL SHR
    "jumpdest_keccak_general",    # JUMPDEST KECCAK_GENERAL
    "jumps",                      # JUMP JUMPI
    "push_prover_input",          # PUSH1..32 PROVER_INPUT
    "dup_swap",                   # DUPn SWAPn
    "context_op",                 # GET_CONTEXT SET_CONTEXT
    "m_op_32bytes",               # MSTORE_32BYTES MLOAD_32BYTES
    "exit_kernel",                # EXIT_KERNEL
    "m_op_general",               # MSTORE_GENERAL MLOAD_GENERAL
    "pc_push0",                   # PC PUSH0
    "syscall",
    "exception",
]
OP = {name: ix for name, ix in zip(OP_NAMES, _a.many(len(OP_NAMES)))}
OP_START = OP[OP_NAMES[0]]
N_OP_FLAGS = len(OP_NAMES)

OPCODE_BITS = _a.many(8)          # little-endian bits of the opcode

# general-purpose union: 8 shared slots with per-op views (general.rs)
GENERAL = _a.many(N_SHARED)
# exception view: 3 exception-code bits
EXC_CODE_BITS = GENERAL[:3]
# logic view: pseudoinverse limbs of (in0 - in1)
LOGIC_DIFF_PINV = GENERAL[:8]
# jumps view
JUMPS_SHOULD_JUMP = GENERAL[0]
JUMPS_COND_SUM_PINV = GENERAL[1]
# shift view
SHIFT_HIGH_LIMB_SUM_INV = GENERAL[0]
# push view
PUSH_IS_NOT_KERNEL = GENERAL[0]
# context-pruning view
CTX_PRUNING_FLAG = GENERAL[0]
# stack view: last four shared slots
STACK_INV = GENERAL[N_SHARED - 4]
STACK_INV_AUX = GENERAL[N_SHARED - 3]
STACK_INV_AUX_2 = GENERAL[N_SHARED - 2]
STACK_LEN_BOUNDS_AUX = GENERAL[N_SHARED - 1]

CLOCK = _a.one()


class MemChannel:
    """13-column full memory-bus channel."""

    def __init__(self, alloc):
        self.used = alloc.one()
        self.is_read = alloc.one()
        self.addr_context = alloc.one()
        self.addr_segment = alloc.one()
        self.addr_virtual = alloc.one()
        self.value = alloc.many(VALUE_LIMBS)

    @property
    def all(self):
        return [self.used, self.is_read, self.addr_context,
                self.addr_segment, self.addr_virtual] + self.value


class PartialChannel:
    """5-column channel sharing GP0's value (top of stack)."""

    def __init__(self, alloc):
        self.used = alloc.one()
        self.is_read = alloc.one()
        self.addr_context = alloc.one()
        self.addr_segment = alloc.one()
        self.addr_virtual = alloc.one()


MEM_CHANNELS = [MemChannel(_a) for _ in range(N_GP_CHANNELS)]
PARTIAL_CHANNEL = PartialChannel(_a)

NUM_CPU_COLUMNS = _a.n
assert NUM_CPU_COLUMNS == 85, NUM_CPU_COLUMNS

# cdk_erigon flavor: one extra op flag for POSEIDON/POSEIDON_GENERAL
# (ops.rs cfg(cdk_erigon) `poseidon`; decode.rs:42 block 0x22-0x23).
# Appended past the eth_mainnet namespace so every other index is
# flavor-independent.
POSEIDON = NUM_CPU_COLUMNS
NUM_CPU_COLUMNS_CDK = NUM_CPU_COLUMNS + 1
