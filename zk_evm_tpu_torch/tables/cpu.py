"""CPU table: the zkCPU's full constraint set plus the host-side decoder.

Twin of the reference's CpuStark (evm_arithmetization/src/cpu/
cpu_stark.rs).  Every constraint module of the reference is implemented
here: decode (decode.rs:86-221 — flag booleanity/exclusivity, aligned
opcode blocks, kernel-only gating, combined flags), clock, halt, membus,
gas, stack, dup_swap, jumps, syscalls_exceptions, memio, contextops,
modfp254, byte_unpacking, pc/push0, and the shift/logic views.

Opcode blocks (start, log2 length checked via top bits, kernel-only):
the five aligned blocks map 1:1 to flags; eleven combined flags cover
arbitrary opcode pairs and are pinned by product constraints on the
recomposed opcode.  Kernel opcode values come from the extracted
constants table (witness/kernel_constants.json, e.g. SUBMOD=0x0f,
FP254 ops 0x0c-0x0e, KECCAK_GENERAL=0x21, M-ops 0xfb/0xfc).
"""

from __future__ import annotations

import numpy as np

from ..field import host
from ..stark import Stark, StarkFrame, ConstraintConsumer
from . import cpu_columns as cc
from .arithmetic import BN_BASE

# (block start, number of top bits that must match, kernel_only, flag)
ALIGNED_BLOCKS = [
    (0x14, 7, False, "eq_iszero"),        # 0x14-0x15
    (0x56, 7, False, "jumps"),            # 0x56-0x57
    (0x80, 3, False, "dup_swap"),         # 0x80-0x9f
    (0xf6, 7, True, "context_op"),        # 0xf6-0xf7
    (0xf9, 8, True, "exit_kernel"),       # 0xf9
]

# cdk_erigon adds the POSEIDON/POSEIDON_GENERAL block (decode.rs:42);
# bit 0 distinguishes POSEIDON (0x22) from POSEIDON_GENERAL (0x23)
CDK_ALIGNED_BLOCKS = [(0x22, 7, True, "poseidon")]

COMBINED_FLAGS = ["logic_op", "fp254_op", "binary_op", "ternary_op",
                  "shift", "m_op_general", "jumpdest_keccak_general",
                  "not_pop", "pc_push0", "m_op_32bytes",
                  "push_prover_input"]

# host-side opcode classification (for trace generation)
_COMBINED_MEMBERS = {
    "binary_op": [0x01, 0x02, 0x03, 0x04, 0x06, 0x10, 0x11, 0x1a],
    "ternary_op": [0x08, 0x09, 0x0f],            # SUBMOD kernel-only
    "fp254_op": [0x0c, 0x0d, 0x0e],              # kernel-only
    "logic_op": [0x16, 0x17, 0x18],
    "not_pop": [0x19, 0x50],
    "shift": [0x1b, 0x1c],
    "jumpdest_keccak_general": [0x5b, 0x21],     # KECCAK_GENERAL kernel
    "pc_push0": [0x58, 0x5f],
    "m_op_general": [0xfb, 0xfc],                # kernel-only
    "m_op_32bytes": list(range(0xc0, 0xe0)) + [0xf8],   # kernel-only
    "push_prover_input": list(range(0x60, 0x80)) + [0xee],
}
KERNEL_ONLY = ({0x0f, 0x0c, 0x0d, 0x0e, 0x21, 0xfb, 0xfc, 0xee, 0xf8}
               | set(range(0xc0, 0xe0)))


def flag_for(opcode: int, kernel: bool, flavor: str = "eth_mainnet"):
    """Host decode: which single op flag (if any) this opcode sets."""
    blocks = ALIGNED_BLOCKS if flavor == "eth_mainnet" \
        else ALIGNED_BLOCKS + CDK_ALIGNED_BLOCKS
    for start, top_bits, kernel_only, flag in blocks:
        length = 1 << (8 - top_bits)
        if start <= opcode < start + length:
            if kernel_only and not kernel:
                return None
            return flag
    for flag, members in _COMBINED_MEMBERS.items():
        if opcode in members:
            if opcode in KERNEL_ONLY and not kernel:
                return None
            return flag
    return None


# constant gas schedule (gas.rs:20-49); None = dynamic/handled elsewhere
G_KERNEL, G_JUMPDEST, G_BASE, G_VERYLOW, G_LOW, G_MID, G_HIGH = \
    0, 1, 2, 3, 5, 8, 10
SIMPLE_GAS = {
    "fp254_op": G_KERNEL, "eq_iszero": G_VERYLOW,
    "logic_op": G_VERYLOW, "shift": G_VERYLOW, "pc_push0": G_BASE,
    "dup_swap": G_VERYLOW, "context_op": G_KERNEL,
    "m_op_32bytes": G_KERNEL, "m_op_general": G_KERNEL,
}


def host_gas(opcode: int, flag: str):
    """Constant gas cost of a flagged instruction, or None when the
    cost is dynamic (syscalls, exceptions, EXIT_KERNEL)."""
    if flag in SIMPLE_GAS:
        return SIMPLE_GAS[flag]
    if flag == "jumps":
        return G_HIGH if opcode & 1 else G_MID          # JUMPI / JUMP
    if flag == "binary_op":
        slow = not ((opcode & 1) or (opcode >> 4) & 1)  # MUL DIV MOD
        return G_LOW if slow else G_VERYLOW
    if flag == "ternary_op":
        return 0 if (opcode >> 1) & 1 else G_MID        # SUBMOD free
    if flag == "not_pop":
        return G_VERYLOW if opcode & 1 else G_BASE      # NOT / POP
    if flag == "jumpdest_keccak_general":
        return G_JUMPDEST if (opcode >> 1) & 1 else G_KERNEL
    if flag == "push_prover_input":
        return G_KERNEL if (opcode >> 7) & 1 else G_VERYLOW
    return None


# stack behaviors per flag: (num_pops, pushes, disable_other_channels)
# (stack.rs:110-165; flags absent here have their stack semantics in
# their own module — dup_swap, jumps, eq_iszero, context_op,
# m_op_general — or the POP/NOT split below)
STACK_SEGMENT = 1                 # Segment::Stack.unscale()
SHIFT_TABLE_SEGMENT = 13          # Segment::ShiftTable.unscale()
JUMPDEST_BITS_SEGMENT = 14        # Segment::JumpdestBits.unscale()
STACK_BEHAVIORS = {
    "binary_op": (2, True, True),
    "ternary_op": (3, True, True),
    "fp254_op": (2, True, False),     # ch2 carries BN_BASE (modfp254.rs)
    "logic_op": (2, True, True),
    "shift": (2, True, False),
    "push_prover_input": (0, True, True),
    "pc_push0": (0, True, True),
    "m_op_32bytes": (2, True, False),
    "exit_kernel": (1, False, True),
    "syscall": (0, True, False),
    "exception": (0, True, False),
}
# ops that can push the user stack past 1024 (stack.rs MIGHT_OVERFLOW)
MIGHT_OVERFLOW = ["push_prover_input", "pc_push0", "dup_swap",
                  "exit_kernel"]

# flags whose rows are "native" instructions: pc advances by one and
# the kernel flag carries over (control_flow.rs:12-35)
NATIVE_FLAGS = ["binary_op", "ternary_op", "fp254_op", "eq_iszero",
                "logic_op", "not_pop", "shift",
                "jumpdest_keccak_general", "pc_push0", "dup_swap",
                "context_op", "m_op_general"]


def build_cpu_rows(ops, n_rows=None, start_pc=0, halt_pc=0,
                   final_gas=None, final_context=0, final_stack_len=0,
                   syscall_jumptable=0, exception_jumptable=0,
                   flavor="eth_mainnet"):
    """(num_columns, n) trace matrix from executed instructions.

    `ops` entries are (opcode, is_kernel), (opcode, is_kernel, flag),
    (opcode, is_kernel, flag, pc), optionally extended with
    (..., stack, ctx, gas, exc_code) — the explicit flag covers
    syscall/exception rows (whose opcode is the faulting one); the
    explicit pc replays a recorded execution with jumps; explicit gas
    replays the interpreter's accounting (syscall traps reset it).
    Without one, the program counter starts at start_pc and advances by
    1; padding rows are halt rows (kernel mode, pc = halt_pc, running
    clock, no flags; generation/mod.rs:646-668)."""
    n = max(len(ops), 2)
    if n_rows is None:
        n_rows = 1 << max(1, n.bit_length())
        if n_rows < n + 1:
            n_rows <<= 1          # at least one halt padding row
    ncols = cc.NUM_CPU_COLUMNS_CDK if flavor == "cdk_erigon" \
        else cc.NUM_CPU_COLUMNS
    m = np.zeros((ncols, n_rows), dtype=np.uint64)
    m[cc.CLOCK] = np.arange(1, n_rows + 1, dtype=np.uint64)
    m[cc.IS_KERNEL_MODE] = 1
    m[cc.PROGRAM_COUNTER] = halt_pc
    m[cc.CONTEXT, len(ops):] = final_context
    pc = start_pc
    gas = 0
    for r, op in enumerate(ops):
        opcode, kernel = op[0], op[1]
        flag = op[2] if len(op) > 2 and op[2] is not None \
            else flag_for(opcode, kernel, flavor)
        if len(op) > 3:
            pc = op[3]
        stack = op[4] if len(op) > 4 else None
        ctx = op[5] if len(op) > 5 else 0
        if len(op) > 6 and op[6] is not None:
            gas = op[6]
        exc_code = op[7] if len(op) > 7 else None
        m[cc.IS_KERNEL_MODE, r] = int(kernel)
        m[cc.CONTEXT, r] = ctx
        m[cc.CODE_CONTEXT, r] = 0 if kernel else ctx
        m[cc.PROGRAM_COUNTER, r] = pc
        m[cc.GAS, r] = gas
        for b in range(8):
            m[cc.OPCODE_BITS[b], r] = (opcode >> b) & 1
        if flag is not None:
            m[cc.POSEIDON if flag == "poseidon" else cc.OP[flag], r] = 1
            if flag == "push_prover_input":
                m[cc.PUSH_IS_NOT_KERNEL, r] = 0 if kernel else 1
            if len(op) <= 6 or op[6] is None:
                cost = host_gas(opcode, flag)
                gas += cost if cost is not None else 0
        if flag == "exception" and exc_code is not None:
            for b in range(3):
                m[cc.EXC_CODE_BITS[b], r] = (exc_code >> b) & 1
        if stack is not None:
            _fill_stack_witness(m, r, opcode, flag, stack, kernel, ctx)
            if flag == "exit_kernel" and stack and (
                    len(op) <= 6 or op[6] is None):
                gas = (stack[-1] >> 192) & 0xFFFFFFFF
        if flag == "fp254_op":
            # channel 2 (unused) carries the BN254 modulus for the
            # arithmetic CTL (operation.rs:102-113, cpu/modfp254.rs)
            _set_value(m, r, cc.MEM_CHANNELS[2], BN_BASE)
        pc += 1
    m[cc.GAS, len(ops):] = final_gas if final_gas is not None else gas
    m[cc.STACK_LEN, len(ops):] = final_stack_len
    _fill_overflow_aux(m, ops)
    _fill_trap_channels(m, ops, syscall_jumptable, exception_jumptable)
    # second pass: MLOAD_GENERAL's loaded value is the next row's top;
    # context_op channel-2 witness needs the next row's stack/context;
    # next-top reads (set by their predecessor) live in the reader's
    # own context
    ch0 = cc.MEM_CHANNELS[0]
    for r in range(n_rows):
        if m[ch0.used, r]:
            m[ch0.addr_context, r] = m[cc.CONTEXT, r]
    for r, op in enumerate(ops):
        if len(op) <= 4 or op[4] is None or r + 1 >= n_rows:
            continue
        opcode, stack = op[0], op[4]
        if opcode == 0xFB:
            for j in range(8):
                m[cc.MEM_CHANNELS[1].value[j], r] = \
                    m[ch0.value[j], r + 1]
        elif opcode in (0xF6, 0xF7):          # GET/SET_CONTEXT
            from ..field import host
            is_set = opcode & 1
            nlen = int(m[cc.STACK_LEN, r + 1])
            q = nlen - (0 if is_set else 1)   # relevant stack length
            m[cc.STACK_INV, r] = host.finv(q) if q else 0
            m[cc.STACK_INV_AUX, r] = 1 if q else 0
            if is_set:
                m[cc.STACK_INV_AUX_2, r] = m[cc.STACK_INV_AUX, r]
                m[cc.CTX_PRUNING_FLAG, r] = _limbs(stack[-1])[0] & 1
            if q:
                ch2 = cc.MEM_CHANNELS[2]
                m[ch2.used, r] = 1
                m[ch2.is_read, r] = is_set
                m[ch2.addr_context, r] = m[cc.CONTEXT, r + 1]
                m[ch2.addr_segment, r] = STACK_SEGMENT
                m[ch2.addr_virtual, r] = q - 1
                if is_set:                    # read the new context top
                    for j in range(8):
                        m[ch2.value[j], r] = m[ch0.value[j], r + 1]
                else:                         # write back the old top
                    _set_value(m, r, ch2, stack[-1])
    return m


def _limbs(v):
    return [(v >> (32 * j)) & 0xFFFFFFFF for j in range(8)]


def _set_value(m, r, ch, v):
    for j, limb in enumerate(_limbs(v)):
        m[ch.value[j], r] = limb


def _read_channel(m, r, ch, virt, value=None, ctx=0):
    if r >= m.shape[1]:
        return
    m[ch.used, r] = 1
    m[ch.is_read, r] = 1
    m[ch.addr_context, r] = ctx
    m[ch.addr_segment, r] = STACK_SEGMENT
    m[ch.addr_virtual, r] = virt
    if value is not None:
        _set_value(m, r, ch, value)


def _fill_stack_witness(m, r, opcode, flag, stack, kernel=True, ctx=0):
    """Memory-channel + stack-helper columns for one row, from the
    before-stack (the witness-generation side of stack.rs)."""
    from ..field import host
    L = len(stack)
    m[cc.STACK_LEN, r] = L
    if L:
        _set_value(m, r, cc.MEM_CHANNELS[0], stack[-1])
    behavior = STACK_BEHAVIORS.get(flag)
    if flag == "poseidon":
        # POSEIDON pops 3, POSEIDON_GENERAL pops 2; both push the
        # digest as the next top (stack.rs:107-121)
        behavior = (2, True, True) if opcode & 1 else (3, True, True)
    if flag == "jumps":
        jumpi = opcode & 1
        dst = stack[-1]
        if jumpi:
            cond_v = stack[-2]
            _read_channel(m, r, cc.MEM_CHANNELS[1], L - 2, cond_v,
                          ctx=ctx)
        else:
            cond_v = 1
            m[cc.MEM_CHANNELS[1].value[0], r] = 1   # pinned, unused
        should = 1 if cond_v != 0 else 0
        m[cc.JUMPS_SHOULD_JUMP, r] = should
        cond_sum = sum(_limbs(cond_v)) % host.P
        m[cc.JUMPS_COND_SUM_PINV, r] = \
            host.finv(cond_sum) if cond_sum else 0
        ch2 = cc.MEM_CHANNELS[2]                     # JUMPDEST bit
        m[ch2.value[0], r] = 1
        m[ch2.is_read, r] = 1
        m[ch2.addr_context, r] = ctx
        m[ch2.addr_segment, r] = JUMPDEST_BITS_SEGMENT
        m[ch2.addr_virtual, r] = dst & 0xFFFFFFFF
        m[ch2.used, r] = should * (1 - int(kernel))
        rem = L - 1 - jumpi
        m[cc.STACK_INV, r] = host.finv(rem % host.P) if rem else 0
        m[cc.STACK_INV_AUX, r] = 1 if rem else 0
        if rem:
            _read_channel(m, r + 1, cc.MEM_CHANNELS[0], rem - 1)
        return
    if flag == "dup_swap":
        n = opcode & 0xF
        if (opcode >> 4) & 1 == 0:            # DUP_{n+1}
            ch1, ch2 = cc.MEM_CHANNELS[1], cc.MEM_CHANNELS[2]
            m[ch1.used, r] = 1
            m[ch1.is_read, r] = 0
            m[ch1.addr_context, r] = ctx
            m[ch1.addr_segment, r] = STACK_SEGMENT
            m[ch1.addr_virtual, r] = L - 1
            _set_value(m, r, ch1, stack[-1])
            _read_channel(m, r, ch2, L - 1 - n, stack[-1 - n], ctx=ctx)
        else:                                  # SWAP_{n+1}
            ch1, ch2 = cc.MEM_CHANNELS[1], cc.MEM_CHANNELS[2]
            _read_channel(m, r, ch1, L - 2 - n, stack[-2 - n], ctx=ctx)
            m[ch2.used, r] = 1
            m[ch2.is_read, r] = 0
            m[ch2.addr_context, r] = ctx
            m[ch2.addr_segment, r] = STACK_SEGMENT
            m[ch2.addr_virtual, r] = L - 2 - n
            _set_value(m, r, ch2, stack[-1])
        return
    if flag == "jumpdest_keccak_general":
        behavior = (0, False, True) if (opcode >> 1) & 1 \
            else (2, True, True)
    if flag == "m_op_general":
        mload = opcode & 1
        rem = (L - 2) % host.P
        m[cc.STACK_INV, r] = host.finv(rem) if rem else 0
        m[cc.STACK_INV_AUX, r] = 1 if rem else 0
        if mload:
            # address sits in the top; the loaded value (next top) is
            # copied into channel 1 by the second builder pass
            ch1 = cc.MEM_CHANNELS[1]
            al = _limbs(stack[-1])
            m[ch1.used, r] = 1
            m[ch1.is_read, r] = 1
            m[ch1.addr_context, r] = al[2]
            m[ch1.addr_segment, r] = al[1]
            m[ch1.addr_virtual, r] = al[0]
        else:
            m[cc.STACK_INV_AUX_2, r] = m[cc.STACK_INV_AUX, r]
            addr_word = stack[-2]
            _read_channel(m, r, cc.MEM_CHANNELS[1], L - 2, addr_word,
                          ctx=ctx)
            al = _limbs(addr_word)
            pch = cc.PARTIAL_CHANNEL
            m[pch.used, r] = 1
            m[pch.is_read, r] = 0
            m[pch.addr_context, r] = al[2]
            m[pch.addr_segment, r] = al[1]
            m[pch.addr_virtual, r] = al[0]
            if L > 2:
                _read_channel(m, r + 1, cc.MEM_CHANNELS[0], L - 3)
        return
    if flag == "shift":
        d = stack[-1]
        dl = _limbs(d)
        hs = sum(dl[1:]) % host.P
        m[cc.SHIFT_HIGH_LIMB_SUM_INV, r] = host.finv(hs) if hs else 0
        ch2 = cc.MEM_CHANNELS[2]
        m[ch2.addr_segment, r] = SHIFT_TABLE_SEGMENT
        m[ch2.addr_virtual, r] = dl[0]
        if hs == 0:
            m[ch2.used, r] = 1
            m[ch2.is_read, r] = 1
            if d < 256:
                _set_value(m, r, ch2, 1 << d)
    if flag == "eq_iszero":
        iszero = opcode & 1
        behavior = (1, True, True) if iszero else (2, True, True)
        in0 = stack[-1]
        in1 = 0 if iszero else stack[-2]
        l0, l1 = _limbs(in0), _limbs(in1)
        n_neq = sum(1 for a, b in zip(l0, l1) if a != b)
        n_inv = host.finv(n_neq) if n_neq else 0
        for j, (a, b) in enumerate(zip(l0, l1)):
            d = (a - b) % host.P
            m[cc.LOGIC_DIFF_PINV[j], r] = \
                host.fmul(host.finv(d), n_inv) if d else 0
    if flag == "not_pop":
        behavior = (1, True, True) if opcode & 1 else None
        inv = host.finv((L - 1) % host.P) if L != 1 else 0
        m[cc.STACK_INV, r] = inv
        m[cc.STACK_INV_AUX, r] = 1 if L != 1 else 0
        if not (opcode & 1):                  # POP
            m[cc.STACK_INV_AUX_2, r] = m[cc.STACK_INV_AUX, r]
            if L > 1:
                _read_channel(m, r + 1, cc.MEM_CHANNELS[0], L - 2)
    if behavior is None:
        return
    num_pops, pushes, _ = behavior
    for i in range(1, num_pops):
        _read_channel(m, r, cc.MEM_CHANNELS[i], L - 1 - i,
                      stack[-1 - i], ctx=ctx)
    if num_pops > 0 and not pushes:
        inv = host.finv((L - num_pops) % host.P) if L != num_pops else 0
        m[cc.STACK_INV, r] = inv
        m[cc.STACK_INV_AUX, r] = 1 if L != num_pops else 0
        if L > num_pops:
            _read_channel(m, r + 1, cc.MEM_CHANNELS[0],
                          L - num_pops - 1)
    elif num_pops == 0 and pushes:
        inv = host.finv(L) if L else 0
        m[cc.STACK_INV, r] = inv
        m[cc.STACK_INV_AUX, r] = 1 if L else 0
        if L:
            pch = cc.PARTIAL_CHANNEL
            m[pch.used, r] = 1
            m[pch.is_read, r] = 0
            m[pch.addr_context, r] = ctx
            m[pch.addr_segment, r] = STACK_SEGMENT
            m[pch.addr_virtual, r] = L - 1


def _fill_trap_channels(m, ops, syscall_jt, exception_jt):
    """Channel 1 of syscall/exception rows: the (unused-flagged)
    jumptable pointer whose value is the handler address; the actual
    3-byte read goes through the BytePacking CTL
    (operation.rs:748-771,1009-1031)."""
    ch1 = cc.MEM_CHANNELS[1]
    n_rows = m.shape[1]
    for r, op in enumerate(ops):
        flag = op[2] if len(op) > 2 else None
        if flag not in ("syscall", "exception"):
            continue
        opcode = op[0]
        exc_code = op[7] if len(op) > 7 and op[7] is not None else 0
        if flag == "syscall":
            virt = syscall_jt + 3 * opcode
        else:
            virt = exception_jt + 3 * exc_code
        m[ch1.used, r] = 0
        m[ch1.is_read, r] = 1
        m[ch1.addr_context, r] = 0
        m[ch1.addr_segment, r] = 0        # Segment::Code.unscale()
        m[ch1.addr_virtual, r] = virt
        # value[0] = handler address = the next row's program counter
        if r + 1 < n_rows and r + 1 <= len(ops):
            if r + 1 < len(ops) and len(ops[r + 1]) > 3:
                m[ch1.value[0], r] = ops[r + 1][3]
        for j in range(1, 8):
            m[ch1.value[j], r] = 0


def _fill_overflow_aux(m, ops):
    """stack_len_bounds_aux: pseudoinverse of (next stack_len - 1025)
    when the next row is user mode (stack.rs MIGHT_OVERFLOW)."""
    from ..field import host
    n_rows = m.shape[1]
    for r in range(min(len(ops), n_rows - 1)):
        if any(m[cc.OP[f], r] for f in MIGHT_OVERFLOW):
            if m[cc.IS_KERNEL_MODE, r + 1] == 0:
                diff = (int(m[cc.STACK_LEN, r + 1])
                        - (cc.MAX_USER_STACK_SIZE + 1)) % host.P
                m[cc.STACK_LEN_BOUNDS_AUX, r] = host.finv(diff)


def _eval_stack_one(lv, nv, filt, behavior, consumer):
    """Constraints for one StackBehavior (stack.rs:180-300):
    pops read channels 1..n at stack[len-2]...; push-only ops write the
    old top through the partial channel; no-op behaviors freeze the
    cached top; the new stack length is pinned."""
    num_pops, pushes, disable = behavior
    one = 1
    top = cc.MEM_CHANNELS[0]
    if num_pops > 0:
        for i in range(1, num_pops):
            ch = cc.MEM_CHANNELS[i]
            consumer.constraint(filt * (lv[ch.used] - one))
            consumer.constraint(filt * (lv[ch.is_read] - one))
            consumer.constraint(filt * (lv[ch.addr_context]
                                        - lv[cc.CONTEXT]))
            consumer.constraint(filt * (lv[ch.addr_segment]
                                        - STACK_SEGMENT))
            consumer.constraint(filt * (lv[ch.addr_virtual]
                                        - (lv[cc.STACK_LEN] - (i + 1))))
        consumer.constraint(filt * lv[cc.PARTIAL_CHANNEL.used])
        if not pushes:
            len_diff = lv[cc.STACK_LEN] - num_pops
            nf = len_diff * filt
            consumer.constraint_transition(nf * (nv[top.used] - one))
            consumer.constraint_transition(nf * (nv[top.is_read] - one))
            consumer.constraint_transition(
                nf * (nv[top.addr_context] - nv[cc.CONTEXT]))
            consumer.constraint_transition(
                nf * (nv[top.addr_segment] - STACK_SEGMENT))
            consumer.constraint_transition(
                nf * (nv[top.addr_virtual] - (nv[cc.STACK_LEN] - one)))
            consumer.constraint(filt * (len_diff * lv[cc.STACK_INV]
                                        - lv[cc.STACK_INV_AUX]))
            consumer.constraint_transition(
                filt * (lv[cc.STACK_INV_AUX] - one) * nv[top.used])
    elif pushes:
        nf = lv[cc.STACK_LEN] * filt
        pch = cc.PARTIAL_CHANNEL
        consumer.constraint(nf * (lv[pch.used] - one))
        consumer.constraint(nf * lv[pch.is_read])
        consumer.constraint(nf * (lv[pch.addr_context] - lv[cc.CONTEXT]))
        consumer.constraint(nf * (lv[pch.addr_segment] - STACK_SEGMENT))
        consumer.constraint(nf * (lv[pch.addr_virtual]
                                  - (lv[cc.STACK_LEN] - one)))
        consumer.constraint(filt * (lv[cc.STACK_LEN] * lv[cc.STACK_INV]
                                    - lv[cc.STACK_INV_AUX]))
        consumer.constraint(filt * (lv[cc.STACK_INV_AUX] - one)
                            * lv[pch.used])
    else:
        consumer.constraint(filt * nv[top.used])
        for j in range(8):
            consumer.constraint(filt * (lv[top.value[j]]
                                        - nv[top.value[j]]))
        consumer.constraint(filt * lv[cc.PARTIAL_CHANNEL.used])
    if disable:
        for i in range(max(1, num_pops),
                       cc.N_GP_CHANNELS - int(pushes)):
            consumer.constraint(filt * lv[cc.MEM_CHANNELS[i].used])
    consumer.constraint_transition(
        filt * (nv[cc.STACK_LEN]
                - (lv[cc.STACK_LEN] - num_pops + int(pushes))))


def cpu_rows_from_run(interp, n_rows=None):
    """CPU trace from a finished kernel Interpreter run: replays the
    recorded per-step entries (pc, opcode, is_kernel, context,
    stack-before, gas, kind); the halt pc is wherever execution
    stopped.  Returns (trace, CpuStark)."""
    gl = interp.kernel.global_labels
    flavor = getattr(interp, "flavor", "eth_mainnet")
    if getattr(interp, "_nvm", None) is not None:
        # native fast path: rows built inside the core, straight off the
        # recorded trace buffers (bit-identical; tests/test_zvm.py)
        from ..witness import native_vm
        trace = native_vm.cpu_rows_native(interp, n_rows)
        n_ops = interp._nvm.trace_len()
        stark = CpuStark(
            start_pc=int(trace[cc.PROGRAM_COUNTER, 0]) if n_ops else 0,
            halt_pc=interp.registers.program_counter,
            syscall_jumptable=gl.get("syscall_jumptable", 0),
            exception_jumptable=gl.get("exception_jumptable", 0))
        return trace, stark
    ops = []
    for pc, opcode, kernel, ctx, stack, gas, kind in interp.trace:
        if kind == "syscall":
            flag, exc_code = "syscall", None
        elif isinstance(kind, tuple) and kind[0] == "exception":
            flag, exc_code = "exception", kind[1]
        else:
            flag, exc_code = flag_for(opcode, kernel, flavor), None
            if flag is None:
                raise ValueError(
                    f"executed opcode {opcode:#x} (kernel={kernel}) has "
                    f"no decode flag at pc {pc}")
        ops.append((opcode, kernel, flag, pc, stack, ctx, gas, exc_code))
    halt_pc = interp.registers.program_counter
    gl = interp.kernel.global_labels
    stark = CpuStark(start_pc=interp.trace[0][0] if interp.trace else 0,
                     halt_pc=halt_pc,
                     syscall_jumptable=gl.get("syscall_jumptable", 0),
                     exception_jumptable=gl.get("exception_jumptable", 0),
                     flavor=flavor)
    trace = build_cpu_rows(
        ops, n_rows=n_rows, halt_pc=halt_pc,
        final_gas=interp.registers.gas_used,
        final_context=interp.registers.context,
        final_stack_len=interp.registers.stack_len,
        syscall_jumptable=gl.get("syscall_jumptable", 0),
        exception_jumptable=gl.get("exception_jumptable", 0),
        flavor=flavor)
    return trace, stark


def cpu_stark_for_kernel(kernel, flavor: str = "eth_mainnet") -> "CpuStark":
    """The CpuStark a VERIFIER constructs from the kernel identity alone.
    A generation run starts at `init` and idles at `halt_final` — the pc
    the exc_stop epilogue parks on (NOT `halt`, which is the
    pre-epilogue label recorded in registers_after) — so the halt-module
    constraints must pin the padding rows there, exactly as the
    prover-side CpuStark from cpu_rows_from_run does."""
    gl = kernel.global_labels
    return CpuStark(start_pc=gl["init"],
                    halt_pc=gl.get("halt_final", gl["halt"]),
                    syscall_jumptable=gl.get("syscall_jumptable", 0),
                    exception_jumptable=gl.get("exception_jumptable", 0),
                    flavor=flavor)


class CpuStark(Stark):
    """CPU table; start_pc/halt_pc are the kernel's `init` and
    `halt_final` label offsets (control_flow.rs:27-38)."""
    name = "cpu"
    num_columns = cc.NUM_CPU_COLUMNS
    # segment-boundary pcs vary per proof -> traced (stark.py)
    proof_param_names = ("start_pc", "halt_pc")

    def __init__(self, start_pc: int = 0, halt_pc: int = 0,
                 syscall_jumptable: int = 0,
                 exception_jumptable: int = 0,
                 flavor: str = "eth_mainnet"):
        self.start_pc = start_pc
        self.halt_pc = halt_pc
        self.syscall_jumptable = syscall_jumptable
        self.exception_jumptable = exception_jumptable
        self.flavor = flavor
        if flavor == "cdk_erigon":
            # one extra op flag (ops.rs cfg(cdk_erigon) poseidon)
            self.num_columns = cc.NUM_CPU_COLUMNS_CDK

    def eval(self, frame: StarkFrame, consumer: ConstraintConsumer):
        lv = frame.local
        nv = frame.next
        start_pc, halt_pc = frame.params if frame.params \
            else (self.start_pc, self.halt_pc)
        one = 1

        # ---- clock.rs ----
        consumer.constraint_first_row(lv[cc.CLOCK] - one)
        consumer.constraint_transition(nv[cc.CLOCK] - lv[cc.CLOCK] - one)

        # ---- decode.rs ----
        kernel = lv[cc.IS_KERNEL_MODE]
        consumer.constraint(kernel * kernel - kernel)
        bits = [lv[cc.OPCODE_BITS[i]] for i in range(8)]
        for b in bits:
            consumer.constraint(b * b - b)

        cdk = self.flavor == "cdk_erigon"
        aligned_blocks = ALIGNED_BLOCKS + (CDK_ALIGNED_BLOCKS if cdk
                                           else [])
        opidx = dict(cc.OP)
        if cdk:
            opidx["poseidon"] = cc.POSEIDON

        flags = [lv[opidx[f]] for _, _, _, f in aligned_blocks] \
            + [lv[opidx[f]] for f in COMBINED_FLAGS]
        for f in flags:
            consumer.constraint(f * f - f)
        s = flags[0]
        for f in flags[1:]:
            s = s + f
        consumer.constraint(s * s - s)

        # aligned blocks: flag => top bits match and mode is allowed
        for start, top_bits, kernel_only, name in aligned_blocks:
            unavailable = (one - kernel) if kernel_only else 0
            mismatch = None
            for i in range(7, 7 - top_bits, -1):
                want = (start >> i) & 1
                term = (one - bits[i]) if want else bits[i]
                mismatch = term if mismatch is None else mismatch + term
            consumer.constraint(lv[opidx[name]]
                                * (mismatch + unavailable))

        opcode = None
        for i in range(8):
            t = bits[i] * (1 << i)
            opcode = t if opcode is None else opcode + t
        op_high3 = (bits[7] * 0x80) + (bits[6] * 0x40) + (bits[5] * 0x20)

        # kernel-only gating + membership for the combined flags
        consumer.constraint((kernel - one) * lv[cc.OP["fp254_op"]])
        consumer.constraint(lv[cc.OP["ternary_op"]] * bits[1]
                            * (kernel - one))
        consumer.constraint((kernel - one) * lv[cc.OP["m_op_general"]])
        consumer.constraint((opcode - 0xfb) * (opcode - 0xfc)
                            * lv[cc.OP["m_op_general"]])
        consumer.constraint((kernel - one)
                            * lv[cc.OP["jumpdest_keccak_general"]]
                            * (one - bits[1]))
        consumer.constraint((opcode - 0x21) * (opcode - 0x5b)
                            * lv[cc.OP["jumpdest_keccak_general"]])
        consumer.constraint((opcode - 0x58) * (opcode - 0x5f)
                            * lv[cc.OP["pc_push0"]])
        consumer.constraint((opcode - 0x19) * (opcode - 0x50)
                            * lv[cc.OP["not_pop"]])
        consumer.constraint((kernel - one) * lv[cc.OP["m_op_32bytes"]])
        consumer.constraint((op_high3 - 0xc0) * (opcode - 0xf8)
                            * lv[cc.OP["m_op_32bytes"]])
        consumer.constraint((opcode - 0xee) * (op_high3 - 0x60)
                            * lv[cc.OP["push_prover_input"]])
        consumer.constraint(lv[cc.OP["push_prover_input"]] * bits[7]
                            * (kernel - one))

        # ---- halt.rs / control_flow.rs ----
        def flag_sum(v):
            s = v[opidx[cpu_flag_names[0]]]
            for f in cpu_flag_names[1:]:
                s = s + v[opidx[f]]
            return s

        cpu_flag_names = list(opidx)
        is_cpu = flag_sum(lv)
        is_cpu_next = flag_sum(nv)
        halt = one - is_cpu
        halt_next = one - is_cpu_next

        # halt.rs: halted forever, kernel mode, channels off, at halt_pc
        consumer.constraint(halt * (halt - one))
        consumer.constraint_transition(halt * (halt_next - one))
        consumer.constraint(halt * (kernel - one))
        for ch in cc.MEM_CHANNELS:
            consumer.constraint(halt * lv[ch.used])
        consumer.constraint_last_row(halt - one)
        consumer.constraint(halt * (lv[cc.PROGRAM_COUNTER]
                                    - halt_pc))

        # control_flow.rs: native instructions advance pc by one and
        # keep the kernel flag
        native = lv[cc.OP[NATIVE_FLAGS[0]]]
        for f in NATIVE_FLAGS[1:]:
            native = native + lv[cc.OP[f]]
        if cdk:
            # POSEIDON/POSEIDON_GENERAL are native (control_flow.rs:23)
            native = native + lv[cc.POSEIDON]
        pc, npc = lv[cc.PROGRAM_COUNTER], nv[cc.PROGRAM_COUNTER]
        nkernel = nv[cc.IS_KERNEL_MODE]
        consumer.constraint_transition(native * (pc - npc + one))
        consumer.constraint_transition(native * (kernel - nkernel))
        prover_input = lv[cc.OP["push_prover_input"]] * bits[7]
        consumer.constraint_transition(prover_input * (pc - npc + one))
        consumer.constraint_transition(prover_input * (kernel - nkernel))
        consumer.constraint(lv[cc.OP["push_prover_input"]]
                            * (kernel + lv[cc.PUSH_IS_NOT_KERNEL]
                               - one))
        # re-entering cpu cycles from a halt state: at the kernel entry
        # point, kernel mode, empty stack
        last_noncpu = (is_cpu - one) * is_cpu_next
        consumer.constraint_transition(last_noncpu
                                       * (npc - start_pc))
        consumer.constraint_transition(last_noncpu * (nkernel - one))
        consumer.constraint_transition(last_noncpu * nv[cc.STACK_LEN])

        # ---- membus.rs ----
        # code_context is 0 in kernel mode, the current context in user
        consumer.constraint(lv[cc.CODE_CONTEXT]
                            - (one - kernel) * lv[cc.CONTEXT])
        for ch in cc.MEM_CHANNELS:
            u = lv[ch.used]
            consumer.constraint(u * (u - one))
        pu = lv[cc.PARTIAL_CHANNEL.used]
        consumer.constraint(pu * (pu - one))

        # ---- gas.rs: constant-cost accounting ----
        gas_diff = nv[cc.GAS] - lv[cc.GAS]
        for flag, cost in SIMPLE_GAS.items():
            consumer.constraint_transition(lv[cc.OP[flag]]
                                           * (gas_diff - cost))
        jump_cost = bits[0] * (G_HIGH - G_MID) + G_MID
        consumer.constraint_transition(lv[cc.OP["jumps"]]
                                       * (gas_diff - jump_cost))
        cheap = bits[0] + bits[4] - bits[0] * bits[4]   # ADD-class
        binary_cost = G_LOW - cheap * (G_LOW - G_VERYLOW)
        consumer.constraint_transition(lv[cc.OP["binary_op"]]
                                       * (gas_diff - binary_cost))
        ternary_cost = G_MID - bits[1] * G_MID          # SUBMOD free
        consumer.constraint_transition(lv[cc.OP["ternary_op"]]
                                       * (gas_diff - ternary_cost))
        not_pop_cost = bits[0] * (G_VERYLOW - G_BASE) + G_BASE
        consumer.constraint_transition(lv[cc.OP["not_pop"]]
                                       * (gas_diff - not_pop_cost))
        jkg_cost = bits[1] * G_JUMPDEST
        consumer.constraint_transition(
            lv[cc.OP["jumpdest_keccak_general"]] * (gas_diff - jkg_cost))
        ppi_cost = (one - bits[7]) * G_VERYLOW
        consumer.constraint_transition(
            lv[cc.OP["push_prover_input"]] * (gas_diff - ppi_cost))
        if cdk:
            # poseidon: KERNEL_ONLY_INSTR, zero gas (gas.rs:31)
            consumer.constraint_transition(lv[cc.POSEIDON] * gas_diff)
        # first executing row of a segment starts at gas 0
        consumer.constraint_transition(last_noncpu * nv[cc.GAS])

        # ---- stack.rs ----
        for flag, behavior in STACK_BEHAVIORS.items():
            _eval_stack_one(lv, nv, lv[cc.OP[flag]], behavior, consumer)
        # JUMPDEST (0 pops, no push) / KECCAK_GENERAL (2 pops, push)
        jkg = lv[cc.OP["jumpdest_keccak_general"]]
        _eval_stack_one(lv, nv, jkg * bits[1], (0, False, True),
                        consumer)
        _eval_stack_one(lv, nv, jkg * (one - bits[1]), (2, True, True),
                        consumer)
        if cdk:
            # POSEIDON (bit 0 clear): 3 pops, push; POSEIDON_GENERAL
            # (bit 0 set): 2 pops, push (stack.rs:107-121,355-365)
            pos_f = lv[cc.POSEIDON]
            _eval_stack_one(lv, nv, pos_f * (one - bits[0]),
                            (3, True, True), consumer)
            _eval_stack_one(lv, nv, pos_f * bits[0], (2, True, True),
                            consumer)
        # NOT: unary, via its simple_logic filter (not.rs:23-31), with
        # the bitwise-complement value constraint
        not_f = lv[cc.OP["not_pop"]] * bits[0]
        _eval_stack_one(lv, nv, not_f, (1, True, True), consumer)
        for j in range(8):
            consumer.constraint_transition(
                not_f * (lv[cc.MEM_CHANNELS[0].value[j]]
                         + nv[cc.MEM_CHANNELS[0].value[j]]
                         - 0xFFFFFFFF))
        # POP: special handling (stack.rs:346-379)
        np_f = lv[cc.OP["not_pop"]]
        len_m1 = lv[cc.STACK_LEN] - one
        consumer.constraint(np_f * (len_m1 * lv[cc.STACK_INV]
                                    - lv[cc.STACK_INV_AUX]))
        is_top_read = lv[cc.STACK_INV_AUX] * (one - bits[0])
        consumer.constraint(np_f * (lv[cc.STACK_INV_AUX_2]
                                    - is_top_read))
        top = cc.MEM_CHANNELS[0]
        pop_read = np_f * lv[cc.STACK_INV_AUX_2]
        consumer.constraint_transition(pop_read * (nv[top.used] - one))
        consumer.constraint_transition(pop_read
                                       * (nv[top.is_read] - one))
        consumer.constraint_transition(
            pop_read * (nv[top.addr_context] - nv[cc.CONTEXT]))
        consumer.constraint_transition(
            pop_read * (nv[top.addr_segment] - STACK_SEGMENT))
        consumer.constraint_transition(
            pop_read * (nv[top.addr_virtual]
                        - (nv[cc.STACK_LEN] - one)))
        consumer.constraint(np_f * (lv[cc.STACK_INV_AUX_2] - one)
                            * nv[top.used])
        for ch in cc.MEM_CHANNELS[1:]:
            consumer.constraint(np_f * (bits[0] - one) * lv[ch.used])
        consumer.constraint(np_f * (bits[0] - one)
                            * lv[cc.PARTIAL_CHANNEL.used])
        consumer.constraint_transition(
            np_f * (bits[0] - one)
            * (nv[cc.STACK_LEN] - lv[cc.STACK_LEN] + one))
        # ---- dup_swap.rs ----
        ds = lv[cc.OP["dup_swap"]]
        n_ds = bits[0] + bits[1] * 2 + bits[2] * 4 + bits[3] * 8
        ch0, ch1, ch2 = cc.MEM_CHANNELS

        def _chan(filt, ch, is_read, offset):
            consumer.constraint(filt * (lv[ch.used] - one))
            consumer.constraint(filt * (lv[ch.is_read]
                                        - (1 if is_read else 0)))
            consumer.constraint(filt * (lv[ch.addr_context]
                                        - lv[cc.CONTEXT]))
            consumer.constraint(filt * (lv[ch.addr_segment]
                                        - STACK_SEGMENT))
            consumer.constraint(filt * (lv[ch.addr_virtual]
                                        - (lv[cc.STACK_LEN] - one
                                           - offset)))

        def _equal(filt, ch_a_vals, ch_b_vals):
            for a, b in zip(ch_a_vals, ch_b_vals):
                consumer.constraint(filt * (a - b))

        # DUP (bit 4 clear): write old top via ch1, read stack[n] via
        # ch2 into the next top
        dup_f = ds * (one - bits[4])
        _equal(dup_f, [lv[ch1.value[j]] for j in range(8)],
               [lv[ch0.value[j]] for j in range(8)])
        _chan(dup_f, ch1, False, 0)
        _equal(dup_f, [lv[ch2.value[j]] for j in range(8)],
               [nv[ch0.value[j]] for j in range(8)])
        _chan(dup_f, ch2, True, n_ds)
        consumer.constraint_transition(
            dup_f * (nv[cc.STACK_LEN] - lv[cc.STACK_LEN] - one))
        consumer.constraint(dup_f * nv[ch0.used])
        # SWAP (bit 4 set): old top written to stack[n+1] via ch2, new
        # top read from stack[n+1] via ch1
        swap_f = ds * bits[4]
        n_p1 = n_ds + one
        _equal(swap_f, [lv[ch0.value[j]] for j in range(8)],
               [lv[ch2.value[j]] for j in range(8)])
        _chan(swap_f, ch2, False, n_p1)
        _equal(swap_f, [lv[ch1.value[j]] for j in range(8)],
               [nv[ch0.value[j]] for j in range(8)])
        _chan(swap_f, ch1, True, n_p1)
        consumer.constraint(swap_f * (nv[cc.STACK_LEN]
                                      - lv[cc.STACK_LEN]))
        consumer.constraint(swap_f * nv[ch0.used])
        consumer.constraint(ds * lv[cc.PARTIAL_CHANNEL.used])

        # ---- jumps.rs ----
        jf = lv[cc.OP["jumps"]]
        is_jump = jf * (one - bits[0])
        is_jumpi = jf * bits[0]
        dst = [lv[ch0.value[j]] for j in range(8)]
        cond = [lv[ch1.value[j]] for j in range(8)]
        should = lv[cc.JUMPS_SHOULD_JUMP]
        pinv = lv[cc.JUMPS_COND_SUM_PINV]
        # extra read of the new top when the stack isn't emptied
        len_diff = lv[cc.STACK_LEN] - one - bits[0]
        nf = len_diff * jf
        consumer.constraint_transition(nf * (nv[ch0.used] - one))
        consumer.constraint_transition(nf * (nv[ch0.is_read] - one))
        consumer.constraint_transition(nf * (nv[ch0.addr_context]
                                             - nv[cc.CONTEXT]))
        consumer.constraint_transition(nf * (nv[ch0.addr_segment]
                                             - STACK_SEGMENT))
        consumer.constraint_transition(
            nf * (nv[ch0.addr_virtual] - (nv[cc.STACK_LEN] - one)))
        consumer.constraint(jf * (len_diff * lv[cc.STACK_INV]
                                  - lv[cc.STACK_INV_AUX]))
        consumer.constraint_transition(jf * (lv[cc.STACK_INV_AUX] - one)
                                       * nv[ch0.used])
        # JUMP is JUMPI with the condition pinned to 1
        consumer.constraint(is_jump * (cond[0] - one))
        for limb in cond[1:]:
            consumer.constraint(is_jump * limb)
        # should_jump is boolean and mirrors the condition's nullity
        consumer.constraint(jf * should * (should - one))
        cond_sum = cond[0]
        for limb in cond[1:]:
            cond_sum = cond_sum + limb
        consumer.constraint(jf * (should - one) * cond_sum)
        consumer.constraint(jf * (pinv * cond_sum - should))
        dst_hi = dst[1]
        for limb in dst[2:]:
            dst_hi = dst_hi + limb
        consumer.constraint(jf * should * dst_hi)
        # the destination must hold a JUMPDEST bit (read via the last
        # channel; only actually read for user-mode taken jumps)
        consumer.constraint(jf * (lv[ch2.value[0]] - one))
        consumer.constraint(jf * (lv[ch2.used]
                                  - should * (one - kernel)))
        consumer.constraint(jf * (lv[ch2.is_read] - one))
        consumer.constraint(jf * (lv[ch2.addr_context] - lv[cc.CONTEXT]))
        consumer.constraint(jf * (lv[ch2.addr_segment]
                                  - JUMPDEST_BITS_SEGMENT))
        consumer.constraint(jf * (lv[ch2.addr_virtual] - dst[0]))
        consumer.constraint(jf * lv[cc.PARTIAL_CHANNEL.used])
        consumer.constraint(is_jump * lv[ch1.used])
        consumer.constraint_transition(
            is_jump * (nv[cc.STACK_LEN] - lv[cc.STACK_LEN] + one))
        consumer.constraint_transition(
            is_jumpi * (nv[cc.STACK_LEN] - lv[cc.STACK_LEN] + 2))
        consumer.constraint_transition(
            jf * (should - one) * (npc - (pc + one)))
        consumer.constraint_transition(jf * should * (npc - dst[0]))

        # ---- EXIT_KERNEL restore (jumps.rs:1-19) ----
        ek = lv[cc.OP["exit_kernel"]]
        consumer.constraint_transition(ek * (lv[ch0.value[0]] - npc))
        consumer.constraint_transition(ek * (lv[ch0.value[1]]
                                             - nkernel))
        consumer.constraint_transition(ek * (lv[ch0.value[6]]
                                             - nv[cc.GAS]))
        consumer.constraint(ek * lv[ch0.value[7]])

        # ---- syscalls_exceptions.rs ----
        sy = lv[cc.OP["syscall"]]
        ex = lv[cc.OP["exception"]]
        trap = sy + ex
        exc_bits = [lv[cc.EXC_CODE_BITS[b]] for b in range(3)]
        exc_code = exc_bits[0] + exc_bits[1] * 2 + exc_bits[2] * 4
        # only exc_stop (code 6) may fire in kernel mode
        consumer.constraint(ex * (exc_code - 6) * kernel)
        for b in exc_bits:
            consumer.constraint(ex * b * (b - one))
        jch = cc.MEM_CHANNELS[1]
        # jumptable pointer channel: flagged unused (the 3-byte read
        # goes through the BytePacking CTL), kernel code segment
        consumer.constraint(trap * lv[jch.used])
        consumer.constraint(trap * (lv[jch.is_read] - one))
        consumer.constraint(trap * lv[jch.addr_context])
        consumer.constraint(trap * lv[jch.addr_segment])  # Code == 0
        consumer.constraint(sy * (lv[jch.addr_virtual]
                                  - (opcode * 3
                                     + self.syscall_jumptable)))
        consumer.constraint(ex * (lv[jch.addr_virtual]
                                  - (exc_code * 3
                                     + self.exception_jumptable)))
        for j in range(1, 8):
            consumer.constraint(trap * lv[jch.value[j]])
        consumer.constraint(trap * lv[cc.MEM_CHANNELS[2].used])
        # handler entry: next pc = handler, kernel mode, gas reset
        consumer.constraint_transition(trap * (npc - lv[jch.value[0]]))
        consumer.constraint_transition(trap * (nkernel - one))
        consumer.constraint_transition(trap * nv[cc.GAS])
        # kexit_info pushed as the new top of stack
        out = [nv[ch0.value[j]] for j in range(8)]
        consumer.constraint_transition(sy * (out[0] - (pc + one)))
        consumer.constraint_transition(ex * (out[0] - pc))
        consumer.constraint_transition(sy * (out[1] - kernel))
        consumer.constraint_transition(trap * (out[6] - lv[cc.GAS]))
        consumer.constraint_transition(trap * out[7])
        consumer.constraint_transition(ex * (exc_code - 6) * out[1])
        for j in range(2, 6):
            consumer.constraint_transition(trap * out[j])

        # ---- simple_logic/eq_iszero.rs ----
        ei = lv[cc.OP["eq_iszero"]]
        eq_f = ei * (one - bits[0])
        isz_f = ei * bits[0]
        in0 = [lv[ch0.value[j]] for j in range(8)]
        in1 = [lv[ch1.value[j]] for j in range(8)]
        out = [nv[ch0.value[j]] for j in range(8)]
        equal = out[0]
        unequal = one - equal
        consumer.constraint(ei * equal * unequal)
        for limb in out[1:]:
            consumer.constraint(ei * limb)
        for limb in in1:                      # ISZERO(x) == EQ(x, 0)
            consumer.constraint(isz_f * limb)
        for a, b in zip(in0, in1):
            consumer.constraint(ei * equal * (a - b))
        dot = None
        for j, (a, b) in enumerate(zip(in0, in1)):
            t = (a - b) * lv[cc.LOGIC_DIFF_PINV[j]]
            dot = t if dot is None else dot + t
        consumer.constraint(ei * (dot - unequal))
        _eval_stack_one(lv, nv, eq_f, (2, True, True), consumer)
        _eval_stack_one(lv, nv, isz_f, (1, True, True), consumer)

        # ---- shift.rs ----
        sh = lv[cc.OP["shift"]]
        disp = [lv[ch0.value[j]] for j in range(8)]
        hz = lv[ch2.used]          # 1 iff the displacement fits 32 bits
        consumer.constraint(sh * hz * (lv[ch2.is_read] - one))
        hsum = disp[1]
        for limb in disp[2:]:
            hsum = hsum + limb
        hinv = lv[cc.SHIFT_HIGH_LIMB_SUM_INV]
        consumer.constraint(sh * (hsum * hinv - (one - hz)))
        consumer.constraint(sh * hsum * hz)
        consumer.constraint(sh * lv[ch2.addr_context])
        consumer.constraint(sh * (lv[ch2.addr_segment]
                                  - SHIFT_TABLE_SEGMENT))
        consumer.constraint(sh * (lv[ch2.addr_virtual] - disp[0]))

        # ---- memio.rs ----
        mg = lv[cc.OP["m_op_general"]]
        load_f = mg * bits[0]                 # MLOAD_GENERAL (0xfb)
        store_f = mg * (bits[0] - one)        # MSTORE_GENERAL (0xfc)
        # address is packed (virt, seg, ctx) in the holding channel's
        # low three limbs (cpu_stark.rs get_addr:318-323)
        la = (lv[ch0.value[2]], lv[ch0.value[1]], lv[ch0.value[0]])
        sa = (lv[ch1.value[2]], lv[ch1.value[1]], lv[ch1.value[0]])
        # load: channel 1 reads the addressed cell into the next top
        consumer.constraint(load_f * (lv[ch1.used] - one))
        consumer.constraint(load_f * (lv[ch1.is_read] - one))
        consumer.constraint(load_f * (lv[ch1.addr_context] - la[0]))
        consumer.constraint(load_f * (lv[ch1.addr_segment] - la[1]))
        consumer.constraint(load_f * (lv[ch1.addr_virtual] - la[2]))
        for j in range(8):
            consumer.constraint(load_f * (lv[ch1.value[j]]
                                          - nv[ch0.value[j]]))
        consumer.constraint(load_f * lv[ch2.used])
        consumer.constraint(load_f * lv[cc.PARTIAL_CHANNEL.used])
        _eval_stack_one(lv, nv, load_f, (1, True, False), consumer)
        # store: the write goes through the partial channel (the value
        # is the cached top; checked by the memory CTL)
        pch = cc.PARTIAL_CHANNEL
        consumer.constraint(store_f * (lv[pch.used] - one))
        consumer.constraint(store_f * lv[pch.is_read])
        consumer.constraint(store_f * (lv[pch.addr_context] - sa[0]))
        consumer.constraint(store_f * (lv[pch.addr_segment] - sa[1]))
        consumer.constraint(store_f * (lv[pch.addr_virtual] - sa[2]))
        consumer.constraint(store_f * lv[ch2.used])
        consumer.constraint(store_f * (lv[ch1.used] - one))
        consumer.constraint(store_f * (lv[ch1.is_read] - one))
        consumer.constraint(store_f * (lv[ch1.addr_context]
                                       - lv[cc.CONTEXT]))
        consumer.constraint(store_f * (lv[ch1.addr_segment]
                                       - STACK_SEGMENT))
        consumer.constraint(store_f * (lv[ch1.addr_virtual]
                                       - (lv[cc.STACK_LEN] - 2)))
        mg_len_diff = lv[cc.STACK_LEN] - 2
        consumer.constraint(mg * (mg_len_diff * lv[cc.STACK_INV]
                                  - lv[cc.STACK_INV_AUX]))
        mg_top_read = lv[cc.STACK_INV_AUX] * (one - bits[0])
        consumer.constraint(mg * (lv[cc.STACK_INV_AUX_2] - mg_top_read))
        mg_nf = mg * lv[cc.STACK_INV_AUX_2]
        consumer.constraint_transition(mg_nf * (nv[ch0.used] - one))
        consumer.constraint_transition(mg_nf * (nv[ch0.is_read] - one))
        consumer.constraint_transition(mg_nf * (nv[ch0.addr_context]
                                                - nv[cc.CONTEXT]))
        consumer.constraint_transition(mg_nf * (nv[ch0.addr_segment]
                                                - STACK_SEGMENT))
        consumer.constraint_transition(
            mg_nf * (nv[ch0.addr_virtual] - (nv[cc.STACK_LEN] - one)))
        consumer.constraint(mg * (lv[cc.STACK_INV_AUX] - one)
                            * nv[ch0.used])
        consumer.constraint(mg * bits[0] * nv[ch0.used])
        # (MSTORE's stack-length change is bound via the memory CTL,
        # not here — mirroring memio.rs)

        # ---- contextops.rs ----
        co = lv[cc.OP["context_op"]]
        keep_flags = [f for f in cc.OP if f != "context_op"]
        for f in keep_flags:
            consumer.constraint_transition(lv[cc.OP[f]]
                                           * (nv[cc.CONTEXT]
                                              - lv[cc.CONTEXT]))
        get_f = co * (one - bits[0])
        set_f = co * bits[0]
        consumer.constraint_transition(get_f * (nv[cc.CONTEXT]
                                                - lv[cc.CONTEXT]))
        # GET_CONTEXT pushes ctx<<64 (limb 2), everything else zero
        for j in range(8):
            t = nv[ch0.value[j]] - lv[cc.CONTEXT] if j == 2 \
                else nv[ch0.value[j]]
            consumer.constraint(get_f * t)
        consumer.constraint(get_f * lv[cc.CTX_PRUNING_FLAG])
        consumer.constraint(get_f * (nv[cc.STACK_LEN]
                                     - (lv[cc.STACK_LEN] + one)))
        consumer.constraint(get_f * lv[ch1.used])
        consumer.constraint(get_f * nv[ch0.used])
        # SET_CONTEXT: the new context comes from the top's limb 2; the
        # prune flag from limb 0; other limbs zero
        consumer.constraint(set_f * (lv[ch0.value[2]] - nv[cc.CONTEXT]))
        for j in (1, 3, 4, 5, 6, 7):
            consumer.constraint(set_f * lv[ch0.value[j]])
        pf = lv[cc.CTX_PRUNING_FLAG]
        consumer.constraint(co * pf * (pf - one))
        consumer.constraint(set_f * (pf - lv[ch0.value[0]]))
        consumer.constraint(co * (lv[cc.STACK_INV_AUX] * bits[0]
                                  - lv[cc.STACK_INV_AUX_2]))
        for j in range(8):
            consumer.constraint(co * lv[cc.STACK_INV_AUX_2]
                                * (nv[ch0.value[j]] - lv[ch2.value[j]]))
        consumer.constraint(set_f * lv[ch1.used])
        consumer.constraint(set_f * nv[ch0.used])
        # shared channel-2 plumbing: write-back (GET) / new-top read
        # (SET), live only when the relevant stack is non-empty
        ctx_len = nv[cc.STACK_LEN] - (one - bits[0])
        consumer.constraint(co * (ctx_len * lv[cc.STACK_INV]
                                  - lv[cc.STACK_INV_AUX]))
        consumer.constraint(co * (lv[cc.STACK_INV_AUX] - lv[ch2.used]))
        co_nf = co * lv[cc.STACK_INV_AUX]
        consumer.constraint(co_nf * (lv[ch2.is_read] - bits[0]))
        consumer.constraint(co_nf * (lv[ch2.addr_context]
                                     - nv[cc.CONTEXT]))
        consumer.constraint(co_nf * (lv[ch2.addr_segment]
                                     - STACK_SEGMENT))
        consumer.constraint(co_nf * (lv[ch2.addr_virtual]
                                     - (ctx_len - one)))

        # ---- modfp254.rs ----
        # fp254 ops reuse the ternary-op arithmetic CTL shape with the
        # BN254 modulus pinned into channel 2 instead of a stack read
        fp = lv[cc.OP["fp254_op"]]
        for j, p_limb in enumerate(_limbs(BN_BASE)):
            consumer.constraint(fp * (lv[ch2.value[j]] - p_limb))

        # ---- byte_unpacking.rs ----
        # MSTORE_32BYTES_n (bit 5 clear) pushes the written address
        # advanced by its length (low five opcode bits + 1); the byte
        # (un)packing itself is bound via the BytePacking CTL
        b32 = lv[cc.OP["m_op_32bytes"]] * (bits[5] - one)
        blen = bits[0]
        for i in range(1, 5):
            blen = blen + bits[i] * (1 << i)
        blen = blen + one
        consumer.constraint(b32 * (nv[ch0.value[0]] - lv[ch0.value[0]]
                                   - blen))
        consumer.constraint(b32 * (nv[ch0.value[1]] - lv[ch0.value[1]]))
        consumer.constraint(b32 * (nv[ch0.value[2]] - lv[ch0.value[2]]))
        for j in range(3, 8):
            consumer.constraint(b32 * nv[ch0.value[j]])

        # ---- pc.rs / push0.rs ----
        pc_f = lv[cc.OP["pc_push0"]] * (one - bits[0])   # PC (0x58)
        push0_f = lv[cc.OP["pc_push0"]] * bits[0]        # PUSH0 (0x5f)
        consumer.constraint(pc_f * (nv[ch0.value[0]] - pc))
        for j in range(1, 8):
            consumer.constraint(pc_f * nv[ch0.value[j]])
        for j in range(8):
            consumer.constraint(push0_f * nv[ch0.value[j]])

        # stack overflow check (user mode only)
        for flag in MIGHT_OVERFLOW:
            diff = nv[cc.STACK_LEN] - (cc.MAX_USER_STACK_SIZE + 1)
            consumer.constraint_transition(
                lv[cc.OP[flag]]
                * (diff * lv[cc.STACK_LEN_BOUNDS_AUX]
                   - (one - nkernel)))
