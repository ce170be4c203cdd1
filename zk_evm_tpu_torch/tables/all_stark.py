"""AllStark registry: the 9 EVM tables and their cross-table lookups.

Functional twin of the reference's all_stark.rs (Table enum :74-107,
all_cross_table_lookups :153-172, eth_mainnet feature set) with the
CPU-side looking views of cpu_stark.rs:33-463: arithmetic dispatch,
byte packing/unpacking (incl. user PUSH reads and syscall/exception
jumptable reads), keccak-sponge calls, logic dispatch, the five memory
bus channels, SET_CONTEXT's stack-pointer ops and context pruning.
"""

from __future__ import annotations

from ..stark import CrossTableLookup, CtlView
from ..stark.lookup import ColExpr, Filter, col, col_next

from . import (arithmetic, byte_packing, keccak, keccak_sponge, logic,
               memory, memory_continuation)
from . import cpu_columns as cc
from .arithmetic import ArithmeticStark
from .byte_packing import BytePackingStark
from .cpu import CpuStark
from .keccak import KeccakStark
from .keccak_sponge import KeccakSpongeStark
from .logic import LogicStark
from .memory import MemoryStark
from .memory_continuation import MemoryContinuationStark
from .segments import Segment


class Table:
    """Table indices, in the reference's order (all_stark.rs:74-107).
    Poseidon (index 9) exists only in the cdk_erigon flavor
    (all_stark.rs:85, feature-gated upstream)."""
    Arithmetic = 0
    BytePacking = 1
    Cpu = 2
    Keccak = 3
    KeccakSponge = 4
    Logic = 5
    Memory = 6
    MemBefore = 7
    MemAfter = 8
    Poseidon = 9


NUM_TABLES = 9
CDK_NUM_TABLES = 10

# Optional tables that may be skipped when their trace is empty
# (all_stark.rs:110-126)
OPTIONAL_TABLES = (Table.BytePacking, Table.Keccak, Table.KeccakSponge,
                   Table.Logic, Table.MemAfter)
CDK_OPTIONAL_TABLES = OPTIONAL_TABLES + (Table.Poseidon,)

MEMORY_CTL_IDX = 6

NUM_CHANNELS = 5          # code + 3 GP + partial (cpu/membus.rs)
_CTX_STACK_SIZE = 11      # ContextMetadata::StackSize, unscaled


def all_starks(flavor: str = "eth_mainnet"):
    """Stark instances in Table order. The CpuStark here carries default
    kernel offsets; provers built from a real run swap in the run's
    instance (witness/traces.py _starks_with). flavor="cdk_erigon"
    appends the Poseidon coprocessor table (all_stark.rs:85)."""
    starks = [
        ArithmeticStark(),
        BytePackingStark(),
        CpuStark(flavor=flavor),
        KeccakStark(),
        KeccakSpongeStark(),
        LogicStark(),
        MemoryStark(),
        MemoryContinuationStark(),
        MemoryContinuationStark(),
    ]
    if flavor == "cdk_erigon":
        from .poseidon import PoseidonStark
        starks.append(PoseidonStark())
    return starks


# ---------------------------------------------------------------------------
# CPU-side view helpers (cpu_stark.rs)
# ---------------------------------------------------------------------------

def _le_bits(bits, const=0):
    return ColExpr(terms=tuple((b, 1 << i) for i, b in enumerate(bits)),
                   const=const)


def _ch_value(ch):
    return tuple(col(c) for c in ch.value)


def _ch_value_next(ch):
    return tuple(col_next(c) for c in ch.value)


def _zeros(n):
    return tuple(ColExpr() for _ in range(n))


def _timestamp(channel_slot: int) -> ColExpr:
    """clock * NUM_CHANNELS + channel_slot - NUM_CHANNELS + 1
    (cpu_stark.rs mem_time_and_channel:326-330)."""
    return ColExpr(terms=((cc.CLOCK, NUM_CHANNELS),),
                   const=channel_slot - NUM_CHANNELS + 1)


def _cpu_addr_from_top():
    """(context, segment, virt) unpacked from the top of the stack
    (cpu_stark.rs get_addr:318-323)."""
    ch0 = cc.MEM_CHANNELS[0]
    return (col(ch0.value[2]), col(ch0.value[1]), col(ch0.value[0]))


def _cpu_keccak_sponge_data():
    """(ctx, seg, virt, len, timestamp, 8 output limbs from the next
    row's top) — cpu_stark.rs ctl_data_keccak_sponge:33-54."""
    ctx, seg, virt = _cpu_addr_from_top()
    length = col(cc.MEM_CHANNELS[1].value[0])
    return (ctx, seg, virt, length, _timestamp(0)) \
        + _ch_value_next(cc.MEM_CHANNELS[0])


def _cpu_keccak_sponge_filter():
    """jumpdest_keccak_general with opcode bit 1 == 0 (KECCAK_GENERAL)."""
    return Filter(products=((col(cc.OP["jumpdest_keccak_general"]),
                             ColExpr(terms=((cc.OPCODE_BITS[1], -1),),
                                     const=1)),))


def _cpu_arithmetic_view():
    """Opcode (from bits) + the three inputs and one output of ternary
    ops over the memory channels (ctl_arithmetic_base_rows:106-132)."""
    columns = (_le_bits(cc.OPCODE_BITS),) \
        + _ch_value(cc.MEM_CHANNELS[0]) + _ch_value(cc.MEM_CHANNELS[1]) \
        + _ch_value(cc.MEM_CHANNELS[2]) + _ch_value_next(cc.MEM_CHANNELS[0])
    filt = Filter(
        products=((col(cc.OP["push_prover_input"]),
                   col(cc.OPCODE_BITS[7])),),
        constants=(ColExpr(terms=tuple(
            (cc.OP[f], 1) for f in ("binary_op", "fp254_op", "ternary_op",
                                    "shift", "syscall", "exception"))),))
    return CtlView(table=Table.Cpu, columns=columns, filter=filt)


def _cpu_logic_view():
    columns = (_le_bits(cc.OPCODE_BITS),) \
        + _ch_value(cc.MEM_CHANNELS[0]) + _ch_value(cc.MEM_CHANNELS[1]) \
        + _ch_value_next(cc.MEM_CHANNELS[0])
    return CtlView(table=Table.Cpu, columns=columns,
                   filter=Filter(column=cc.OP["logic_op"]))


def _cpu_byte_packing_views():
    """The CPU's four byte-packing dispatches (cpu_stark.rs:153-304):
    MLOAD_32BYTES, MSTORE_32BYTES, user-mode PUSH immediates, and the
    3-byte syscall/exception jumptable reads."""
    ch0, ch1 = cc.MEM_CHANNELS[0], cc.MEM_CHANNELS[1]
    ctx, seg, virt = _cpu_addr_from_top()

    mload = CtlView(
        table=Table.Cpu,
        columns=(ColExpr(const=1), ctx, seg, virt,
                 col(ch1.value[0]), _timestamp(0)) + _ch_value_next(ch0),
        filter=Filter(product=(cc.OP["m_op_32bytes"], cc.OPCODE_BITS[5])))

    # len = new_offset - virt (the pushed next top minus the base)
    mstore_len = ColExpr(terms=((ch0.value[0], -1),),
                         next_terms=((ch0.value[0], 1),))
    mstore = CtlView(
        table=Table.Cpu,
        columns=(ColExpr(const=0), ctx, seg, virt, mstore_len,
                 _timestamp(0)) + _ch_value(ch1),
        filter=Filter(products=((col(cc.OP["m_op_32bytes"]),
                                 ColExpr(terms=((cc.OPCODE_BITS[5], -1),),
                                         const=1)),)))

    push = CtlView(
        table=Table.Cpu,
        columns=(ColExpr(const=1), col(cc.CODE_CONTEXT),
                 ColExpr(const=int(Segment.Code)),
                 ColExpr(terms=((cc.PROGRAM_COUNTER, 1),), const=1),
                 _le_bits(cc.OPCODE_BITS[0:5], const=1),
                 _timestamp(0)) + _ch_value_next(ch0),
        filter=Filter(product=(cc.PUSH_IS_NOT_KERNEL,
                               cc.OP["push_prover_input"])))

    jumptable = CtlView(
        table=Table.Cpu,
        columns=(ColExpr(const=1), col(ch1.addr_context),
                 col(ch1.addr_segment), col(ch1.addr_virtual),
                 ColExpr(const=3), _timestamp(0)) + _ch_value(ch1),
        filter=Filter(sum_cols=(cc.OP["syscall"], cc.OP["exception"])))

    return (mload, mstore, push, jumptable)


def _cpu_memory_views(flavor: str = "eth_mainnet"):
    """The five memory-bus channels plus SET_CONTEXT's two stack-pointer
    ops (cpu_stark.rs:334-463). Tuple order matches memory.ctl_data():
    (is_read, ctx, seg, virt, 8 value limbs, timestamp)."""
    views = []
    # code channel: every executed instruction (is_cpu = sum of ALL op
    # flags, incl. the cdk poseidon flag) reads its opcode
    op_flags = tuple(cc.OP.values()) \
        + ((cc.POSEIDON,) if flavor == "cdk_erigon" else ())
    views.append(CtlView(
        table=Table.Cpu,
        columns=(ColExpr(const=1), col(cc.CODE_CONTEXT),
                 ColExpr(const=int(Segment.Code)),
                 col(cc.PROGRAM_COUNTER), _le_bits(cc.OPCODE_BITS))
        + _zeros(7) + (_timestamp(0),),
        filter=Filter(sum_cols=op_flags)))
    for i, ch in enumerate(cc.MEM_CHANNELS):
        views.append(CtlView(
            table=Table.Cpu,
            columns=(col(ch.is_read), col(ch.addr_context),
                     col(ch.addr_segment), col(ch.addr_virtual))
            + _ch_value(ch) + (_timestamp(1 + i),),
            filter=Filter(column=ch.used)))
    pch = cc.PARTIAL_CHANNEL
    views.append(CtlView(
        table=Table.Cpu,
        columns=(col(pch.is_read), col(pch.addr_context),
                 col(pch.addr_segment), col(pch.addr_virtual))
        + _ch_value(cc.MEM_CHANNELS[0])
        + (_timestamp(1 + cc.N_GP_CHANNELS),),
        filter=Filter(column=pch.used)))
    # SET_CONTEXT old-sp write / new-sp read (CTL-only ops)
    set_ctx = Filter(product=(cc.OP["context_op"], cc.OPCODE_BITS[0]))
    views.append(CtlView(
        table=Table.Cpu,
        columns=(ColExpr(const=0), col(cc.CONTEXT),
                 ColExpr(const=int(Segment.ContextMetadata)),
                 ColExpr(const=_CTX_STACK_SIZE),
                 ColExpr(terms=((cc.STACK_LEN, 1),), const=-1))
        + _zeros(7) + (_timestamp(2),),
        filter=set_ctx))
    views.append(CtlView(
        table=Table.Cpu,
        columns=(ColExpr(const=1), col(cc.MEM_CHANNELS[0].value[2]),
                 ColExpr(const=int(Segment.ContextMetadata)),
                 ColExpr(const=_CTX_STACK_SIZE),
                 col_next(cc.STACK_LEN))
        + _zeros(7) + (_timestamp(3),),
        filter=set_ctx))
    return tuple(views)


def _cdk_poseidon_simple_filter() -> Filter:
    """op.poseidon * (1 - opcode_bits[0]) — POSEIDON, 0x22
    (cpu_stark.rs ctl_poseidon_simple_filter:513-521)."""
    return Filter(products=((col(cc.POSEIDON),
                             ColExpr(terms=((cc.OPCODE_BITS[0], -1),),
                                     const=1)),))


def _cdk_poseidon_general_filter() -> Filter:
    """op.poseidon * opcode_bits[0] — POSEIDON_GENERAL, 0x23
    (cpu_stark.rs:526-533)."""
    return Filter(product=(cc.POSEIDON, cc.OPCODE_BITS[0]))


def _cdk_poseidon_simple_view() -> CtlView:
    """GP channels 0..2 carry x,y,z as u64 felts (pairs of 32-bit limbs
    recombined); the digest is the next row's top-of-stack
    (cpu_stark.rs ctl_poseidon_simple_op:467-487)."""
    cols = []
    for channel in range(3):
        ch = cc.MEM_CHANNELS[channel]
        for i in range(4):
            cols.append(ColExpr(terms=((ch.value[2 * i], 1),
                                       (ch.value[2 * i + 1], 1 << 32))))
    cols.extend(_ch_value_next(cc.MEM_CHANNELS[0]))
    return CtlView(table=Table.Cpu, columns=tuple(cols),
                   filter=_cdk_poseidon_simple_filter())


def _cdk_poseidon_general_input_view() -> CtlView:
    """(ctx, seg, virt) from the address on top, len from channel 1,
    timestamp = clock * NUM_CHANNELS (cpu_stark.rs:490-507)."""
    ctx, seg, virt = _cpu_addr_from_top()
    return CtlView(
        table=Table.Cpu,
        columns=(ctx, seg, virt, col(cc.MEM_CHANNELS[1].value[0]),
                 ColExpr(terms=((cc.CLOCK, NUM_CHANNELS),))),
        filter=_cdk_poseidon_general_filter())


def _cdk_poseidon_general_output_view() -> CtlView:
    """Digest = next row's top, timestamp = clock * NUM_CHANNELS
    (cpu_stark.rs ctl_poseidon_general_output:538-544)."""
    return CtlView(
        table=Table.Cpu,
        columns=_ch_value_next(cc.MEM_CHANNELS[0])
        + (ColExpr(terms=((cc.CLOCK, NUM_CHANNELS),)),),
        filter=_cdk_poseidon_general_filter())


def all_cross_table_lookups(
        flavor: str = "eth_mainnet") -> list[CrossTableLookup]:
    """The 10 eth_mainnet CTLs (all_stark.rs:153-172). flavor=
    "cdk_erigon" adds the three Poseidon CTLs (all_stark.rs:166-170,
    420-441) with their cdk-CPU looking views (the cdk CpuStark layout
    carries the extra `poseidon` op flag) and the Poseidon table's 56
    byte-read views into the memory CTL (all_stark.rs:345-349)."""
    ctls = _base_ctls(flavor)
    if flavor == "cdk_erigon":
        from . import poseidon
        ctls.append(CrossTableLookup(
            name="poseidon_simple",
            looking=(_cdk_poseidon_simple_view(),),
            looked=CtlView(table=Table.Poseidon,
                           columns=poseidon.ctl_looked_simple_op(),
                           filter=poseidon.ctl_looked_simple_filter())))
        ctls.append(CrossTableLookup(
            name="poseidon_general_input",
            looking=(_cdk_poseidon_general_input_view(),),
            looked=CtlView(
                table=Table.Poseidon,
                columns=poseidon.ctl_looked_general_input(),
                filter=poseidon.ctl_looked_general_input_filter())))
        ctls.append(CrossTableLookup(
            name="poseidon_general_output",
            looking=(_cdk_poseidon_general_output_view(),),
            looked=CtlView(
                table=Table.Poseidon,
                columns=poseidon.ctl_looked_general_output(),
                filter=poseidon.ctl_looked_general_output_filter())))
    return ctls


def _base_ctls(flavor: str = "eth_mainnet") -> list[CrossTableLookup]:
    poseidon_mem_views = ()
    if flavor == "cdk_erigon":
        from . import poseidon
        poseidon_mem_views = tuple(
            CtlView(table=Table.Poseidon,
                    columns=poseidon.ctl_looking_memory(i),
                    filter=poseidon.ctl_looking_memory_filter())
            for i in range(poseidon.BLOCK_BYTES))
    return [
        # ctl_arithmetic: CPU -> Arithmetic
        CrossTableLookup(
            name="arithmetic",
            looking=(_cpu_arithmetic_view(),),
            looked=CtlView(
                table=Table.Arithmetic,
                columns=_arithmetic_looked_columns(),
                filter=_arithmetic_looked_filter())),
        # ctl_byte_packing: CPU (4 views) -> BytePacking
        CrossTableLookup(
            name="byte_packing",
            looking=_cpu_byte_packing_views(),
            looked=CtlView(table=Table.BytePacking,
                           columns=byte_packing.ctl_looked_data(),
                           filter=byte_packing.ctl_looked_filter())),
        # ctl_keccak_sponge: CPU -> KeccakSponge
        CrossTableLookup(
            name="keccak_sponge",
            looking=(CtlView(table=Table.Cpu,
                             columns=_cpu_keccak_sponge_data(),
                             filter=_cpu_keccak_sponge_filter()),),
            looked=CtlView(table=Table.KeccakSponge,
                           columns=keccak_sponge.ctl_looked_data(),
                           filter=keccak_sponge.ctl_looked_filter())),
        # ctl_keccak_inputs: KeccakSponge -> Keccak
        CrossTableLookup(
            name="keccak_inputs",
            looking=(CtlView(
                table=Table.KeccakSponge,
                columns=keccak_sponge.ctl_looking_keccak_inputs(),
                filter=keccak_sponge.ctl_looking_keccak_filter()),),
            looked=CtlView(table=Table.Keccak,
                           columns=keccak.ctl_data_inputs(),
                           filter=keccak.ctl_filter_inputs())),
        # ctl_keccak_outputs: KeccakSponge -> Keccak
        CrossTableLookup(
            name="keccak_outputs",
            looking=(CtlView(
                table=Table.KeccakSponge,
                columns=keccak_sponge.ctl_looking_keccak_outputs(),
                filter=keccak_sponge.ctl_looking_keccak_filter()),),
            looked=CtlView(table=Table.Keccak,
                           columns=keccak.ctl_data_outputs(),
                           filter=keccak.ctl_filter_outputs())),
        # ctl_logic: CPU + 5 KeccakSponge views -> Logic
        CrossTableLookup(
            name="logic",
            looking=(_cpu_logic_view(),) + tuple(
                CtlView(table=Table.KeccakSponge,
                        columns=keccak_sponge.ctl_looking_logic(i),
                        filter=keccak_sponge.ctl_looking_logic_filter())
                for i in range(keccak_sponge.NUM_LOGIC_CTLS)),
            looked=CtlView(table=Table.Logic, columns=logic.ctl_data(),
                           filter=logic.ctl_filter())),
        # ctl_memory (index 6): CPU bus + 136 sponge readers
        # + 32 byte_packing ops + MemBefore rows -> Memory
        CrossTableLookup(
            name="memory",
            looking=_cpu_memory_views(flavor)
            + tuple(
                CtlView(table=Table.KeccakSponge,
                        columns=keccak_sponge.ctl_looking_memory(i),
                        filter=keccak_sponge.ctl_looking_memory_filter(i))
                for i in range(keccak_sponge.RATE_BYTES))
            + tuple(
                CtlView(table=Table.BytePacking,
                        columns=byte_packing.ctl_looking_memory(i),
                        filter=byte_packing.ctl_looking_memory_filter(i))
                for i in range(32))
            + poseidon_mem_views
            + (CtlView(table=Table.MemBefore,
                       columns=memory_continuation.ctl_data_memory(),
                       filter=memory_continuation.ctl_filter()),),
            looked=CtlView(table=Table.Memory, columns=memory.ctl_data(),
                           filter=memory.ctl_filter())),
        # ctl_mem_before: Memory -> MemBefore
        CrossTableLookup(
            name="mem_before",
            looking=(CtlView(table=Table.Memory,
                             columns=memory.ctl_looking_mem(),
                             filter=memory.ctl_filter_mem_before()),),
            looked=CtlView(table=Table.MemBefore,
                           columns=memory_continuation.ctl_data(),
                           filter=memory_continuation.ctl_filter())),
        # ctl_mem_after: Memory -> MemAfter
        CrossTableLookup(
            name="mem_after",
            looking=(CtlView(table=Table.Memory,
                             columns=memory.ctl_looking_mem(),
                             filter=memory.ctl_filter_mem_after()),),
            looked=CtlView(table=Table.MemAfter,
                           columns=memory_continuation.ctl_data(),
                           filter=memory_continuation.ctl_filter())),
        # ctl_context_pruning: Memory stale contexts -> CPU SET_CONTEXT
        # pruning rows (all_stark.rs:378-383 — Memory is the looking side)
        CrossTableLookup(
            name="context_pruning",
            looking=(CtlView(
                table=Table.Memory,
                columns=memory.ctl_context_pruning_looking(),
                filter=memory.ctl_context_pruning_looking_filter()),),
            looked=CtlView(
                table=Table.Cpu,
                columns=(col(cc.CONTEXT),),
                filter=Filter(product=(cc.OP["context_op"],
                                       cc.CTX_PRUNING_FLAG)))),
    ]


def _arithmetic_looked_columns():
    """Opcode recomposition + the 4 x 16-limb registers combined in pairs
    (x + y*2^16) into the CPU's u32 limbs (arithmetic_stark.rs
    cpu_arith_data_link:33-59, ctl_arithmetic_rows:62-116)."""
    from .arithmetic import (OPCODE_COL, INPUT_REGISTER_0,
                             INPUT_REGISTER_1, INPUT_REGISTER_2,
                             OUTPUT_REGISTER, BINARY_FLAG, TERNARY_FLAG)
    opcodes = {
        "add": 0x01, "mul": 0x02, "sub": 0x03, "div": 0x04, "mod": 0x06,
        "addmod": 0x08, "mulmod": 0x09, "addfp254": 0x0c,
        "mulfp254": 0x0d, "subfp254": 0x0e, "submod": 0x0f, "lt": 0x10,
        "gt": 0x11, "byte": 0x1a, "shl": 0x1b, "shr": 0x1c,
    }
    flag_terms = []
    for name, code in opcodes.items():
        flag = BINARY_FLAG.get(name, TERNARY_FLAG.get(name))
        flag_terms.append((flag, code))
    out = [ColExpr(terms=tuple(flag_terms) + ((OPCODE_COL, 1),))]
    for reg in (INPUT_REGISTER_0, INPUT_REGISTER_1, INPUT_REGISTER_2,
                OUTPUT_REGISTER):
        for i in range(0, len(reg), 2):
            out.append(ColExpr(terms=((reg[i], 1),
                                      (reg[i + 1], 1 << 16))))
    return tuple(out)


def _arithmetic_looked_filter():
    from .arithmetic import OP_FLAGS
    return Filter(sum_cols=tuple(OP_FLAGS))
