"""Witness -> 9-table trace assembly.

Functional twin of the reference's traces.rs (Traces::into_tables,
traces.rs:139-259) and generation/mod.rs:496-638 (generate_traces): a
finished tracing-interpreter run is converted into the nine table traces
plus PublicValues, with every cross-table timestamp derived from the CPU
row index so the CTL multisets balance by construction.

Timestamp convention (witness/memory.rs:106-121): a memory op on CPU row
r (0-based) through channel slot c (Code=0, GP n=n+1, Partial=4) has
timestamp r*NUM_CHANNELS + 1 + c; coprocessor dispatches (keccak sponge,
byte packing) carry the row's base timestamp r*NUM_CHANNELS + 1. The
block-metadata / trie-digest / registers writes applied before execution
(generation/mod.rs:271-433) land at timestamp 2 (clock 0, GP channel 0)
and are balanced on the verifier side by the public-values extra looking
sum (verifier.rs:319-490).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..tables import cpu_columns as cc
from ..tables import (arithmetic, byte_packing, keccak, keccak_sponge,
                      logic, memory, memory_continuation)
from ..tables.cpu import cpu_rows_from_run
from .interpreter import trie_root_hash
from ..tables.all_stark import Table, NUM_TABLES, OPTIONAL_TABLES, all_starks
from ..tables.segments import Segment
from ..stark.public_values import (PublicValues, TrieRoots, ExtraBlockData,
                                   RegistersData)

NUM_CHANNELS = 5                      # code + 3 GP + partial (membus.rs)

# Allowed log2 trace lengths: every table pads up to one of these (the
# JAX package's compile_cache.BUCKETS, the reference's per-table circuit
# ranges, zero/src/prover_state/circuit.rs:79-90). The floor at 2^8 only
# lifts trivial shapes.
BUCKETS = tuple(range(8, 23))


def bucket_rows(n_rows: int) -> int:
    """The smallest allowed power of two holding n_rows."""
    need = max(n_rows, 2).bit_length() - 1
    if (1 << need) < n_rows:
        need += 1
    return 1 << next((b for b in BUCKETS if b >= need), need)
_CTX_STACK_SIZE = 11                  # ContextMetadata::StackSize unscaled


def derive_memory_ops_arrays(trace: np.ndarray) -> "memory.MemOpsArrays":
    """Memory ops implied by a CPU trace's bus columns, as
    struct-of-arrays blocks: one code read per flagged row, one op per
    used GP/partial channel, plus SET_CONTEXT's two CTL-only
    stack-pointer ops (cpu_stark.rs:334-463, operation.rs:371-454)."""
    n = trace.shape[1]
    base_ts = np.arange(n, dtype=np.uint64) * NUM_CHANNELS + np.uint64(1)
    flag_rows = trace[cc.OP_START:cc.OP_START + cc.N_OP_FLAGS].sum(axis=0)
    opcode = np.zeros(n, dtype=np.uint64)
    for b in range(8):
        opcode |= trace[cc.OPCODE_BITS[b]] << np.uint64(b)
    parts = []

    def block(rows, ts_off, ctx, seg, virt, is_read, limbs):
        k = len(rows)
        if not k:
            return
        ones = np.ones(k, dtype=np.uint64)
        parts.append(memory.MemOpsArrays(
            ones, base_ts[rows] + np.uint64(ts_off),
            np.asarray(ctx, dtype=np.uint64),
            (np.full(k, seg, dtype=np.uint64)
             if np.isscalar(seg) else np.asarray(seg, dtype=np.uint64)),
            np.asarray(virt, dtype=np.uint64),
            (np.full(k, is_read, dtype=np.uint64)
             if np.isscalar(is_read)
             else np.asarray(is_read, dtype=np.uint64)),
            limbs))

    def lo_limbs(vals):
        k = len(vals)
        out = np.zeros((k, memory.VALUE_LIMBS), dtype=np.uint32)
        out[:, 0] = vals & np.uint64(0xFFFFFFFF)
        out[:, 1] = vals >> np.uint64(32)
        return out

    rows = np.flatnonzero(flag_rows)
    block(rows, 0, trace[cc.CODE_CONTEXT, rows], int(Segment.Code),
          trace[cc.PROGRAM_COUNTER, rows], 1, lo_limbs(opcode[rows]))
    for i, ch in enumerate(cc.MEM_CHANNELS):
        rows = np.flatnonzero(trace[ch.used])
        limbs = trace[np.array(ch.value)][:, rows].T.astype(np.uint32)
        block(rows, 1 + i, trace[ch.addr_context, rows],
              trace[ch.addr_segment, rows], trace[ch.addr_virtual, rows],
              trace[ch.is_read, rows], np.ascontiguousarray(limbs))
    pch = cc.PARTIAL_CHANNEL
    rows = np.flatnonzero(trace[pch.used])
    limbs = trace[np.array(cc.MEM_CHANNELS[0].value)][:, rows].T \
        .astype(np.uint32)
    block(rows, 4, trace[pch.addr_context, rows],
          trace[pch.addr_segment, rows], trace[pch.addr_virtual, rows],
          trace[pch.is_read, rows], np.ascontiguousarray(limbs))
    # SET_CONTEXT: old-sp write / new-sp read live only in CTL views
    rows = np.flatnonzero(trace[cc.OP["context_op"]]
                          * trace[cc.OPCODE_BITS[0]])
    block(rows, 2, trace[cc.CONTEXT, rows],
          int(Segment.ContextMetadata),
          np.full(len(rows), _CTX_STACK_SIZE, dtype=np.uint64), 0,
          lo_limbs(trace[cc.STACK_LEN, rows] - np.uint64(1)))
    block(rows, 3, trace[cc.MEM_CHANNELS[0].value[2], rows],
          int(Segment.ContextMetadata),
          np.full(len(rows), _CTX_STACK_SIZE, dtype=np.uint64), 1,
          lo_limbs(trace[cc.STACK_LEN, (rows + 1) % n]))
    if not parts:
        return memory.MemOpsArrays(
            np.zeros(0, np.uint64), np.zeros(0, np.uint64),
            np.zeros(0, np.uint64), np.zeros(0, np.uint64),
            np.zeros(0, np.uint64), np.zeros(0, np.uint64),
            np.zeros((0, memory.VALUE_LIMBS), np.uint32))
    return memory.MemOpsArrays.concat(parts)


def _sponge_blocks(data: bytes):
    """Replay the sponge absorption exactly as the KeccakSponge trace
    does (keccak_sponge.py generate_trace): yields per-block
    (state_before_u32s, block_bytes, xored_state_u32s)."""
    RATE = keccak_sponge.RATE_BYTES
    state = [0] * keccak_sponge.WIDTH_U32S
    n_full = len(data) // RATE
    blocks = [data[b * RATE:(b + 1) * RATE] for b in range(n_full)]
    final = bytearray(data[n_full * RATE:])
    if len(final) == RATE - 1:
        final.append(0b10000001)
    else:
        final.append(0x01)
        final.extend(b"\x00" * (RATE - len(final)))
        final[-1] |= 0b10000000
    blocks.append(bytes(final))
    for block in blocks:
        before = list(state)
        for i in range(keccak_sponge.RATE_U32S):
            state[i] ^= int.from_bytes(block[4 * i:4 * i + 4], "little")
        xored = list(state)
        state = keccak_sponge._keccakf_u32s(state)
        yield before, block, xored


def _sponge_coprocessor_ops(sponge_ops):
    """Keccak-f inputs and Logic XOR ops implied by the sponge trace's
    looking views (ctl_looking_keccak_inputs / ctl_looking_logic)."""
    keccak_inputs = []
    logic_ops = []
    for op in sponge_ops:
        for before, block, xored in _sponge_blocks(op.input):
            u32s = xored[:keccak_sponge.RATE_U32S] \
                + before[keccak_sponge.RATE_U32S:]
            lanes = [u32s[2 * i] | (u32s[2 * i + 1] << 32)
                     for i in range(25)]
            keccak_inputs.append((lanes, op.timestamp))
            for i in range(keccak_sponge.NUM_LOGIC_CTLS):
                x = 0
                for j in range(8):
                    k = i * 8 + j
                    if k < keccak_sponge.RATE_U32S:
                        x |= before[k] << (32 * j)
                y = int.from_bytes(block[32 * i:32 * i + 32], "little")
                logic_ops.append(("xor", x, y))
    return keccak_inputs, logic_ops


def _sponge_memory_ops(sponge_ops):
    """Per-byte reads of each sponge op's input (ctl_looking_memory:
    padding bytes are not read)."""
    out = []
    for op in sponge_ops:
        for i, b in enumerate(op.input):
            out.append(memory.MemoryOp(True, op.timestamp, op.context,
                                       op.segment, op.virt + i, True, b))
    return out


def _bp_memory_ops(bp_ops):
    """Per-byte ops of each byte-packing op (byte_packing.py
    ctl_looking_memory: byte p of the big-endian sequence at virt+p)."""
    out = []
    for op in bp_ops:
        for p, b in enumerate(op.bytes):
            out.append(memory.MemoryOp(True, op.timestamp, op.context,
                                       op.segment, op.virt + p,
                                       op.is_read, b))
    return out


@dataclass
class GeneratedTables:
    traces: list                       # NUM_TABLES entries (None = unused)
    table_in_use: list
    starks: list                       # per-table Stark instances
    public_values: PublicValues
    mem_before_values: list
    mem_after_values: list


def generate_all_tables(interp) -> GeneratedTables:
    """All nine table traces from a finished segment run (segments.py);
    an empty optional table is None (unused, no proof)."""
    ts_of = lambda step: step * NUM_CHANNELS + 1

    mins = _table_min_rows() or {}
    cpu_trace, cpu_stark = cpu_rows_from_run(interp)
    want = max(bucket_rows(cpu_trace.shape[1]),
               mins.get(Table.Cpu, 2))
    if want > cpu_trace.shape[1]:
        # rebuild: the generator's halt-row padding + witness fill stay
        # constraint-exact at any size (generic column padding would
        # break the in-table lookups)
        cpu_trace, cpu_stark = cpu_rows_from_run(interp, n_rows=want)

    # native runs export the (n, 20) raw op array; the vectorized
    # arithmetic generator consumes it directly (python-object Ops only
    # on the pure-python interpreter path)
    arith_ops = getattr(interp, "arith_raw", None)
    if arith_ops is None:
        arith_ops = [arithmetic.Op(kind, in0, in1, in2, opcode, result)
                     for _s, (kind, in0, in1, in2, opcode, result)
                     in interp.arith_log]

    sponge_ops = [keccak_sponge.KeccakSpongeOp(ctx, seg, virt, ts_of(s),
                                               bytes(data))
                  for s, (ctx, seg, virt), data in interp.sponge_log]
    keccak_inputs, sponge_logic = _sponge_coprocessor_ops(sponge_ops)
    logic_ops = [(op, a, b) for _s, (op, a, b) in interp.logic_log] \
        + sponge_logic

    bp_ops = [byte_packing.BytePackingOp(is_read, ctx, seg, virt,
                                         ts_of(s), data)
              for s, is_read, (ctx, seg, virt), data in interp.bp_log]

    extra_ops = _sponge_memory_ops(sponge_ops) + _bp_memory_ops(bp_ops)
    # metadata / trie digests / registers: timestamp-2 writes matched by
    # the verifier's public-values extra looking sum
    for seg, virt, value in interp.metadata_ops:
        extra_ops.append(memory.MemoryOp(True, 2, 0, seg, virt, False,
                                         value))

    mem_ops = memory.MemOpsArrays.concat(
        [derive_memory_ops_arrays(cpu_trace),
         memory._ops_to_arrays(extra_ops)]) if extra_ops \
        else derive_memory_ops_arrays(cpu_trace)
    mem_before_values = interp.mem_before_values
    mem_trace, mem_after_values = memory.generate_trace_arrays(
        mem_ops, mem_before_values=mem_before_values,
        stale_contexts=list(interp.stale_contexts),
        min_rows=mins.get(Table.Memory, 2))
    want = bucket_rows(mem_trace.shape[1])
    if want > mem_trace.shape[1]:
        mem_trace, mem_after_values = memory.generate_trace_arrays(
            mem_ops, mem_before_values=mem_before_values,
            stale_contexts=list(interp.stale_contexts), min_rows=want)

    def _build(generate, ops, t, default_min):
        """Build at the generator's natural size, then rebuild at the
        bucket-ladder size if that is larger — every padding row comes
        from the generator itself, so in-table lookups stay balanced."""
        floor = max(mins.get(t, 2), default_min)
        trace = generate(ops, min_rows=floor)
        want = bucket_rows(trace.shape[1])
        if want > trace.shape[1]:
            trace = generate(ops, min_rows=want)
        return trace

    traces: list = [None] * NUM_TABLES
    traces[Table.Arithmetic] = _build(arithmetic.generate_trace,
                                      arith_ops, Table.Arithmetic,
                                      1 << 16)
    traces[Table.BytePacking] = _build(byte_packing.generate_trace,
                                       bp_ops, Table.BytePacking, 256)
    traces[Table.Cpu] = cpu_trace
    traces[Table.Keccak] = _build(keccak.generate_trace, keccak_inputs,
                                  Table.Keccak, 128)
    traces[Table.KeccakSponge] = _build(keccak_sponge.generate_trace,
                                        sponge_ops, Table.KeccakSponge,
                                        256)
    traces[Table.Logic] = _build(logic.generate_trace, logic_ops,
                                 Table.Logic, 8)
    traces[Table.Memory] = mem_trace
    traces[Table.MemBefore] = _build(memory_continuation.generate_trace,
                                     mem_before_values, Table.MemBefore,
                                     128)
    traces[Table.MemAfter] = _build(memory_continuation.generate_trace,
                                    mem_after_values, Table.MemAfter,
                                    128)

    table_in_use = [True] * NUM_TABLES
    empties = {Table.Keccak: keccak_inputs,
               Table.KeccakSponge: sponge_ops,
               Table.Logic: logic_ops,
               Table.BytePacking: bp_ops,
               Table.MemAfter: mem_after_values}
    for t, ops in empties.items():
        if not ops and t in OPTIONAL_TABLES:
            table_in_use[t] = False
            traces[t] = None

    pv = build_public_values(interp)
    starks = all_starks()
    starks[Table.Cpu] = cpu_stark
    return GeneratedTables(traces=traces, table_in_use=table_in_use,
                           starks=starks, public_values=pv,
                           mem_before_values=mem_before_values,
                           mem_after_values=mem_after_values)


def _table_min_rows():
    """The reference's per-table MINIMUM circuit degrees
    (zero/src/prover_state/circuit.rs:79-90 lower bounds: Arith 2^16,
    BytePacking 2^9, Cpu 2^12, Keccak 2^14, KeccakSponge 2^9, Logic
    2^12, Memory 2^17, MemBefore/MemAfter 2^7). Enabled with
    ZK_TABLE_MIN_DEGREES=1 (the production prove paths set it): every
    block then exercises at most len(BUCKETS) shapes per table. Off by
    default so unit tests keep their tiny shapes. It changes shapes,
    never values."""
    import os
    if os.environ.get("ZK_TABLE_MIN_DEGREES") != "1":
        return None
    return {Table.Arithmetic: 1 << 16, Table.BytePacking: 1 << 9,
            Table.Cpu: 1 << 12, Table.Keccak: 1 << 14,
            Table.KeccakSponge: 1 << 9, Table.Logic: 1 << 12,
            Table.Memory: 1 << 17, Table.MemBefore: 1 << 7,
            Table.MemAfter: 1 << 7}


def build_public_values(interp) -> PublicValues:
    """PublicValues from the generation inputs + final registers
    (generation/mod.rs:536-585)."""
    inputs = interp.inputs
    md = inputs.block_metadata
    fr = interp.final_registers
    stack_top = 0
    if fr.stack_len > 0:
        stack_top = interp.memory.get(fr.context, Segment.Stack,
                                      fr.stack_len - 1)
    rb = interp.segment_registers_before_vals
    return PublicValues(
        trie_roots_before=TrieRoots(
            state_root=trie_root_hash(inputs.tries.state),
            transactions_root=trie_root_hash(inputs.tries.transactions),
            receipts_root=trie_root_hash(inputs.tries.receipts)),
        trie_roots_after=inputs.trie_roots_after,
        block_metadata=md,
        block_hashes=inputs.block_hashes,
        extra_block_data=ExtraBlockData(
            checkpoint_state_trie_root=inputs.checkpoint_state_trie_root,
            checkpoint_consolidated_hash=(
                inputs.checkpoint_consolidated_hash),
            txn_number_before=inputs.txn_number_before,
            txn_number_after=(inputs.txn_number_before
                              + len(inputs.signed_txns)),
            gas_used_before=inputs.gas_used_before,
            gas_used_after=inputs.gas_used_after),
        registers_before=RegistersData(
            program_counter=rb[0], is_kernel=rb[1], stack_len=rb[2],
            stack_top=rb[3], context=rb[4], gas_used=rb[5]),
        registers_after=RegistersData(
            program_counter=fr.program_counter,
            is_kernel=int(fr.is_kernel), stack_len=fr.stack_len,
            stack_top=stack_top, context=fr.context,
            gas_used=fr.gas_used),
        burn_addr=getattr(inputs, "burn_addr", None))
