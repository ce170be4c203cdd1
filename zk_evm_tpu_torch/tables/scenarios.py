"""Self-consistent mini-scenarios over the real tables — used by the
AllStark integration tests.

The sponge scenario wires one keccak256 absorb through the full CTL
graph: KeccakSponge <-> Keccak (inputs + outputs), -> Logic (the xor
limbs), -> Memory (byte reads) with MemBefore/MemAfter continuation
rows; the CPU table's dispatch side is contributed by the verifier via
extra looking sums (the same mechanism as zk_evm's memory extra
looking values, verifier.rs:319-512). The cdk_erigon scenario drives the
Poseidon coprocessor from real cdk CPU rows through all ten tables."""

from __future__ import annotations

import numpy as np

from ..challenger import Challenger
from ..stark import lookup as lk
from ..stark.multi import observe_global, _zero_cap
from . import all_stark as ast
from . import keccak, keccak_sponge as ks, logic, memory as mem, \
    memory_continuation as mc
from .segments import Segment

INPUT = b"hello"
TS = 2
CTX, SEG, VIRT = 0, Segment.MainMemory, 64


def build_sponge_scenario():
    """Consistent traces for one sponge op over INPUT. Returns
    (traces, sponge_trace)."""
    sponge_op = ks.KeccakSpongeOp(CTX, SEG, VIRT, TS, INPUT)
    sponge_trace = ks.generate_trace([sponge_op])

    block = bytearray(INPUT)
    block.append(0x01)
    block.extend(b"\x00" * (ks.RATE_BYTES - len(block)))
    block[-1] |= 0x80
    xored_u32s = [int.from_bytes(block[4 * i:4 * i + 4], "little")
                  for i in range(ks.RATE_U32S)] + [0] * ks.CAPACITY_U32S
    lanes = [xored_u32s[2 * i] | (xored_u32s[2 * i + 1] << 32)
             for i in range(25)]
    keccak_trace = keccak.generate_trace([(lanes, TS)])

    logic_ops = []
    for i in range(ks.NUM_LOGIC_CTLS):
        chunk = block[32 * i:32 * i + 32]
        y = int.from_bytes(bytes(chunk), "little")
        logic_ops.append(("xor", 0, y))
    logic_trace = logic.generate_trace(logic_ops)

    mem_before_values = [((CTX, SEG, VIRT + i), INPUT[i])
                         for i in range(len(INPUT))]
    mem_ops = [mem.MemoryOp(True, TS, CTX, SEG, VIRT + i, True, INPUT[i])
               for i in range(len(INPUT))]
    mem_trace, mem_after_values = mem.generate_trace(
        mem_ops, mem_before_values=mem_before_values)

    mem_before_trace = mc.generate_trace(mem_before_values)
    mem_after_trace = mc.generate_trace(mem_after_values)

    traces = [None] * ast.NUM_TABLES
    traces[ast.Table.Keccak] = keccak_trace
    traces[ast.Table.KeccakSponge] = sponge_trace
    traces[ast.Table.Logic] = logic_trace
    traces[ast.Table.Memory] = mem_trace
    traces[ast.Table.MemBefore] = mem_before_trace
    traces[ast.Table.MemAfter] = mem_after_trace
    return traces, sponge_trace


def cpu_side_extra_sums(proof, ctls, cfg, sponge_trace):
    """The CPU table's contribution to ctl_keccak_sponge, recomputed by
    the verifier from the claimed digest."""
    challenger = Challenger()
    caps = [p.trace_cap if p is not None else _zero_cap(cfg)
            for p in proof.proofs]
    observe_global(challenger, caps, proof.public_inputs)
    chs = lk.get_challenge_set(challenger, cfg.num_challenges)
    sponge_idx = [i for i, c in enumerate(ctls)
                  if c.name == "keccak_sponge"][0]
    extra = []
    for beta, gamma in chs.pairs:
        extra.append(lk.ctl_view_sum_np(sponge_trace,
                                        ctls[sponge_idx].looked,
                                        beta, gamma))
    return {sponge_idx: extra}


def build_cdk_poseidon_scenario(general_blocks: int = 1):
    """cdk_erigon: CPU rows executing POSEIDON (0x22) and
    POSEIDON_GENERAL (0x23), the Poseidon coprocessor table, and a
    Memory table carrying both the coprocessor's byte-reads (56 a block)
    and the CPU's code/stack traffic. Every CTL — including the three
    Poseidon dispatch CTLs (all_stark.rs:166-170) — balances from real
    table rows, with no extra-looking stand-ins.

    The POSEIDON_GENERAL op hashes `general_blocks` 56-byte blocks, one
    Poseidon row each: the default 1 is the JAX package's scenario, 7
    fills an 8-row Poseidon table, the fewest a height-4 cap at rate
    2^-1 (the standard config) can commit.

    Returns (traces, cpu_stark) where cpu_stark is the cdk-flavored
    CpuStark matching the built rows."""
    from ..stark.debug import _view_multiset
    from . import cpu as cput
    from . import poseidon as ps

    # --- poseidon coprocessor ops -------------------------------------
    x, y, z = 11, 222, 3333                  # u256 stack operands
    simple_inp = []
    for v in (x, y, z):                      # ch value limb pairs -> u64s
        for i in range(4):
            simple_inp.append((v >> (64 * i)) & 0xFFFFFFFFFFFFFFFF)
    simple_op = ps.PoseidonSimpleOp(input=tuple(simple_inp))

    g_ctx, g_seg, g_virt = 0, int(Segment.KernelGeneral), 128
    data = bytes((7 * i + 3) % 256
                 for i in range(ps.BLOCK_BYTES * general_blocks))
    g_clock = 3                              # CPU row index 2 (clock 3)
    g_ts = g_clock * ast.NUM_CHANNELS        # clock * NUM_CHANNELS
    general_op = ps.PoseidonGeneralOp(context=g_ctx, segment=g_seg,
                                      virt=g_virt, timestamp=g_ts,
                                      input=data, len=len(data))
    pos_trace = ps.generate_trace([simple_op, general_op])

    def _digest_u256(row):
        v = 0
        for j in range(8):
            v |= int(pos_trace[ps.DIGEST_COLS[j], row]) << (32 * j)
        return v

    simple_rows = np.nonzero(pos_trace[ps.IS_SIMPLE_OP])[0]
    final_general = [int(r) for r in
                     np.nonzero(pos_trace[ps.NOT_PADDING])[0]
                     if not pos_trace[ps.IS_SIMPLE_OP, r]]
    digest_s = _digest_u256(int(simple_rows[0]))
    digest_g = _digest_u256(final_general[-1])

    # --- cdk CPU rows -------------------------------------------------
    addr_word = g_virt | (g_seg << 32) | (g_ctx << 64)
    length = len(data)
    stack0 = [length, addr_word, z, y, x]
    ops = [
        (0x22, True, "poseidon", 0, list(stack0)),
        (0x50, True, None, 1, [length, addr_word, digest_s]),
        (0x23, True, "poseidon", 2, [length, addr_word]),
        (0x50, True, None, 3, [digest_g]),
    ]
    # halt padding parks on pc=4, one past the last executed op (the
    # native-instruction transition constraint requires pc+1 continuity
    # into the first padding row)
    cpu_trace = cput.build_cpu_rows(ops, final_stack_len=0, halt_pc=4,
                                    flavor="cdk_erigon")
    cpu_stark = cput.CpuStark(halt_pc=4, flavor="cdk_erigon")

    # --- memory: CPU bus traffic derived from the CTL views ----------
    ctls = ast.all_cross_table_lookups("cdk_erigon")
    mem_ctl = ctls[ast.MEMORY_CTL_IDX]
    mem_ops = []
    seen_addrs = {}
    for view in mem_ctl.looking:
        if view.table != ast.Table.Cpu:
            continue
        for tup, cnt in _view_multiset(cpu_trace, view).items():
            is_read, ctx, seg, virt = tup[0], tup[1], tup[2], tup[3]
            ts = tup[12]
            value = 0
            for j in range(8):
                value |= int(tup[4 + j]) << (32 * j)
            for _ in range(cnt):
                mem_ops.append(mem.MemoryOp(True, ts, ctx, seg, virt,
                                            bool(is_read), value))
            if is_read:
                seen_addrs.setdefault((ctx, seg, virt), value)
    # coprocessor byte reads
    for i in range(len(data)):
        mem_ops.append(mem.MemoryOp(True, g_ts, g_ctx, g_seg,
                                    g_virt + i, True, data[i]))
        seen_addrs.setdefault((g_ctx, g_seg, g_virt + i), data[i])

    # every first-read address is seeded by MemBefore (zk-continuation
    # style: the segment's live memory arrives via the continuation CTL)
    mem_before_values = sorted(seen_addrs.items())
    mem_trace, mem_after_values = mem.generate_trace(
        mem_ops, mem_before_values=mem_before_values)

    traces = [None] * ast.CDK_NUM_TABLES
    traces[ast.Table.Cpu] = cpu_trace
    traces[ast.Table.Poseidon] = pos_trace
    traces[ast.Table.Memory] = mem_trace
    traces[ast.Table.MemBefore] = mc.generate_trace(mem_before_values)
    traces[ast.Table.MemAfter] = mc.generate_trace(mem_after_values)
    return traces, cpu_stark
