"""Self-consistent mini-scenarios over the real tables — used by the
AllStark integration tests.

The sponge scenario wires one keccak256 absorb through the full CTL
graph: KeccakSponge <-> Keccak (inputs + outputs), -> Logic (the xor
limbs), -> Memory (byte reads) with MemBefore/MemAfter continuation
rows; the CPU table's dispatch side is contributed by the verifier via
extra looking sums (the same mechanism as zk_evm's memory extra
looking values, verifier.rs:319-512). The cdk_erigon scenario with the
Poseidon coprocessor waits for the cdk flavor."""

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
