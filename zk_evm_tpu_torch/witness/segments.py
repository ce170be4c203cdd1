"""Proof segmentation (zk-continuations).

Twin of the reference's generation/segments.rs: a non-tracing pre-run
walks the whole execution in cycle-bounded chunks, capturing at every
boundary the registers, the live memory, and the oracle state
(SegmentDataIterator / GenerationSegmentData, segments.rs:21-231); each
segment is then re-executed with tracing to produce its own 9-table
witness whose MemBefore is the previous segment's MemAfter and whose
registers_before/after chain across proofs.

Every segment run enters at `init` (the prologue restores + checks the
claimed registers, main.asm:1-62) and leaves through the exc_stop
epilogue (exception.asm:176+), which asserts the claimed final
registers. The cycle budget for the segment body leaves room for the
epilogue: cycle_limit = 2^max_cpu_len_log - NUM_EXTRA_CYCLES_AFTER
(generation/mod.rs:49-52). In the frozen kernel (assembled with
optimal %stack expansion) the exc_stop epilogue measures a constant 81 cycles on every
segment of every fixture (the reference's is 82); the budget matches
the reference constant and the final clock is asserted to fit.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from .interpreter import (MAX_CYCLES, Interpreter, Registers,
                          initial_registers)

# Upper bound on exc_stop epilogue cycles in the frozen kernel: measured
# 81 on every segment; the reference's
# constant is 82 (generation/mod.rs:48-49) — use the same value, leaving
# one cycle of margin over the measurement.
NUM_EXTRA_CYCLES_AFTER = 82


@dataclass
class SegmentData:
    """Everything needed to (re-)generate one segment's witness
    (the reference's GenerationSegmentData, segments.rs:21-47)."""
    index: int
    registers_before: Registers
    registers_after: Registers | None
    memory: object                      # MemoryState snapshot at start
    mem_before_values: list             # MemBefore table content
    extra: dict                         # oracle state (capture_extra)
    max_cpu_len_log: int | None = None


class SegmentDataIterator:
    """Yields SegmentData for each cycle-bounded chunk of the execution
    (segments.rs:94-231). A single non-tracing interpreter advances
    through the payload; each yielded item is an independent snapshot a
    tracing run can start from."""

    def __init__(self, kernel, inputs, max_cpu_len_log: int | None = None,
                 max_cycles: int = MAX_CYCLES):
        from ..tables.memory_continuation import \
            kernel_initial_memory_values
        self.kernel = kernel
        self.max_cpu_len_log = max_cpu_len_log
        self.interp = Interpreter(kernel, kernel.global_labels["init"],
                                  max_cycles=max_cycles)
        self.interp.record_trace = False
        self.interp.initialize_from_inputs(inputs)
        self._next = SegmentData(
            index=0,
            registers_before=initial_registers(kernel),
            registers_after=None,
            memory=self.interp.memory.deep_copy(),
            mem_before_values=kernel_initial_memory_values(kernel.code),
            extra=self.interp.capture_extra(),
            max_cpu_len_log=max_cpu_len_log)

    def _cycle_limit(self):
        if self.max_cpu_len_log is None:
            return None
        budget = (1 << self.max_cpu_len_log) - NUM_EXTRA_CYCLES_AFTER
        assert budget > 0, "max_cpu_len_log too small for the epilogue"
        return budget

    def __iter__(self):
        return self

    def __next__(self) -> SegmentData:
        cur = self._next
        if cur is None:
            raise StopIteration
        halt_pc = self.kernel.global_labels["halt"]
        if cur.registers_before.program_counter == halt_pc:
            self._next = None
            raise StopIteration

        interp = self.interp
        interp.stale_contexts = []
        # record jumpdest tables generated during this chunk so the
        # tracing re-run replays them instead of re-simulating
        interp.jumpdest_regen_log = []
        interp.run_segment(cur.registers_before,
                           cycle_limit=self._cycle_limit())
        cur.extra["jumpdest_regen_log"] = interp.jumpdest_regen_log
        interp.jumpdest_regen_log = None
        regs_after = interp.final_registers
        assert regs_after is not None, "segment did not reach exc_stop"
        cur.registers_after = replace(regs_after)

        # Drop pruned contexts from the live memory too: the kernel
        # guarantees they are never read again, and later snapshots must
        # not resurrect them (get_active_memory, interpreter.rs:621-645).
        for ctx in set(interp.stale_contexts):
            interp.memory.delete_context(ctx)
        # NOTE: the execution snapshot is a superset of the bus-level
        # memory (our interpreter spills the stack top eagerly; the CPU
        # table keeps it in a column). The TABLE MemBefore of the next
        # segment is therefore chained from the previous segment's
        # table-generated mem_after (generate_segment_tables), not from
        # this snapshot.
        self._next = SegmentData(
            index=cur.index + 1,
            registers_before=replace(regs_after),
            registers_after=None,
            memory=interp.memory.deep_copy(),
            mem_before_values=None,
            extra=interp.capture_extra(),
            max_cpu_len_log=self.max_cpu_len_log)
        return cur


def run_segment_generation(kernel, inputs, segment: SegmentData,
                           max_cycles: int = MAX_CYCLES) -> Interpreter:
    """Tracing re-run of one segment: returns a finished interpreter
    ready for witness/traces.generate_all_tables (the per-segment
    generate_traces path, generation/mod.rs:496-560). A failing run
    writes a debug bundle and names it in a note on the exception."""
    interp = Interpreter(kernel, kernel.global_labels["init"],
                         max_cycles=max_cycles)
    interp.initialize_from_inputs(inputs, segment=segment)
    regen = segment.extra.get("jumpdest_regen_log")
    if regen:
        from collections import deque
        interp.jumpdest_regen_replay = deque(regen)
    limit = None
    if segment.max_cpu_len_log is not None:
        limit = (1 << segment.max_cpu_len_log) - NUM_EXTRA_CYCLES_AFTER
    try:
        interp.run_segment(segment.registers_before, cycle_limit=limit)
    except Exception as err:
        from .debug import dump_error_artifacts
        err.add_note(f"segment {segment.index} debug artifacts: "
                     + dump_error_artifacts(interp, err))
        raise
    fr = interp.final_registers
    assert fr is not None, "segment did not reach exc_stop"
    if segment.registers_after is not None:
        assert (fr.program_counter, fr.is_kernel, fr.stack_len,
                fr.context, fr.gas_used) == \
            (segment.registers_after.program_counter,
             segment.registers_after.is_kernel,
             segment.registers_after.stack_len,
             segment.registers_after.context,
             segment.registers_after.gas_used), \
            "traced segment diverged from the pre-run"
    if segment.max_cpu_len_log is not None:
        assert interp.clock <= (1 << segment.max_cpu_len_log), \
            "segment (incl. epilogue) exceeded 2^max_cpu_len_log cycles" \
            " — an exc_stop expansion costlier than the measured 81" \
            " cycles overran NUM_EXTRA_CYCLES_AFTER=82 (segments.py:33;" \
            " raise it if a new kernel path legitimately needs more)"
    return interp


def generate_segment_tables(kernel, inputs, max_cpu_len_log=None,
                            max_cycles: int = MAX_CYCLES):
    """Full zk-continuations witness pipeline: yields one GeneratedTables
    per segment, with each segment's table MemBefore chained from the
    previous segment's table-generated mem_after (so MemAfter(k) ==
    MemBefore(k+1) exactly, the cap-chaining contract of
    verifier.rs:514-547)."""
    from .traces import generate_all_tables
    prev_mem_after = None
    for seg in SegmentDataIterator(kernel, inputs, max_cpu_len_log,
                                   max_cycles):
        if seg.index > 0:
            seg.mem_before_values = prev_mem_after
        interp = run_segment_generation(kernel, inputs, seg, max_cycles)
        gt = generate_all_tables(interp)
        prev_mem_after = gt.mem_after_values
        yield seg, gt
