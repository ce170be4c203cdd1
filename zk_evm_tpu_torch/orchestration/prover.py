"""Segment -> batch proving pipeline over the in-process runtime.

Shape of the reference's `BlockProverInput::prove` (zero/src/prover.rs:97-
333): segments prove independently (zk-continuations, SURVEY.md §2.9 P3),
then aggregate in a binary tree. Until the recursive aggregation circuits
land, the "aggregate" carries the ordered proof list, but the chaining
checks are cryptographic: adjacent segments must agree on their public
values (registers_after == next registers_before, identical block
statement) and on the MemAfter -> MemBefore Merkle cap chain — the same
constraints the reference's segment-aggregation circuit enforces
(fixed_recursive_verifier.rs:2298-2408).

Segments prove on `device` (CUDA when not given). The runtime's pool
threads share the one card: a runtime of more than one worker overlaps
host work only."""

from __future__ import annotations

from dataclasses import dataclass

from ..stark import prove_all
from ..tables.all_stark import all_cross_table_lookups, all_starks
from .block import check_segment_pair
from .runtime import Runtime, Operation, Monoid


@dataclass
class SegmentTask:
    """One zk-continuation segment ready to prove: per-table traces +
    the segment's PublicValues (registers/continuation state bound into
    the transcript)."""
    index: int
    traces: list
    public_values: object
    starks: list | None = None       # default all_starks() if None


@dataclass
class SegmentProofResult:
    index: int
    proof: object                    # AllProof with public_values


@dataclass
class AggSegmentProof:
    first: int
    last: int
    proofs: list                     # ordered AllProofs


class SegmentProofOp(Operation):
    def __init__(self, config, ctls=None, device=None):
        self.config = config
        self.ctls = ctls or all_cross_table_lookups()
        self.device = device

    def execute(self, task: SegmentTask, abort):
        abort.check()
        starks = task.starks or all_starks()
        proof = prove_all(starks, task.traces, self.ctls, self.config,
                          public_values=task.public_values,
                          device=self.device)
        return SegmentProofResult(task.index, proof)


class SegmentAggMonoid(Monoid):
    """Chains adjacent segments cryptographically: public-value register
    chain + MemAfter/MemBefore cap chain (check_segment_pair)."""

    def empty(self):
        return AggSegmentProof(0, -1, [])

    def _lift(self, x):
        if isinstance(x, SegmentProofResult):
            return AggSegmentProof(x.index, x.index, [x.proof])
        return x

    def combine(self, a, b, abort):
        abort.check()
        a, b = self._lift(a), self._lift(b)
        if a.last == -1:
            return b
        if b.last == -1:
            return a
        assert a.last + 1 == b.first, "non-adjacent segments"
        check_segment_pair(a.proofs[-1], b.proofs[0])
        return AggSegmentProof(a.first, b.last, a.proofs + b.proofs)


def prove_segments(config, tasks: list[SegmentTask],
                   runtime: Runtime | None = None,
                   ctls=None, device=None) -> AggSegmentProof:
    rt = runtime or Runtime()
    results = rt.map(SegmentProofOp(config, ctls, device), tasks)
    return rt.fold(SegmentAggMonoid(), results)
