"""Segment proving, block aggregation, the witness/prove pipeline and the
leader/worker service layer (filesystem job queue, HTTP leader)."""
from .runtime import Runtime, Operation, Monoid, AbortSignal
from .prover import SegmentTask, prove_segments
from .queue import FsQueue, run_worker

__all__ = ["Runtime", "Operation", "Monoid", "AbortSignal",
           "SegmentTask", "prove_segments", "FsQueue", "run_worker"]
