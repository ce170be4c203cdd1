"""Witness generation overlapped with proving.

The reference's zero prover streams SegmentDataIterator output into
proving futures (zero/src/prover.rs segment stream + paladin pipelining).
Here witness generation (host python, numpy and the native VM core) runs
in a producer thread while the card proves the previous segment: the
CUDA launches and the native core release the GIL, so the two overlap.
At most one finished witness waits in the queue, which caps in-flight
witness memory (segments hold full table traces). Each segment's host
witness time is recorded beside its prove time under the ambient
TimingTree.
"""

from __future__ import annotations

import queue
import threading
import time

from ..timing import record, timed


def prove_segments_pipelined(segment_iter, prove_fn):
    """Drive `segment_iter` (yielding (segment, tables)) through
    `prove_fn(tables) -> proof` with witness generation running one
    segment ahead of proving. Returns proofs in order. Exceptions from
    either side propagate to the caller."""
    q: queue.Queue = queue.Queue(maxsize=1)
    DONE = object()
    err: list = []

    def produce():
        try:
            while True:
                t0 = time.perf_counter()
                item = next(segment_iter, DONE)
                if item is DONE:
                    break
                q.put((item, time.perf_counter() - t0))
        except BaseException as e:            # noqa: BLE001
            err.append(e)
        finally:
            q.put((DONE, 0.0))

    th = threading.Thread(target=produce, daemon=True)
    th.start()
    proofs = []
    while True:
        item, witness_s = q.get()
        if item is DONE:
            break
        seg, tables = item
        index = getattr(seg, "index", len(proofs))
        record(f"witness segment {index} (host)", witness_s)
        with timed(f"prove segment {index}"):
            proofs.append(prove_fn(tables))
    th.join()
    if err:
        raise err[0]
    return proofs
