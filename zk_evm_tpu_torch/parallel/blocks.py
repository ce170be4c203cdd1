"""Row-block work over a mesh: a CUDA stream a block, one issuing thread.

The stages between a proof's commitments (aux columns, the quotient, the
openings, FRI's combination G and its folds) split over a mesh's row
blocks, as the JAX package's `shard_rows` lets XLA's SPMD partitioner do.
`run_blocks` runs a stage's block function for every block: block s with
its device current and on a stream of its own that first waits for the
caller's stream of that device. Launches return at once, so the caller's
thread issues every card's blocks while the cards run them. Each block's
stream is synchronised before `run_blocks` returns, and every tensor a
block returns is recorded on the caller's stream, so the caching
allocator does not hand its memory out while that stream may still read
it; a block's stream is kept from call to call, so its freed memory
serves the next call. A thread a block, or a thread a card, was
measured slower: Python threads contend for the interpreter lock at
every launch (PERF.md).

`BLOCK_RUNS` counts the blocks each stage ran, by (stage, entries a
block): what a test or the chip check reads to see that a stage really
ran split. It holds one count a distinct block size, so it stays small
in a process that proves for ever.
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter

import torch

from ..field import GF, GFE

BLOCK_RUNS: Counter = Counter()
_RUNS_LOCK = threading.Lock()


def reset_block_runs() -> None:
    with _RUNS_LOCK:
        BLOCK_RUNS.clear()


def block_runs(stage: str) -> dict[int, int]:
    """{entries a block: blocks} that `stage` ran since the last reset."""
    with _RUNS_LOCK:
        return {n: c for (name, n), c in sorted(BLOCK_RUNS.items())
                if name == stage}


_STREAMS: dict = {}
_STREAMS_LOCK = threading.Lock()


def kept_stream(d: torch.device, slot: int):
    """Card `d`'s stream number `slot`, made once and kept: the caching
    allocator hands a stream's freed memory out again only to that
    stream, so a new stream a call would leave every call's temporaries
    to new allocations."""
    with _STREAMS_LOCK:
        if (d, slot) not in _STREAMS:
            _STREAMS[d, slot] = torch.cuda.Stream(device=d)
        return _STREAMS[d, slot]


@contextlib.contextmanager
def side_stream(d: torch.device, prover_stream, slot: int):
    """Run the body with `d`'s card current, on its kept stream `slot`
    after that stream waits for `prover_stream`, and synchronise it at
    the end; on a CPU device, run the body as it is. The caller records
    what the body made on `prover_stream` before freeing it there."""
    if d.type != "cuda":
        yield
        return
    with torch.cuda.device(d):
        side = kept_stream(d, slot)
        side.wait_stream(prover_stream)
        with torch.cuda.stream(side):
            yield
        side.synchronize()


def indexed(d) -> torch.device:
    """`d` with its card's index: a `cuda` device with none is the
    caller's current card (a pool thread's current card is card 0)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def tensors_of(obj) -> list[torch.Tensor]:
    """Every tensor in a nest of GF, GFE, tensors, lists, tuples and
    dicts."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, GF):
        return [obj.v]
    if isinstance(obj, GFE):
        return [obj.a.v, obj.b.v]
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return [t for x in obj for t in tensors_of(x)]
    return []


def run_blocks(stage: str, devices, fn, entries: int) -> list:
    """[fn(s) for s in range(len(devices))], block s on `devices[s]` and
    on a stream of its own, all issued from the caller's thread (see the
    module's notes); each block is counted in `BLOCK_RUNS` under (stage,
    entries)."""
    devs = [indexed(d) for d in devices]
    out = [None] * len(devs)
    prover = {d: torch.cuda.current_stream(d)
              for d in dict.fromkeys(devs) if d.type == "cuda"}
    streams = [kept_stream(d, s) if d.type == "cuda" else None
               for s, d in enumerate(devs)]
    for d, st in zip(devs, streams):
        if st is not None:
            st.wait_stream(prover[d])
    for s, (d, st) in enumerate(zip(devs, streams)):
        if st is None:
            out[s] = fn(s)
            continue
        with torch.cuda.device(d), torch.cuda.stream(st):
            out[s] = fn(s)
    for s, (d, st) in enumerate(zip(devs, streams)):
        if st is not None:
            st.synchronize()
            for t in tensors_of(out[s]):
                if t.device == d:
                    t.record_stream(prover[d])
    with _RUNS_LOCK:
        BLOCK_RUNS[stage, entries] += len(devs)
    return out
