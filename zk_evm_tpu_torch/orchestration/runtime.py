"""In-process task runtime: the reference's paladin layer, reshaped.

The reference distributes proving over AMQP with `Operation`/`Monoid`
remote execution and `Directive::{map, fold}` over indexed streams
(paladin-core; zero/src/ops.rs, SURVEY.md §2.9 P6), and its CI runs the
same code paths on an in-memory runtime. This module is that in-memory
runtime: map fans tasks out to a worker pool, fold combines results in a
binary tree by index order (deterministic regardless of completion
order), and AbortSignal cancels cooperatively between steps. On the card
only one-thread runtimes have run: Runtime(num_workers>1) overlaps host
work only, while device work queues on the one card in turn.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass


class AbortSignal:
    def __init__(self):
        self._flag = threading.Event()

    def abort(self):
        self._flag.set()

    def check(self):
        if self._flag.is_set():
            raise RuntimeError("aborted")


class Operation:
    """A remote-executable unit: override execute(input) -> output."""

    def execute(self, value, abort: AbortSignal):
        raise NotImplementedError


class Monoid:
    """Associative combine with identity; folded as a binary tree."""

    def empty(self):
        raise NotImplementedError

    def combine(self, a, b, abort: AbortSignal):
        raise NotImplementedError


class Runtime:
    def __init__(self, num_workers: int = 1):
        # Device work queues on the one card in turn; >1 worker overlaps
        # host-side stages only (witness gen, proof serialization).
        self.pool = ThreadPoolExecutor(max_workers=num_workers)
        self.abort_signal = AbortSignal()

    def map(self, op: Operation, inputs: list) -> list:
        """Run op on every input, preserving index order."""
        futures = [self.pool.submit(op.execute, x, self.abort_signal)
                   for x in inputs]
        return [f.result() for f in futures]

    def fold(self, monoid: Monoid, items: list):
        """Binary-tree fold in index order (deterministic shape: the same
        tree the reference's proof aggregation builds)."""
        if not items:
            return monoid.empty()
        layer = list(items)
        while len(layer) > 1:
            pairs = [(layer[i], layer[i + 1])
                     for i in range(0, len(layer) - 1, 2)]
            tail = [layer[-1]] if len(layer) % 2 else []
            futures = [self.pool.submit(monoid.combine, a, b,
                                        self.abort_signal)
                       for a, b in pairs]
            layer = [f.result() for f in futures] + tail
        return layer[0]

    def shutdown(self):
        self.pool.shutdown(wait=False)
