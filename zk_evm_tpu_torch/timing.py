"""Hierarchical phase timers — the reference's plonky2 TimingTree (every
prove phase is wrapped in `timed!(timing, "...")` and the tree is printed
per proof).

Usage:
    tree = TimingTree()
    with tree.scope("prove cpu"):
        with tree.scope("commit trace"):
            ...
    tree.print()          # indented tree with durations

`timed(name)` is the ambient form: modules time their phases without
threading a tree through every call; scopes are no-ops unless a tree is
active (activated by `TimingTree.activate()` or used as a context
manager)."""

from __future__ import annotations

import contextlib
import contextvars
import logging
import sys
import time
from dataclasses import dataclass, field

import torch

from . import metrics


@dataclass
class _Node:
    name: str
    start: float
    elapsed: float = 0.0
    children: list = field(default_factory=list)


class TimingTree:
    def __init__(self, name: str = "root"):
        self.root = _Node(name, time.perf_counter())
        self._stack = [self.root]
        self._token = None

    @contextlib.contextmanager
    def scope(self, name: str):
        node = _Node(name, time.perf_counter())
        self._stack[-1].children.append(node)
        self._stack.append(node)
        try:
            yield node
        finally:
            node.elapsed = time.perf_counter() - node.start
            self._stack.pop()

    # -- ambient activation ------------------------------------------------
    def __enter__(self):
        self._token = _ACTIVE.set(self)
        return self

    def __exit__(self, *exc):
        self.root.elapsed = time.perf_counter() - self.root.start
        _ACTIVE.reset(self._token)
        return False

    def print(self, out=None, min_fraction: float = 0.0):
        out = out or sys.stderr
        if not self.root.elapsed:
            self.root.elapsed = time.perf_counter() - self.root.start
        total = self.root.elapsed

        def walk(node, depth):
            if node.elapsed < min_fraction * total:
                return
            print(f"{'  ' * depth}{node.elapsed:8.3f}s  {node.name}",
                  file=out)
            for c in node.children:
                walk(c, depth + 1)

        walk(self.root, 0)


_ACTIVE: contextvars.ContextVar[TimingTree | None] = \
    contextvars.ContextVar("zk_evm_tpu_torch_timing", default=None)


def record(name: str, seconds: float) -> None:
    """Add a phase measured elsewhere (another thread's work) under the
    ambient TimingTree's open scope, if a tree is active."""
    tree = _ACTIVE.get()
    if tree is not None:
        tree._stack[-1].children.append(
            _Node(name, time.perf_counter() - seconds, seconds))
    logging.getLogger("zk_evm_tpu_torch").info("phase %-40s %8.2fs", name,
                                               seconds)


@contextlib.contextmanager
def timed(name: str):
    """Time a phase under the ambient TimingTree, if one is active, and
    feed the process-wide metrics registry (`metrics.py`, as
    `phase.<name>`) either way. Phases also log at info level as they
    close, so long proving runs are observable while in flight. Host
    clock; a phase waits for the CUDA work it queued, so its time
    includes its device work."""
    log = logging.getLogger("zk_evm_tpu_torch")
    tree = _ACTIVE.get()
    t0 = time.perf_counter()
    scope = tree.scope(name) if tree is not None \
        else contextlib.nullcontext()
    try:
        with scope as node:
            try:
                yield node
            finally:
                # inside the scope, so the node's time includes the
                # device work the phase queued
                if torch.cuda.is_initialized():
                    torch.cuda.synchronize()
    finally:
        dt = time.perf_counter() - t0
        metrics.observe(f"phase.{name}", dt)
        log.info("phase %-40s %8.2fs", name, dt)
