"""Metrics + structured logging.

The reference's zero binaries ship env_logger tracing and per-phase
metrics hooks (zero/src/prover.rs logging, ops.rs timing; the leader and
worker binaries configure RUST_LOG-style filtering). The port's twin: one
process-wide registry of counters / gauges / timers that the prover,
orchestration runtime and queue worker update, dumpable as a single JSON
object (for scraping or end-of-run reports), plus `setup_logging()`
driven by ZK_LOG (error|warn|info|debug) the way RUST_LOG drives the
reference binaries.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import defaultdict


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = defaultdict(float)
        self._gauges: dict[str, float] = {}
        self._timers: dict[str, list] = defaultdict(
            lambda: [0, 0.0, 0.0])      # count, total_s, max_s

    def inc(self, name: str, amount: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += amount

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            t = self._timers[name]
            t[0] += 1
            t[1] += seconds
            t[2] = max(t[2], seconds)

    def time(self, name: str):
        """Context manager recording a duration."""
        return _Timer(self, name)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "timers": {k: {"count": v[0],
                               "total_s": round(v[1], 6),
                               "mean_s": round(v[1] / v[0], 6) if v[0]
                               else 0.0,
                               "max_s": round(v[2], 6)}
                           for k, v in self._timers.items()},
            }

    def dump(self, path: str | None = None) -> str:
        s = json.dumps(self.snapshot(), sort_keys=True)
        if path:
            with open(path, "w") as f:
                f.write(s + "\n")
        return s

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._timers.clear()


class _Timer:
    __slots__ = ("reg", "name", "t0")

    def __init__(self, reg: Registry, name: str):
        self.reg = reg
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.reg.observe(self.name, time.perf_counter() - self.t0)
        return False


REGISTRY = Registry()

inc = REGISTRY.inc
gauge = REGISTRY.gauge
observe = REGISTRY.observe
timeit = REGISTRY.time
snapshot = REGISTRY.snapshot
dump = REGISTRY.dump


def setup_logging(level: str | None = None) -> logging.Logger:
    """ZK_LOG=debug|info|warn|error (default warn), RUST_LOG-style."""
    level = (level or os.environ.get("ZK_LOG", "warning")).lower()
    mapping = {"error": logging.ERROR, "warn": logging.WARNING,
               "warning": logging.WARNING, "info": logging.INFO,
               "debug": logging.DEBUG}
    logging.basicConfig(
        level=mapping.get(level, logging.WARNING),
        format="%(asctime)s %(levelname).1s %(name)s %(message)s")
    return logging.getLogger("zk_evm_tpu_torch")
