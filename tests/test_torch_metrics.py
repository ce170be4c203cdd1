"""The port's metrics registry (`metrics.py`) and `timing.timed` feeding
it, against the JAX package's: the same calls give the same snapshot
(timers compared by count; their seconds are the host clock's), and the
port's worker counts completed and failed jobs as the JAX worker does.
"""

import json
import logging
import time

from zk_evm_tpu import metrics as jmetrics
from zk_evm_tpu import timing as jtiming
from zk_evm_tpu_torch import metrics
from zk_evm_tpu_torch import timing


def counts(snap: dict) -> dict:
    """A snapshot with each timer's seconds left out."""
    return {**snap, "timers": {k: v["count"]
                               for k, v in snap["timers"].items()}}


def test_counters_gauges_timers(tmp_path):
    def run(m, path):
        m.REGISTRY.reset()
        m.inc("x")
        m.inc("x", 2)
        m.gauge("g", 7.5)
        with m.timeit("op"):
            time.sleep(0.01)
        snap = m.snapshot()
        assert snap["timers"]["op"]["total_s"] >= 0.01
        assert snap["timers"]["op"]["max_s"] == snap["timers"]["op"]["total_s"]
        m.dump(str(path))
        return counts(snap), counts(json.loads(path.read_text()))

    got = run(metrics, tmp_path / "port.json")
    assert got == run(jmetrics, tmp_path / "jax.json")
    assert got[0] == got[1] == {"counters": {"x": 3.0},
                                "gauges": {"g": 7.5},
                                "timers": {"op": 1}}


def test_timed_feeds_metrics_without_tree():
    for m, t in ((metrics, timing), (jmetrics, jtiming)):
        m.REGISTRY.reset()
        with t.timed("loose phase"):
            pass
        with t.timed("loose phase"):
            pass
    assert counts(metrics.snapshot()) == counts(jmetrics.snapshot()) == {
        "counters": {}, "gauges": {}, "timers": {"phase.loose phase": 2}}


def test_timed_feeds_metrics_with_tree():
    trees = []
    for m, t in ((metrics, timing), (jmetrics, jtiming)):
        m.REGISTRY.reset()
        with t.TimingTree() as tree:
            with t.timed("inner"):
                time.sleep(0.002)
        trees.append([c.name for c in tree.root.children])
    assert counts(metrics.snapshot()) == counts(jmetrics.snapshot())
    assert metrics.snapshot()["timers"]["phase.inner"]["count"] == 1
    assert metrics.snapshot()["timers"]["phase.inner"]["total_s"] >= 0.002
    assert trees == [["inner"], ["inner"]]


def test_worker_metrics(tmp_path):
    from zk_evm_tpu.orchestration.queue import (FsQueue as JFsQueue,
                                                run_worker as jrun_worker)
    from zk_evm_tpu_torch.orchestration.queue import FsQueue, run_worker
    for m, fs_queue, run, handler in (
            (metrics, FsQueue, run_worker,
             {"echo": lambda j, device: j["v"]}),
            (jmetrics, JFsQueue, jrun_worker, {"echo": lambda j: j["v"]})):
        m.REGISTRY.reset()
        path = tmp_path / m.__name__
        q = fs_queue(str(path))
        q.submit({"kind": "echo", "v": 1})
        q.submit({"kind": "nope"})
        kw = {"device": "cpu"} if m is metrics else {}
        assert run(str(path), handlers=handler, max_jobs=2, **kw) == 2
    snap = counts(metrics.snapshot())
    assert snap == counts(jmetrics.snapshot())
    assert snap["counters"] == {"worker.jobs_completed": 1.0,
                                "worker.jobs_failed": 1.0}
    assert snap["gauges"] == {"worker.jobs_seen": 2}
    assert snap["timers"] == {"job.echo": 1}


def test_setup_logging_reads_zk_log(monkeypatch):
    """ZK_LOG picks the level when none is given; the port logs under
    its own name, the logger its phase timers write to."""
    root = logging.getLogger()
    level, handlers = root.level, root.handlers[:]
    try:
        for value, want in (("debug", logging.DEBUG), ("error",
                                                       logging.ERROR)):
            root.handlers.clear()
            monkeypatch.setenv("ZK_LOG", value)
            log = metrics.setup_logging()
            assert log.name == "zk_evm_tpu_torch"
            assert root.level == want
        root.handlers.clear()
        assert jmetrics.setup_logging("info").name == "zk_evm_tpu"
        assert root.level == logging.INFO
    finally:
        root.handlers[:] = handlers
        root.setLevel(level)
