"""Filesystem job queue + worker loop: the multi-host distribution layer.

The reference's leader/worker split rides AMQP (paladin; zero/src/bin/
worker.rs:1-39, leader dispatches Operations as queue messages). Here
the shared medium is the filesystem (a directory every host mounts), so
this module implements the same contract with atomic-rename claims
instead of broker acks:

  leader:  job_id = q.submit({"kind": ..., ...}); q.wait(job_id)
  worker:  run_worker(dir, handlers) claims jobs, executes, writes
           results; crash-safe (an unacked claim can be requeued).

Handlers are looked up by the job's "kind" — proving handlers live in
`WORKER_HANDLERS` below; tests register cheap kinds. A handler is called
as `handler(job, device)`: a worker is one process per card, and its
device is fixed for the process (SURVEY §2.9 P6). The on-disk format is
the JAX package's, file for file, so either package's leader and workers
can share one queue directory.
"""

from __future__ import annotations

import functools
import json
import os
import socket
import time
import uuid

_JOB = ".job.json"
_RESULT = ".result.json"
_ERROR = ".error.json"


class FsQueue:
    """Directory-backed job queue. Submission and claiming are atomic
    renames, so any number of leaders and workers can share the dir."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)

    # -- leader side ----------------------------------------------------
    def submit(self, job: dict, klass: str = "default") -> str:
        """Submit with a routing class (the reference's light-proof /
        heavy-proof routing keys for worker affinity,
        zero/src/bin/leader.rs:28-70). The class is encoded in the job
        filename so workers filter without reading payloads."""
        assert "." not in klass, klass
        job_id = uuid.uuid4().hex[:16]
        tmp = os.path.join(self.path, f".tmp.{job_id}")
        with open(tmp, "w") as f:
            json.dump(job, f)
        os.rename(tmp, os.path.join(self.path,
                                    f"{job_id}.{klass}{_JOB}"))
        return job_id

    def wait(self, job_id: str, timeout: float = 600.0,
             poll_s: float = 0.05) -> dict:
        """Block until the job's result (or error) file appears."""
        res = os.path.join(self.path, job_id + _RESULT)
        err = os.path.join(self.path, job_id + _ERROR)
        deadline = time.time() + timeout
        while time.time() < deadline:
            if os.path.exists(res):
                with open(res) as f:
                    return json.load(f)
            if os.path.exists(err):
                with open(err) as f:
                    raise RuntimeError(json.load(f)["error"])
            time.sleep(poll_s)
        raise TimeoutError(f"job {job_id} not completed in {timeout}s")

    def map(self, jobs: list[dict], timeout: float = 600.0) -> list[dict]:
        """Submit all, wait for all (order-preserving); the leader-side
        counterpart of Runtime.map over remote workers."""
        ids = [self.submit(j) for j in jobs]
        return [self.wait(i, timeout=timeout) for i in ids]

    # -- worker side ----------------------------------------------------
    def claim(self, worker: str,
              classes: tuple[str, ...] | None = None
              ) -> tuple[str, dict] | None:
        """Claim the oldest pending job via atomic rename; None if the
        queue is empty. `classes` restricts claims to those routing
        classes (worker affinity, leader.rs:28-70's two-runtime split);
        None claims anything."""
        def _mtime(f):
            # a concurrent worker may claim (rename away) the file between
            # listdir and stat; sort the ghost last instead of dying (the
            # broker-atomic claim is the rename below, not this ordering)
            try:
                return os.path.getmtime(os.path.join(self.path, f))
            except OSError:
                return float("inf")

        pending = sorted(
            (f for f in os.listdir(self.path) if f.endswith(_JOB)),
            key=_mtime)
        for fname in pending:
            tagged = fname[:-len(_JOB)]        # "{job_id}.{klass}"
            job_id, _, fklass = tagged.partition(".")
            if classes is not None and fklass not in classes:
                continue                  # not this worker's affinity
            src = os.path.join(self.path, fname)
            dst = os.path.join(self.path, f"{tagged}.claimed.{worker}")
            try:
                os.rename(src, dst)
            except OSError:
                continue                  # raced with another worker
            with open(dst) as f:
                return job_id, json.load(f)
        return None

    def complete(self, job_id: str, result: dict) -> None:
        tmp = os.path.join(self.path, f".tmp.r.{job_id}")
        with open(tmp, "w") as f:
            json.dump(result, f)
        os.rename(tmp, os.path.join(self.path, job_id + _RESULT))

    def fail(self, job_id: str, error: str) -> None:
        tmp = os.path.join(self.path, f".tmp.e.{job_id}")
        with open(tmp, "w") as f:
            json.dump({"error": error}, f)
        os.rename(tmp, os.path.join(self.path, job_id + _ERROR))

    def requeue_stale(self, max_age_s: float) -> int:
        """Requeue claims older than max_age_s whose worker presumably
        died (the broker-redelivery analog). Returns count requeued."""
        n = 0
        now = time.time()
        for fname in os.listdir(self.path):
            if ".claimed." not in fname:
                continue
            p = os.path.join(self.path, fname)
            tagged = fname.split(".claimed.")[0]   # "{job_id}.{klass}"
            job_id = tagged.partition(".")[0]
            if os.path.exists(os.path.join(self.path, job_id + _RESULT)):
                continue
            try:
                stale = now - os.path.getmtime(p) > max_age_s
            except OSError:
                continue                  # completed/requeued concurrently
            if stale:
                try:
                    os.rename(p, os.path.join(self.path, tagged + _JOB))
                    n += 1
                except OSError:
                    pass
        return n


# -- proving handlers ----------------------------------------------------

def confined(path: str, root: str, what: str) -> str:
    """`path` resolved (relative to the worker's working directory, with
    `..` and symlinks followed), which must lie inside the directory
    `root`; a path outside it raises ValueError."""
    real = os.path.realpath(path)
    base = os.path.realpath(root)
    if os.path.commonpath([real, base]) != base:
        raise ValueError(f"{what} path {path!r} lies outside the "
                         f"configured {what} directory {root!r} "
                         f"(ZK_{what.upper()}_DIR)")
    return real


def _handle_prove_block(job: dict, device, config=None) -> dict:
    """Prove one block batch: the worker-side body of BlockProverInput::
    prove (zero/src/prover.rs:49-134) — witness generation through the
    kernel, 9-table proof on the worker's device, self-verify, persist.
    The job references a shared-path witness artifact (or a built-in
    fixture) and the output proof path. A client names those files, so
    both must lie inside the runtime config's `witness_dir` and
    `output_dir` (`config`, or `runtime_config.load()` when not given):
    a job naming another path fails before anything is read or proved."""
    from ..runtime_config import load
    config = config or load()
    output = confined(job["output"], config.output_dir, "output")
    witness = None if "fixture" in job else confined(
        job["witness"], config.witness_dir, "witness")
    from ..witness.kernel import combined_kernel
    from ..witness.interpreter import run_generation
    from ..witness.traces import generate_all_tables
    from .block import prove_block, verify_block
    from .persistence import write_proof

    if "fixture" in job:
        from ..witness.testing_fixtures import FIXTURES
        inputs = FIXTURES[job["fixture"]]()
    else:
        from ..decoder import parse_block_prover_input, entrypoint
        with open(witness) as f:
            obj = json.load(f)
        bpi = parse_block_prover_input(
            obj[job.get("index", 0)] if isinstance(obj, list) else obj)
        gis = entrypoint(bpi, batch_size_hint=job.get("batch_size", 100))
        inputs = gis[job.get("batch", 0)]
    kernel = combined_kernel()
    interp = run_generation(kernel, inputs)
    gt = generate_all_tables(interp)
    proof = prove_block(gt, device=device)
    verify_block(proof, kernel, device=device)
    write_proof(output, proof)
    return {"proof_path": job["output"], "cycles": len(interp.trace)}


def _handle_echo(job: dict, device) -> dict:
    del device
    return {"echo": job.get("payload")}


WORKER_HANDLERS = {
    "prove_block": _handle_prove_block,
    "echo": _handle_echo,
}


def run_worker(queue_dir: str, handlers: dict | None = None,
               poll_s: float = 0.05, max_jobs: int | None = None,
               worker_name: str | None = None,
               idle_timeout: float | None = None,
               classes: tuple[str, ...] | None = None,
               device=None, config=None) -> int:
    """Worker main loop (bin/worker.rs twin): claim -> execute -> ack.
    Returns the number of jobs executed. `max_jobs`/`idle_timeout` bound
    the loop for tests and drain-and-exit deployments. `classes` is the
    worker's affinity (claim only those routing classes — the
    light-proof/heavy-proof worker split of leader.rs:28-70). Every
    handler runs on this thread with the worker's `device` (CUDA when
    not given); a handler that raises fails its job, which is written
    as the job's error file, and the worker goes on. `config` (a
    `RuntimeConfig`, resolved by `runtime_config.load()` when not given)
    names the directories that prove_block jobs may read and write."""
    from .. import metrics
    from ..runtime_config import load
    from ..stark.prover import resolve_device
    device = resolve_device(device)
    q = FsQueue(queue_dir)
    if handlers is None:
        handlers = dict(WORKER_HANDLERS, prove_block=functools.partial(
            _handle_prove_block, config=config or load()))
    name = worker_name or f"{socket.gethostname()}.{os.getpid()}"
    done = 0
    idle_since = time.time()
    while max_jobs is None or done < max_jobs:
        claimed = q.claim(name, classes=classes)
        if claimed is None:
            if idle_timeout is not None \
                    and time.time() - idle_since > idle_timeout:
                break
            time.sleep(poll_s)
            continue
        idle_since = time.time()
        job_id, job = claimed
        handler = handlers.get(job.get("kind"))
        try:
            if handler is None:
                raise ValueError(f"unknown job kind: {job.get('kind')!r}")
            with metrics.timeit(f"job.{job.get('kind')}"):
                q.complete(job_id, handler(job, device))
            metrics.inc("worker.jobs_completed")
        except Exception as e:  # noqa: BLE001 — worker must stay alive
            q.fail(job_id, f"{type(e).__name__}: {e}")
            metrics.inc("worker.jobs_failed")
        done += 1
        metrics.gauge("worker.jobs_seen", done)
    return done
