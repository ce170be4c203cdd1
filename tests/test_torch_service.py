"""The port's service layer against the JAX package's: the filesystem job
queue and worker loop (`orchestration/queue.py`), the HTTP leader
(`orchestration/leader_http.py`), the in-process runtime and the segment
pipeline (`orchestration/{runtime,prover}.py`), proof-file naming
(`orchestration/persistence.py`) and the command line's `worker`.

Each case runs the same inputs through both packages and asserts that the
port gives what the JAX package gives (tolerance 0). The queue directory
is one format: a job submitted by either package's `FsQueue` is claimed,
run and answered by the other's worker.

The `prove_block` handler: its witness step (`run_generation` ->
`generate_all_tables`) is held to the JAX package's traces by hash, and
its plumbing runs with the proof stubbed. Proofs that take minutes of XLA
compiles are sha256 constants that `slow` tests recompute with the JAX
package: the two-segment memory pipeline's and the JAX worker's
`prove_block` proof of `simple-transfer`, which `chip_smoke.py` holds the
card's proof to.
"""

import hashlib
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import zk_evm_tpu.orchestration.queue as jqueue
import zk_evm_tpu_torch.orchestration.queue as pqueue
from zk_evm_tpu.orchestration import leader_http as jleader
from zk_evm_tpu_torch.orchestration import leader_http as pleader

# sha256 over the proof_to_json strings of the two segment proofs of
# `two_segment_tasks` (each string, then a newline), equal between the
# packages (the `slow` test recomputes it with the JAX package)
TWO_SEGMENT_SHA256 = (
    "7984f73e6e074d39def05dc0a6661bad987acc70089bcbdc5291e7139552332f")
# sha256 of the proof file the JAX package's worker writes for
# {"kind": "prove_block", "fixture": "simple-transfer"}: the unsegmented
# block, default table sizes, StarkConfig() (the standard config);
# chip_smoke.py holds the card's proof to the same constant, and the
# `slow` test recomputes it with the JAX package
PROVE_BLOCK_SIMPLE_TRANSFER_SHA256 = (
    "ecc259fe9b373d56dc13c5d3fae1ae0890f1c10a98d7e5acc1238baa7edc9192")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The CPU proofs here are small: one intra-op thread proves them
    faster than many and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_handlers(handlers):
    """The JAX tests' one-argument handlers in the port's form, which
    also receives the worker's device."""
    return {k: (lambda h: lambda job, device: h(job))(h)
            for k, h in handlers.items()}


def echo_handlers():
    return {"echo": lambda job: {"echo": job["payload"]},
            "boom": lambda job: 1 / 0}


def run_port_worker(path, handlers=None, **kw):
    if handlers is not None:
        handlers = port_handlers(handlers)
    return pqueue.run_worker(str(path), handlers=handlers, device="cpu",
                             **kw)


def run_jax_worker(path, handlers=None, **kw):
    return jqueue.run_worker(str(path), handlers=handlers, **kw)


PACKAGES = {"jax": (jqueue.FsQueue, run_jax_worker),
            "port": (pqueue.FsQueue, run_port_worker)}


def outcome(q, job_id, timeout=1):
    try:
        return ("done", q.wait(job_id, timeout=timeout))
    except RuntimeError as e:
        return ("failed", str(e))


# -- tests/test_queue_worker.py:16-122 ----------------------------------

def roundtrip(fs_queue, path):
    q = fs_queue(str(path))
    jid = q.submit({"kind": "echo", "payload": 7})
    claimed = q.claim("w0")
    assert claimed is not None and claimed[0] == jid
    second = q.claim("w1")
    q.complete(jid, {"echo": 7})
    return claimed[1], second, q.wait(jid, timeout=1), sorted(
        f.replace(jid, "ID") for f in os.listdir(path))


def test_submit_claim_complete_roundtrip(tmp_path):
    got = roundtrip(pqueue.FsQueue, tmp_path / "port")
    assert got == roundtrip(jqueue.FsQueue, tmp_path / "jax")
    assert got[0]["payload"] == 7 and got[1] is None
    assert got[2]["echo"] == 7


def loop_outcomes(name, path):
    fs_queue, run = PACKAGES[name]
    q = fs_queue(str(path))
    ids = [q.submit({"kind": "echo", "payload": i}) for i in range(5)]
    bad = q.submit({"kind": "boom"})
    unknown = q.submit({"kind": "nope"})
    n = run(path, handlers=echo_handlers(), max_jobs=7, worker_name="w0")
    return n, [outcome(q, i) for i in ids + [bad, unknown]]


def test_worker_loop_executes_and_reports_errors(tmp_path):
    got = loop_outcomes("port", tmp_path / "port")
    assert got == loop_outcomes("jax", tmp_path / "jax")
    n, outcomes = got
    assert n == 7
    assert outcomes[:5] == [("done", {"echo": i}) for i in range(5)]
    assert outcomes[5] == ("failed", "ZeroDivisionError: division by zero")
    assert outcomes[6] == ("failed", "ValueError: unknown job kind: 'nope'")


def shared_queue(name, path):
    """Two concurrent workers drain 20 jobs; returns the payloads each
    job ran with, sorted (a job run twice would show twice)."""
    fs_queue, run = PACKAGES[name]
    q = fs_queue(str(path))
    executed = []
    lock = threading.Lock()

    def handler(job):
        with lock:
            executed.append(job["payload"])
        return {"echo": job["payload"]}

    ids = [q.submit({"kind": "echo", "payload": i}) for i in range(20)]
    ts = [threading.Thread(
        target=run, args=(path,),
        kwargs=dict(handlers={"echo": handler}, idle_timeout=0.5,
                    worker_name=f"w{k}")) for k in range(2)]
    for t in ts:
        t.start()
    results = [q.wait(i, timeout=10)["echo"] for i in ids]
    for t in ts:
        t.join()
    return results, sorted(executed)


def test_two_workers_share_the_queue(tmp_path):
    got = shared_queue("port", tmp_path / "port")
    assert got == shared_queue("jax", tmp_path / "jax")
    assert got == (list(range(20)), list(range(20)))


def test_many_workers_claim_each_job_once(tmp_path):
    """More worker threads than cores, with thread switches forced
    often: every job runs exactly once (the claim is one atomic rename)
    and every answer reaches its job."""
    import sys
    q = pqueue.FsQueue(str(tmp_path))
    runs = []
    lock = threading.Lock()

    def handler(job, device):
        with lock:
            runs.append(job["payload"])
        return {"echo": job["payload"]}

    ids = [q.submit({"kind": "echo", "payload": i}) for i in range(120)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(
            target=pqueue.run_worker, args=(q.path,),
            kwargs=dict(handlers={"echo": handler}, idle_timeout=0.3,
                        poll_s=0.001, worker_name=f"w{k}", device="cpu"))
            for k in range(2 * (os.cpu_count() or 4))]
        for t in ts:
            t.start()
        results = [q.wait(i, timeout=30)["echo"] for i in ids]
        for t in ts:
            t.join(30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    assert results == list(range(120))
    assert sorted(runs) == list(range(120))


def requeue(fs_queue, path):
    q = fs_queue(str(path))
    jid = q.submit({"kind": "echo", "payload": 1})
    first = q.claim("dead-worker") is not None
    second = q.claim("w1")
    n = q.requeue_stale(max_age_s=0.0)
    claimed = q.claim("w1")
    return first, second, n, claimed is not None and claimed[0] == jid


def test_requeue_stale_claims(tmp_path):
    got = requeue(pqueue.FsQueue, tmp_path / "port")
    assert got == requeue(jqueue.FsQueue, tmp_path / "jax")
    assert got == (True, None, 1, True)


def mapped(name, path):
    fs_queue, run = PACKAGES[name]
    q = fs_queue(str(path))
    t = threading.Thread(target=run, args=(path,),
                         kwargs=dict(handlers=echo_handlers(),
                                     idle_timeout=0.5))
    t.start()
    out = q.map([{"kind": "echo", "payload": i} for i in range(8)],
                timeout=10)
    t.join()
    return [r["echo"] for r in out]


def test_queue_map_orders_results(tmp_path):
    got = mapped("port", tmp_path / "port")
    assert got == mapped("jax", tmp_path / "jax") == list(range(8))


def affinity(fs_queue, path):
    q = fs_queue(str(path))
    heavy = [q.submit({"kind": "echo", "payload": i}, klass="heavy")
             for i in range(3)]
    light = q.submit({"kind": "echo", "payload": "agg"}, klass="light")
    got = q.claim("w-light", classes=("light",))
    out = [got is not None and got[0] == light,
           q.claim("w-light", classes=("light",))]
    seen = set()
    while (c := q.claim("w-any")) is not None:
        seen.add(c[0])
    out.append(seen == set(heavy))
    # a stale requeue keeps the routing class claimable by class
    q2 = fs_queue(str(path / "b"))
    jid = q2.submit({"kind": "echo"}, klass="heavy")
    out.append(q2.claim("w1", classes=("heavy",))[0] == jid)
    for f in os.listdir(q2.path):
        if ".claimed." in f:
            old = time.time() - 3600
            os.utime(os.path.join(q2.path, f), (old, old))
    out.append(q2.requeue_stale(10))
    out.append(q2.claim("w2", classes=("heavy",))[0] == jid)
    return out


def test_worker_affinity_routing(tmp_path):
    got = affinity(pqueue.FsQueue, tmp_path / "port")
    assert got == affinity(jqueue.FsQueue, tmp_path / "jax")
    assert got == [True, None, True, True, 1, True]


# -- one queue directory, either package's leader and workers -----------

@pytest.mark.parametrize("submitter", ["jax", "port"])
def test_queue_directory_is_shared_between_packages(tmp_path, submitter):
    """Jobs submitted by one package's FsQueue are claimed and answered by
    the other's worker, and the submitter reads the results and errors;
    the files each package writes for the same jobs are byte for byte
    the same."""
    worker = "port" if submitter == "jax" else "jax"
    jobs = [{"kind": "echo", "payload": [1, "two", None]},
            {"kind": "boom"}, {"kind": "nope", "x": 1}]

    def run(sub, work, path):
        q = PACKAGES[sub][0](str(path))
        ids = [q.submit(job, klass="heavy" if i else "default")
               for i, job in enumerate(jobs)]

        def files():
            out = {}
            for f in os.listdir(path):
                name = f
                for k, i in enumerate(ids):
                    name = name.replace(i, f"ID{k}")
                with open(os.path.join(path, f), "rb") as fh:
                    out[name] = fh.read()
            return out

        submitted = files()
        n = PACKAGES[work][1](path, max_jobs=3, worker_name="w")
        return n, submitted, files(), [outcome(q, i) for i in ids]

    got = run(submitter, worker, tmp_path / "mixed")
    assert got == run(submitter, submitter, tmp_path / "same")
    n, submitted, answered, outcomes = got
    assert n == 3
    assert sorted(submitted) == ["ID0.default.job.json",
                                 "ID1.heavy.job.json", "ID2.heavy.job.json"]
    assert sorted(answered) == [
        "ID0.default.claimed.w", "ID0.result.json",
        "ID1.error.json", "ID1.heavy.claimed.w",
        "ID2.error.json", "ID2.heavy.claimed.w"]
    assert outcomes == [
        ("done", {"echo": [1, "two", None]}),
        ("failed", "ValueError: unknown job kind: 'boom'"),
        ("failed", "ValueError: unknown job kind: 'nope'")]


# -- tests/test_leader_http.py ------------------------------------------

def request(url, data=None, raw=None):
    body = raw if raw is not None else \
        json.dumps(data).encode() if data is not None else None
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"},
        method="POST" if body is not None else "GET")
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def leader_lifecycle(name, path):
    serve = {"jax": jleader.serve, "port": pleader.serve}[name]
    run = PACKAGES[name][1]
    srv = serve(str(path), port=0, background=True)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    seen = []
    try:
        seen.append(request(base + "/healthz"))
        code, r = request(base + "/jobs", {"kind": "square", "v": 9})
        job_id = r["job_id"]
        seen.append((code, sorted(r)))
        seen.append(request(f"{base}/jobs/{job_id}"))
        worker = threading.Thread(
            target=run, args=(path,),
            kwargs={"handlers": {"square": lambda j: j["v"] ** 2},
                    "max_jobs": 1}, daemon=True)
        worker.start()
        worker.join(10)
        deadline = time.time() + 10
        while time.time() < deadline:
            code, st = request(f"{base}/jobs/{job_id}")
            if st["status"] == "done":
                break
            time.sleep(0.05)
        seen.append((code, st))
        code, m = request(base + "/metrics")
        seen.append((code, sorted(m)))
        seen.append(request(f"{base}/jobs/0123456789abcdef"))
    finally:
        srv.shutdown()
        srv.server_close()
    return seen


def test_leader_job_lifecycle(tmp_path):
    got = leader_lifecycle("port", tmp_path / "port")
    assert got == leader_lifecycle("jax", tmp_path / "jax")
    assert got == [
        (200, {"ok": True}), (202, ["job_id"]), (200, {"status": "queued"}),
        (200, {"status": "done", "result": 81}),
        (200, ["counters", "gauges", "timers"]),
        (404, {"status": "unknown"})]


def test_leader_refuses_job_ids_it_cannot_have_made(tmp_path):
    """The port's leader answers 400 to a job id that is not 16 hex
    digits, so that `..` never reads a result file outside the queue
    directory; the JAX leader joins the raw id onto the queue path (the
    gap recorded in ROADMAP Queue 3)."""
    (tmp_path / "secret.result.json").write_text(json.dumps("s"))
    got = {}
    for name, serve in (("jax", jleader.serve), ("port", pleader.serve)):
        srv = serve(str(tmp_path / name), port=0, background=True)
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            got[name] = [request(f"{base}/jobs/{job_id}") for job_id in
                         ("../secret", "nope", "0123456789ABCDEF",
                          "0123456789abcdef0")]
        finally:
            srv.shutdown()
            srv.server_close()
    refused = (400, {"error": "a job id is 16 hex digits"})
    assert got["port"] == [refused] * 4
    unknown = (404, {"status": "unknown"})
    assert got["jax"] == [(200, {"status": "done", "result": "s"})] + \
        [unknown] * 3


def malformed(name, path):
    serve = {"jax": jleader.serve, "port": pleader.serve}[name]
    srv = serve(str(path), port=0, background=True)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        return [request(base + "/jobs", raw=b"not json"),
                request(base + "/jobs", {"no": "kind"}),
                request(base + "/jobs", [1, 2]),
                request(base + "/nowhere"),
                request(base + "/jobs/x", {"kind": "echo"}),
                os.listdir(path)]
    finally:
        srv.shutdown()
        srv.server_close()


def test_leader_rejects_malformed(tmp_path):
    got = malformed("port", tmp_path / "port")
    assert got == malformed("jax", tmp_path / "jax")
    want = (400, {"error": "body must be a JSON job object with a 'kind'"})
    assert got == [want, want, want, (404, {"error": "not found"}),
                   (404, {"error": "not found"}), []]


# -- tests/test_orchestration.py ----------------------------------------

def test_runtime_map_fold():
    from zk_evm_tpu.orchestration import runtime as jrt
    from zk_evm_tpu_torch.orchestration import runtime as prt

    def run(rt_mod):
        class Square(rt_mod.Operation):
            def execute(self, x, abort):
                return x * x

        class Sum(rt_mod.Monoid):
            def empty(self):
                return 0

            def combine(self, a, b, abort):
                return a + b

        class Order(rt_mod.Monoid):
            def empty(self):
                return ()

            def combine(self, a, b, abort):
                return (a, b)           # the fold's tree shape

        rt = rt_mod.Runtime(num_workers=4)
        xs = list(range(17))
        out = [rt.map(Square(), xs), rt.fold(Sum(), [x * x for x in xs]),
               rt.fold(Sum(), []), rt.fold(Order(), list(range(7)))]
        rt.abort_signal.abort()
        with pytest.raises(RuntimeError, match="aborted"):
            rt.abort_signal.check()
        rt.shutdown()
        return out

    got = run(prt)
    assert got == run(jrt)
    assert got[:3] == [[x * x for x in range(17)],
                       sum(x * x for x in range(17)), 0]


def fake_proof(pkg, regs_before, regs_after, before_cap, after_cap):
    """AllProof stub with just enough structure for the chain checks."""
    multi = pkg["multi"]
    pv = pkg["pv"]
    ast = pkg["ast"]

    class _P:
        def __init__(self, cap):
            self.trace_cap = cap
    proofs = [None] * ast.NUM_TABLES
    proofs[ast.Table.MemBefore] = _P(before_cap)
    proofs[ast.Table.MemAfter] = _P(after_cap)
    values = pv.PublicValues(
        registers_before=pv.RegistersData(**regs_before),
        registers_after=pv.RegistersData(**regs_after))
    return multi.AllProof(proofs=proofs,
                          table_in_use=[p is not None for p in proofs],
                          public_values=values)


def chain_check(pkg):
    prover, runtime = pkg["prover"], pkg["runtime"]
    m = prover.SegmentAggMonoid()
    cap_a, cap_b, cap_c = [[1, 0, 0, 0]], [[2, 0, 0, 0]], [[3, 0, 0, 0]]
    ra = dict(program_counter=10, gas_used=5)
    rb = dict(program_counter=20, gas_used=9)
    rc = dict(program_counter=30, gas_used=11)
    r0 = prover.SegmentProofResult(0, fake_proof(pkg, ra, rb, cap_a, cap_b))
    r1 = prover.SegmentProofResult(1, fake_proof(pkg, rb, rc, cap_b, cap_c))
    out = []
    agg = m.combine(r0, r1, runtime.Runtime().abort_signal)
    out.append((agg.first, agg.last, len(agg.proofs)))
    out.append(m.combine(m.empty(), r0, runtime.Runtime().abort_signal)
               .first)
    for bad in (
            # a broken register chain, then a broken cap chain
            prover.SegmentProofResult(1, fake_proof(pkg, rc, rc, cap_b,
                                                    cap_c)),
            prover.SegmentProofResult(1, fake_proof(pkg, rb, rc, cap_c,
                                                    cap_c)),
            prover.SegmentProofResult(2, fake_proof(pkg, rb, rc, cap_b,
                                                    cap_c))):
        try:
            m.combine(r0, bad, runtime.Runtime().abort_signal)
            out.append("accepted")
        except AssertionError as e:
            out.append(str(e))
    return out


def packages():
    import zk_evm_tpu.orchestration.prover as jprover
    import zk_evm_tpu.orchestration.runtime as jruntime
    import zk_evm_tpu.stark.multi as jmulti
    import zk_evm_tpu.stark.public_values as jpv
    import zk_evm_tpu.tables.all_stark as jast
    import zk_evm_tpu_torch.orchestration.prover as pprover
    import zk_evm_tpu_torch.orchestration.runtime as pruntime
    import zk_evm_tpu_torch.stark.multi as pmulti
    import zk_evm_tpu_torch.stark.public_values as ppv
    import zk_evm_tpu_torch.tables.all_stark as past
    return ({"prover": jprover, "runtime": jruntime, "multi": jmulti,
             "pv": jpv, "ast": jast},
            {"prover": pprover, "runtime": pruntime, "multi": pmulti,
             "pv": ppv, "ast": past})


def test_segment_chain_check():
    jpkg, ppkg = packages()
    got = chain_check(ppkg)
    assert got == chain_check(jpkg)
    assert got == [(0, 1, 2), 0, "register chain broken between segments",
                   "MemAfter -> MemBefore cap chain broken",
                   "non-adjacent segments"]


def two_segment_tasks(pkg):
    """tests/test_orchestration.py's two memory-continuation segments:
    segment 0 writes two values (its MemAfter), segment 1 starts from
    that state."""
    from importlib import import_module
    root = pkg["ast"].__name__.split(".")[0]
    ast = pkg["ast"]
    mem = import_module(f"{root}.tables.memory")
    mc = import_module(f"{root}.tables.memory_continuation")
    seg = import_module(f"{root}.tables.segments").Segment
    stark = import_module(f"{root}.stark")
    pv = pkg["pv"]
    cfg = stark.StarkConfig(
        security_bits=1,
        fri_config=stark.FriConfig(rate_bits=1, cap_height=2,
                                   proof_of_work_bits=0, num_query_rounds=1,
                                   arity_bits=2, final_poly_bits=2))
    starks = ast.all_starks()
    ctls = [c for c in ast.all_cross_table_lookups()
            if c.name in ("memory", "mem_before", "mem_after")]

    def make_segment(idx, before_vals):
        trace, after_vals = mem.generate_trace(
            [], mem_before_values=before_vals)
        traces = [None] * ast.NUM_TABLES
        traces[ast.Table.Memory] = trace
        traces[ast.Table.MemBefore] = mc.generate_trace(before_vals)
        traces[ast.Table.MemAfter] = mc.generate_trace(after_vals)
        values = pv.PublicValues(
            registers_before=pv.RegistersData(program_counter=idx),
            registers_after=pv.RegistersData(program_counter=idx + 1))
        return pkg["prover"].SegmentTask(idx, traces, values,
                                         starks=starks), after_vals

    task0, after0 = make_segment(0, [((0, seg.MainMemory, 0), 7),
                                     ((0, seg.MainMemory, 3), 42)])
    task1, _ = make_segment(1, after0)
    task1.public_values.registers_before = \
        task0.public_values.registers_after
    return cfg, [task0, task1], ctls, starks, stark


def proofs_sha256(proofs, to_json) -> str:
    return hashlib.sha256("".join(
        to_json(p) + "\n" for p in proofs).encode()).hexdigest()


def test_two_segment_pipeline_with_real_proofs():
    """The two segments proved through `prove_segments` on the CPU and
    chained; every proof verifies under both packages' `verify_all`, and
    their JSON hashes to the JAX package's proofs (the `slow` test)."""
    import zk_evm_tpu.stark as jstark
    from zk_evm_tpu.stark.serialization import (
        all_proof_from_json as jfrom_json)
    from zk_evm_tpu_torch.stark.serialization import proof_to_json
    jpkg, ppkg = packages()
    cfg, tasks, ctls, starks, stark = two_segment_tasks(ppkg)
    agg = ppkg["prover"].prove_segments(cfg, tasks, ctls=ctls,
                                        device="cpu")
    assert (agg.first, agg.last, len(agg.proofs)) == (0, 1, 2)
    jcfg, _, jctls, jstarks, _ = two_segment_tasks(jpkg)
    for p in agg.proofs:
        optional = tuple(i for i, pr in enumerate(p.proofs) if pr is None)
        stark.verify_all(starks, p, ctls, cfg, optional_tables=optional)
        jstark.verify_all(jstarks, jfrom_json(proof_to_json(p)), jctls,
                          jcfg, optional_tables=optional)
    assert proofs_sha256(agg.proofs, proof_to_json) == TWO_SEGMENT_SHA256


@pytest.mark.slow
def test_two_segment_pipeline_sha256_is_the_jax_packages():
    """The JAX package's `prove_segments` of the same two segments (its
    XLA compiles take minutes on the CPU) hashes to the pinned
    constant."""
    from zk_evm_tpu.stark.serialization import proof_to_json as jto_json
    jpkg, _ = packages()
    cfg, tasks, ctls, _, _ = two_segment_tasks(jpkg)
    agg = jpkg["prover"].prove_segments(cfg, tasks, ctls=ctls)
    assert proofs_sha256(agg.proofs, jto_json) == TWO_SEGMENT_SHA256


# -- the prove_block handler --------------------------------------------

def traces_sha256(gt) -> str:
    h = hashlib.sha256()
    for t in gt.traces:
        h.update(b"unused" if t is None else
                 f"{t.dtype}{t.shape}".encode()
                 + np.ascontiguousarray(t).tobytes())
    return h.hexdigest()


@pytest.fixture(scope="module")
def witness_file(tmp_path_factory):
    from zk_evm_tpu_torch.witness.testing_fixtures import build_witness_chain
    witnesses, roots = build_witness_chain("add11")
    path = tmp_path_factory.mktemp("witness") / "add11-chain.json"
    path.write_text(json.dumps(witnesses))
    return path, roots


JOBS = {
    "simple-transfer": {"kind": "prove_block",
                        "fixture": "simple-transfer"},
    "add11-chain-batch-0": {"kind": "prove_block", "index": 0,
                            "batch": 0},
}
# len(interp.trace) of each job's witness run, as the JAX handler
# returns it in "cycles"
CYCLES = {"simple-transfer": 42866, "add11-chain-batch-0": 50522}


def job_inputs(name, witness_file, pkg_root):
    """What the handler proves for JOBS[name], through `pkg_root`'s own
    fixtures or decoder (the handler's body up to the witness run)."""
    from importlib import import_module
    job = dict(JOBS[name])
    if "fixture" in job:
        return job, import_module(
            f"{pkg_root}.witness.testing_fixtures").FIXTURES[
                job["fixture"]]()
    job["witness"] = str(witness_file[0])
    dec = import_module(f"{pkg_root}.decoder")
    with open(job["witness"]) as f:
        obj = json.load(f)
    gis = dec.entrypoint(dec.parse_block_prover_input(obj[job["index"]]),
                         batch_size_hint=job.get("batch_size", 100))
    return job, gis[job["batch"]]


@pytest.mark.parametrize("name", list(JOBS))
def test_prove_block_witness_step_equals_jax(name, witness_file,
                                             monkeypatch):
    """`run_generation` -> `generate_all_tables`, the handler's witness
    step, gives the JAX package's traces, public values and cycles."""
    from zk_evm_tpu.stark.public_values import (
        public_values_to_dict as jpv_dict)
    from zk_evm_tpu.witness.assembler import combined_kernel as jkernel
    from zk_evm_tpu.witness.interpreter import run_generation as jrun
    from zk_evm_tpu.witness.traces import generate_all_tables as jtables
    from zk_evm_tpu_torch.stark.public_values import public_values_to_dict
    from zk_evm_tpu_torch.witness.interpreter import run_generation
    from zk_evm_tpu_torch.witness.kernel import combined_kernel
    from zk_evm_tpu_torch.witness.traces import generate_all_tables
    monkeypatch.delenv("ZK_TABLE_MIN_DEGREES", raising=False)
    _, inputs = job_inputs(name, witness_file, "zk_evm_tpu_torch")
    interp = run_generation(combined_kernel(), inputs)
    gt = generate_all_tables(interp)
    _, jinputs = job_inputs(name, witness_file, "zk_evm_tpu")
    jinterp = jrun(jkernel(), jinputs)
    jgt = jtables(jinterp)
    assert traces_sha256(gt) == traces_sha256(jgt)
    assert gt.table_in_use == jgt.table_in_use
    assert public_values_to_dict(gt.public_values) == \
        jpv_dict(jgt.public_values)
    assert len(interp.trace) == len(jinterp.trace) == CYCLES[name]


def test_prove_block_handler_plumbing(tmp_path, witness_file, monkeypatch):
    """Both prove_block jobs through the port's worker, with the proof
    stubbed: each proves the tables of its witness run on the worker's
    device, self-verifies against the frozen kernel, writes the proof
    file and answers {"proof_path", "cycles"}; a job naming no known
    fixture fails and the worker goes on."""
    from zk_evm_tpu_torch.orchestration import block, persistence
    from zk_evm_tpu_torch.witness.kernel import combined_kernel
    monkeypatch.delenv("ZK_TABLE_MIN_DEGREES", raising=False)
    calls = []

    def prove_block(gt, config=None, device=None):
        calls.append(("prove", traces_sha256(gt), config, str(device)))
        return ("proof", len(calls))

    def verify_block(proof, kernel, config=None, device=None):
        calls.append(("verify", proof, bytes(kernel.code) ==
                      bytes(combined_kernel().code), str(device)))

    monkeypatch.setattr(block, "prove_block", prove_block)
    monkeypatch.setattr(block, "verify_block", verify_block)
    monkeypatch.setattr(persistence, "proof_to_json",
                        lambda proof: json.dumps(proof))
    q = pqueue.FsQueue(str(tmp_path / "q"))
    ids = {}
    for name in JOBS:
        job, _ = job_inputs(name, witness_file, "zk_evm_tpu_torch")
        job["output"] = str(tmp_path / f"{name}.zkproof")
        ids[name] = q.submit(job)
    bad = q.submit({"kind": "prove_block", "fixture": "no-such-block",
                    "output": str(tmp_path / "x")})
    assert pqueue.run_worker(q.path, max_jobs=3, device="cpu") == 3
    for k, name in enumerate(JOBS):
        out = str(tmp_path / f"{name}.zkproof")
        assert q.wait(ids[name], timeout=1) == {"proof_path": out,
                                                "cycles": CYCLES[name]}
        with open(out) as f:
            assert json.load(f) == ["proof", 2 * k + 1]
    assert outcome(q, bad) == ("failed", "KeyError: 'no-such-block'")
    assert [c[0] for c in calls] == ["prove", "verify"] * 2
    assert all(c[2] is None and c[3] == "cpu" for c in calls[::2])
    assert all(c[2] is True and c[3] == "cpu" for c in calls[1::2])


@pytest.mark.slow
def test_prove_block_handler_sha256_is_the_jax_packages(tmp_path):
    """The JAX package's worker handler proves simple-transfer at the
    standard config on the CPU: its proof file hashes to the constant
    that chip_smoke.py holds the card's proof to. Tens of minutes."""
    out = tmp_path / "simple-transfer.zkproof"
    res = jqueue._handle_prove_block({"kind": "prove_block",
                                      "fixture": "simple-transfer",
                                      "output": str(out)})
    assert res == {"proof_path": str(out),
                   "cycles": CYCLES["simple-transfer"]}
    assert hashlib.sha256(out.read_bytes()).hexdigest() == \
        PROVE_BLOCK_SIMPLE_TRANSFER_SHA256


# -- tests/test_persistence.py::test_proof_file_naming ------------------

def test_proof_file_naming(tmp_path):
    from zk_evm_tpu.orchestration import persistence as jper
    from zk_evm_tpu_torch.orchestration import persistence as per
    assert per.proof_path(str(tmp_path), 1033) == \
        jper.proof_path(str(tmp_path), 1033)
    assert per.proof_path(str(tmp_path), 1033).endswith("b1033.zkproof")


def test_block_proof_file_roundtrip(tmp_path):
    """save_block_proof writes what the JAX package's load_block_proof
    reads, and the reverse, for the two-segment pipeline's proof."""
    from zk_evm_tpu.orchestration import persistence as jper
    from zk_evm_tpu.stark.serialization import proof_to_json as jto_json
    from zk_evm_tpu_torch.orchestration import persistence as per
    from zk_evm_tpu_torch.stark.serialization import proof_to_json
    _, ppkg = packages()
    cfg, tasks, ctls, _, _ = two_segment_tasks(ppkg)
    (task,) = tasks[:1]
    proof = ppkg["prover"].SegmentProofOp(cfg, ctls, "cpu").execute(
        task, ppkg["runtime"].AbortSignal()).proof
    path = per.save_block_proof(str(tmp_path / "port"), 7, proof)
    assert path == jper.proof_path(str(tmp_path / "port"), 7)
    back = jper.load_block_proof(str(tmp_path / "port"), 7)
    assert jto_json(back) == proof_to_json(proof)
    jper.save_block_proof(str(tmp_path / "jax"), 7, back)
    assert proof_to_json(per.load_block_proof(str(tmp_path / "jax"), 7)) \
        == proof_to_json(proof)


# -- tests/test_cli.py:23-38 --------------------------------------------

def test_cli_requires_subcommand():
    from zk_evm_tpu_torch.__main__ import main
    with pytest.raises(SystemExit):
        main([])


def test_cli_worker_drains_queue(tmp_path, capsys):
    """`worker --queue DIR` claims and runs queued jobs, as the JAX
    package's does (the echo kind; --device cpu, since the worker
    proves on CUDA by default)."""
    from zk_evm_tpu.__main__ import main as jmain
    from zk_evm_tpu_torch.__main__ import main

    def drain(entry, path, extra):
        q = jqueue.FsQueue(str(path))
        jid = q.submit({"kind": "echo", "payload": "hi"})
        assert entry(["worker", "--queue", str(path), "--max-jobs", "1",
                      *extra]) == 0
        return json.loads(capsys.readouterr().out), q.wait(jid, timeout=1)

    got = drain(main, tmp_path / "port", ["--device", "cpu"])
    assert got == drain(jmain, tmp_path / "jax", [])
    assert got == ({"jobs_executed": 1}, {"echo": "hi"})
