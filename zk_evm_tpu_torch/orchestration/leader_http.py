"""HTTP leader: accept prove/decode jobs over HTTP, dispatch through the
filesystem queue to workers.

Twin of the reference leader's HTTP mode (zero/src/bin/leader.rs with
cli::Command::Http + zero/src/rpc: the leader accepts block prover
inputs over the wire and fans segments to paladin workers). Endpoints:

    POST /jobs          {"kind": ..., ...}     -> {"job_id": ...}
    GET  /jobs/<id>                            -> {"status": ..., ...}
    GET  /metrics                              -> metrics snapshot
    GET  /healthz                              -> ok

Stdlib http.server only (no third-party deps); one FsQueue directory is
the whole coordination surface, so leaders and workers scale by just
sharing it.

The leader trusts its clients: a prove_block job names the witness file
a worker reads and the proof file it writes, as the user running the
worker. Keep it bound to localhost (`serve`'s default). It does refuse a
job id that `FsQueue.submit` cannot have made (16 hex digits), so that a
status query never names a file outside the queue directory."""

from __future__ import annotations

import json
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .queue import FsQueue

_JOB_ID = re.compile(r"[0-9a-f]{16}")


def make_handler(queue: FsQueue):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):          # noqa: A003
            import logging
            logging.getLogger("zk_evm_tpu_torch.leader").debug(
                fmt, *args)

        def do_GET(self):                           # noqa: N802
            if self.path == "/healthz":
                self._send(200, {"ok": True})
                return
            if self.path == "/metrics":
                from .. import metrics
                self._send(200, metrics.snapshot())
                return
            if self.path.startswith("/jobs/"):
                job_id = self.path.split("/", 2)[2]
                if not _JOB_ID.fullmatch(job_id):
                    self._send(400, {"error": "a job id is 16 hex digits"})
                    return
                res = os.path.join(queue.path, job_id + ".result.json")
                err = os.path.join(queue.path, job_id + ".error.json")
                # pending/claimed filenames carry the routing class:
                # "{job_id}.{klass}.job.json" / "...claimed.{worker}"
                listing = os.listdir(queue.path)
                pending_f = any(f.startswith(job_id + ".")
                                and f.endswith(".job.json")
                                for f in listing)
                running = any(f.startswith(job_id + ".")
                              and ".claimed." in f for f in listing)
                if os.path.exists(res):
                    with open(res) as f:
                        self._send(200, {"status": "done",
                                         "result": json.load(f)})
                elif os.path.exists(err):
                    with open(err) as f:
                        self._send(200, {"status": "failed",
                                         "error": json.load(f)})
                elif running:
                    self._send(200, {"status": "running"})
                elif pending_f:
                    self._send(200, {"status": "queued"})
                else:
                    self._send(404, {"status": "unknown"})
                return
            self._send(404, {"error": "not found"})

        def do_POST(self):                          # noqa: N802
            if self.path != "/jobs":
                self._send(404, {"error": "not found"})
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                job = json.loads(self.rfile.read(length))
            except ValueError:
                job = None
            if not (isinstance(job, dict) and "kind" in job):
                self._send(400, {"error": "body must be a JSON job "
                                          "object with a 'kind'"})
                return
            job_id = queue.submit(job)
            from .. import metrics
            metrics.inc("leader.jobs_submitted")
            self._send(202, {"job_id": job_id})

    return Handler


def serve(queue_dir: str, host: str = "127.0.0.1", port: int = 8080,
          background: bool = False):
    """Run the leader. With background=True, returns the server after
    starting its thread (tests); otherwise serves forever."""
    q = FsQueue(queue_dir)
    srv = ThreadingHTTPServer((host, port), make_handler(q))
    if background:
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        return srv
    srv.serve_forever()
    return srv
