"""The PyTorch port stands alone: importing every module of
`zk_evm_tpu_torch` loads neither jax nor the JAX package, and work on CPU
tensors runs the plain versions without launching a kernel.

Each check runs in a fresh interpreter, because this test process has
already imported both packages."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IMPORT_ALL = """
import importlib, json, pkgutil, sys
import zk_evm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    zk_evm_tpu_torch.__path__, "zk_evm_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"modules": names, "loaded": sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "zk_evm_tpu"))}))
"""

CPU_CALLS = """
import json
import numpy as np
from zk_evm_tpu_torch.field import GF
from zk_evm_tpu_torch.hash import (keccak_device, poseidon, poseidon_dense,
                                   poseidon_pallas)
from zk_evm_tpu_torch.merkle import build_commitment_tree
from zk_evm_tpu_torch.parallel import commit_cap, make_mesh, sharded_commit_cap
rng = np.random.default_rng(5)
m = GF.from_u64(rng.integers(0, 2**63, size=(16, 13), dtype=np.uint64))
poseidon.hash_rows(m)
poseidon.hash_rows(m.T)
poseidon.permute(GF.from_u64(rng.integers(0, 2**63, size=(3, 12),
                                          dtype=np.uint64)))
commit_cap(GF.from_u64(rng.integers(0, 2**63, size=(9, 16),
                                    dtype=np.uint64)), cap_height=1)
poseidon_pallas.permute_pallas(GF.from_u64(
    rng.integers(0, 2**63, size=(3, 12), dtype=np.uint64)))
poseidon_pallas.sponge_pallas(m)
build_commitment_tree(m, cap_height=1, hasher="keccak")
keccak_device.hash_rows(m.T)
sharded_commit_cap(GF.from_u64(rng.integers(0, 2**63, size=(9, 16),
                                            dtype=np.uint64)),
                   make_mesh(4, device_type="cpu"), cap_height=1)
build_commitment_tree(m, cap_height=1, hasher="keccak",
                      mesh=make_mesh(2, device_type="cpu"))
print(json.dumps([poseidon_dense.LAUNCHES, poseidon_pallas.LAUNCHES,
                  keccak_device.LAUNCHES]))
"""


REFUSALS = """
import json, sys, torch
import numpy as np
from zk_evm_tpu_torch.field import GF
from zk_evm_tpu_torch.parallel import Mesh, make_mesh
from zk_evm_tpu_torch.stark.poly_batch import PolynomialBatch
have = torch.cuda.device_count() if torch.cuda.is_available() else 0
values = GF.from_u64(np.arange(32, dtype=np.uint64).reshape(2, 16))
calls = {
    "more cards": lambda: make_mesh(have + 1),
    "three entries": lambda: Mesh(["cpu"] * 3),
    "keccak_host": lambda: PolynomialBatch.from_values(
        values, hasher="keccak_host", mesh=make_mesh(2, device_type="cpu")),
}
raised = {}
for name, call in calls.items():
    try:
        call()
        raised[name] = None
    except ValueError as e:
        raised[name] = str(e)
print(json.dumps({"raised": raised, "loaded": sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                  "zk_evm_tpu"))}))
"""


def run_fresh(code: str) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax():
    out = run_fresh(IMPORT_ALL)
    # every subpackage the slice ports is walked, down to the kernels
    for name in ("zk_evm_tpu_torch.hash.poseidon_dense",
                 "zk_evm_tpu_torch.hash.poseidon_pallas",
                 "zk_evm_tpu_torch.hash.keccak_device",
                 "zk_evm_tpu_torch.hash.keccak_np",
                 "zk_evm_tpu_torch.merkle.keccak_host",
                 "zk_evm_tpu_torch.merkle.keccak_tree",
                 "zk_evm_tpu_torch.stark.prover",
                 "zk_evm_tpu_torch.stark.lookup",
                 "zk_evm_tpu_torch.stark.multi",
                 "zk_evm_tpu_torch.tables.logic",
                 "zk_evm_tpu_torch.tables.all_stark",
                 "zk_evm_tpu_torch.tables.memory",
                 "zk_evm_tpu_torch.tables.memory_chain",
                 "zk_evm_tpu_torch.tables.cpu",
                 "zk_evm_tpu_torch.tables.keccak_sponge",
                 "zk_evm_tpu_torch.parallel",
                 "zk_evm_tpu_torch.parallel.sharded",
                 "zk_evm_tpu_torch.parallel.blocks",
                 "zk_evm_tpu_torch.entry",
                 "zk_evm_tpu_torch.rpc",
                 "zk_evm_tpu_torch.rpc.provider",
                 "zk_evm_tpu_torch.rpc.block_interval",
                 "zk_evm_tpu_torch.rpc.fetch",
                 "zk_evm_tpu_torch.rpc.loopback",
                 "zk_evm_tpu_torch.bench",
                 "zk_evm_tpu_torch.__main__",
                 "zk_evm_tpu_torch.native",
                 "zk_evm_tpu_torch.mpt.rlp",
                 "zk_evm_tpu_torch.mpt.trie",
                 "zk_evm_tpu_torch.mpt.world",
                 "zk_evm_tpu_torch.decoder.core",
                 "zk_evm_tpu_torch.decoder.wire",
                 "zk_evm_tpu_torch.decoder.type1",
                 "zk_evm_tpu_torch.decoder.type2",
                 "zk_evm_tpu_torch.decoder.world",
                 "zk_evm_tpu_torch.decoder.inputs",
                 "zk_evm_tpu_torch.decoder.observer",
                 "zk_evm_tpu_torch.smt",
                 "zk_evm_tpu_torch.smt.smt",
                 "zk_evm_tpu_torch.mpt.builder",
                 "zk_evm_tpu_torch.stark.public_values",
                 "zk_evm_tpu_torch.stark.serialization",
                 "zk_evm_tpu_torch.witness.kernel",
                 "zk_evm_tpu_torch.witness.bn254",
                 "zk_evm_tpu_torch.witness.bls381",
                 "zk_evm_tpu_torch.witness.native_vm",
                 "zk_evm_tpu_torch.witness.mpt_load",
                 "zk_evm_tpu_torch.witness.rlp_inputs",
                 "zk_evm_tpu_torch.witness.interpreter",
                 "zk_evm_tpu_torch.witness.traces",
                 "zk_evm_tpu_torch.witness.segments",
                 "zk_evm_tpu_torch.witness.testing_fixtures",
                 "zk_evm_tpu_torch.orchestration.block",
                 "zk_evm_tpu_torch.orchestration.aggregation",
                 "zk_evm_tpu_torch.orchestration.pipeline",
                 "zk_evm_tpu_torch.stark.debug",
                 "zk_evm_tpu_torch.tables.poseidon",
                 "zk_evm_tpu_torch.tables.scenarios",
                 "zk_evm_tpu_torch.recursion",
                 "zk_evm_tpu_torch.recursion.known",
                 "zk_evm_tpu_torch.recursion.ram",
                 "zk_evm_tpu_torch.recursion.vm",
                 "zk_evm_tpu_torch.recursion.tape_lib",
                 "zk_evm_tpu_torch.recursion.verify_tape",
                 "zk_evm_tpu_torch.recursion.system",
                 "zk_evm_tpu_torch.recursion.continuation",
                 "zk_evm_tpu_torch.recursion.aggregate",
                 "zk_evm_tpu_torch.metrics",
                 "zk_evm_tpu_torch.runtime_config",
                 "zk_evm_tpu_torch.timing",
                 "zk_evm_tpu_torch.orchestration.runtime",
                 "zk_evm_tpu_torch.orchestration.prover",
                 "zk_evm_tpu_torch.orchestration.persistence",
                 "zk_evm_tpu_torch.orchestration.queue",
                 "zk_evm_tpu_torch.orchestration.leader_http",
                 "zk_evm_tpu_torch.witness.debug",
                 "zk_evm_tpu_torch.witness.asm_parser",
                 "zk_evm_tpu_torch.witness.stack_search",
                 "zk_evm_tpu_torch.witness.optimizer",
                 "zk_evm_tpu_torch.witness.assembler",
                 "zk_evm_tpu_torch.witness.lsp",
                 "zk_evm_tpu_torch.witness.extract_constants"):
        assert name in out["modules"]
    assert out["loaded"] == []


def test_cpu_calls_launch_no_kernel():
    assert run_fresh(CPU_CALLS) == [{"permute": 0, "sponge": 0}] * 2 \
        + [{"rows": 0}]


def test_mesh_refusals_do_not_fall_back():
    """A mesh of more cards than the host has, a mesh whose size is not a
    power of two, and the numpy Keccak tree over a mesh each raise."""
    out = run_fresh(REFUSALS)
    assert out["loaded"] == []
    assert "CUDA devices" in out["raised"]["more cards"]
    assert "power of two" in out["raised"]["three entries"]
    assert "keccak_host" in out["raised"]["keccak_host"]


# Host modules the port carries as jax-free copies; each is the reference's
# file byte for byte, so the two cannot drift apart unnoticed. The modules
# the port had to edit (`hash/host_poseidon.py`, `stark/verifier.py`,
# `stark/serialization.py`, `tables/logic.py`, `timing.py`) are held to
# the reference by behaviour in the other test_torch_* files, and so are
# the table copies (`tests/test_torch_tables.py`), the Keccak hasher
# (`hash/keccak_np.py`, `tests/test_torch_keccak.py`), the cdk scenario
# (`tests/test_torch_cdk.py`), the batch and block statements
# (`tests/test_torch_aggregation.py`), the lookup module
# (`tests/test_torch_lookup.py`), the multi-table prover
# (`tests/test_torch_multi.py`), the witness generation, tries, fixtures
# and public values (`tests/test_torch_witness.py`), the block layer
# (`tests/test_torch_block.py`), the Poseidon table
# (`tests/test_torch_poseidon_table.py`), the sponge scenario
# (`tests/test_torch_scenarios.py`), the recursion modules that pass a
# device or require the native tape core (`tests/test_torch_recursion.py`),
# the witness debug tooling (`witness/debug.py`, `tests/test_torch_debug.py`),
# the runtime config, which keeps only the settings a command reads
# (`tests/test_torch_runtime_config.py`), the service layer's queue,
# leader, prover and proof files (`tests/test_torch_service.py`), and the
# kernel-asm assembler, language server and constant extractor, which
# read a zk_evm checkout only where ZK_EVM_REFERENCE names one
# (`tests/test_torch_assembler.py`, `tests/test_torch_lsp.py`).
VERBATIM_COPIES = [
    "field/host.py", "field/np_field.py", "field/hext.py",
    "hash/poseidon_params.py", "challenger/challenger.py",
    "merkle/host.py", "ntt/host.py", "stark/config.py", "stark/proof.py",
    "stark/domains.py", "tables/cpu_columns.py", "tables/cpu.py",
    "mpt/__init__.py", "mpt/rlp.py", "mpt/world.py",
    "witness/kernel_constants.json", "data/kernel_eth_mainnet.json.gz",
    "stark/debug.py", "recursion/known.py", "recursion/ram.py",
    "recursion/tape_lib.py", "merkle/keccak_host.py", "merkle/keccak_tree.py",
    "tables/all_stark.py",
    "decoder/__init__.py", "decoder/core.py", "decoder/wire.py",
    "decoder/type1.py", "decoder/type2.py", "decoder/world.py",
    "decoder/inputs.py", "decoder/observer.py", "smt/__init__.py",
    "mpt/builder.py",
    "rpc/__init__.py", "rpc/provider.py", "rpc/block_interval.py",
    "rpc/fetch.py", "witness/stack_search.py", "witness/optimizer.py",
]

# Copies that differ from the reference only in the lines listed, and why.
# Every other line is the reference's, byte for byte.
EDITED_COPIES = {
    # the docstring names the upstream crate instead of a local checkout
    "witness/asm_parser.py": {
        4: "reference defines in pest form (zk_evm's "
           "evm_arithmetization/src/"},
    # the docstring names the upstream crate instead of a local checkout
    "smt/smt.py": {3: ("Functional twin of the reference's smt_trie crate "
                       "(zk_evm's")},
    # the docstring names the port; the port logs under its own name
    "metrics.py": {
        5: "worker binaries configure RUST_LOG-style filtering). The "
           "port's twin: one",
        112: '    return logging.getLogger("zk_evm_tpu_torch")'},
    # the pool's threads share one card: more than one overlaps host work
    "orchestration/runtime.py": {
        9: "order), and AbortSignal cancels cooperatively between steps. "
           "On the card",
        10: "only one-thread runtimes have run: Runtime(num_workers>1) "
            "overlaps host",
        11: "work only, while device work queues on the one card in turn.",
        52: "        # Device work queues on the one card in turn; >1 worker "
            "overlaps",
        53: "        # host-side stages only (witness gen, proof "
            "serialization)."},
}


@pytest.mark.parametrize("path", VERBATIM_COPIES)
def test_host_copy_equals_reference(path):
    with open(os.path.join(REPO, "zk_evm_tpu_torch", path), "rb") as f:
        port = f.read()
    with open(os.path.join(REPO, "zk_evm_tpu", path), "rb") as f:
        ref = f.read()
    assert port == ref


@pytest.mark.parametrize("path", sorted(EDITED_COPIES))
def test_host_copy_differs_only_in_listed_lines(path):
    with open(os.path.join(REPO, "zk_evm_tpu_torch", path)) as f:
        port = f.read().splitlines()
    with open(os.path.join(REPO, "zk_evm_tpu", path)) as f:
        ref = f.read().splitlines()
    assert len(port) == len(ref)
    differ = {i + 1: line for i, (line, want) in enumerate(zip(port, ref))
              if line != want}
    assert differ == EDITED_COPIES[path]


WORKER_WITHOUT_CARD = """
import json, os, sys, torch
torch.cuda.is_available = lambda: False
from zk_evm_tpu_torch.__main__ import main
from zk_evm_tpu_torch.orchestration.queue import FsQueue
q = FsQueue(sys.argv[1])
q.submit({"kind": "echo", "payload": 1})
try:
    main(["worker", "--queue", q.path, "--max-jobs", "1"])
    raised = None
except RuntimeError as e:
    raised = str(e)
print(json.dumps({"raised": raised, "files": sorted(
    f.split(".", 1)[1] for f in os.listdir(q.path)), "loaded": sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                  "zk_evm_tpu"))}))
"""

LEADER = """
import json, sys, threading, urllib.request
from zk_evm_tpu_torch import __main__ as cli
from zk_evm_tpu_torch.orchestration import leader_http
serve = leader_http.serve
started = threading.Event()
servers = []

def in_background(*args, **kw):
    servers.append(serve(*args, background=True, **kw))
    started.set()
    return servers[-1]

leader_http.serve = in_background
assert cli.main(["leader", "--queue", sys.argv[1], "--port", "0"]) == 0
started.wait(30)
srv = servers[0]
base = f"http://127.0.0.1:{srv.server_address[1]}"
health = json.loads(urllib.request.urlopen(base + "/healthz").read())
req = urllib.request.Request(base + "/jobs", method="POST",
                             data=json.dumps({"kind": "echo"}).encode())
job = json.loads(urllib.request.urlopen(req).read())
srv.shutdown()
print(json.dumps({"health": health, "job": sorted(job), "loaded": sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                  "zk_evm_tpu"))}))
"""


def run_fresh_argv(code: str, *argv) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, *argv], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_worker_refuses_without_card(tmp_path):
    """`worker` proves on CUDA by default: with no card it raises before
    claiming a job, and runs nothing on the CPU."""
    out = run_fresh_argv(WORKER_WITHOUT_CARD, str(tmp_path / "q"))
    assert out["raised"].startswith("no CUDA device")
    assert out["files"] == ["default.job.json"]
    assert out["loaded"] == []


def test_leader_serves_without_jax(tmp_path):
    """`leader` serves through `serve`; with it started in the
    background, a job is accepted and neither jax nor the JAX package
    was loaded."""
    out = run_fresh_argv(LEADER, str(tmp_path / "q"))
    assert out == {"health": {"ok": True}, "job": ["job_id"], "loaded": []}
