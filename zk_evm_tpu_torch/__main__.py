"""Command-line front end of the port (`python -m zk_evm_tpu_torch ...`).

Twin of the JAX package's command line (the reference's zero binaries,
zero/src/bin/):

  [--config cfg.json] [--flavor eth_mainnet] [--log-level L] COMMAND ...
          resolved through runtime_config.load (CLI > ZK_* env > the
          config file > defaults); they fill --batch-size and
          --max-cpu-len-log where a command leaves them unset, and set
          the logging level (ZK_LOG); any other flavor is refused
  decode  <witness.json> [--batch-size N]
          block witness(es) -> one JSON line a block: trie roots before
          and after, batches, gas (the leader's decode stage)
  prove   --fixture simple-transfer|add11 | --witness w.json
          [--batch-size N] [--batch-pool N] [--previous-proof b.zkproof]
          [--max-cpu-len-log N] [-o block.zkproof] [--device cuda|cpu]
          witness run -> segments of 9 tables -> segment-chain proofs on
          the card -> batch aggregation -> block proof JSON; a witness
          list proves block after block (`b{n}.zkproof` each) and checks
          the chain's checkpoint anchor and parent links
  verify  <proof.zkproof> [--checkpoint] [--device cuda|cpu]
          a block proof (every segment, the segment chain, the block
          statement rebuilt from them; with --checkpoint also the
          checkpoint anchor), a JSON list of segment AllProofs (one
          batch's chain), or a single AllProof, against the canonical
          kernel
  worker  --queue DIR [--max-jobs N] [--idle-timeout S] [--name W]
          [--affinity light,heavy] [--device cuda|cpu]
          [--witness-dir D] [--output-dir D]
          claim jobs from a shared queue directory and run them:
          `prove_block` jobs prove a fixture or a decoded witness batch
          on this process's card (orchestration/queue.py); a job's
          witness and proof files must lie in the witness and output
          directories (ZK_WITNESS_DIR, ZK_OUTPUT_DIR; the working
          directory by default), or the job fails
  leader  --queue DIR [--host H] [--port P]
          HTTP leader: POST /jobs, GET /jobs/<id>, /metrics, /healthz,
          dispatching through the queue directory to workers. A job
          names the files a worker reads and writes, which the worker
          confines to its configured directories; the leader has no
          authentication, so keep it on localhost (the default host)
  bench   the commitment benchmark (zk_evm_tpu_torch.bench), one JSON
          line
  trie-diff A B
          structural diff of two trie-shape JSON dumps (a witness
          debug bundle's); exit 1 with the diff lines, 0 without
  lsp     the kernel-asm language server over stdio (semantic tokens,
          definition, hover; witness/lsp.py); it indexes the kernel's
          .asm tree when ZK_EVM_REFERENCE names a zk_evm checkout, else
          only the open documents

`prove`, `verify` and `worker` run on CUDA unless `--device cpu` is given;
without a card they raise rather than fall back to the CPU. `bench` needs
the card. The commands that run the witness VM or a verifier raise if the
native host library (the witness VM core, the host Poseidon and Keccak)
does not build, rather than run its python twins.

A `--max-cpu-len-log` of 0, which the runtime config gives by default,
means no segmentation, as `runtime_config.py` documents: one segment a
batch.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

from . import native


def _device(name: str):
    import torch
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on "
                           "the CPU")
    return dev


@contextlib.contextmanager
def _table_min_degrees():
    """Production prove: pin table sizes to the reference's per-table
    minimum circuit degrees (zero/src/prover_state/circuit.rs:79-90), as
    the JAX package's `prove` does; restored afterwards, so a caller in
    the same process keeps its own sizes."""
    old = os.environ.get("ZK_TABLE_MIN_DEGREES")
    os.environ.setdefault("ZK_TABLE_MIN_DEGREES", "1")
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("ZK_TABLE_MIN_DEGREES", None)


def cmd_decode(args) -> int:
    native.require()
    from .decoder import parse_block_prover_input, entrypoint
    with open(args.witness) as f:
        blocks = json.load(f)
    if isinstance(blocks, dict):
        blocks = [blocks]
    for obj in blocks:
        bpi = parse_block_prover_input(obj)
        gis = entrypoint(bpi, batch_size_hint=args.batch_size)
        out = {
            "block_number": bpi.block_metadata.block_number,
            "txns": len(bpi.txn_info),
            "batches": len(gis),
            "pre_state_root": "0x" + bpi.trie_roots_before()
                                        .state_root.hex(),
            "checkpoint_ok": bpi.trie_roots_before().state_root
            == bpi.checkpoint_state_trie_root,
            "post_state_root":
                "0x" + gis[-1].trie_roots_after.state_root.hex(),
            "transactions_root":
                "0x" + gis[-1].trie_roots_after.transactions_root.hex(),
            "receipts_root":
                "0x" + gis[-1].trie_roots_after.receipts_root.hex(),
            "gas_used": gis[-1].gas_used_after,
        }
        print(json.dumps(out))
    return 0


def cmd_prove(args) -> int:
    """Prove block(s): witness generation (interpreter run -> 9 tables
    per segment) -> per-batch segment-chain STARK proofs -> batch
    aggregation -> block statement, chained across blocks
    (BlockProverInput::prove, zero/src/prover.rs:97-333)."""
    device = _device(args.device)
    native.require()
    from .orchestration.aggregation import (
        prove_block_batches, verify_block_chain,
        rewrite_checkpoint_consolidation)
    from .stark.serialization import (block_proof_to_json,
                                      block_proof_from_json)
    from .timing import TimingTree
    from .witness.kernel import combined_kernel
    from .witness.testing_fixtures import FIXTURES

    if args.fixture:
        gis_per_block = [[FIXTURES[args.fixture]()]]
    else:
        from .decoder import parse_block_prover_input, entrypoint
        with open(args.witness) as f:
            obj = json.load(f)
        blocks = obj if isinstance(obj, list) else [obj]
        gis_per_block = [
            entrypoint(parse_block_prover_input(b),
                       batch_size_hint=args.batch_size)
            for b in blocks]
        # the witness's consolidated hash was computed with plonky2's
        # Poseidon; restamp it under ours so the chain is self-
        # consistent and checkpoint-checkable
        rewrite_checkpoint_consolidation(gis_per_block)

    parent_pv = None
    if args.previous_proof:
        with open(args.previous_proof) as f:
            parent_pv = block_proof_from_json(f.read()).public_values

    block_proofs = []
    outputs = []
    with _table_min_degrees(), TimingTree("prove blocks") as tree:
        with tree.scope("assemble kernel"):
            kernel = combined_kernel()
        for gis in gis_per_block:
            n = gis[0].block_metadata.block_number
            with tree.scope(f"block {n} ({len(gis)} batches)"):
                bp = prove_block_batches(
                    kernel, gis, max_cpu_len_log=args.max_cpu_len_log,
                    batch_pool_size=args.batch_pool, device=device)
            block_proofs.append(bp)
            out = args.output if len(gis_per_block) == 1 \
                else f"b{n}.zkproof"
            with open(out, "w") as f:
                f.write(block_proof_to_json(bp))
            outputs.append(out)
        with tree.scope("verify chain (self-check)"):
            # fixtures replicate the reference's test blocks, which are
            # not checkpoint-anchored (simple_transfer.rs:155 uses the
            # empty trie root); batch aggregation and the block's
            # initial checks already ran inside prove_block_batches
            if args.witness:
                verify_block_chain(block_proofs, kernel,
                                   parent=parent_pv, reverify=False)
    tree.print()
    last = block_proofs[-1]
    print(json.dumps({
        "proofs": outputs,
        "blocks": len(block_proofs),
        "batches": [len(bp.batches) for bp in block_proofs],
        "segments": [sum(len(c) for c in bp.batches)
                     for bp in block_proofs],
        "state_root_after":
            "0x" + bytes(last.public_values.trie_roots_after
                         .state_root).hex(),
    }))
    return 0


def cmd_verify(args) -> int:
    device = _device(args.device)
    native.require()
    from .orchestration.aggregation import (aggregate_block,
                                            check_checkpoint_block)
    from .orchestration.block import verify_block, verify_segments
    from .stark.serialization import (all_proof_from_dict,
                                      all_proof_from_json,
                                      block_proof_from_json)
    from .witness.kernel import combined_kernel

    with open(args.proof) as f:
        raw = f.read()
    obj = json.loads(raw)
    kernel = combined_kernel()
    try:
        if isinstance(obj, dict) and obj.get("kind") == "block":
            bp = block_proof_from_json(raw)
            rebuilt = aggregate_block(bp.batches, kernel, device=device)
            assert rebuilt.public_values == bp.public_values, \
                "claimed block statement does not match its batches"
            if args.checkpoint:
                check_checkpoint_block(bp.public_values)
            n = sum(len(c) for c in bp.batches)
        elif isinstance(obj, list):
            proofs = [all_proof_from_dict(p) for p in obj]
            verify_segments(proofs, kernel, device=device)
            n = len(proofs)
        else:
            verify_block(all_proof_from_json(raw), kernel, device=device)
            n = 1
    except AssertionError as e:
        print(f"verify: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "proof": args.proof, "segments": n}))
    return 0


def cmd_worker(args) -> int:
    """Worker loop: claim prove jobs from a shared-directory queue and
    run them on this process's card (bin/worker.rs twin)."""
    device = _device(args.device)
    native.require()
    from .orchestration.queue import run_worker
    classes = tuple(args.affinity.split(",")) if args.affinity else None
    n = run_worker(args.queue, max_jobs=args.max_jobs,
                   idle_timeout=args.idle_timeout,
                   worker_name=args.name, classes=classes, device=device,
                   config=args.runtime)
    print(json.dumps({"jobs_executed": n}))
    return 0


def cmd_leader(args) -> int:
    """HTTP leader (leader.rs http-mode twin): accept jobs over HTTP,
    dispatch via the shared queue directory to workers."""
    from .orchestration.leader_http import serve
    print(f"leader serving on {args.host}:{args.port} "
          f"(queue: {args.queue})", file=sys.stderr, flush=True)
    serve(args.queue, host=args.host, port=args.port)
    return 0


def cmd_bench(args) -> int:
    del args
    from . import bench
    bench.main()
    return 0


def cmd_trie_diff(args) -> int:
    """Structural diff of two trie-shape JSON dumps — the files written
    by witness/debug.py's error bundles (bin/trie_diff.rs twin)."""
    from .witness.debug import trie_diff
    with open(args.a) as f:
        a = json.load(f)
    with open(args.b) as f:
        b = json.load(f)
    diffs = trie_diff(a, b)
    for d in diffs:
        print(d)
    if not diffs:
        print("tries are structurally identical")
    return 1 if diffs else 0


def cmd_lsp(args) -> int:
    """Kernel-asm language server over stdio (lsp-server.rs twin)."""
    del args
    from .witness.lsp import main as lsp_main
    lsp_main()
    return 0


def main(argv=None) -> int:
    from . import metrics, runtime_config
    p = argparse.ArgumentParser(prog="zk_evm_tpu_torch")
    p.add_argument("--config", default=None,
                   help="JSON config file (or ZK_CONFIG)")
    p.add_argument("--flavor", choices=("eth_mainnet",), default=None,
                   help="chain flavor (or ZK_FLAVOR); the port proves "
                        "eth_mainnet blocks only")
    p.add_argument("--log-level", default=None,
                   choices=("error", "warn", "info", "debug"),
                   help="logging level (or ZK_LOG)")
    sub = p.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("decode", help="decode a block witness")
    d.add_argument("witness")
    d.add_argument("--batch-size", type=int, default=None)
    d.set_defaults(fn=cmd_decode)
    pr = sub.add_parser("prove", help="prove a block or a chain of blocks")
    src = pr.add_mutually_exclusive_group(required=True)
    src.add_argument("--witness", help="decoder witness JSON")
    src.add_argument("--fixture", choices=("simple-transfer", "add11"),
                     help="built-in test block")
    pr.add_argument("-o", "--output", default="block.zkproof")
    pr.add_argument("--batch-size", type=int, default=None)
    pr.add_argument("--max-cpu-len-log", type=int, default=None,
                    help="segment the proof at 2^N CPU rows "
                         "(zk-continuations)")
    pr.add_argument("--batch-pool", type=int, default=1,
                    help="txn batches proven concurrently per block "
                         "(reference: paladin batch fan-out, "
                         "zero/src/prover.rs:72-118)")
    pr.add_argument("--previous-proof", default=None,
                    help="previous block's .zkproof to chain from "
                         "(resume, zero/src/fs.rs:14-30)")
    pr.add_argument("--device", default="cuda",
                    help="torch device to prove on (default cuda)")
    pr.set_defaults(fn=cmd_prove)
    v = sub.add_parser("verify", help="verify a proof file")
    v.add_argument("proof")
    v.add_argument("--checkpoint", action="store_true",
                   help="also require the block to anchor at its "
                        "claimed checkpoint")
    v.add_argument("--device", default="cuda",
                   help="torch device of the initial-cap commitment "
                        "(default cuda)")
    v.set_defaults(fn=cmd_verify)
    b = sub.add_parser("bench", help="run the commitment benchmark")
    b.set_defaults(fn=cmd_bench)
    w = sub.add_parser("worker",
                       help="serve prove jobs from a shared queue dir")
    w.add_argument("--queue", required=True)
    w.add_argument("--max-jobs", type=int, default=None)
    w.add_argument("--idle-timeout", type=float, default=None,
                   help="exit after this many idle seconds")
    w.add_argument("--name", default=None)
    w.add_argument("--affinity", default=None,
                   help="comma-separated routing classes to claim "
                        "(e.g. 'heavy' or 'light,default'); the "
                        "reference's light-proof/heavy-proof worker "
                        "affinity (leader.rs:28-70)")
    w.add_argument("--device", default="cuda",
                   help="torch device to prove on (default cuda)")
    w.add_argument("--witness-dir", default=None,
                   help="directory the jobs' witness files must lie in "
                        "(or ZK_WITNESS_DIR; default the working "
                        "directory)")
    w.add_argument("--output-dir", default=None,
                   help="directory the jobs' proof files must lie in "
                        "(or ZK_OUTPUT_DIR; default the working "
                        "directory)")
    w.set_defaults(fn=cmd_worker)
    lsp = sub.add_parser("lsp", help="kernel-asm language server (stdio)")
    lsp.set_defaults(fn=cmd_lsp)
    td = sub.add_parser("trie-diff",
                        help="diff two trie-shape JSON dumps")
    td.add_argument("a")
    td.add_argument("b")
    td.set_defaults(fn=cmd_trie_diff)
    ld = sub.add_parser("leader",
                        help="HTTP leader serving jobs into a queue dir")
    ld.add_argument("--queue", required=True)
    ld.add_argument("--host", default="127.0.0.1",
                    help="address to bind (default 127.0.0.1); the leader "
                         "has no authentication, so keep it on "
                         "localhost")
    ld.add_argument("--port", type=int, default=8080)
    ld.set_defaults(fn=cmd_leader)
    args = p.parse_args(argv)
    rc = runtime_config.load(
        cli_overrides={
            "flavor": args.flavor,
            "log_level": args.log_level,
            "batch_size": getattr(args, "batch_size", None),
            "max_cpu_len_log": getattr(args, "max_cpu_len_log", None),
            "witness_dir": getattr(args, "witness_dir", None),
            "output_dir": getattr(args, "output_dir", None),
        },
        config_path=args.config)
    args.runtime = rc
    metrics.setup_logging(rc.log_level)
    # the resolved config fills the per-command flags left unset; a
    # max_cpu_len_log of 0 is the config's "no segmentation"
    if hasattr(args, "batch_size"):
        args.batch_size = rc.batch_size
    if hasattr(args, "max_cpu_len_log"):
        args.max_cpu_len_log = rc.max_cpu_len_log or None
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
