"""Command-line front end of the port (`python -m zk_evm_tpu_torch ...`).

Twin of the JAX package's `decode`, `prove` and `verify` (the reference's
zero binaries, zero/src/bin/):

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

`prove` and `verify` run on CUDA unless `--device cpu` is given; without a
card they raise rather than fall back to the CPU. Every command raises if
the native host library (the witness VM core, the host Poseidon and
Keccak) does not build, rather than run its python twins.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

from . import native

# txns per batch when --batch-size is not given: the JAX package's
# resolved default (its runtime_config.RuntimeConfig.batch_size)
BATCH_SIZE = 10


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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="zk_evm_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("decode", help="decode a block witness")
    d.add_argument("witness")
    d.add_argument("--batch-size", type=int, default=BATCH_SIZE)
    d.set_defaults(fn=cmd_decode)
    pr = sub.add_parser("prove", help="prove a block or a chain of blocks")
    src = pr.add_mutually_exclusive_group(required=True)
    src.add_argument("--witness", help="decoder witness JSON")
    src.add_argument("--fixture", choices=("simple-transfer", "add11"),
                     help="built-in test block")
    pr.add_argument("-o", "--output", default="block.zkproof")
    pr.add_argument("--batch-size", type=int, default=BATCH_SIZE)
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
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
