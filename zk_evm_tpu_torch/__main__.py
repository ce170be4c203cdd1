"""Command-line front end of the port (`python -m zk_evm_tpu_torch ...`).

Twin of the JAX package's `prove --fixture` and `verify` (the reference's
zero binaries, zero/src/bin/):

  prove   --fixture simple-transfer|add11 [--max-cpu-len-log N]
          [-o block.zkproof] [--device cuda|cpu]
          witness run -> segments of 9 tables -> segment-chain proofs on
          the card -> batch aggregation -> block proof JSON
  verify  <block.zkproof> [--device cuda|cpu]
          verify a block proof written by `prove` against the canonical
          kernel: every segment (cap binding, CTL sums, public values),
          the segment chain, and the block statement rebuilt from them

Both run on CUDA unless `--device cpu` is given; without a card they
raise rather than fall back to the CPU. Both also raise if the native
host library (the witness VM core, the host Poseidon and Keccak) does not
build, rather than run its python twins.
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


def cmd_prove(args) -> int:
    """Prove a fixture block: witness generation (interpreter run -> 9
    tables per segment) -> segment-chain STARK proofs -> batch
    aggregation -> block statement (BlockProverInput::prove,
    zero/src/prover.rs:97-333)."""
    device = _device(args.device)
    native.require()
    from .orchestration.aggregation import prove_block_batches
    from .stark.serialization import block_proof_to_json
    from .timing import TimingTree
    from .witness.kernel import combined_kernel
    from .witness.testing_fixtures import FIXTURES

    gis = [FIXTURES[args.fixture]()]
    with _table_min_degrees(), TimingTree("prove block") as tree:
        with tree.scope("assemble kernel"):
            kernel = combined_kernel()
        n = gis[0].block_metadata.block_number
        with tree.scope(f"block {n} ({len(gis)} batches)"):
            # fixtures replicate the reference's test blocks, which are
            # not checkpoint-anchored (simple_transfer.rs:155 uses the
            # empty trie root): batch aggregation and the block's
            # initial checks run inside prove_block_batches
            bp = prove_block_batches(
                kernel, gis, max_cpu_len_log=args.max_cpu_len_log,
                device=device)
        with open(args.output, "w") as f:
            f.write(block_proof_to_json(bp))
    tree.print()
    print(json.dumps({
        "proofs": [args.output],
        "blocks": 1,
        "batches": [len(bp.batches)],
        "segments": [sum(len(c) for c in bp.batches)],
        "state_root_after":
            "0x" + bytes(bp.public_values.trie_roots_after
                         .state_root).hex(),
    }))
    return 0


def cmd_verify(args) -> int:
    device = _device(args.device)
    native.require()
    from .orchestration.aggregation import aggregate_block
    from .stark.serialization import block_proof_from_json
    from .witness.kernel import combined_kernel

    with open(args.proof) as f:
        raw = f.read()
    kernel = combined_kernel()
    try:
        bp = block_proof_from_json(raw)
        rebuilt = aggregate_block(bp.batches, kernel, device=device)
        assert rebuilt.public_values == bp.public_values, \
            "claimed block statement does not match its batches"
        n = sum(len(c) for c in bp.batches)
    except AssertionError as e:
        print(f"verify: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "proof": args.proof, "segments": n}))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="zk_evm_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("prove", help="prove a fixture block")
    pr.add_argument("--fixture", required=True,
                    choices=("simple-transfer", "add11"),
                    help="built-in test block")
    pr.add_argument("-o", "--output", default="block.zkproof")
    pr.add_argument("--max-cpu-len-log", type=int, default=None,
                    help="segment the proof at 2^N CPU rows "
                         "(zk-continuations)")
    pr.add_argument("--device", default="cuda",
                    help="torch device to prove on (default cuda)")
    pr.set_defaults(fn=cmd_prove)
    v = sub.add_parser("verify", help="verify a block proof file")
    v.add_argument("proof")
    v.add_argument("--device", default="cuda",
                   help="torch device of the initial-cap commitment "
                        "(default cuda)")
    v.set_defaults(fn=cmd_verify)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
