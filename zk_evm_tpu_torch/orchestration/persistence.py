"""Disk persistence: proof files.

Twin of the reference's zero/src/fs.rs (proof files named
`b{height}.zkproof`). The JAX package's module also caches assembled
kernels (prover_state/persistence.rs); that half serves the kernel
assembler, which the port does not carry (it loads the frozen
eth_mainnet kernel, `witness/kernel.py`), so it is left out here."""

from __future__ import annotations

import os

from ..stark.serialization import proof_to_json, all_proof_from_json


def proof_path(output_dir: str, block_height: int) -> str:
    return os.path.join(output_dir, f"b{block_height}.zkproof")


def write_proof(path: str, proof) -> str:
    """Write an AllProof as `proof_to_json` gives it (the worker's proof
    file, and `save_block_proof`'s)."""
    with open(path, "w") as f:
        f.write(proof_to_json(proof))
    return path


def save_block_proof(output_dir: str, block_height: int, proof) -> str:
    os.makedirs(output_dir, exist_ok=True)
    return write_proof(proof_path(output_dir, block_height), proof)


def load_block_proof(output_dir: str, block_height: int):
    with open(proof_path(output_dir, block_height)) as f:
        return all_proof_from_json(f.read())
