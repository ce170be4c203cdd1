"""Disk persistence: proof files and the assembled-kernel cache.

Twin of the reference's zero/src/fs.rs (proof files named
`b{height}.zkproof`) and prover_state/persistence.rs (artifacts keyed by
an 8-hex-char kernel-hash prefix so caches invalidate when the kernel
changes)."""

from __future__ import annotations

import json
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


def kernel_cache_path(cache_dir: str, kernel_hash: bytes) -> str:
    return os.path.join(cache_dir, f"kernel_{kernel_hash[:4].hex()}.json")


def save_kernel(cache_dir: str, kernel) -> str:
    from ..witness.kernel import kernel_to_json
    os.makedirs(cache_dir, exist_ok=True)
    path = kernel_cache_path(cache_dir, kernel.code_hash)
    with open(path, "w") as f:
        json.dump(kernel_to_json(kernel), f)
    return path


def load_kernel(path: str):
    from ..witness.kernel import kernel_from_json
    with open(path) as f:
        return kernel_from_json(json.load(f))
