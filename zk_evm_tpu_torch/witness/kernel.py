"""The eth_mainnet kernel: bytecode, labels and prover-input sites.

The canonical kernel is the JAX package's pre-assembled artifact
(data/kernel_eth_mainnet.json.gz, the 159-file stock build): the
reference's .asm sources are not in this repository. The assembler
(witness/assembler.py) builds this `Kernel` from .asm sources and can
rebuild the artifact from a zk_evm checkout. The kernel code hash
(keccak256 of the bytecode) binds proofs to the kernel.
`kernel_constants.json` holds the kernel's global constants, which the
interpreter and the assembler read.
"""

from __future__ import annotations

import gzip
import json
import os
from dataclasses import dataclass

CONSTANTS_PATH = os.path.join(os.path.dirname(__file__),
                              "kernel_constants.json")
FROZEN_KERNEL_PATH = os.path.join(os.path.dirname(__file__), "..", "data",
                                  "kernel_eth_mainnet.json.gz")


def load_constants() -> dict:
    with open(CONSTANTS_PATH) as f:
        return {k: int(v) for k, v in json.load(f)["constants"].items()}


@dataclass
class Kernel:
    code: bytes
    code_hash: bytes
    global_labels: dict
    ordered_labels: list
    prover_inputs: dict       # offset -> tuple path

    def offset_label(self, offset):
        for k, v in self.global_labels.items():
            if v == offset:
                return k
        return None


def combined_kernel() -> Kernel:
    """The full 159-file eth_mainnet kernel (68,210 code bytes)."""
    return load_frozen_kernel()


def kernel_to_json(kernel: Kernel) -> dict:
    """The JSON object of a kernel: code bytes, labels and the
    prover-input map (the frozen artifact's and the kernel cache's)."""
    return {"code": kernel.code.hex(),
            "code_hash": kernel.code_hash.hex(),
            "global_labels": kernel.global_labels,
            "ordered_labels": kernel.ordered_labels,
            "prover_inputs": {str(k): list(v)
                              for k, v in kernel.prover_inputs.items()}}


def kernel_from_json(payload: dict) -> Kernel:
    return Kernel(code=bytes.fromhex(payload["code"]),
                  code_hash=bytes.fromhex(payload["code_hash"]),
                  global_labels={k: int(v) for k, v in
                                 payload["global_labels"].items()},
                  ordered_labels=list(payload["ordered_labels"]),
                  prover_inputs={int(k): tuple(v)
                                 for k, v in payload["prover_inputs"].items()})


def load_frozen_kernel(path: str = FROZEN_KERNEL_PATH) -> Kernel:
    """A kernel as `assembler.freeze_kernel` wrote it."""
    with gzip.open(path, "rt") as f:
        return kernel_from_json(json.load(f))
