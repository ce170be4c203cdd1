"""The eth_mainnet kernel: bytecode, labels and prover-input sites.

The port loads the JAX package's pre-assembled artifact
(data/kernel_eth_mainnet.json.gz, the 159-file stock build) and carries
no assembler: assembling needs the reference's .asm sources, which are
not in this repository. The kernel code hash (keccak256 of the bytecode)
binds proofs to the kernel. `kernel_constants.json` holds the kernel's
global constants, which the interpreter reads.
"""

from __future__ import annotations

import gzip
import json
import os
from dataclasses import dataclass

_CONSTANTS_PATH = os.path.join(os.path.dirname(__file__),
                               "kernel_constants.json")
FROZEN_KERNEL_PATH = os.path.join(os.path.dirname(__file__), "..", "data",
                                  "kernel_eth_mainnet.json.gz")


def load_constants() -> dict:
    with open(_CONSTANTS_PATH) as f:
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
    with gzip.open(FROZEN_KERNEL_PATH, "rt") as f:
        payload = json.load(f)
    return Kernel(code=bytes.fromhex(payload["code"]),
                  code_hash=bytes.fromhex(payload["code_hash"]),
                  global_labels=payload["global_labels"],
                  ordered_labels=payload["ordered_labels"],
                  prover_inputs={int(k): tuple(v)
                                 for k, v in payload["prover_inputs"].items()})
