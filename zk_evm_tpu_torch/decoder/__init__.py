"""Witness decoder: Erigon compact wire format -> partial tries.

TPU-framework frontend twin of the reference's trace_decoder crate:
wire.rs (instruction stream parser) and type1.rs (MPT frontend).
"""

from .wire import parse_wire, encode_wire, Instruction
from .type1 import type1_frontend, Type1Frontend
from .type2 import type2_frontend, Type2Frontend
from .inputs import parse_block_prover_input, BlockProverInput
from .world import Type1World
from .core import (middle, entrypoint, batch_txns, Batch, TrieInputs,
                   GenerationInputs)
from .observer import Observer, DummyObserver, TriesObserver

__all__ = ["parse_wire", "encode_wire", "Instruction",
           "type1_frontend", "Type1Frontend",
           "type2_frontend", "Type2Frontend",
           "parse_block_prover_input", "BlockProverInput",
           "Type1World", "middle", "entrypoint", "batch_txns",
           "Batch", "TrieInputs", "GenerationInputs",
           "Observer", "DummyObserver", "TriesObserver"]
