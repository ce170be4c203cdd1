"""L2 recursion: the verifier-AIR proof system — a straight-line
verification VM (vm.py) with a RAM argument (ram.py) and Poseidon-table
hashing, whose program is bound by its preprocessed oracle's cap (and,
for legacy known columns, by verifier-recomputed openings, known.py).
Twin of the JAX package's `recursion/`; proving runs on CUDA unless the
caller passes `device="cpu"`."""

from .vm import Tape, RvmStark, Cell
from .ram import RvmMemStark
from .system import prove_system, verify_system, system_ctls
from .verify_tape import verify_stark_tape, verify_all_tape
from .aggregate import wrap_segment_chain

__all__ = ["Tape", "RvmStark", "Cell", "RvmMemStark",
           "prove_system", "verify_system", "system_ctls",
           "verify_stark_tape", "verify_all_tape", "wrap_segment_chain"]
