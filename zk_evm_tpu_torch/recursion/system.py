"""The verifier-AIR proof system: Rvm + RvmMem + Poseidon under one
transcript with two CTLs (RAM bus, Poseidon permutations).

This is its own little AllStark (stark/multi.py machinery reused): a tape
finalizes into the three traces, prove_system proves them under a shared
challenger, verify_system replays it — including the known-column
(program) binding inside the Rvm's verify_stark — and checks the two
CTL sums. The tape's public inputs are the system's public inputs,
observed globally (transcript shape mirrors SURVEY.md Appendix A)."""

from __future__ import annotations

import numpy as np

from ..stark import StarkConfig, prove_all, verify_all
from ..stark.lookup import CrossTableLookup, CtlView
from ..stark.multi import AllProof
from ..timing import timed
from ..tables import poseidon as ps
from . import ram, vm

RVM = 0
RAM_T = 1
POSEIDON = 2


def system_ctls(npub: int) -> list[CrossTableLookup]:
    ctls = [CrossTableLookup(
        name="rvm_ram",
        looking=tuple(
            CtlView(table=RVM,
                    columns=vm.ctl_looking_ram(npub, ch),
                    filter=vm.ctl_looking_ram_filter(ch))
            for ch in range(vm.N_SLOTS)),
        looked=CtlView(table=RAM_T, columns=ram.ctl_data(),
                       filter=ram.ctl_filter())),
        CrossTableLookup(
        name="rvm_poseidon",
        looking=(CtlView(table=RVM,
                         columns=vm.ctl_looking_poseidon(npub),
                         filter=vm.ctl_looking_poseidon_filter()),),
        looked=CtlView(table=POSEIDON,
                       columns=ps.ctl_looked_permutation(),
                       filter=ps.ctl_looked_simple_filter())),
    ]
    return ctls


def prove_system(tape: vm.Tape, config: StarkConfig,
                 min_rows: int = 2, device=None):
    """Prove the tape on `device` (CUDA when not given). Returns
    (starks, AllProof, public_inputs)."""
    with timed("finalize tape"):
        stark, rvm_trace, ram_trace, pose_ops, pub = \
            tape.finalize(min_rows)
    with timed("poseidon table trace"):
        pose_trace = ps.generate_trace(pose_ops) if pose_ops else None
    starks = [stark, ram.RvmMemStark(), ps.PoseidonStark()]
    traces = [rvm_trace, ram_trace, pose_trace]
    ctls = system_ctls(tape.npub)
    proof = prove_all(starks, traces, ctls, config, public_inputs=pub,
                      table_public_inputs={RVM: pub}, device=device)
    return starks, proof, pub


def verify_system(starks, proof: AllProof, config: StarkConfig,
                  expected_public_inputs: list[int] | None = None,
                  device=None) -> None:
    """Replays the shared transcript; the Rvm's program binding runs
    inside its verify_stark, through the preprocessed oracle whose cap is
    committed from starks[RVM]'s program on `device` (CUDA when not
    given). The Poseidon table is optional (a tape with no hashes)."""
    if expected_public_inputs is not None:
        assert list(proof.public_inputs) == list(expected_public_inputs), \
            "public inputs mismatch"
    npub = starks[RVM].npub
    # link the globally-observed public inputs to the Rvm's PUB-bound
    # per-proof public inputs (both prover-supplied; the constraint set
    # binds the latter to RAM, this equality binds them to the former)
    assert list(proof.proofs[RVM].public_inputs) == \
        list(proof.public_inputs), "Rvm public input link mismatch"
    verify_all(starks, proof, system_ctls(npub), config,
               optional_tables=(POSEIDON,), device=device)
