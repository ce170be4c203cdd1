"""Proof containers (host ints; json-serializable via dataclass asdict).

Structural twin of the reference's StarkProof / StarkOpeningSet
(/root/reference — starky 1.0.0 via evm_arithmetization/src/proof.rs)."""

from __future__ import annotations

from dataclasses import dataclass, field

from .fri import FriProof

Ext = tuple  # (a, b) extension element as ints


@dataclass
class StarkOpeningSet:
    trace_local: list[Ext]        # trace polys at zeta
    trace_next: list[Ext]         # trace polys at zeta * g
    aux_local: list[Ext]          # aux (lookup/CTL) polys at zeta
    aux_next: list[Ext]
    ctl_zs_first: list[int]       # CTL Z columns at x = 1 (base field)
    quotient: list[Ext]           # quotient chunks at zeta

    def observe_order(self):
        """Flat element stream in transcript order."""
        out = []
        for group in (self.trace_local, self.trace_next, self.aux_local,
                      self.aux_next):
            for a, b in group:
                out += [a, b]
        out += list(self.ctl_zs_first)
        for a, b in self.quotient:
            out += [a, b]
        return out


@dataclass
class StarkProof:
    degree_bits: int
    trace_cap: list[list[int]]
    aux_cap: list[list[int]] | None
    quotient_cap: list[list[int]]
    openings: StarkOpeningSet
    fri_proof: FriProof
    # sponge state snapshot before this table's challenge schedule
    # (multi-table proving resumes the transcript from here; cf. the
    # reference's init_challenger_state, prover.rs:320-338)
    init_challenger_state: list[int] | None = None
    public_inputs: list[int] = field(default_factory=list)
