"""Proof (de)serialization: JSON with exact ints, for StarkProof and
AllProof.

The same JSON as the JAX package's `proof_to_json`: the dataclasses keep
the JAX package's fields in its order. Block public values are not ported
yet, so an AllProof's `public_values` is always null."""

from __future__ import annotations

import dataclasses
import json

from .fri import (FriProof, FriQueryRound, FriQueryStep, FriInitialProof)
from .proof import StarkProof, StarkOpeningSet
from .multi import AllProof


def proof_to_json(proof: StarkProof | AllProof) -> str:
    return json.dumps(dataclasses.asdict(proof))


def _tupled(pairs):
    return [tuple(p) for p in pairs]


def _openings_from(d) -> StarkOpeningSet:
    return StarkOpeningSet(
        trace_local=_tupled(d["trace_local"]),
        trace_next=_tupled(d["trace_next"]),
        aux_local=_tupled(d["aux_local"]),
        aux_next=_tupled(d["aux_next"]),
        ctl_zs_first=list(d["ctl_zs_first"]),
        quotient=_tupled(d["quotient"]))


def _fri_from(d) -> FriProof:
    rounds = []
    for r in d["query_rounds"]:
        initial = FriInitialProof(leaves=r["initial"]["leaves"],
                                  paths=r["initial"]["paths"])
        steps = [FriQueryStep(coset_values=_tupled(s["coset_values"]),
                              path=s["path"]) for s in r["steps"]]
        rounds.append(FriQueryRound(initial=initial, steps=steps))
    return FriProof(commit_phase_caps=d["commit_phase_caps"],
                    final_poly=_tupled(d["final_poly"]),
                    pow_witness=d["pow_witness"],
                    query_rounds=rounds)


def stark_proof_from_dict(d) -> StarkProof:
    return StarkProof(
        degree_bits=d["degree_bits"],
        trace_cap=d["trace_cap"],
        aux_cap=d["aux_cap"],
        quotient_cap=d["quotient_cap"],
        openings=_openings_from(d["openings"]),
        fri_proof=_fri_from(d["fri_proof"]),
        init_challenger_state=d["init_challenger_state"],
        public_inputs=list(d["public_inputs"]))


def stark_proof_from_json(s: str) -> StarkProof:
    return stark_proof_from_dict(json.loads(s))


def all_proof_from_json(s: str) -> AllProof:
    d = json.loads(s)
    if d.get("public_values") is not None:
        raise NotImplementedError("block public values: later slice")
    return AllProof(
        proofs=[stark_proof_from_dict(p) if p is not None else None
                for p in d["proofs"]],
        table_in_use=list(d["table_in_use"]),
        public_inputs=list(d["public_inputs"]))
