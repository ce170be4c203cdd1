"""Proof (de)serialization: JSON with exact ints, for StarkProof, AllProof
and block proofs.

The same JSON as the JAX package's `proof_to_json`: the dataclasses keep
the JAX package's fields in its order, and an AllProof's public values go
through `public_values_to_dict`. A block proof is the persisted
`b{height}.zkproof` shape (zero/src/fs.rs:8-12)."""

from __future__ import annotations

import dataclasses
import json

from .fri import (FriProof, FriQueryRound, FriQueryStep, FriInitialProof)
from .proof import StarkProof, StarkOpeningSet
from .multi import AllProof
from .public_values import public_values_to_dict, public_values_from_dict


def proof_to_json(proof: StarkProof | AllProof) -> str:
    if isinstance(proof, AllProof):
        d = dataclasses.asdict(
            dataclasses.replace(proof, public_values=None))
        if proof.public_values is not None:
            d["public_values"] = public_values_to_dict(proof.public_values)
        return json.dumps(d)
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
    return all_proof_from_dict(json.loads(s))


def all_proof_from_dict(d) -> AllProof:
    pv = d.get("public_values")
    return AllProof(
        proofs=[stark_proof_from_dict(p) if p is not None else None
                for p in d["proofs"]],
        table_in_use=list(d["table_in_use"]),
        public_inputs=list(d["public_inputs"]),
        public_values=None if pv is None else public_values_from_dict(pv))


def block_proof_to_json(bp) -> str:
    """BlockProof (orchestration/aggregation.py) -> the persisted
    b{height}.zkproof shape: block statement + FinalPublicValues + all
    per-batch segment-chain AllProofs."""
    from ..orchestration.aggregation import FinalPublicValues
    fin = FinalPublicValues.from_public_values(bp.public_values)
    return json.dumps({
        "kind": "block",
        "block_number": bp.public_values.block_metadata.block_number,
        "public_values": public_values_to_dict(bp.public_values),
        "final_public_values": {
            "chain_id": fin.chain_id,
            "checkpoint_state_trie_root":
                fin.checkpoint_state_trie_root.hex(),
            "new_state_trie_root": fin.new_state_trie_root.hex(),
            "checkpoint_consolidated_hash":
                list(fin.checkpoint_consolidated_hash),
            "new_consolidated_hash": list(fin.new_consolidated_hash),
        },
        "batches": [[json.loads(proof_to_json(p)) for p in chain]
                    for chain in bp.batches],
    })


def block_proof_from_json(s: str):
    from ..orchestration.aggregation import BlockProof
    d = json.loads(s)
    assert d.get("kind") == "block", "not a block proof file"
    return BlockProof(
        batches=[[all_proof_from_dict(p) for p in chain]
                 for chain in d["batches"]],
        public_values=public_values_from_dict(d["public_values"]))
