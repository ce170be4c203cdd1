"""Multi-table proving: the AllStark layer.

Twin of the JAX package's `stark/multi.py`. Transcript: all trace caps
observed in table order (zero caps for unused optional tables), then the
public inputs, then the global CTL challenge set, then each table proves
under the shared sequential challenger (each proof snapshots
init_challenger_state). A block proof's public inputs are
its PublicValues' elements (`PublicValues.to_elements()`). The global
verifier additionally cross-checks the CTL running-sum totals across
tables.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from ..field import GF, host
from ..challenger import Challenger
from ..parallel.blocks import indexed, side_stream
from ..timing import record, timed
from .config import StarkConfig
from .poly_batch import PolynomialBatch
from .stark import Stark
from .proof import StarkProof
from .prover import prove_stark, resolve_device, same_device
from .verifier import verify_stark
from . import lookup


@dataclass
class AllProof:
    proofs: list[StarkProof | None]      # None = table unused (skipped)
    table_in_use: list[bool]
    public_inputs: list[int] = field(default_factory=list)
    public_values: object | None = None  # PublicValues (block proofs)


def _zero_cap(config: StarkConfig) -> list[list[int]]:
    return [[0, 0, 0, 0] for _ in range(1 << config.cap_height)]


def observe_global(challenger: Challenger, caps, public_inputs) -> None:
    for cap in caps:
        challenger.observe_cap(cap)
    challenger.observe_elements(public_inputs)


def prove_all(starks: list[Stark], traces: list[np.ndarray | None],
              ctls: list[lookup.CrossTableLookup], config: StarkConfig,
              public_inputs: list[int] | None = None,
              public_values=None,
              table_public_inputs: dict[int, list[int]] | None = None,
              device=None, parallel_commits: bool = False,
              devices: list | None = None, mesh=None) -> AllProof:
    """Prove every in-use table under one transcript, on `device` (CUDA
    when not given). traces[i] may be None for unused optional tables
    (zero cap observed, no proof). `public_values` (a PublicValues)
    takes the place of raw public_inputs for block proofs: the
    transcript observes its `to_elements()`.
    `table_public_inputs[t]` feeds table t's per-proof public inputs
    (e.g. the Rvm's PUB bindings) without re-observing them: the global
    observation already covers them when the caller passes the same
    values in `public_inputs`. A table's preprocessed columns are
    committed in their own oracle, not with its trace.

    `parallel_commits`: every trace commitment runs before any
    transcript step, so they are independent; each runs in a thread of
    its own on a CUDA stream of its own (on `devices[i % len(devices)]`
    when `devices` is given, and table i is then proved on the device
    that committed it). The table proofs then run in turn under the one
    transcript, as before.
    `mesh` (`parallel.Mesh`): every table's `prove_stark` runs over it
    (with k > 1 entries its aux columns, quotient, openings, G and folds
    over the mesh's row blocks), and so, without `parallel_commits`,
    does its trace commitment; each table's transcript runs on
    `mesh[0]`. The proof is the same on any of these paths."""
    if mesh is not None:
        if device is not None and not same_device(device, mesh[0]):
            raise ValueError(f"device {device} is not the mesh's first "
                             f"device {mesh[0]}")
        device = mesh[0]
        if devices and not all(same_device(d, mesh[0]) for d in devices):
            raise ValueError("with a mesh every table is proved on the "
                             "mesh's first device; devices names others")
    # parallel commits over `devices` put each table on a device of its own
    dev = None if parallel_commits and devices else resolve_device(device)
    if public_values is not None:
        assert public_inputs is None, \
            "pass public_values OR raw public_inputs, not both"
        public_inputs = public_values.to_elements()
    public_inputs = public_inputs or []
    table_in_use = [t is not None for t in traces]

    challenger = Challenger()
    if parallel_commits:
        batches = _commit_in_parallel(starks, traces, config, dev, devices)
    else:
        batches = []
        for stark, trace in zip(starks, traces):
            if trace is None:
                batches.append(None)
                continue
            with timed(f"commit {stark.name} trace"):
                batches.append(PolynomialBatch.from_values(
                    GF.from_u64(trace[stark.num_preprocessed:], dev),
                    rate_bits=config.rate_bits,
                    cap_height=config.cap_height, hasher=config.hasher,
                    mesh=mesh))
    caps = [b.cap_ints() if b is not None else _zero_cap(config)
            for b in batches]
    observe_global(challenger, caps, public_inputs)
    challenges = lookup.get_challenge_set(challenger, config.num_challenges)

    proofs: list[StarkProof | None] = []
    for t, (stark, trace) in enumerate(zip(starks, traces)):
        if trace is None:
            proofs.append(None)
            continue
        groups = lookup.ctl_groups_for_table(ctls, t)
        with timed(f"prove {stark.name} {trace.shape}"):
            proofs.append(prove_stark(
                stark, trace, config, challenger,
                public_inputs=(table_public_inputs or {}).get(t),
                challenges=challenges, ctl_groups=groups,
                observe_trace_cap=False, trace_batch=batches[t],
                mesh=mesh))
        batches[t] = None       # free the table's device buffers
    return AllProof(proofs=proofs, table_in_use=table_in_use,
                    public_inputs=list(public_inputs),
                    public_values=public_values)


def table_devices(n: int, dev, devices) -> list[torch.device]:
    """The device of each of `n` tables under `parallel_commits`:
    devices[i % len(devices)], or `dev` for all. A `cuda` device with no
    index is the caller's current card; it is indexed here, because a
    pool thread's current card is card 0."""
    return [indexed(devices[i % len(devices)] if devices else dev)
            for i in range(n)]


def _commit_in_parallel(starks, traces, config: StarkConfig, dev,
                        devices) -> list[PolynomialBatch | None]:
    """Every trace commitment at once, one thread and one kept CUDA
    stream a table (`parallel.blocks.side_stream`), each thread on its
    table's card. A batch allocated on a side stream is read later on the prover's stream (the current stream of
    its device here): each side stream is synchronised before its batch
    is used, and every tensor the batch keeps is recorded on the
    prover's stream, so that the caching allocator does not hand its
    memory out while that stream may still read it."""
    devs = table_devices(len(starks), dev, devices)
    prover_streams = {d: torch.cuda.current_stream(d)
                      for d in set(devs) if d.type == "cuda"}

    def commit(i: int):
        trace = traces[i]
        if trace is None:
            return None, 0.0
        d = devs[i]
        t0 = time.perf_counter()
        with side_stream(d, prover_streams.get(d), i):
            batch = PolynomialBatch.from_values(
                GF.from_u64(trace[starks[i].num_preprocessed:], d),
                rate_bits=config.rate_bits,
                cap_height=config.cap_height, hasher=config.hasher)
        if d.type == "cuda":
            for t in batch.tensors():
                t.record_stream(prover_streams[d])
        return batch, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(starks)) as pool:
        results = list(pool.map(commit, range(len(starks))))
    for stark, (batch, seconds) in zip(starks, results):
        if batch is not None:
            record(f"commit {stark.name} trace", seconds)
    return [batch for batch, _ in results]


def verify_all(starks: list[Stark], all_proof: AllProof,
               ctls: list[lookup.CrossTableLookup], config: StarkConfig,
               extra_looking_sums: dict[int, list[int]] | None = None,
               extra_looking_values: dict[int, list] | None = None,
               optional_tables: tuple[int, ...] = (),
               device=None) -> None:
    """Verify every table proof under the replayed transcript, then check
    every CTL's global sum: sum of looking totals (+ extra looking sums,
    keyed by CTL index, one value per challenge) == looked total.

    `extra_looking_values` maps a CTL index to raw value rows the
    VERIFIER contributes (e.g. the memory table's public-value writes);
    their logUp sums are computed here under the derived challenges —
    callers cannot inject arbitrary sums. `extra_looking_sums` is for
    lower-level harnesses that derive the sums themselves (the sponge
    scenario's CPU-side dispatch, `tables/scenarios.py`).

    A table with preprocessed columns has its program cap recomputed on
    `device` (CUDA when not given); no other table needs a device.

    `optional_tables` are the only table indices allowed to omit a proof;
    every other table MUST carry one — otherwise an all-None AllProof
    with degenerate 0==0 CTL sums verifies."""
    assert len(all_proof.proofs) == len(starks), "proof count mismatch"
    assert len(all_proof.table_in_use) == len(starks)
    for t, proof in enumerate(all_proof.proofs):
        assert all_proof.table_in_use[t] == (proof is not None), \
            f"table_in_use[{t}] inconsistent with supplied proofs"
        if proof is None and t not in optional_tables:
            raise AssertionError(f"missing proof for required table {t}")
    challenger = Challenger()
    caps = [p.trace_cap if p is not None else _zero_cap(config)
            for p in all_proof.proofs]
    observe_global(challenger, caps, all_proof.public_inputs)
    challenges = lookup.get_challenge_set(challenger, config.num_challenges)

    extra_looking_sums = dict(extra_looking_sums or {})
    for ci, rows in (extra_looking_values or {}).items():
        sums = []
        for beta, gamma in challenges.pairs:
            s = 0
            for row in rows:
                combined = 0
                gp = 1
                for v in row:
                    combined = host.fadd(combined,
                                         host.fmul(int(v) % host.P, gp))
                    gp = host.fmul(gp, gamma)
                s = host.fadd(s, host.finv(host.fadd(beta, combined)))
            sums.append(s)
        assert ci not in extra_looking_sums
        extra_looking_sums[ci] = sums

    for t, (stark, proof) in enumerate(zip(starks, all_proof.proofs)):
        if proof is None:
            continue
        groups = lookup.ctl_groups_for_table(ctls, t)
        verify_stark(stark, proof, config, challenger,
                     challenges=challenges, ctl_groups=groups,
                     observe_trace_cap=False, device=device)

    # ---- global CTL sum check ------------------------------------------
    totals = _collect_ctl_totals(all_proof, ctls, challenges)
    nc = len(challenges.pairs)
    for ci, ctl in enumerate(ctls):
        for c in range(nc):
            looking = totals.get((ci, "looking", c), 0)
            extra = extra_looking_sums.get(ci)
            if extra is not None:
                looking = host.fadd(looking, extra[c])
            looked = totals.get((ci, "looked", c), 0)
            assert looking == looked, \
                f"CTL '{ctl.name}' unbalanced (challenge {c})"


def _collect_ctl_totals(all_proof: AllProof, ctls, challenges):
    """Sum exported Z(first) totals into (ctl_index, side, challenge)
    buckets across tables. Unused tables contribute zero."""
    totals: dict = {}
    nc = len(challenges.pairs)
    for t, proof in enumerate(all_proof.proofs):
        groups = lookup.ctl_groups_for_table(ctls, t)
        if proof is None:
            continue
        zs = proof.openings.ctl_zs_first
        assert len(zs) == nc * len(groups), \
            f"table {t}: ctl_zs_first count mismatch"
        k = 0
        for c in range(nc):
            for ci, side, _views in groups:
                key = (ci, side, c)
                totals[key] = host.fadd(totals.get(key, 0), zs[k])
                k += 1
    return totals
