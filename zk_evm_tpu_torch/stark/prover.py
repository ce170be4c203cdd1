"""Single-table STARK prover.

The device (the trace tensors' device, given by `device=`) does all O(n)
and larger work: commitments (NTT + Merkle), whole-LDE constraint
evaluation, quotient interpolation, FRI. The host does transcript
sequencing only. Tables with lookups or cross-table lookups, whose
auxiliary logUp columns come in a later slice, are refused.
"""

from __future__ import annotations

import numpy as np

from ..field import GF, host
from .. import ntt
from ..challenger import Challenger
from ..timing import timed
from .config import StarkConfig
from .poly_batch import PolynomialBatch
from .stark import Stark, StarkFrame, StackingConsumer
from .proof import StarkProof, StarkOpeningSet
from . import domains, fri


def _quotient_chunks(stark: Stark, trace_batch: PolynomialBatch,
                     alphas: list[int], config: StarkConfig,
                     public_inputs: list[int]) -> GF:
    """Evaluate the constraint composition over the LDE coset and return
    quotient chunk coefficients, shape (num_challenges << rate_bits, n).

    One eager pass with the stacked fold: every constraint's values over
    the coset are stacked, folded per challenge in one weighted sum,
    divided by Z_H and interpolated back to coefficients."""
    degree_bits = trace_batch.degree.bit_length() - 1
    rate_bits = config.rate_bits
    log_m = degree_bits + rate_bits
    m = 1 << log_m
    lde = trace_batch.lde                       # (cols, m) bitrev
    dev = lde.device
    sel = domains.selector_tables_bitrev(degree_bits, rate_bits)
    frame = StarkFrame(
        local=lde,
        next_=lde.take(domains.next_row_perm_bitrev(log_m, rate_bits),
                       axis=-1),
        public_inputs=list(public_inputs),
        params=tuple(GF.const(p, device=dev) for p in stark.proof_params()))
    cc = StackingConsumer(
        alphas=alphas, zero=GF.zeros((m,), dev),
        z_last=GF.from_u64(sel["z_last"], dev),
        lagrange_first=GF.from_u64(sel["l_first"], dev),
        lagrange_last=GF.from_u64(sel["l_last"], dev))
    stark.eval(frame, cc)
    cc.finalize()
    zh_inv = GF.from_u64(sel["zh_inv"], dev)
    q_vals = GF.stack([acc * zh_inv for acc in cc.accs], axis=0)
    coeffs = ntt.coset_ifft_from_bitrev(q_vals)          # (nc, m)
    return coeffs.reshape(q_vals.shape[0] << rate_bits, 1 << degree_bits)


def prove_stark(stark: Stark, trace: np.ndarray, config: StarkConfig,
                challenger: Challenger,
                public_inputs: list[int] | None = None,
                ctl_groups=None, device=None,
                trace_batch: PolynomialBatch | None = None) -> StarkProof:
    """Prove one table whose (num_columns, n) uint64 trace is `trace`, on
    `device` (default CPU). The proof depends only on the trace, config
    and public inputs: it is the same on every device.

    A caller that has already committed the trace passes `trace_batch`;
    the proof then runs on that batch's device."""
    if stark.lookups() or ctl_groups:
        raise NotImplementedError("lookups: later slice")
    if stark.num_preprocessed:
        raise NotImplementedError("preprocessed columns: later slice")
    public_inputs = public_inputs or []
    n = trace.shape[1]
    degree_bits = n.bit_length() - 1
    assert 1 << degree_bits == n
    assert trace.shape[0] == stark.num_columns
    fri_cfg = config.fri_config

    if trace_batch is None:
        with timed("commit trace"):
            trace_batch = PolynomialBatch.from_values(
                GF.from_u64(trace, device), rate_bits=config.rate_bits,
                cap_height=config.cap_height, hasher=config.hasher)
    trace_cap = trace_batch.cap_ints()

    init_state = challenger.compact()
    challenger.observe_cap(trace_cap)
    # bind single-table public inputs into the transcript
    challenger.observe_elements(public_inputs)

    # 1. constraint-folding challenges + quotient commitment
    alphas = challenger.get_n_challenges(config.num_challenges)
    with timed("evaluate quotient"):
        chunks = _quotient_chunks(stark, trace_batch, alphas, config,
                                  public_inputs)
    with timed("commit quotient"):
        quotient_batch = PolynomialBatch.from_coeffs(
            chunks, rate_bits=config.rate_bits,
            cap_height=config.cap_height, hasher=config.hasher)
        quotient_cap = quotient_batch.cap_ints()
    challenger.observe_cap(quotient_cap)

    # 2. openings at zeta / zeta*g
    zeta = challenger.get_extension_challenge()
    g = host.primitive_root_of_unity(degree_bits)
    zeta_next = host.emul(zeta, (g, 0))
    with timed("openings"):
        t_open = trace_batch.open_at([zeta, zeta_next])
        q_open = quotient_batch.open_at([zeta])
    openings = StarkOpeningSet(
        trace_local=[tuple(map(int, v)) for v in t_open[0]],
        trace_next=[tuple(map(int, v)) for v in t_open[1]],
        aux_local=[], aux_next=[], ctl_zs_first=[],
        quotient=[tuple(map(int, v)) for v in q_open[0]])
    challenger.observe_elements(openings.observe_order())

    # 3. FRI batched opening proof (oracle order: [trace, quotient])
    alpha = challenger.get_extension_challenge()
    oracles = [trace_batch, quotient_batch]
    trace_entries = [(0, i) for i in range(trace_batch.num_polys)]
    batches = [
        fri.FriOpeningBatch(
            point=zeta,
            entries=trace_entries + [(1, j) for j in
                                     range(quotient_batch.num_polys)],
            values=openings.trace_local + openings.quotient),
        fri.FriOpeningBatch(point=zeta_next, entries=trace_entries,
                            values=list(openings.trace_next)),
    ]
    with timed("FRI"):
        fri_proof = fri.prove_fri(oracles, batches, alpha, degree_bits,
                                  challenger, fri_cfg,
                                  hasher=config.hasher)

    return StarkProof(degree_bits=degree_bits, trace_cap=trace_cap,
                      aux_cap=None, quotient_cap=quotient_cap,
                      openings=openings, fri_proof=fri_proof,
                      init_challenger_state=init_state,
                      public_inputs=list(public_inputs))
