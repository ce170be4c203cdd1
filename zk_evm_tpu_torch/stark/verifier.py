"""Single-table STARK verifier (host-exact python ints).

Independent implementation of the checks — shares no device code with the
prover, mirroring the reference's verify_stark_proof_with_challenges path,
lookups and cross-table lookups included. A table's preprocessed
(program) columns are bound through FRI by the cap the verifier commits
from the program itself; known columns by their recomputed openings."""

from __future__ import annotations

from ..field import HExt, host
from ..challenger import Challenger
from .config import StarkConfig
from .stark import Stark, StarkFrame, ConstraintConsumer
from .proof import StarkProof
from . import domains, fri, lookup


def verify_stark(stark: Stark, proof: StarkProof, config: StarkConfig,
                 challenger: Challenger,
                 challenges: lookup.ChallengeSet | None = None,
                 ctl_groups=None,
                 observe_trace_cap: bool = True,
                 expected_public_inputs: list[int] | None = None,
                 device=None) -> None:
    """Raises AssertionError on any failure. `challenger` must be at the
    same transcript position as the prover's on entry.

    Single-table mode (observe_trace_cap=True) observes the proof's
    public inputs in the transcript, binding them to every challenge; in
    AllStark mode the caller observes them globally. Callers with an
    expectation pass `expected_public_inputs`. The program cap of a table
    with preprocessed columns is committed on `device` (CUDA when not
    given)."""
    fri_cfg = config.fri_config
    degree_bits = proof.degree_bits
    n = 1 << degree_bits
    ops = proof.openings
    groups = list(ctl_groups or [])
    lookups = stark.lookups()
    has_aux = bool(lookups or groups)

    assert len(ops.trace_local) == stark.num_columns
    assert len(ops.trace_next) == stark.num_columns
    assert len(ops.quotient) == config.num_challenges << config.rate_bits
    assert len(proof.public_inputs) == stark.num_public_inputs, \
        "public input count mismatch"
    if expected_public_inputs is not None:
        assert list(proof.public_inputs) == list(expected_public_inputs), \
            "public inputs mismatch"
    cap_len = 1 << config.cap_height
    for cap in (proof.trace_cap, proof.quotient_cap):
        assert len(cap) == cap_len, "cap size mismatch"

    npre = stark.num_preprocessed
    pre_batch = stark.preprocessed_batch(config, device) if npre else None
    assert (pre_batch is None) == (npre == 0)
    pre_cap = pre_batch.cap_ints() if pre_batch is not None else None

    challenger.compact()
    if observe_trace_cap:
        challenger.observe_cap(proof.trace_cap)
        challenger.observe_elements(proof.public_inputs)
    if pre_cap is not None:
        # verification-key constant: the verifier computes this cap from
        # the program itself, binding the preprocessed oracle via FRI
        challenger.observe_cap(pre_cap)
    if has_aux:
        if challenges is None:
            challenges = lookup.get_challenge_set(
                challenger, config.num_challenges)
        num_aux = lookup.num_aux_columns(lookups, groups,
                                         len(challenges.pairs))
        assert len(ops.aux_local) == num_aux
        assert len(ops.aux_next) == num_aux
        assert proof.aux_cap is not None
        assert len(proof.aux_cap) == cap_len, "aux cap size mismatch"
        challenger.observe_cap(proof.aux_cap)
        z_idxs = lookup.ctl_z_first_indices(lookups, groups, challenges)
        assert len(ops.ctl_zs_first) == len(z_idxs)
    else:
        assert not (ops.aux_local or ops.aux_next or ops.ctl_zs_first), \
            "aux openings in a proof without lookups"
        assert proof.aux_cap is None, "aux cap in a proof without lookups"
    alphas = challenger.get_n_challenges(config.num_challenges)
    challenger.observe_cap(proof.quotient_cap)
    zeta = challenger.get_extension_challenge()
    g = host.primitive_root_of_unity(degree_bits)
    zeta_next = host.emul(zeta, (g, 0))

    # ---- known (program) columns: bind openings to the known values -----
    known = stark.known_columns()
    if known:
        from ..recursion.known import eval_known_at
        cache: dict = {}
        for c, vals in known.items():
            assert len(vals) == n, "known column length mismatch"
            assert tuple(ops.trace_local[c]) == \
                eval_known_at(vals, zeta, cache), \
                f"known column {c} opening mismatch at zeta"
            assert tuple(ops.trace_next[c]) == \
                eval_known_at(vals, zeta_next, cache), \
                f"known column {c} opening mismatch at zeta*g"

    # ---- constraint identity at zeta -----------------------------------
    z_last, l_first, l_last, zh = domains.selectors_at_point(
        zeta, degree_bits)
    frame = StarkFrame(
        local=[HExt(v) for v in ops.trace_local],
        next_=[HExt(v) for v in ops.trace_next],
        aux_local=[HExt(v) for v in ops.aux_local],
        aux_next=[HExt(v) for v in ops.aux_next],
        public_inputs=list(proof.public_inputs))
    cc = ConstraintConsumer(
        alphas=alphas, zero=HExt.zero(), z_last=HExt(z_last),
        lagrange_first=HExt(l_first), lagrange_last=HExt(l_last))
    stark.eval(frame, cc)
    if has_aux:
        lookup.eval_aux_constraints(lookups, groups, challenges, frame, cc)

    zeta_pow_n = HExt(host.eexp(zeta, n))
    chunks_per = 1 << config.rate_bits
    for i, acc in enumerate(cc.accs):
        q = [HExt(v) for v in
             ops.quotient[i * chunks_per:(i + 1) * chunks_per]]
        rhs = HExt.zero()
        for c in reversed(q):
            rhs = rhs * zeta_pow_n + c
        rhs = rhs * HExt(zh)
        assert acc == rhs, f"constraint identity failed (challenge {i})"

    # ---- FRI (oracle order: [pre?, trace, aux?, quotient]) ---------------
    challenger.observe_elements(ops.observe_order())
    alpha = challenger.get_extension_challenge()
    num_wit = stark.num_columns - npre
    oracle_caps = []
    oracle_widths = []
    zeta_entries, next_entries = [], []
    if pre_cap is not None:
        oracle_caps.append(pre_cap)
        oracle_widths.append(npre)
        zeta_entries += [(0, i) for i in range(npre)]
        next_entries += [(0, i) for i in range(npre)]
    tidx = len(oracle_caps)
    oracle_caps.append(proof.trace_cap)
    oracle_widths.append(num_wit)
    zeta_entries += [(tidx, i) for i in range(num_wit)]
    next_entries += [(tidx, i) for i in range(num_wit)]
    zeta_values = list(ops.trace_local)
    next_values = list(ops.trace_next)
    if has_aux:
        aidx = len(oracle_caps)
        num_aux = len(ops.aux_local)
        oracle_caps.append(proof.aux_cap)
        oracle_widths.append(num_aux)
        aux_entries = [(aidx, i) for i in range(num_aux)]
        zeta_entries += aux_entries
        zeta_values += list(ops.aux_local)
        next_entries += aux_entries
        next_values += list(ops.aux_next)
    qidx = len(oracle_caps)
    oracle_caps.append(proof.quotient_cap)
    oracle_widths.append(len(ops.quotient))
    zeta_entries += [(qidx, j) for j in range(len(ops.quotient))]
    zeta_values += list(ops.quotient)
    batches = [
        fri.FriOpeningBatch(point=zeta, entries=zeta_entries,
                            values=zeta_values),
        fri.FriOpeningBatch(point=zeta_next, entries=next_entries,
                            values=next_values),
    ]
    if has_aux and ops.ctl_zs_first:
        batches.append(fri.FriOpeningBatch(
            point=(1, 0),
            entries=[(aidx, i) for i in z_idxs],
            values=[(v, 0) for v in ops.ctl_zs_first]))
    fri.verify_fri(oracle_caps, batches, alpha, degree_bits,
                   proof.fri_proof, challenger, fri_cfg,
                   oracle_widths=oracle_widths, hasher=config.hasher)
