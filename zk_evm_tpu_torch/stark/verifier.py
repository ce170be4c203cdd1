"""Single-table STARK verifier (host-exact python ints).

Independent implementation of the checks — shares no device code with the
prover, mirroring the reference's verify_stark_proof_with_challenges path.
Tables with lookups or cross-table lookups come in a later slice."""

from __future__ import annotations

from ..field import HExt, host
from ..challenger import Challenger
from .config import StarkConfig
from .stark import Stark, StarkFrame, ConstraintConsumer
from .proof import StarkProof
from . import domains, fri


def verify_stark(stark: Stark, proof: StarkProof, config: StarkConfig,
                 challenger: Challenger, ctl_groups=None,
                 expected_public_inputs: list[int] | None = None) -> None:
    """Raises AssertionError on any failure. `challenger` must be at the
    same transcript position as the prover's on entry. The proof's public
    inputs are observed in the transcript, binding them to every
    challenge; callers with an expectation pass
    `expected_public_inputs`."""
    if stark.lookups() or ctl_groups:
        raise NotImplementedError("lookups: later slice")
    if stark.num_preprocessed:
        raise NotImplementedError("preprocessed columns: later slice")
    fri_cfg = config.fri_config
    degree_bits = proof.degree_bits
    n = 1 << degree_bits
    ops = proof.openings

    assert len(ops.trace_local) == stark.num_columns
    assert len(ops.trace_next) == stark.num_columns
    assert len(ops.quotient) == config.num_challenges << config.rate_bits
    assert not (ops.aux_local or ops.aux_next or ops.ctl_zs_first), \
        "aux openings in a proof without lookups"
    assert proof.aux_cap is None, "aux cap in a proof without lookups"
    assert len(proof.public_inputs) == stark.num_public_inputs, \
        "public input count mismatch"
    if expected_public_inputs is not None:
        assert list(proof.public_inputs) == list(expected_public_inputs), \
            "public inputs mismatch"
    cap_len = 1 << config.cap_height
    for cap in (proof.trace_cap, proof.quotient_cap):
        assert len(cap) == cap_len, "cap size mismatch"

    challenger.compact()
    challenger.observe_cap(proof.trace_cap)
    challenger.observe_elements(proof.public_inputs)
    alphas = challenger.get_n_challenges(config.num_challenges)
    challenger.observe_cap(proof.quotient_cap)
    zeta = challenger.get_extension_challenge()
    g = host.primitive_root_of_unity(degree_bits)
    zeta_next = host.emul(zeta, (g, 0))

    # ---- constraint identity at zeta -----------------------------------
    z_last, l_first, l_last, zh = domains.selectors_at_point(
        zeta, degree_bits)
    frame = StarkFrame(
        local=[HExt(v) for v in ops.trace_local],
        next_=[HExt(v) for v in ops.trace_next],
        public_inputs=list(proof.public_inputs))
    cc = ConstraintConsumer(
        alphas=alphas, zero=HExt.zero(), z_last=HExt(z_last),
        lagrange_first=HExt(l_first), lagrange_last=HExt(l_last))
    stark.eval(frame, cc)

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

    # ---- FRI (oracle order: [trace, quotient]) --------------------------
    challenger.observe_elements(ops.observe_order())
    alpha = challenger.get_extension_challenge()
    num_wit = stark.num_columns
    trace_entries = [(0, i) for i in range(num_wit)]
    batches = [
        fri.FriOpeningBatch(
            point=zeta,
            entries=trace_entries + [(1, j) for j in
                                     range(len(ops.quotient))],
            values=list(ops.trace_local) + list(ops.quotient)),
        fri.FriOpeningBatch(point=zeta_next, entries=trace_entries,
                            values=list(ops.trace_next)),
    ]
    fri.verify_fri([proof.trace_cap, proof.quotient_cap], batches, alpha,
                   degree_bits, proof.fri_proof, challenger, fri_cfg,
                   oracle_widths=[num_wit, len(ops.quotient)],
                   hasher=config.hasher)
