"""The verification program: verify_stark re-expressed as a tape.

Mirrors stark/verifier.py + stark/fri.py's verify path step for step —
same transcript order, same checks — but every field operation becomes a
VM row, every hash a Poseidon-table CTL, every proof element a witness
LOAD, and every data-dependent branch a bit-decomposed select. Proving
the resulting tape (recursion/system.py) therefore proves "a proof of
`stark` with these public inputs verifies under `config`" — the TPU-native
analog of the reference's recursive verifier circuit
(fixed_recursive_verifier.rs:110-141, verifier.rs:172-319).

Children may carry lookup/CTL aux columns and preprocessed columns;
`verify_all_tape` replays a whole AllStark transcript."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..field import host
from ..stark.config import StarkConfig
from ..stark.proof import StarkProof
from ..stark.stark import Stark, StarkFrame, ConstraintConsumer
from .vm import Cell, Tape
from . import tape_lib as tl

P = host.P
SHIFT = host.MULT_GENERATOR
INV2 = host.finv(2)


def _load_cap(t: Tape, cap) -> list[list[Cell]]:
    return [[t.load(int(v)) for v in digest] for digest in cap]


def _base_inv(t: Tape, x: Cell) -> Cell:
    """Hint-backed base-field inverse."""
    v = t.value(x)
    assert v != 0, "tape base inverse of zero"
    inv = t.load(host.finv(v))
    t.assert_eq(t.mul(x, inv), t.one())
    return inv


def _exp_pow2(t: Tape, x: tl.ECell, k: int) -> tl.ECell:
    """x^(2^k) by squaring."""
    for _ in range(k):
        x = tl.e_mul(t, x, x)
    return x


def _hash_or_noop(t: Tape, leaf: list[Cell]) -> list[Cell]:
    """merkle/host.py hash_or_noop: identity pad for <= 4 cells, else a
    rate-8 overwrite sponge."""
    if len(leaf) <= 4:
        return list(leaf) + [t.zero()] * (4 - len(leaf))
    state = [t.zero()] * 12
    for off in range(0, len(leaf), 8):
        chunk = leaf[off:off + 8]
        state = list(chunk) + state[len(chunk):]
        state = t.pose(state)
    return state[:4]


def _two_to_one(t: Tape, left: list[Cell], right: list[Cell]) -> list[Cell]:
    state = list(left) + list(right) + [t.zero()] * 4
    return t.pose(state)[:4]


def _merkle_verify(t: Tape, leaf: list[Cell], idx_bits: list[Cell],
                   path: list[list[Cell]], cap: list[list[Cell]]) -> None:
    """merkle/host.py verify_path on the tape: len(path) levels consume
    the low index bits (left/right selects), the rest select the cap
    entry."""
    digest = _hash_or_noop(t, leaf)
    for lvl, sib in enumerate(path):
        bit = idx_bits[lvl]
        left = [t.sel(bit, s, d) for s, d in zip(sib, digest)]
        right = [t.sel(bit, d, s) for d, s in zip(digest, sib)]
        digest = _two_to_one(t, left, right)
    cap_bits = idx_bits[len(path):]
    assert len(cap) == 1 << len(cap_bits), "cap size mismatch"
    want = tl.select_by_bits(t, cap_bits, [list(d) for d in cap]) \
        if cap_bits else list(cap[0])
    for d, w in zip(digest, want):
        t.assert_eq(d, w)


def _pow_g(t: Tape, bits: list[Cell], exps: list[int], g: int) -> Cell:
    """prod over i of (bit_i ? g^exps[i] : 1) — the bit-decomposed power
    g^(sum bit_i * exps[i])."""
    acc = None
    one = t.one()
    for b, e in zip(bits, exps):
        term = t.sel(b, t.const(host.fexp(g, e)), one)
        acc = term if acc is None else t.mul(acc, term)
    return acc if acc is not None else one


def _mod_reduce(t: Tape, c: Cell, log_m: int) -> list[Cell]:
    """value(c) mod 2^log_m with full integer soundness: c = q*2^log_m + r,
    q and r bit-decomposed, plus the no-wrap guard q*2^log_m + r < P
    (top 32 bits of q all-ones forces the rest to zero; P-1 =
    (2^32-1)*2^32). Returns r's bits (low first)."""
    v = t.value(c)
    q, r = divmod(v, 1 << log_m)
    qc = t.load(q)
    rc = t.load(r)
    qbits = tl.decompose_bits(t, qc, 64 - log_m)
    rbits = tl.decompose_bits(t, rc, log_m)
    t.assert_eq(t.arith(qc, t.one(), rc, c2=1 << log_m, c0=1), c)
    top = qbits[32 - log_m]
    for b in qbits[32 - log_m + 1:]:
        top = t.mul(top, b)
    low = t.scale(qbits[0], 1)
    for i in range(1, 32 - log_m):
        low = t.arith(qbits[i], t.one(), low, c2=1 << i, c0=1)
    t.assert_zero(t.mul(top, t.add(low, rc)))
    return rbits


@dataclass
class TapeStarkResult:
    """Cells a wrapped proof exposes to its caller."""
    public_inputs: list[Cell] = field(default_factory=list)
    zs_first: list[Cell] = field(default_factory=list)   # CTL Z exports
    trace_cap: list = field(default_factory=list)


def tape_challenge_set(t: Tape, ch: tl.TapeChallenger, num_challenges: int):
    """lookup.get_challenge_set twin: (beta, gamma) pairs as base-embedded
    ECells so the generic lookup-constraint code runs on the tape."""
    from ..stark.lookup import ChallengeSet
    return ChallengeSet(tuple(
        (tl.e_from_base(t, ch.get_challenge()),
         tl.e_from_base(t, ch.get_challenge()))
        for _ in range(num_challenges)))


def verify_stark_tape(t: Tape, stark: Stark, proof: StarkProof,
                      config: StarkConfig,
                      challenger: tl.TapeChallenger | None = None,
                      challenges=None,
                      ctl_groups=None,
                      observe_trace_cap: bool = True,
                      device=None) -> TapeStarkResult:
    """Lay down the verification of `proof` on the tape. Returns the
    child public-input cells (callers bind them to VM public inputs)
    plus CTL Z(first) export cells for the AllStark global sum check.
    Raises AssertionError while building if the proof is invalid — and
    the resulting constraints reject any forged witness for a bad proof.

    Mirrors verify_stark's two modes: single-table (observe everything
    here) and AllStark (caps/publics observed globally by the caller,
    shared `challenges`). A child with preprocessed columns (a wrap proof
    being wrapped again) has its program cap committed on `device`
    (CUDA when not given)."""
    from ..stark import lookup as lkp
    # The verifier-AIR replays Merkle paths with in-tape Poseidon; the
    # Keccak commitment config is outer-only (the reference recurses only
    # over PoseidonGoldilocksConfig proofs for the same reason).
    assert config.hasher == "poseidon", \
        "recursion wraps Poseidon-committed proofs only"
    fri_cfg = config.fri_config
    degree_bits = proof.degree_bits
    n = 1 << degree_bits
    ops = proof.openings
    groups = list(ctl_groups or [])
    lookups = stark.lookups()
    has_aux = bool(lookups or groups)
    assert not stark.known_columns(), \
        "known-column children are legacy; use the preprocessed oracle"
    assert len(ops.trace_local) == stark.num_columns
    assert len(ops.trace_next) == stark.num_columns
    npre = stark.num_preprocessed
    pre_cap_cells = None
    if npre:
        # The child's program cap is a verification-key CONSTANT of the
        # wrap program: FRI binds the openings to it for free — this is
        # what makes wrapping a wrap (self-recursion) possible.
        pre_cap = stark.preprocessed_batch(config, device).cap_ints()
        pre_cap_cells = [[t.const(int(v)) for v in d] for d in pre_cap]

    ch = challenger or tl.TapeChallenger(t)
    ch.compact()
    trace_cap = _load_cap(t, proof.trace_cap)
    pub_cells = [t.load(int(v)) for v in proof.public_inputs]
    if observe_trace_cap:
        ch.observe_cap(trace_cap)
        ch.observe_many(pub_cells)
    if pre_cap_cells is not None:
        ch.observe_cap(pre_cap_cells)
    aux_cap = None
    aux_local: list = []
    aux_next: list = []
    zs_first: list = []
    z_idxs: list = []
    if has_aux:
        if challenges is None:
            challenges = tape_challenge_set(t, ch, config.num_challenges)
        num_aux = lkp.num_aux_columns(lookups, groups,
                                      len(challenges.pairs))
        assert len(ops.aux_local) == num_aux
        assert len(ops.aux_next) == num_aux
        aux_cap = _load_cap(t, proof.aux_cap)
        ch.observe_cap(aux_cap)
        aux_local = [tl.e_load(t, v) for v in ops.aux_local]
        aux_next = [tl.e_load(t, v) for v in ops.aux_next]
        z_idxs = lkp.ctl_z_first_indices(lookups, groups, challenges)
        assert len(ops.ctl_zs_first) == len(z_idxs)
        zs_first = [t.load(int(v)) for v in ops.ctl_zs_first]
    alphas = ch.get_n_challenges(config.num_challenges)   # base Cells
    quotient_cap = _load_cap(t, proof.quotient_cap)
    ch.observe_cap(quotient_cap)
    zeta = ch.get_extension_challenge()                   # ECell

    # ---- constraint identity at zeta -----------------------------------
    trace_local = [tl.e_load(t, v) for v in ops.trace_local]
    trace_next = [tl.e_load(t, v) for v in ops.trace_next]
    quotient = [tl.e_load(t, v) for v in ops.quotient]

    g_n = host.primitive_root_of_unity(degree_bits)
    g_last = host.fexp(g_n, n - 1)
    zeta_pow_n = _exp_pow2(t, zeta, degree_bits)
    zh = zeta_pow_n - 1
    z_last = zeta - t.const(g_last)
    n_inv = host.finv(n)
    l_first = tl.e_scalar(
        t, tl.e_mul(t, zh, tl.e_inv(t, zeta - 1)), n_inv)
    l_last = tl.e_scalar(
        t, tl.e_mul(t, zh, tl.e_inv(t, z_last)),
        host.fmul(n_inv, g_last))

    zero_e = tl.ECell(t.zero(), t.zero(), t)
    frame = StarkFrame(local=trace_local, next_=trace_next,
                       public_inputs=pub_cells,
                       aux_local=aux_local, aux_next=aux_next)
    cc = ConstraintConsumer(alphas=alphas, zero=zero_e, z_last=z_last,
                            lagrange_first=l_first, lagrange_last=l_last)
    stark.eval(frame, cc)
    if has_aux:
        from ..stark.lookup import eval_aux_constraints
        eval_aux_constraints(lookups, groups, challenges, frame, cc)

    chunks_per = 1 << config.rate_bits
    for i, acc in enumerate(cc.accs):
        q = quotient[i * chunks_per:(i + 1) * chunks_per]
        rhs = zero_e
        for c in reversed(q):
            rhs = tl.e_add(t, tl.e_mul(t, rhs, zeta_pow_n), c)
        rhs = tl.e_mul(t, rhs, zh)
        tl.e_assert_eq(t, acc, rhs)

    # ---- FRI -------------------------------------------------------------
    # observation order mirrors StarkOpeningSet.observe_order()
    for group in (trace_local, trace_next, aux_local, aux_next):
        for e in group:
            ch.observe_extension(e)
    ch.observe_many(zs_first)
    for e in quotient:
        ch.observe_extension(e)
    alpha = ch.get_extension_challenge()

    zeta_next = zeta * t.const(g_n)
    oracle_caps = []
    oracle_widths = []
    zeta_entries, next_entries = [], []
    if npre:
        oracle_caps.append(pre_cap_cells)
        oracle_widths.append(npre)
        zeta_entries += [(0, i, v)
                         for i, v in enumerate(trace_local[:npre])]
        next_entries += [(0, i, v)
                         for i, v in enumerate(trace_next[:npre])]
    tidx = len(oracle_caps)
    oracle_caps.append(trace_cap)
    oracle_widths.append(stark.num_columns - npre)
    zeta_entries += [(tidx, i, v)
                     for i, v in enumerate(trace_local[npre:])]
    next_entries += [(tidx, i, v)
                     for i, v in enumerate(trace_next[npre:])]
    if has_aux:
        aidx = len(oracle_caps)
        oracle_caps.append(aux_cap)
        oracle_widths.append(len(aux_local))
        zeta_entries += [(aidx, i, v) for i, v in enumerate(aux_local)]
        next_entries += [(aidx, i, v) for i, v in enumerate(aux_next)]
    qidx = len(oracle_caps)
    oracle_caps.append(quotient_cap)
    oracle_widths.append(len(ops.quotient))
    zeta_entries += [(qidx, j, v) for j, v in enumerate(quotient)]
    batches = [(zeta, zeta_entries), (zeta_next, next_entries)]
    if has_aux and zs_first:
        batches.append((tl.e_const(t, (1, 0)),
                        [(aidx, i, tl.e_from_base(t, zc))
                         for i, zc in zip(z_idxs, zs_first)]))
    _verify_fri_tape(t, ch, oracle_caps, oracle_widths, batches, alpha,
                     degree_bits, proof.fri_proof, fri_cfg)
    return TapeStarkResult(public_inputs=pub_cells, zs_first=zs_first,
                           trace_cap=trace_cap)


def verify_all_tape(t: Tape, starks, all_proof, ctls,
                    config: StarkConfig,
                    extra_looking_values: dict | None = None,
                    deferred_extra=None, device=None) -> tuple:
    """Tape twin of stark/multi.py verify_all: global cap observation,
    shared challenge set, per-table verification, and the cross-table
    logUp sum check. Which tables are in use is part of the wrap
    program's shape (the reference bakes the same choice into its
    per-degree recursive circuits).

    `extra_looking_values[ci]` are rows of base Cells the *program*
    contributes to CTL ci (e.g. public-value memory writes,
    verifier.rs:319): their logUp sums are computed in-tape under the
    derived challenges. Returns (global public-input cells, per-table
    TapeStarkResult-or-None list)."""
    from ..stark import lookup as lkp
    ch = tl.TapeChallenger(t)
    cap_len = 1 << config.cap_height
    caps = []
    for proof in all_proof.proofs:
        if proof is None:
            caps.append([[t.zero()] * 4 for _ in range(cap_len)])
        else:
            caps.append(_load_cap(t, proof.trace_cap))
    pub_cells = [t.load(int(v)) for v in all_proof.public_inputs]
    for cap in caps:
        ch.observe_cap(cap)
    ch.observe_many(pub_cells)
    challenges = tape_challenge_set(t, ch, config.num_challenges)
    nc = len(challenges.pairs)
    if deferred_extra is not None:
        # extra rows built FROM the public-input cells (e.g. the memory
        # PV writes of recursion/aggregate.py)
        assert extra_looking_values is None
        extra_looking_values = deferred_extra(pub_cells)

    totals: dict = {}
    results: list = []
    for ti, (stark, proof) in enumerate(zip(starks, all_proof.proofs)):
        if proof is None:
            results.append(None)
            continue
        groups = lkp.ctl_groups_for_table(ctls, ti)
        res = verify_stark_tape(t, stark, proof, config, challenger=ch,
                                challenges=challenges, ctl_groups=groups,
                                observe_trace_cap=False, device=device)
        results.append(res)
        assert len(res.zs_first) == nc * len(groups)
        k = 0
        for c in range(nc):
            for ci, side, _views in groups:
                key = (ci, side, c)
                z = res.zs_first[k]
                prev = totals.get(key)
                totals[key] = z if prev is None else t.add(prev, z)
                k += 1

    # program-contributed extra looking sums (in-tape base-field logUp;
    # beta/gamma embed base challenges, so everything stays base)
    extra_sums: dict = {}
    for ci, rows in (extra_looking_values or {}).items():
        sums = []
        for beta, gamma in challenges.pairs:
            s = None
            for row in rows:
                combined = row[0]
                gp = gamma.a
                for v in row[1:]:
                    combined = t.arith(v, gp, combined, c2=1, c0=1)
                    gp = t.mul(gp, gamma.a)
                term = _base_inv(t, t.add(beta.a, combined))
                s = term if s is None else t.add(s, term)
            sums.append(s)
        extra_sums[ci] = sums

    zero = t.zero()
    for ci in range(len(ctls)):
        for c in range(nc):
            looking = totals.get((ci, "looking", c), zero)
            extra = extra_sums.get(ci)
            if extra is not None and extra[c] is not None:
                looking = t.add(looking, extra[c])
            looked = totals.get((ci, "looked", c), zero)
            t.assert_eq(looking, looked)
    return pub_cells, results


def _verify_fri_tape(t: Tape, ch: tl.TapeChallenger, oracle_caps,
                     oracle_widths, batches, alpha, degree_bits,
                     proof, config) -> None:
    log_m = degree_bits + config.rate_bits
    m = 1 << log_m
    arities = config.reduction_arity_bits(degree_bits)
    assert len(proof.commit_phase_caps) == len(arities)

    cap_h0 = (len(oracle_caps[0]) - 1).bit_length()
    init_path_len = log_m - cap_h0
    step_shapes = []
    cur_lm = log_m
    for ab, cap in zip(arities, proof.commit_phase_caps):
        n_leaves_log = cur_lm - ab
        cap_h = min(cap_h0, n_leaves_log)
        step_shapes.append((ab, n_leaves_log - cap_h, 1 << cap_h))
        assert len(cap) == 1 << cap_h
        cur_lm -= ab

    betas = []
    commit_caps = []
    for cap in proof.commit_phase_caps:
        cc_cells = _load_cap(t, cap)
        commit_caps.append(cc_cells)
        ch.observe_cap(cc_cells)
        betas.append(ch.get_extension_challenge())
    final_poly = [tl.e_load(t, (a, b)) for a, b in proof.final_poly]
    for e in final_poly:
        ch.observe_extension(e)

    pow_witness = t.load(proof.pow_witness)
    ch.observe(pow_witness)
    pow_response = ch.get_challenge()
    if config.proof_of_work_bits > 0:
        # response < 2^(64 - bits): bit-decompose into that many bits
        tl.decompose_bits(t, pow_response, 64 - config.proof_of_work_bits)

    idx_cells = ch.get_n_challenges(config.num_query_rounds)
    for idx_cell, rnd in zip(idx_cells, proof.query_rounds):
        idx_bits = _mod_reduce(t, idx_cell, log_m)
        _verify_query_tape(t, idx_bits, rnd, oracle_caps, oracle_widths,
                           batches, alpha, betas, commit_caps, final_poly,
                           log_m, arities, init_path_len, step_shapes)


def _verify_query_tape(t: Tape, idx_bits, rnd, oracle_caps, oracle_widths,
                       batches, alpha, betas, commit_caps, final_poly,
                       log_m, arities, init_path_len, step_shapes) -> None:
    # -- initial tree openings --------------------------------------------
    assert len(rnd.initial.leaves) == len(oracle_caps)
    assert len(rnd.steps) == len(arities)
    leaf_cells = []
    for leaf, path, cap, width in zip(rnd.initial.leaves,
                                      rnd.initial.paths,
                                      oracle_caps, oracle_widths):
        assert len(leaf) == width
        assert len(path) == init_path_len
        lc = [t.load(int(v)) for v in leaf]
        pc = [[t.load(int(v)) for v in sib] for sib in path]
        _merkle_verify(t, lc, idx_bits, pc, cap)
        leaf_cells.append(lc)

    # -- reconstruct G(x) ---------------------------------------------------
    g = host.primitive_root_of_unity(log_m)
    # x = SHIFT * g^bitrev(idx): bit i of idx carries exponent
    # 2^(log_m-1-i) after reversal
    exps = [1 << (log_m - 1 - i) for i in range(log_m)]
    x = t.scale(_pow_g(t, idx_bits, exps, g), SHIFT)
    gx = tl.ECell(t.zero(), t.zero(), t)
    apow = tl.e_const(t, (1, 0))
    for point, entries in batches:
        # explicit (oracle, leaf position) indices, as in fri.py:430-440
        num = tl.ECell(t.zero(), t.zero(), t)
        denom = tl.e_sub(t, tl.e_from_base(t, x), point)
        inv_denom = tl.e_inv(t, denom)
        for oi, pos, yv in entries:
            pv = leaf_cells[oi][pos]
            diff = tl.e_sub(t, tl.e_from_base(t, pv), yv)
            num = tl.e_add(t, num, tl.e_mul(t, apow, diff))
            apow = tl.e_mul(t, apow, alpha)
        gx = tl.e_add(t, gx, tl.e_mul(t, num, inv_denom))

    # -- fold chain ----------------------------------------------------------
    eval_cur = gx
    bits_cur = idx_bits
    cur_log_m = log_m
    shift = SHIFT
    for step, shape, beta, cap in zip(rnd.steps, step_shapes, betas,
                                      commit_caps):
        ab, step_path_len, _cl = shape
        arity = 1 << ab
        assert len(step.coset_values) == arity
        coset_bits = bits_cur[ab:]
        slot_bits = bits_cur[:ab]
        vs = [tl.e_load(t, tuple(v)) for v in step.coset_values]
        opened = tl.select_by_bits(t, slot_bits, vs)
        tl.e_assert_eq(t, opened, eval_cur)
        leaf_flat = [c for v in vs for c in (v.a, v.b)]
        path = [[t.load(int(x_)) for x_ in sib] for sib in step.path]
        assert len(path) == step_path_len
        _merkle_verify(t, leaf_flat, coset_bits, path, cap)

        # xs[p] = shift * g_k^bitrev(coset_idx*arity + p, cur_log_m):
        # the p (low) bits are structural, the coset bits are cells
        gk = host.primitive_root_of_unity(cur_log_m)
        coset_exps = [1 << (cur_log_m - 1 - (ab + j))
                      for j in range(cur_log_m - ab)]
        base = _pow_g(t, coset_bits, coset_exps, gk)
        xs = []
        for p in range(arity):
            cp = 0
            for j in range(ab):
                if (p >> j) & 1:
                    cp += 1 << (cur_log_m - 1 - j)
            xs.append(t.scale(base, host.fmul(shift, host.fexp(gk, cp))))
        bk = beta
        while len(vs) > 1:
            nxs, nvs = [], []
            for i in range(len(vs) // 2):
                v0, v1 = vs[2 * i], vs[2 * i + 1]
                x0 = xs[2 * i]
                s = tl.e_scalar(t, tl.e_add(t, v0, v1), INV2)
                x0inv = _base_inv(t, x0)
                d = tl.e_mul_base(t, tl.e_scalar(
                    t, tl.e_sub(t, v0, v1), INV2), x0inv)
                nvs.append(tl.e_add(t, s, tl.e_mul(t, bk, d)))
                nxs.append(t.mul(x0, x0))
            xs, vs = nxs, nvs
            bk = tl.e_mul(t, bk, bk)
        eval_cur = vs[0]
        bits_cur = coset_bits
        cur_log_m -= ab
        shift = host.fexp(shift, arity)

    # -- final polynomial ------------------------------------------------------
    gk = host.primitive_root_of_unity(cur_log_m)
    exps = [1 << (cur_log_m - 1 - i) for i in range(cur_log_m)]
    x_f = t.scale(_pow_g(t, bits_cur, exps, gk), shift)
    acc = tl.ECell(t.zero(), t.zero(), t)
    for c in reversed(final_poly):
        acc = tl.e_add(t, tl.e_mul_base(t, acc, x_f), c)
    tl.e_assert_eq(t, acc, eval_cur)
