"""Batched FRI opening proofs: device prover + host verifier.

Protocol shape follows plonky2's FRI as driven by starky: rate 2x, fold
arity 2^4 down to a 2^5-coefficient final polynomial, 84 queries, 16-bit
grinding at the standard config.

Device work (on the oracles' device): the combined low-degree witness
G(X) over the whole LDE, every fold step, the commit-phase Merkle trees,
and the proof-of-work search (one batched Poseidon permutation over 2^18
candidate witnesses, the permute kernel on CUDA). Host work: transcript
sequencing and per-query decommitment extraction.
"""

from __future__ import annotations

from dataclasses import dataclass

import copy
import operator

import numpy as np

from ..field import GF, GFE, host, np_field
from ..hash import poseidon
from ..merkle import MerkleTree, build_commitment_tree, paths_verifier
from ..challenger import Challenger
from .config import FriConfig
from ..ntt.ntt import bit_reverse_indices, ifft
from .poly_batch import PolynomialBatch

INV2 = host.finv(2)


# ---------------------------------------------------------------------------
# Proof containers (host ints — serializable)
# ---------------------------------------------------------------------------

@dataclass
class FriInitialProof:
    """Per-oracle opening at one query index: leaf values + Merkle path."""
    leaves: list[list[int]]            # [oracle][poly] values at the index
    paths: list[list[list[int]]]       # [oracle][level][4] sibling digests


@dataclass
class FriQueryStep:
    coset_values: list[tuple[int, int]]   # 2^arity extension values
    path: list[list[int]]


@dataclass
class FriQueryRound:
    initial: FriInitialProof
    steps: list[FriQueryStep]


@dataclass
class FriProof:
    commit_phase_caps: list[list[list[int]]]
    final_poly: list[tuple[int, int]]     # coefficients, low-first
    pow_witness: int
    query_rounds: list[FriQueryRound]


@dataclass
class FriOpeningBatch:
    """One opening point and the (oracle, poly) entries opened there, in
    transcript order. `values` are the claimed evaluations."""
    point: tuple[int, int]
    entries: list[tuple[int, int]]        # (oracle_index, poly_index)
    values: list[tuple[int, int]]


# ---------------------------------------------------------------------------
# Domain tables (numpy, cached by callers via functools if needed)
# ---------------------------------------------------------------------------

def _bitrev_perm(logn: int) -> np.ndarray:
    return bit_reverse_indices(logn)


def coset_points_bitrev(log_m: int, shift: int) -> np.ndarray:
    """x_i = shift * g_m^{br(i)} for the full domain, uint64."""
    pows = np_field.mul(np_field.powers(host.primitive_root_of_unity(log_m),
                                        1 << log_m),
                        np.uint64(shift))
    return pows[_bitrev_perm(log_m)]


def _pair_x_inv_bitrev(log_m: int, shift: int) -> np.ndarray:
    """(x_pair)^{-1} for each butterfly pair of a size-2^log_m bitrev array:
    pair i sits at natural index br_{m/2}(i), x = shift * g_m^{br(i)}."""
    g_inv = host.finv(host.primitive_root_of_unity(log_m))
    pows = np_field.mul(np_field.powers(g_inv, 1 << (log_m - 1)),
                        np.uint64(host.finv(shift)))
    return pows[_bitrev_perm(log_m - 1)]


# ---------------------------------------------------------------------------
# Device folding
# ---------------------------------------------------------------------------

def _fold_once(values: GFE, beta: GFE, x_inv: GF) -> GFE:
    """One arity-2 fold of a bitrev extension array on a known coset:
    v' = (v0 + v1)/2 + beta * (v0 - v1)/(2x)."""
    m = values.shape[-1]
    v = values.reshape(m // 2, 2)
    v0 = v[:, 0]
    v1 = v[:, 1]
    inv2 = GF.const(INV2, device=values.device)
    s = (v0 + v1) * inv2
    d = (v0 - v1) * inv2 * x_inv
    return s + d * beta


# LDE elements weighted at once: a batch's selected rows are combined in
# groups this large, so the limb temporaries of the product stay a few GiB
# however many columns a batch opens at a 2^22-point coset
G_GROUP_ELEMENTS = 1 << 26


def _g_accumulate(g: GFE, sels: list, awa: GF, awb: GF,
                  y: GFE, z: GFE, xs: GF) -> GFE:
    """g += (sum_t alpha^t P_t(x) - y) / (x - z) for one opening batch.

    sels: [(lde (rows, m), row indices)] in entry order; awa/awb: (T,)
    alpha-power limbs over all selected rows; y, z: scalar GFE; xs: (m,)
    domain points. The sums run a group of rows at a time (field sums are
    exact, so the grouping changes no bit)."""
    m = xs.shape[-1]
    step = max(1, G_GROUP_ELEMENTS // m)
    ra = rb = None
    t = 0
    for lde, idxs in sels:
        for k in range(0, len(idxs), step):
            rows = lde.take(np.asarray(idxs[k:k + step]), axis=0)
            n = rows.shape[0]
            pa = (rows * awa[t:t + n].reshape(-1, 1)).sum(axis=0)
            pb = (rows * awb[t:t + n].reshape(-1, 1)).sum(axis=0)
            ra = pa if ra is None else ra + pa
            rb = pb if rb is None else rb + pb
            t += n
    num = GFE(ra, rb) - y
    denom = GFE(xs, GF.zeros((m,), xs.device)) - z
    return g + num * denom.inv()


def _ext_leaves(values: GFE, arity: int) -> GF:
    """Group a bitrev ext array into arity-sized coset leaves:
    (m/arity, 2*arity) base-field rows, layout [a0,b0,a1,b1,...]."""
    m = values.shape[-1]
    a = values.a.reshape(m // arity, arity)
    b = values.b.reshape(m // arity, arity)
    inter = GF.stack([a, b], axis=-1)           # (m/arity, arity, 2)
    return inter.reshape(m // arity, 2 * arity)


def _ifft_ext(values: GFE) -> GFE:
    return GFE(ifft(values.a), ifft(values.b))


# ---------------------------------------------------------------------------
# Prover
# ---------------------------------------------------------------------------

def prove_fri(oracles: list[PolynomialBatch],
              batches: list[FriOpeningBatch],
              alpha: tuple[int, int],
              degree_bits: int,
              challenger: Challenger,
              config: FriConfig,
              hasher: str = "poseidon",
              mesh=None) -> FriProof:
    """Produce a batched FRI opening proof for `batches` over `oracles`.

    Callers must have observed all opening values and drawn `alpha` from the
    challenger already (transcript step 6 in DESIGN.md). With a `mesh`
    (`parallel.Mesh`) each commit-phase tree hashes its row blocks over
    the mesh's devices; the folds and the grind stay on the oracles'
    device."""
    log_m = degree_bits + config.rate_bits
    m = 1 << log_m
    shift = host.MULT_GENERATOR
    dev = oracles[0].lde.device

    # ---- combined witness G on the LDE domain --------------------------
    xs = GF.from_u64(coset_points_bitrev(log_m, shift), dev)
    g_vals = GFE.zeros((m,), dev)
    t = 0  # global alpha power index
    for batch in batches:
        z = batch.point
        # alpha powers for this batch (host-exact), and y = sum a^t y_t
        aps = []
        y = (0, 0)
        ap = host.eexp(alpha, t)
        for yv in batch.values:
            aps.append(ap)
            y = host.eadd(y, host.emul(ap, yv))
            ap = host.emul(ap, alpha)
            t += 1
        # gather the selected LDE rows, grouped by oracle (order-preserving)
        sels = []
        i = 0
        while i < len(batch.entries):
            oi = batch.entries[i][0]
            j = i
            idxs = []
            while j < len(batch.entries) and batch.entries[j][0] == oi:
                idxs.append(batch.entries[j][1])
                j += 1
            sels.append((oracles[oi].lde, idxs))
            i = j
        awa = GF.from_u64(np.array([a for a, _ in aps], dtype=np.uint64), dev)
        awb = GF.from_u64(np.array([b for _, b in aps], dtype=np.uint64), dev)
        g_vals = _g_accumulate(
            g_vals, sels, awa, awb, GFE.const(y[0], y[1], device=dev),
            GFE.const(z[0], z[1], device=dev), xs)

    # ---- commit phase ---------------------------------------------------
    arities = config.reduction_arity_bits(degree_bits)
    commit_trees: list[MerkleTree] = []
    commit_caps: list[list[list[int]]] = []
    cur = g_vals
    cur_log_m = log_m
    cur_shift = shift
    for ab in arities:
        arity = 1 << ab
        leaves = _ext_leaves(cur, arity)
        cap_h = min(config.cap_height, cur_log_m - ab)
        tree = build_commitment_tree(leaves, cap_h, hasher, mesh=mesh)
        cap_ints = [[int(x) for x in row] for row in tree.cap_u64()]
        commit_trees.append(tree)
        commit_caps.append(cap_ints)
        for d in cap_ints:
            challenger.observe_elements(d)
        beta = challenger.get_extension_challenge()
        bk = beta
        for _ in range(ab):
            x_inv = GF.from_u64(_pair_x_inv_bitrev(cur_log_m, cur_shift), dev)
            cur = _fold_once(cur, GFE.const(bk[0], bk[1], device=dev), x_inv)
            bk = host.emul(bk, bk)
            cur_shift = host.fmul(cur_shift, cur_shift)
            cur_log_m -= 1

    # ---- final polynomial ----------------------------------------------
    final_vals_nat = GFE(
        cur.a.take(_bitrev_perm(cur_log_m), axis=-1),
        cur.b.take(_bitrev_perm(cur_log_m), axis=-1))
    coeffs = _ifft_ext(final_vals_nat)
    shift_inv_pows = GF.from_u64(
        np_field.powers(host.finv(cur_shift), 1 << cur_log_m), dev)
    coeffs = GFE(coeffs.a * shift_inv_pows, coeffs.b * shift_inv_pows)
    final_len = 1 << (cur_log_m - config.rate_bits)
    ca = coeffs.a.to_u64()
    cb = coeffs.b.to_u64()
    final_poly = [(int(ca[i]), int(cb[i])) for i in range(final_len)]
    for a, b in final_poly:
        challenger.observe_elements([a, b])

    # ---- proof of work --------------------------------------------------
    pow_witness = _grind(challenger, config.proof_of_work_bits, dev)
    challenger.observe_element(pow_witness)
    _ = challenger.get_challenge()  # the checked PoW response

    # ---- query rounds (batched extraction across all queries) ----------
    indices = [c % m for c in
               challenger.get_n_challenges(config.num_query_rounds)]
    nq = len(indices)
    init_leaves = [o.tree.leaves_at(indices) for o in oracles]
    init_paths = [o.tree.prove_many(indices) for o in oracles]
    step_leaves, step_paths = [], []
    cur_idxs = np.asarray(indices, dtype=np.int64)
    for tree, ab in zip(commit_trees, arities):
        coset_idxs = cur_idxs >> ab
        step_leaves.append(tree.leaves_at(coset_idxs))
        step_paths.append(tree.prove_many(coset_idxs))
        cur_idxs = coset_idxs
    rounds = []
    for q in range(nq):
        initial = FriInitialProof(
            leaves=[[int(x) for x in init_leaves[o][q]]
                    for o in range(len(oracles))],
            paths=[init_paths[o][q] for o in range(len(oracles))])
        steps = []
        for k, ab in enumerate(arities):
            row = step_leaves[k][q]
            vals = [(int(row[2 * i]), int(row[2 * i + 1]))
                    for i in range(1 << ab)]
            steps.append(FriQueryStep(coset_values=vals,
                                      path=step_paths[k][q]))
        rounds.append(FriQueryRound(initial=initial, steps=steps))

    return FriProof(commit_phase_caps=commit_caps, final_poly=final_poly,
                    pow_witness=pow_witness, query_rounds=rounds)


def _grind(challenger: Challenger, bits: int, device=None) -> int:
    """Find w such that observe(w); get_challenge() yields `bits` leading
    zero bits. One batched permutation over candidate witnesses on
    `device` per try.

    Must not mutate `challenger`: we replicate its exact duplex step —
    pending input-buffer elements land in lanes [0..k), the candidate in
    lane k, one permutation, response = state[7] (output_buffer.pop())."""
    if bits == 0:
        return 0
    pending = list(challenger.input_buffer)   # always < RATE elements
    k = len(pending)
    base = list(challenger.sponge_state)
    batch = 1 << max(bits + 2, 12)
    states = np.tile(np.array(base, dtype=np.uint64), (batch, 1))
    for i, x in enumerate(pending):
        states[:, i] = x
    # For 16-bit grinding a single 2^18 batch misses with p ~= e^-4
    # (~1.8%), so retry over successive offset windows rather than abort.
    w = None
    for offset in range(0, 1 << 32, batch):
        states[:, k] = offset + np.arange(batch, dtype=np.uint64)
        out = poseidon.permute(GF.from_u64(states, device)).to_u64()
        resp = out[:, 7]
        ok = np.nonzero((resp >> np.uint64(64 - bits)) == 0)[0]
        if len(ok):
            w = offset + int(ok[0])
            break
    if w is None:
        raise RuntimeError("PoW grind failed over the full u32 range")
    check = copy.deepcopy(challenger)
    check.observe_element(w)
    assert check.get_challenge() >> (64 - bits) == 0
    return w


# ---------------------------------------------------------------------------
# Host verifier
# ---------------------------------------------------------------------------

def verify_fri(oracle_caps: list[list[list[int]]],
               batches: list[FriOpeningBatch],
               alpha: tuple[int, int],
               degree_bits: int,
               proof: FriProof,
               challenger: Challenger,
               config: FriConfig,
               oracle_widths: list[int] | None = None,
               hasher: str = "poseidon") -> None:
    """Replay the transcript and check every query round. Raises
    AssertionError on any failure. `challenger` must be at the same
    transcript position the prover's was when entering prove_fri.

    `oracle_widths[i]` is the expected leaf width (poly count) of oracle
    i; when omitted it is inferred from the largest poly index opened in
    `batches` (exact widths close the leaf-equivocation gap — the
    reference enforces them at deserialization)."""
    log_m = degree_bits + config.rate_bits
    m = 1 << log_m
    arities = config.reduction_arity_bits(degree_bits)
    assert len(proof.commit_phase_caps) == len(arities), \
        "commit-phase cap count mismatch"
    if oracle_widths is None:
        oracle_widths = [0] * len(oracle_caps)
        for batch in batches:
            for oi, pi in batch.entries:
                oracle_widths[oi] = max(oracle_widths[oi], pi + 1)
    assert len(oracle_widths) == len(oracle_caps)

    # Expected shapes for every query round (ADVICE r1: exact-shape checks).
    cap_h0 = (len(oracle_caps[0]) - 1).bit_length()
    for cap in oracle_caps:
        assert len(cap) == 1 << cap_h0, "oracle cap size mismatch"
    init_path_len = log_m - cap_h0
    step_shapes = []   # (arity_bits, path_len, cap_len)
    cur_lm = log_m
    for ab, cap in zip(arities, proof.commit_phase_caps):
        n_leaves_log = cur_lm - ab
        cap_h = min(cap_h0, n_leaves_log)
        step_shapes.append((ab, n_leaves_log - cap_h, 1 << cap_h))
        assert len(cap) == 1 << cap_h, "commit-phase cap size mismatch"
        cur_lm -= ab

    betas = []
    for cap in proof.commit_phase_caps:
        for d in cap:
            challenger.observe_elements(d)
        betas.append(challenger.get_extension_challenge())
    assert len(proof.final_poly) == \
        1 << (log_m - sum(arities) - config.rate_bits)
    for a, b in proof.final_poly:
        challenger.observe_elements([a, b])

    challenger.observe_element(proof.pow_witness)
    pow_response = challenger.get_challenge()
    assert pow_response >> (64 - config.proof_of_work_bits) == 0, \
        "proof-of-work check failed"

    indices = [c % m for c in
               challenger.get_n_challenges(config.num_query_rounds)]
    assert len(proof.query_rounds) == len(indices)

    _verify_openings(indices, proof, oracle_caps, oracle_widths, arities,
                     init_path_len, step_shapes, paths_verifier(hasher))
    terms = _batch_terms(batches, alpha)
    for idx, rnd in zip(indices, proof.query_rounds):
        _verify_query(idx, rnd, batches, terms, betas, proof, log_m,
                      arities)


def _verify_openings(indices, proof: FriProof, oracle_caps, oracle_widths,
                     arities, init_path_len, step_shapes,
                     verify_paths) -> None:
    """Every query round's shapes, then its Merkle openings, tree by
    tree: each initial oracle at the query index, each commit-phase tree
    at the folded coset's index."""
    rounds = proof.query_rounds
    for rnd in rounds:
        assert len(rnd.initial.leaves) == len(oracle_caps)
        assert len(rnd.initial.paths) == len(oracle_caps)
        assert len(rnd.steps) == len(arities), "FRI step count mismatch"
        for leaf, width in zip(rnd.initial.leaves, oracle_widths):
            assert len(leaf) == width, "initial oracle leaf width mismatch"
        for step, ab in zip(rnd.steps, arities):
            assert len(step.coset_values) == 1 << ab, \
                "FRI coset width mismatch"
    for oi, cap in enumerate(oracle_caps):
        assert verify_paths([rnd.initial.leaves[oi] for rnd in rounds],
                            indices,
                            [rnd.initial.paths[oi] for rnd in rounds],
                            cap, init_path_len), \
            "initial oracle Merkle check failed"
    coset_idx = list(indices)
    for k, ((ab, step_path_len, _cap_len), cap) in enumerate(
            zip(step_shapes, proof.commit_phase_caps)):
        coset_idx = [i >> ab for i in coset_idx]
        assert verify_paths([[v for pair in rnd.steps[k].coset_values
                              for v in pair] for rnd in rounds],
                            coset_idx,
                            [rnd.steps[k].path for rnd in rounds],
                            cap, step_path_len), \
            "commit-phase Merkle failed"


def _batch_terms(batches: list[FriOpeningBatch], alpha):
    """Per batch, the query-independent part of its numerator
    sum_t alpha^t (p_t(x) - y_t): the powers alpha^t as two lists of
    base-field coordinates, and sum_t alpha^t y_t. The power t runs on
    across batches."""
    terms = []
    ap = (1, 0)
    for batch in batches:
        a_pows, b_pows = [], []
        claimed = (0, 0)
        for yv in batch.values:
            a_pows.append(ap[0])
            b_pows.append(ap[1])
            claimed = host.eadd(claimed, host.emul(ap, tuple(yv)))
            ap = host.emul(ap, alpha)
        terms.append((a_pows, b_pows, claimed))
    return terms


def _bitrev_int(i: int, bits: int) -> int:
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


def _verify_query(idx: int, rnd: FriQueryRound, batches, terms, betas,
                  proof: FriProof, log_m, arities) -> None:
    """One query round's arithmetic; its shapes and Merkle openings were
    checked by _verify_openings."""
    # -- reconstruct G(x) from the opened oracle values -------------------
    g = host.primitive_root_of_unity(log_m)
    x = host.fmul(host.MULT_GENERATOR, host.fexp(g, _bitrev_int(idx, log_m)))
    gx = (0, 0)
    for batch, (a_pows, b_pows, claimed) in zip(batches, terms):
        # sum_t alpha^t (p_t(x) - y_t), p_t(x) in the base field
        pvs = [rnd.initial.leaves[oracle_idx][poly_idx]
               for oracle_idx, poly_idx in batch.entries]
        num = host.esub((sum(map(operator.mul, a_pows, pvs)) % host.P,
                         sum(map(operator.mul, b_pows, pvs)) % host.P),
                        claimed)
        denom = host.esub((x, 0), batch.point)
        gx = host.eadd(gx, host.emul(num, host.einv(denom)))

    # -- walk the fold chain ----------------------------------------------
    eval_cur = gx
    idx_cur = idx
    cur_log_m = log_m
    shift = host.MULT_GENERATOR
    inv2 = INV2
    for step, ab, beta in zip(rnd.steps, arities, betas):
        arity = 1 << ab
        coset_idx = idx_cur >> ab
        slot = idx_cur & (arity - 1)
        assert tuple(step.coset_values[slot]) == tuple(eval_cur), \
            "fold chain value mismatch"
        # iterated pairwise fold of the coset, tracking x per position
        gk = host.primitive_root_of_unity(cur_log_m)
        xs = [host.fmul(shift,
                        host.fexp(gk, _bitrev_int(coset_idx * arity + p,
                                                  cur_log_m)))
              for p in range(arity)]
        vs = [tuple(v) for v in step.coset_values]
        bk = beta
        for _ in range(ab):
            nxs, nvs = [], []
            for i in range(len(vs) // 2):
                v0, v1 = vs[2 * i], vs[2 * i + 1]
                x0 = xs[2 * i]
                s = host.escalar(host.eadd(v0, v1), inv2)
                d = host.escalar(host.esub(v0, v1),
                                 host.fmul(inv2, host.finv(x0)))
                nvs.append(host.eadd(s, host.emul(bk, d)))
                nxs.append(host.fmul(x0, x0))
            xs, vs = nxs, nvs
            bk = host.emul(bk, bk)
        eval_cur = vs[0]
        idx_cur = coset_idx
        cur_log_m -= ab
        shift = host.fexp(shift, 1 << ab)

    # -- final polynomial check -------------------------------------------
    gk = host.primitive_root_of_unity(cur_log_m)
    x_f = host.fmul(shift, host.fexp(gk, _bitrev_int(idx_cur, cur_log_m)))
    acc = (0, 0)
    for c in reversed(proof.final_poly):
        acc = host.eadd(host.escalar(acc, x_f), c)
    assert tuple(acc) == tuple(eval_cur), "final polynomial mismatch"
