"""Single-table STARK prover (with logUp / CTL auxiliary columns).

The device (CUDA unless the caller passes `device="cpu"`) does all O(n)
and larger work: commitments (NTT + Merkle), aux-column generation
(batched inverses and exact suffix sums), whole-LDE constraint
evaluation, quotient interpolation, FRI. The host does transcript
sequencing only. A table's preprocessed (program) columns take the low
column indices and are committed in an oracle of their own, whose cap
is a constant of the verification key.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import GF, host
from .. import ntt
from ..challenger import Challenger
from ..timing import timed
from .config import StarkConfig
from .poly_batch import PolynomialBatch
from .stark import Stark, StarkFrame, StackingConsumer
from .proof import StarkProof, StarkOpeningSet
from . import domains, fri, lookup


def resolve_device(device=None) -> torch.device:
    """The device a proof runs on: `device` if given, else CUDA. Without
    a CUDA device and without an explicit device this raises: the port
    never moves to the CPU unless the caller asks for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to prove on "
                           "the CPU")
    return torch.device("cuda")


def same_device(a, b) -> bool:
    """Whether `a` and `b` name one device: a device without an index
    names the current one of its type (`cuda` and `cuda:0` are one card
    when card 0 is current)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.index == b.index or None not in (a.index, b.index):
        return a.index == b.index
    current = torch.cuda.current_device() if a.type == "cuda" else 0
    return (current if a.index is None else a.index) == \
        (current if b.index is None else b.index)


def _powers(base: int, count: int, device) -> GF:
    """[base^0 .. base^(count-1)] on `device`, by log-doubling."""
    out = GF.const(1, (1,), device)
    step = base                                 # base^len(out)
    while out.shape[0] < count:
        out = GF.concatenate([out, out * step], axis=0)
        step = host.fmul(step, step)
    return out[:count]


def selector_tables(degree_bits: int, rate_bits: int, device) -> dict:
    """`domains.selector_tables_bitrev` computed on `device`: the same
    field elements over the LDE coset in bit-reversed order, with the
    coset points built by log-doubling and the two m-point inversions as
    one batched device inverse instead of host numpy."""
    n = 1 << degree_bits
    log_m = degree_bits + rate_bits
    m = 1 << log_m
    g_last = host.fexp(host.primitive_root_of_unity(degree_bits), n - 1)
    w = host.primitive_root_of_unity(log_m)
    br = ntt.bit_reverse_indices(log_m)
    xs = _powers(w, m, device).take(br, axis=0) * domains.SHIFT  # bitrev
    # x^n = 7^n * (w^n)^i takes 2^rate_bits values, by i mod 2^rate_bits
    shift_n, w_n = host.fexp(domains.SHIFT, n), host.fexp(w, n)
    zh_vals = [host.fsub(host.fmul(shift_n, host.fexp(w_n, j)), 1)
               for j in range(1 << rate_bits)]
    zh_of = br % (1 << rate_bits)
    zh = GF.from_u64(np.array(zh_vals, dtype=np.uint64), device).take(
        zh_of, axis=0)
    zh_inv = GF.from_u64(np.array([host.finv(v) for v in zh_vals],
                                  dtype=np.uint64), device).take(zh_of, axis=0)
    x_m1 = xs - 1
    x_mg = xs - g_last
    inv = GF.stack([x_m1, x_mg], axis=0).inv()
    n_inv = host.finv(n)
    return {
        "zh_inv": zh_inv,
        "z_last": x_mg,
        "l_first": zh * inv[0] * n_inv,
        "l_last": zh * inv[1] * host.fmul(n_inv, g_last),
    }


def _quotient_chunks(stark: Stark, trace_batch: PolynomialBatch,
                     aux_batch: PolynomialBatch | None,
                     lookups, groups, challenges,
                     alphas: list[int], config: StarkConfig,
                     public_inputs: list[int],
                     pre_batch: PolynomialBatch | None = None) -> GF:
    """Evaluate the constraint composition over the LDE coset and return
    quotient chunk coefficients, shape (num_challenges << rate_bits, n).

    One eager pass with the stacked fold: every constraint's values over
    the coset (the table's and the lookup/CTL ones) are stacked, folded
    per challenge in one weighted sum, divided by Z_H and interpolated
    back to coefficients."""
    degree_bits = trace_batch.degree.bit_length() - 1
    rate_bits = config.rate_bits
    log_m = degree_bits + rate_bits
    m = 1 << log_m
    lde = trace_batch.lde                       # (cols, m) bitrev
    if pre_batch is not None:
        # preprocessed (program) columns occupy the low indices
        lde = GF.concatenate([pre_batch.lde, lde], axis=0)
    dev = lde.device
    perm = domains.next_row_perm_bitrev(log_m, rate_bits)
    sel = selector_tables(degree_bits, rate_bits, dev)
    aux_local, aux_next = [], []
    if aux_batch is not None:
        aux_local = aux_batch.lde
        aux_next = aux_local.take(perm, axis=-1)
    frame = StarkFrame(
        local=lde,
        next_=lde.take(perm, axis=-1),
        aux_local=aux_local, aux_next=aux_next,
        public_inputs=list(public_inputs),
        params=tuple(GF.const(p, device=dev) for p in stark.proof_params()))
    cc = StackingConsumer(
        alphas=alphas, zero=GF.zeros((m,), dev),
        z_last=sel["z_last"], lagrange_first=sel["l_first"],
        lagrange_last=sel["l_last"])
    stark.eval(frame, cc)
    if lookups or groups:
        lookup.eval_aux_constraints(lookups, groups, challenges, frame, cc)
    cc.finalize()
    q_vals = GF.stack([acc * sel["zh_inv"] for acc in cc.accs], axis=0)
    coeffs = ntt.coset_ifft_from_bitrev(q_vals)          # (nc, m)
    return coeffs.reshape(q_vals.shape[0] << rate_bits, 1 << degree_bits)


def prove_stark(stark: Stark, trace: np.ndarray, config: StarkConfig,
                challenger: Challenger,
                public_inputs: list[int] | None = None,
                challenges: lookup.ChallengeSet | None = None,
                ctl_groups=None,
                observe_trace_cap: bool = True,
                trace_batch: PolynomialBatch | None = None,
                device=None, mesh=None) -> StarkProof:
    """Prove one table whose (num_columns, n) uint64 trace is `trace`, on
    `device` (CUDA when not given). The proof depends only on the trace,
    config and public inputs: it is the same on every device.

    In multi-table mode (`prove_all`) the caller commits the trace,
    observes every cap globally, draws the shared CTL challenge set, and
    passes `challenges`, `ctl_groups`, `observe_trace_cap=False` and
    `trace_batch` in; the proof then runs on that batch's device.

    `mesh` (`parallel.Mesh`): every commitment the proof makes (trace,
    aux, quotient chunks, the FRI trees) goes over the mesh's devices;
    the stages between them run on `mesh[0]`, which `device`, if given,
    must name. The proof is the same as on one device. (The JAX
    package's `shard_rows` layout annotation has no counterpart: the
    mesh takes its place.)"""
    if mesh is not None:
        if device is not None and not same_device(device, mesh[0]):
            raise ValueError(f"device {device} is not the mesh's first "
                             f"device {mesh[0]}")
        device = mesh[0]
    public_inputs = public_inputs or []
    groups = list(ctl_groups or [])
    lookups = stark.lookups()
    n = trace.shape[1]
    degree_bits = n.bit_length() - 1
    assert 1 << degree_bits == n
    assert trace.shape[0] == stark.num_columns
    fri_cfg = config.fri_config
    npre = stark.num_preprocessed

    if trace_batch is None:
        with timed("commit trace"):
            trace_batch = PolynomialBatch.from_values(
                GF.from_u64(trace[npre:], resolve_device(device)),
                rate_bits=config.rate_bits,
                cap_height=config.cap_height, hasher=config.hasher,
                mesh=mesh)
    elif device is not None and not same_device(device,
                                                trace_batch.lde.device):
        raise ValueError(f"device {device} differs from the trace batch's "
                         f"{trace_batch.lde.device}")
    trace_cap = trace_batch.cap_ints()
    pre_batch = stark.preprocessed_batch(config, trace_batch.lde.device)
    assert (pre_batch is None) == (npre == 0)
    if pre_batch is not None:
        assert np.array_equal(stark.preprocessed(), trace[:npre]), \
            "trace's program columns deviate from stark.preprocessed()"

    init_state = challenger.compact()
    if observe_trace_cap:
        challenger.observe_cap(trace_cap)
        # bind single-table public inputs into the transcript (the
        # AllStark layer observes them globally instead)
        challenger.observe_elements(public_inputs)
    if pre_batch is not None:
        # the program cap is part of the verification key; observing it
        # domain-separates transcripts of different programs
        challenger.observe_cap(pre_batch.cap_ints())

    # 1. lookup/CTL challenges + aux commitment
    aux_batch = None
    aux_cap = None
    if lookups or groups:
        if challenges is None:
            challenges = lookup.get_challenge_set(
                challenger, config.num_challenges)
        with timed("generate aux columns"):
            trace_gf = trace_batch.values
            if trace_gf is None:
                trace_gf = GF.from_u64(trace[npre:], trace_batch.lde.device)
            if pre_batch is not None:
                # the aux columns see the whole trace, program included
                trace_gf = GF.concatenate([pre_batch.values, trace_gf],
                                          axis=0)
            aux_gf = lookup.generate_aux_trace(trace_gf, lookups, groups,
                                               challenges)
        with timed("commit aux"):
            aux_batch = PolynomialBatch.from_values(
                aux_gf, rate_bits=config.rate_bits,
                cap_height=config.cap_height, hasher=config.hasher,
                mesh=mesh)
            aux_cap = aux_batch.cap_ints()
        challenger.observe_cap(aux_cap)

    # 2. constraint-folding challenges + quotient commitment
    alphas = challenger.get_n_challenges(config.num_challenges)
    with timed("evaluate quotient"):
        chunks = _quotient_chunks(stark, trace_batch, aux_batch, lookups,
                                  groups, challenges, alphas, config,
                                  public_inputs, pre_batch=pre_batch)
    with timed("commit quotient"):
        quotient_batch = PolynomialBatch.from_coeffs(
            chunks, rate_bits=config.rate_bits,
            cap_height=config.cap_height, hasher=config.hasher, mesh=mesh)
        quotient_cap = quotient_batch.cap_ints()
    challenger.observe_cap(quotient_cap)

    # 3. openings at zeta / zeta*g (and x=1 for CTL running sums)
    zeta = challenger.get_extension_challenge()
    g = host.primitive_root_of_unity(degree_bits)
    zeta_next = host.emul(zeta, (g, 0))
    with timed("openings"):
        t_open = trace_batch.open_at([zeta, zeta_next])
        q_open = quotient_batch.open_at([zeta])
        pre_local, pre_next = [], []
        if pre_batch is not None:
            p_open = pre_batch.open_at([zeta, zeta_next])
            pre_local = [tuple(map(int, v)) for v in p_open[0]]
            pre_next = [tuple(map(int, v)) for v in p_open[1]]
        aux_local_open, aux_next_open, ctl_zs_first = [], [], []
        z_idxs: list[int] = []
        if aux_batch is not None:
            a_open = aux_batch.open_at([zeta, zeta_next, (1, 0)])
            aux_local_open = [tuple(map(int, v)) for v in a_open[0]]
            aux_next_open = [tuple(map(int, v)) for v in a_open[1]]
            z_idxs = lookup.ctl_z_first_indices(lookups, groups, challenges)
            for i in z_idxs:
                a, b = int(a_open[2, i, 0]), int(a_open[2, i, 1])
                assert b == 0, "CTL Z opening at x=1 must be base-field"
                ctl_zs_first.append(a)
    openings = StarkOpeningSet(
        trace_local=pre_local + [tuple(map(int, v)) for v in t_open[0]],
        trace_next=pre_next + [tuple(map(int, v)) for v in t_open[1]],
        aux_local=aux_local_open, aux_next=aux_next_open,
        ctl_zs_first=ctl_zs_first,
        quotient=[tuple(map(int, v)) for v in q_open[0]])
    challenger.observe_elements(openings.observe_order())

    # 4. FRI batched opening proof (oracle order: [pre?, trace, aux?, q])
    alpha = challenger.get_extension_challenge()
    oracles = []
    zeta_entries, next_entries = [], []
    if pre_batch is not None:
        oracles.append(pre_batch)
        zeta_entries += [(0, i) for i in range(npre)]
        next_entries += [(0, i) for i in range(npre)]
    tidx = len(oracles)
    oracles.append(trace_batch)
    zeta_entries += [(tidx, i) for i in range(trace_batch.num_polys)]
    next_entries += [(tidx, i) for i in range(trace_batch.num_polys)]
    zeta_values = list(openings.trace_local)
    next_values = list(openings.trace_next)
    if aux_batch is not None:
        aidx = len(oracles)
        oracles.append(aux_batch)
        aux_entries = [(aidx, i) for i in range(aux_batch.num_polys)]
        zeta_entries += aux_entries
        zeta_values += list(openings.aux_local)
        next_entries += aux_entries
        next_values += list(openings.aux_next)
    qidx = len(oracles)
    oracles.append(quotient_batch)
    zeta_entries += [(qidx, j) for j in range(quotient_batch.num_polys)]
    zeta_values += list(openings.quotient)
    batches = [
        fri.FriOpeningBatch(point=zeta, entries=zeta_entries,
                            values=zeta_values),
        fri.FriOpeningBatch(point=zeta_next, entries=next_entries,
                            values=next_values),
    ]
    if ctl_zs_first:
        batches.append(fri.FriOpeningBatch(
            point=(1, 0),
            entries=[(aidx, i) for i in z_idxs],
            values=[(v, 0) for v in openings.ctl_zs_first]))
    with timed("FRI"):
        fri_proof = fri.prove_fri(oracles, batches, alpha, degree_bits,
                                  challenger, fri_cfg,
                                  hasher=config.hasher, mesh=mesh)

    return StarkProof(degree_bits=degree_bits, trace_cap=trace_cap,
                      aux_cap=aux_cap, quotient_cap=quotient_cap,
                      openings=openings, fri_proof=fri_proof,
                      init_challenger_state=init_state,
                      public_inputs=list(public_inputs))
