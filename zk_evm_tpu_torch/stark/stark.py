"""Stark (AIR) abstraction: one constraint system evaluated in two algebras.

A table's constraints are written once against the operator surface shared
by GF arrays (prover: vectorized over the whole LDE coset) and HExt scalars
(verifier: at the out-of-domain point zeta).
"""

from __future__ import annotations

from ..field import GF, np_field


class StarkFrame:
    """Constraint inputs: column values on the current and next row (for
    the prover these are (m,)-shaped GF arrays; for the verifier HExt
    scalars), plus auxiliary (lookup/CTL) columns and public inputs."""

    __slots__ = ("local", "next", "aux_local", "aux_next",
                 "public_inputs", "params")

    def __init__(self, local, next_, public_inputs=None,
                 aux_local=None, aux_next=None, params=()):
        self.local = local
        self.next = next_
        self.aux_local = aux_local or []
        self.aux_next = aux_next or []
        self.params = tuple(params)
        self.public_inputs = public_inputs or []


class ConstraintConsumer:
    """Accumulates constraints as acc_i = acc_i * alpha_i + c per challenge.

    Row-filter selectors (z_last, lagrange_first/last) are algebra elements
    supplied by the caller, evaluated on the same domain as the frame."""

    def __init__(self, alphas, zero, z_last, lagrange_first, lagrange_last):
        self.alphas = list(alphas)
        self.accs = [zero for _ in alphas]
        self.z_last = z_last
        self.lagrange_first = lagrange_first
        self.lagrange_last = lagrange_last

    def constraint(self, c) -> None:
        """Must hold on every row of the trace."""
        self.accs = [acc * alpha + c
                     for acc, alpha in zip(self.accs, self.alphas)]

    def constraint_transition(self, c) -> None:
        """Must hold on every row but the last."""
        self.constraint(c * self.z_last)

    def constraint_first_row(self, c) -> None:
        self.constraint(c * self.lagrange_first)

    def constraint_last_row(self, c) -> None:
        self.constraint(c * self.lagrange_last)

    # -- block forms ---------------------------------------------------------
    # A block of K constraints folds exactly like K sequential constraint()
    # calls (acc*a^K + sum_k a^{K-1-k} c_k). The verifier-side algebra (a
    # list of HExt) takes the sequential path; a (K, m) GF block folds in
    # one weighted sum.

    def constraint_block(self, cs) -> None:
        if isinstance(cs, (list, tuple)):
            for c in cs:
                self.constraint(c)
            return
        k = cs.shape[0]
        new_accs = []
        for acc, alpha in zip(self.accs, self.alphas):
            w = np_field.powers(alpha, k)[::-1].copy()
            wgf = GF.from_u64(w.reshape(k, 1), cs.device)
            ak = int(np_field.powers(alpha, k + 1)[k])
            new_accs.append(acc * ak + (cs * wgf).sum(axis=0))
        self.accs = new_accs

    def constraint_block_transition(self, cs) -> None:
        if isinstance(cs, (list, tuple)):
            for c in cs:
                self.constraint_transition(c)
            return
        self.constraint_block(cs * self.z_last)


class StackingConsumer(ConstraintConsumer):
    """Same folding semantics as ConstraintConsumer, computed as ONE
    weighted reduction instead of a serial alpha-chain.

    Every constraint call stacks its (m,)- or (K, m)-shaped values; a
    final `finalize()` computes, per challenge,
        acc = sum_k alpha^{K_total-1-k} c_k
    which is bit-identical to K_total sequential `constraint()` folds
    (acc0 = 0). The alphas are host ints."""

    def __init__(self, alphas, zero, z_last, lagrange_first, lagrange_last):
        super().__init__(alphas, zero, z_last, lagrange_first, lagrange_last)
        self._stack = []
        self._zero = zero

    def constraint(self, c) -> None:
        if not isinstance(c, GF):
            c = self._zero + c
        if c.shape != self._zero.shape:
            c = c.broadcast_to(self._zero.shape)
        self._stack.append(c.reshape(1, -1))

    def constraint_block(self, cs) -> None:
        if isinstance(cs, (list, tuple)):
            for c in cs:
                self.constraint(c)
            return
        self._stack.append(cs.reshape(-1, cs.shape[-1]))

    # elements folded at once: a group of stacked rows this large is
    # multiplied by its weights and summed before the next is concatenated,
    # so the fold's limb temporaries stay a few GiB at a 2^22-point coset
    FOLD_GROUP_ELEMENTS = 1 << 26

    def finalize(self) -> None:
        """Compute accs from the stacked constraints, a group of rows at a
        time (field sums are exact, so the grouping changes no bit).
        Idempotent."""
        if not self._stack:
            return
        stack, self._stack = self._stack, []
        k = sum(c.shape[0] for c in stack)
        m = stack[0].shape[-1]
        weights = [np_field.powers(alpha, k)[::-1].copy()
                   for alpha in self.alphas]
        # acc0 is zero by construction (fresh consumer per quotient)
        accs = [None] * len(self.alphas)
        row = 0
        while stack:
            group = [stack.pop(0)]
            while stack and (sum(c.shape[0] for c in group)
                             + stack[0].shape[0]) * m \
                    <= self.FOLD_GROUP_ELEMENTS:
                group.append(stack.pop(0))
            cs = GF.concatenate(group, axis=0) if len(group) > 1 \
                else group[0]
            del group
            n = cs.shape[0]
            for i, w in enumerate(weights):
                wgf = GF.from_u64(w[row:row + n].reshape(n, 1), cs.device)
                part = (cs * wgf).sum(axis=0)
                accs[i] = part if accs[i] is None else accs[i] + part
            row += n
        self.accs = accs


class Stark:
    """Base class for one STARK table."""

    name: str = "stark"
    num_columns: int = 0
    num_public_inputs: int = 0
    constraint_degree: int = 3

    # Lookup/CTL metadata filled in by subclasses:
    def lookups(self):
        return []

    # -- per-proof scalar parameters ---------------------------------------
    # Values that vary per proof enter constraint evaluation via
    # frame.params.
    proof_param_names: tuple = ()

    def proof_params(self) -> tuple:
        return tuple(getattr(self, n) for n in self.proof_param_names)

    def known_columns(self):
        """Columns whose values are fixed by data the verifier holds.
        The verifier recomputes their openings at zeta/zeta*g
        barycentrically (recursion/known.py) and asserts equality,
        binding the committed polynomials to the known data. Prefer
        `preprocessed()` (cap-constant binding, recursable)."""
        return {}

    # -- preprocessed (program) oracle ------------------------------------
    # The first `num_preprocessed` columns of the trace are fixed by data
    # the verifier holds (the Rvm's program). They are committed in their
    # OWN oracle whose Merkle cap is a constant of the verification key:
    # the verifier (and the recursion tape) bind openings to that cap via
    # FRI alone.
    num_preprocessed: int = 0

    def preprocessed(self):
        """(num_preprocessed, n) uint64 values, or None."""
        return None

    def preprocessed_batch(self, config, device=None):
        """Commit the preprocessed columns on `device` (CUDA when not
        given), once per (program, config, device)."""
        pre = self.preprocessed()
        if pre is None:
            return None
        from .prover import resolve_device
        dev = resolve_device(device)
        key = ("_pre_batch", config.rate_bits, config.cap_height,
               config.hasher, str(dev))
        cached = getattr(self, "_pre_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        from .poly_batch import PolynomialBatch
        batch = PolynomialBatch.from_values(
            GF.from_u64(pre, dev), rate_bits=config.rate_bits,
            cap_height=config.cap_height, hasher=config.hasher)
        self._pre_cache = (key, batch)
        return batch

    def requires_ctls(self):
        return False

    def eval(self, frame: StarkFrame, cc: ConstraintConsumer) -> None:
        raise NotImplementedError

