"""The stages between commitments over a mesh's row blocks, on the CPU:
aux columns, the quotient, the openings, FRI's G and its folds split as
the JAX package's `shard_rows` splits them (`tests/test_sharded_prove.py`
there shows its mesh proofs equal the single-device bytes).

- WideStark at 2^12 rows over 2 and 4 entries (8 in
  `test_torch_parallel_prove.py`): k = 2 keeps every next row in its own
  block at rate_bits 1, k = 4 copies one successor block. Each proof
  hashes to `WIDE_SHA256`, the single-device proof of both packages, and
  the block counts show that aux, the quotient, G and the first fold each
  ran k times on blocks of n/k or m/k entries: a split that quietly fell
  back to one device would fail.
- A table with preprocessed columns, alone and with a CTL, over 4
  entries: its single-device proofs.
- Units: the successor-block map against `next_row_perm_bitrev`, the
  block aux (halo row and suffix carries) against `generate_aux_trace`,
  and G and the folds over blocks against the whole arrays.
Tolerance 0."""

import numpy as np
import pytest
import torch

from test_torch_parallel import whole_lde
from test_torch_parallel_prove import (WIDE_SHA256, WideStark, sha256,
                                       wide_cfg, wide_trace)
from test_torch_scenarios import (PUBLIC, ProgStark, ToyStark, _cfg,
                                  _ctls, prog_trace, toy_trace)
from zk_evm_tpu_torch.challenger import Challenger
from zk_evm_tpu_torch.field import GF, GFE, host
from zk_evm_tpu_torch.ntt.ntt import bit_reverse_indices
from zk_evm_tpu_torch.parallel import Mesh, block_runs, reset_block_runs
from zk_evm_tpu_torch.stark import (CrossTableLookup, CtlView, Filter,
                                    Lookup, col, prove_all, prove_stark)
from zk_evm_tpu_torch.stark import domains, fri, lookup
from zk_evm_tpu_torch.stark.lookup import ChallengeSet, col_next
from zk_evm_tpu_torch.stark.poly_batch import PolynomialBatch
from zk_evm_tpu_torch.stark.prover import next_row_blocks, selector_tables
from zk_evm_tpu_torch.stark.serialization import proof_to_json

P = host.P


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread a block thread, and no autograd bookkeeping."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.inference_mode():
        yield
    torch.set_num_threads(n)


def cpu_mesh(k: int) -> Mesh:
    return Mesh(["cpu"] * k)


def assert_split(k: int, n: int, m: int) -> None:
    """Aux ran on k blocks of n/k rows, the quotient and G on k blocks of
    m/k coset points, and the first fold on k blocks of m/k."""
    assert block_runs("aux") == {n // k: k}
    assert block_runs("quotient") == {m // k: k}
    assert block_runs("G") == {m // k: k}
    assert block_runs("fold")[m // k] == k


@pytest.mark.parametrize("k", [2, 4])
def test_wide_stark_stages_split(k):
    n = 1 << 12
    reset_block_runs()
    proof = prove_stark(WideStark(), wide_trace(n), wide_cfg(),
                        Challenger(), mesh=cpu_mesh(k))
    assert sha256(proof) == WIDE_SHA256
    assert_split(k, n, 2 * n)


def test_preprocessed_over_4_entries():
    """Program columns (their own oracle, committed off the mesh and
    sliced into its blocks) and a CTL filtered by one: the mesh proofs
    are the single-device ones."""
    trace = prog_trace()
    one = prove_stark(ProgStark(), trace, _cfg(), Challenger(), PUBLIC,
                      device="cpu")
    reset_block_runs()
    many = prove_stark(ProgStark(), trace, _cfg(), Challenger(), PUBLIC,
                       mesh=cpu_mesh(4))
    assert proof_to_json(many) == proof_to_json(one)
    assert block_runs("quotient") == {4: 4}
    traces = [prog_trace(), toy_trace()]
    ctls = _ctls(CrossTableLookup, CtlView, Filter, col)
    kw = dict(public_inputs=PUBLIC, table_public_inputs={0: PUBLIC})
    one = prove_all([ProgStark(), ToyStark()], traces, ctls, _cfg(),
                    device="cpu", **kw)
    many = prove_all([ProgStark(), ToyStark()], traces, ctls, _cfg(),
                     mesh=cpu_mesh(4), **kw)
    assert proof_to_json(many) == proof_to_json(one)


# ---- units ----------------------------------------------------------------

@pytest.mark.parametrize("rate_bits", [1, 2, 3])
def test_next_row_blocks_is_the_perm(rate_bits):
    """Every next row of block s lies in block br_k((br_k(s) + 2^rate)
    mod k), itself while k <= 2^rate; the block map rebuilds
    `next_row_perm_bitrev`."""
    log_m = 7
    perm = domains.next_row_perm_bitrev(log_m, rate_bits)
    for log_k in range(5):
        k = 1 << log_k
        step = (1 << log_m) // k
        src, local = next_row_blocks(log_m, rate_bits, k)
        brk = bit_reverse_indices(log_k)
        got = np.concatenate([
            src[s] * step + (np.arange(step) if local[s] is None
                             else local[s]) for s in range(k)])
        assert np.array_equal(got, perm), (rate_bits, k)
        for s in range(k):
            assert src[s] == brk[(brk[s] + (1 << rate_bits)) % k]
            if k <= 1 << rate_bits:
                assert src[s] == s


@pytest.mark.parametrize("k", [2, 4, 8])
def test_selector_blocks_are_slices(k):
    whole = selector_tables(6, 1, "cpu")
    parts = [selector_tables(6, 1, "cpu", block=(s, k)) for s in range(k)]
    for name, v in whole.items():
        got = np.concatenate([p[name].to_u64() for p in parts])
        assert np.array_equal(got, v.to_u64()), name


def aux_case(n: int = 64):
    """A random 6-column trace with a lookup reading a next row (so each
    block needs its halo row) and two CTL groups, one filtered, under two
    challenge pairs."""
    rng = np.random.default_rng(5)
    trace = GF.from_u64(rng.integers(0, P, size=(6, n), dtype=np.uint64))
    lookups = [Lookup(looking_columns=(col(2), col_next(3)),
                      table_column=1, frequencies_column=4)]
    groups = [(0, "looking", [CtlView(table=0, columns=(0, 5),
                                      filter=Filter(column=4))]),
              (1, "looked", [CtlView(table=0, columns=(1,)),
                             CtlView(table=0, columns=(2, 3)),
                             CtlView(table=0, columns=(5,))])]
    b0, g0, b1, g1 = (int(x) for x in rng.integers(0, P, 4,
                                                    dtype=np.uint64))
    challenges = ChallengeSet(((b0, g0), (b1, g1)))
    return trace, lookups, groups, challenges


@pytest.mark.parametrize("k", [2, 4, 8])
def test_block_aux_is_generate_aux_trace(k):
    trace, lookups, groups, challenges = aux_case()
    want = lookup.generate_aux_trace(trace, lookups, groups, challenges)
    reset_block_runs()
    got = lookup.generate_aux_trace(trace, lookups, groups, challenges,
                                    mesh=cpu_mesh(k))
    assert block_runs("aux") == {64 // k: k}
    assert np.array_equal(got.to_u64(), want.to_u64())
    # every running sum's carries mattered: Z's first row is the total
    z = lookup.aux_z_indices(lookups, groups, challenges)
    assert len(z) == 6 and all(int(want.to_u64()[i, 0]) for i in z)


@pytest.mark.parametrize("k", [2, 4, 8])
def test_block_g_and_folds(k):
    """G from each oracle's row blocks, then three folds of those blocks
    with their slices of the pairs' inverse points: the whole arrays'."""
    rng = np.random.default_rng(k)
    log_n, rate_bits = 5, 1
    log_m = log_n + rate_bits
    oracles = [PolynomialBatch.from_values(GF.from_u64(rng.integers(
        0, P, size=(c, 1 << log_n), dtype=np.uint64)), rate_bits=rate_bits,
        cap_height=1, mesh=cpu_mesh(k)) for c in (3, 5)]

    def ext():
        return tuple(int(x) for x in rng.integers(0, P, 2, dtype=np.uint64))

    batches = [fri.FriOpeningBatch(point=ext(), entries=[(0, 1), (1, 0),
                                                         (1, 4)],
                                   values=[ext() for _ in range(3)]),
               fri.FriOpeningBatch(point=ext(), entries=[(0, 2)],
                                   values=[ext()])]
    terms = fri._g_terms(batches, ext())
    xs = fri.coset_points_bitrev(log_m, host.MULT_GENERATOR)
    whole = fri._g_values(terms, [whole_lde(o) for o in oracles],
                          GF.from_u64(xs))
    step = (1 << log_m) // k
    per_oracle = [o.row_blocks(["cpu"] * k) for o in oracles]
    blocks = [fri._g_values(terms, [b[s] for b in per_oracle],
                            GF.from_u64(xs[s * step:(s + 1) * step]))
              for s in range(k)]
    assert_ext_equal(fri._gather_ext(blocks, "cpu"), whole)
    shift, beta = host.MULT_GENERATOR, ext()
    for _ in range(3):
        x_inv = fri._pair_x_inv_bitrev(log_m, shift)
        whole = fri._fold_once(whole, GFE.const(*beta), GF.from_u64(x_inv))
        blocks = fri._fold_blocks(blocks, beta, x_inv)
        assert_ext_equal(fri._gather_ext(blocks, "cpu"), whole)
        shift, log_m = host.fmul(shift, shift), log_m - 1


def assert_ext_equal(a: GFE, b: GFE) -> None:
    assert np.array_equal(a.a.to_u64(), b.a.to_u64())
    assert np.array_equal(a.b.to_u64(), b.b.to_u64())


def test_batch_keeps_blocks_where_they_are():
    """A mesh batch's coefficients stay in their polys groups and its LDE
    in its row blocks; the tree answers queried rows from those blocks;
    gathered, they are the single-device batch's."""
    values = GF.from_u64(np.random.default_rng(2).integers(
        0, P, size=(6, 32), dtype=np.uint64))
    one = PolynomialBatch.from_values(values, cap_height=2)
    many = PolynomialBatch.from_values(values, cap_height=2,
                                       mesh=cpu_mesh(4))
    assert [c.shape for c in many.coeff_groups] == [(2, 32), (1, 32),
                                                    (1, 32), (2, 32)]
    assert [b.shape for b in many.lde_blocks] == [(6, 16)] * 4
    assert many.tree.leaf_blocks[1].v.data_ptr() == \
        many.lde_blocks[1].v.data_ptr()
    idx = [63, 0, 17, 40, 17]
    assert np.array_equal(many.tree.leaves_at(idx), one.tree.leaves_at(idx))
    zs = [(3, 5), (1, 0)]
    assert np.array_equal(many.open_at(zs), one.open_at(zs))
    assert np.array_equal(whole_lde(many).to_u64(), one.lde.to_u64())
