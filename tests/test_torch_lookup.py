"""The logUp / cross-table-lookup auxiliary trace of the PyTorch port
against the JAX package: `generate_aux_trace` column for column for the
memory-continuation chain at Memory 2^7 rows (Memory's two lookups and
four CTL groups, MemBefore's and MemAfter's groups) and for a one-lookup
range table; the host view sums; and the exact suffix sum. Exact."""

import numpy as np
import pytest

from zk_evm_tpu.field import GF as JGF, host
from zk_evm_tpu.stark import lookup as jlk
from zk_evm_tpu.tables import all_stark as jast
from zk_evm_tpu_torch.field import GF
from zk_evm_tpu_torch.stark import Stark, lookup as lk
from zk_evm_tpu_torch.tables import all_stark as ast
from zk_evm_tpu_torch.tables.memory_chain import (chain_traces,
                                                  preinitialized_words)
from test_lookup_ctl import RangeStark as JRangeStark

P = host.P
rng = np.random.default_rng(33)
PAIRS = tuple((int(b), int(g)) for b, g in
              rng.integers(0, P, size=(2, 2), dtype=np.uint64))
CHAIN = ["Memory", "MemBefore", "MemAfter"]


class RangeStark(Stark):
    """tests/test_lookup_ctl.py's RangeStark over the port's Stark:
    columns V0, V1 (looked-up values), T (counter 0..n-1), F (freqs)."""
    name = "range"
    num_columns = 4

    def eval(self, frame, cc):
        t = frame.local[2]
        cc.constraint_first_row(t)
        cc.constraint_transition(frame.next[2] - t - 1)

    def lookups(self):
        return [lk.Lookup(looking_columns=(0, 1), table_column=2,
                          frequencies_column=3)]


def range_trace(n, seed):
    r = np.random.default_rng(seed)
    tr = np.zeros((4, n), dtype=np.uint64)
    tr[:2] = r.integers(0, n, size=(2, n), dtype=np.uint64)
    tr[2] = np.arange(n, dtype=np.uint64)
    tr[3] = np.bincount(tr[:2].ravel().astype(np.int64), minlength=n)
    return tr


@pytest.fixture(scope="module")
def chain():
    traces = chain_traces(preinitialized_words(100, seed=7))
    assert traces[ast.Table.Memory].shape == (30, 1 << 7)
    return traces


def aux_pair(trace, lookups, jlookups, groups, jgroups):
    aux = lk.generate_aux_trace(GF.from_u64(trace, "cpu"), lookups, groups,
                                lk.ChallengeSet(PAIRS))
    jaux = jlk.generate_aux_trace(JGF.from_u64(trace), jlookups, jgroups,
                                  jlk.ChallengeSet(PAIRS))
    return aux.to_u64(), jaux.to_u64()


@pytest.mark.parametrize("table", CHAIN)
def test_chain_aux_trace_equal(chain, table):
    t = getattr(ast.Table, table)
    stark, jstark = ast.all_starks()[t], jast.all_starks()[t]
    groups = lk.ctl_groups_for_table(ast.all_cross_table_lookups(), t)
    jgroups = jlk.ctl_groups_for_table(jast.all_cross_table_lookups(), t)
    aux, jaux = aux_pair(chain[t], stark.lookups(), jstark.lookups(), groups,
                         jgroups)
    n_aux = lk.num_aux_columns(stark.lookups(), groups, len(PAIRS))
    assert aux.shape == (n_aux, chain[t].shape[1])
    np.testing.assert_array_equal(aux, jaux)


def test_range_aux_trace_equal():
    trace = range_trace(32, seed=4)
    aux, jaux = aux_pair(trace, RangeStark().lookups(),
                         JRangeStark().lookups(), [], [])
    assert aux.shape == (lk.num_aux_columns(RangeStark().lookups(), [], 2),
                         32)
    np.testing.assert_array_equal(aux, jaux)


def test_ctl_view_sums_equal(chain):
    """Every view of the chain's CTLs: the host logUp sum over its trace."""
    checked = 0
    for ctl, jctl in zip(ast.all_cross_table_lookups(),
                         jast.all_cross_table_lookups()):
        for view, jview in zip(ctl.looking + (ctl.looked,),
                               jctl.looking + (jctl.looked,)):
            trace = chain[view.table]
            if trace is None:
                continue
            for beta, gamma in PAIRS:
                assert lk.ctl_view_sum_np(trace, view, beta, gamma) == \
                    jlk.ctl_view_sum_np(trace, jview, beta, gamma)
            checked += 1
    assert checked >= 4


def test_suffix_sum_exact():
    """Z[i] = sum_{j >= i} x[j] mod p with every value near p, where a
    wrapping 64-bit cumulative sum would go wrong."""
    x = np.full((3, 257), P - 1, dtype=np.uint64)
    x[1] = rng.integers(P - (1 << 20), P, size=257, dtype=np.uint64)
    x[2] = rng.integers(0, P, size=257, dtype=np.uint64)
    got = lk._gf_suffix_sum(GF.from_u64(x)).to_u64()
    for row, out in zip(x, got):
        acc, want = 0, []
        for v in reversed(row.tolist()):
            acc = (acc + v) % P
            want.append(acc)
        assert out.tolist() == want[::-1]
