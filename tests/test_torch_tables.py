"""The PyTorch port's copies of the nine eth_mainnet tables against the JAX
package: column counts, logUp lookups and the CTL wiring by repr; every
table's constraints evaluated on the same random frame, in the prover's
algebra (an 8-row GF frame) and in the verifier's (HExt scalars); and the
Memory and MemBefore/MemAfter trace generators. All comparisons exact."""

import numpy as np
import pytest

from zk_evm_tpu.field import GF as JGF, host
from zk_evm_tpu.field.hext import HExt as JHExt
from zk_evm_tpu.stark import lookup as jlk
from zk_evm_tpu.stark.stark import (ConstraintConsumer as JConsumer,
                                    StarkFrame as JFrame)
from zk_evm_tpu.tables import all_stark as jast
from zk_evm_tpu.tables import memory as jmem
from zk_evm_tpu.tables import memory_continuation as jmc
from zk_evm_tpu_torch.field import GF
from zk_evm_tpu_torch.field.hext import HExt
from zk_evm_tpu_torch.stark import lookup as lk
from zk_evm_tpu_torch.stark.stark import ConstraintConsumer, StarkFrame
from zk_evm_tpu_torch.tables import all_stark as ast
from zk_evm_tpu_torch.tables import memory as mem
from zk_evm_tpu_torch.tables import memory_continuation as mc
from zk_evm_tpu_torch.tables.segments import Segment

P = host.P
ROWS = 8
TABLES = ["Arithmetic", "BytePacking", "Cpu", "Keccak", "KeccakSponge",
          "Logic", "Memory", "MemBefore", "MemAfter"]


def table_index(name):
    idx = getattr(ast.Table, name)
    assert idx == getattr(jast.Table, name)
    return idx


def test_table_list():
    assert ast.NUM_TABLES == jast.NUM_TABLES == len(TABLES)
    assert ast.OPTIONAL_TABLES == jast.OPTIONAL_TABLES
    assert ast.MEMORY_CTL_IDX == jast.MEMORY_CTL_IDX
    assert [type(s).__name__ for s in ast.all_starks()] == \
        [type(s).__name__ for s in jast.all_starks()]


def test_ctl_list_equal():
    ctls = ast.all_cross_table_lookups()
    jctls = jast.all_cross_table_lookups()
    assert [c.name for c in ctls] == [c.name for c in jctls]
    assert [repr(c) for c in ctls] == [repr(c) for c in jctls]


@pytest.mark.parametrize("table", TABLES)
def test_table_spec_equal(table):
    t = table_index(table)
    stark, jstark = ast.all_starks()[t], jast.all_starks()[t]
    assert stark.name == jstark.name
    assert stark.num_columns == jstark.num_columns
    assert stark.num_public_inputs == jstark.num_public_inputs
    assert stark.requires_ctls() == jstark.requires_ctls()
    assert repr(stark.lookups()) == repr(jstark.lookups())
    groups = lk.ctl_groups_for_table(ast.all_cross_table_lookups(), t)
    jgroups = jlk.ctl_groups_for_table(jast.all_cross_table_lookups(), t)
    assert repr(groups) == repr(jgroups)
    pairs = lk.ChallengeSet(((3, 5), (7, 11)))
    jpairs = jlk.ChallengeSet(((3, 5), (7, 11)))
    assert lk.num_aux_columns(stark.lookups(), groups, 2) == \
        jlk.num_aux_columns(jstark.lookups(), jgroups, 2)
    assert lk.ctl_z_first_indices(stark.lookups(), groups, pairs) == \
        jlk.ctl_z_first_indices(jstark.lookups(), jgroups, jpairs)


def recorder(base, normalize):
    """A consumer of `base`'s class that records every constraint value
    (selectors applied) as uint64 rows instead of folding them."""
    class Recorder(base):
        def __init__(self, z_last, l_first, l_last, zero):
            super().__init__(alphas=[], zero=zero, z_last=z_last,
                             lagrange_first=l_first, lagrange_last=l_last)
            self.rows = []
            self._zero = zero

        def constraint(self, c):
            self.rows.append(normalize(self._zero + c))

        def constraint_block(self, cs):
            if isinstance(cs, (list, tuple)):
                for c in cs:
                    self.constraint(c)
                return
            self.rows.extend(normalize(cs).reshape(-1, ROWS))
    return Recorder


def gf_rows(x):
    return np.broadcast_to(x.to_u64(), x.shape[:-1] + (ROWS,)) \
        if x.shape else np.full(ROWS, x.to_u64())


def hext_rows(x):
    return np.array(x.v, dtype=np.uint64)


def random_frame(rng, width):
    vals = rng.integers(0, P, size=(2, width, ROWS), dtype=np.uint64)
    # a third of the cells small, so flag and range constraints see
    # realistic values as well as arbitrary ones
    vals[:, :, ::3] %= 4
    sel = rng.integers(0, P, size=(3, ROWS), dtype=np.uint64)
    return vals, sel


@pytest.mark.parametrize("table", TABLES)
def test_eval_gf_frame_equal(table):
    """The prover's algebra: the table's eval over (cols, 8) GF frames."""
    t = table_index(table)
    stark, jstark = ast.all_starks()[t], jast.all_starks()[t]
    vals, sel = random_frame(np.random.default_rng(t), stark.num_columns)
    rec = recorder(ConstraintConsumer, gf_rows)(
        *(GF.from_u64(s) for s in sel), GF.zeros((ROWS,)))
    stark.eval(StarkFrame(local=GF.from_u64(vals[0]),
                          next_=GF.from_u64(vals[1])), rec)
    jrec = recorder(JConsumer, gf_rows)(
        *(JGF.from_u64(s) for s in sel), JGF.zeros((ROWS,)))
    jstark.eval(JFrame(local=JGF.from_u64(vals[0]),
                       next_=JGF.from_u64(vals[1])), jrec)
    assert len(rec.rows) == len(jrec.rows) > 0
    np.testing.assert_array_equal(np.stack(rec.rows), np.stack(jrec.rows))


@pytest.mark.parametrize("table", TABLES)
def test_eval_hext_frame_equal(table):
    """The verifier's algebra: the table's eval over HExt scalars."""
    t = table_index(table)
    stark, jstark = ast.all_starks()[t], jast.all_starks()[t]
    rng = np.random.default_rng(100 + t)
    vals = rng.integers(0, P, size=(2, stark.num_columns, 2),
                        dtype=np.uint64)
    sel = [tuple(int(v) for v in rng.integers(0, P, size=2,
                                              dtype=np.uint64))
           for _ in range(3)]

    def frame(cls, hext):
        return cls(local=[hext(tuple(map(int, v))) for v in vals[0]],
                   next_=[hext(tuple(map(int, v))) for v in vals[1]])
    rec = recorder(ConstraintConsumer, hext_rows)(
        *(HExt(s) for s in sel), HExt.zero())
    rec.constraint_block = lambda cs: [rec.constraint(c) for c in cs]
    stark.eval(frame(StarkFrame, HExt), rec)
    jrec = recorder(JConsumer, hext_rows)(
        *(JHExt(s) for s in sel), JHExt.zero())
    jrec.constraint_block = lambda cs: [jrec.constraint(c) for c in cs]
    jstark.eval(frame(JFrame, JHExt), jrec)
    assert len(rec.rows) == len(jrec.rows) > 0
    np.testing.assert_array_equal(np.stack(rec.rows), np.stack(jrec.rows))


def random_memory(seed, n_ops=60):
    """Random reads and writes over a few addresses of three segments, and
    some preinitialized words; the same ints go to both packages."""
    rng = np.random.default_rng(seed)
    segs = (Segment.Code, Segment.Stack, Segment.MainMemory)
    ops = []
    ts = 1
    for _ in range(n_ops):
        ts += int(rng.integers(1, 40))
        ops.append((True, ts, int(rng.integers(0, 3)),
                    segs[int(rng.integers(0, 3))], int(rng.integers(0, 30)),
                    bool(rng.integers(0, 2)),
                    int.from_bytes(rng.bytes(32), "little")))
    before = [((0, Segment.Code, v), int.from_bytes(rng.bytes(32), "little"))
              for v in range(0, 20, 3)]
    return ops, before


@pytest.mark.parametrize("seed,stale", [(1, []), (2, [2])],
                         ids=["plain", "stale_context"])
def test_memory_generate_trace_equal(seed, stale):
    ops, before = random_memory(seed)
    trace, after = mem.generate_trace([mem.MemoryOp(*o) for o in ops],
                                      mem_before_values=before,
                                      stale_contexts=stale)
    jtrace, jafter = jmem.generate_trace([jmem.MemoryOp(*o) for o in ops],
                                         mem_before_values=before,
                                         stale_contexts=stale)
    np.testing.assert_array_equal(trace, jtrace)
    assert after == jafter
    np.testing.assert_array_equal(mc.generate_trace(after),
                                  jmc.generate_trace(jafter))
    np.testing.assert_array_equal(mc.generate_trace(before),
                                  jmc.generate_trace(before))
