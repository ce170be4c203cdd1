"""Chunked (zk-continuation) wrap tapes: boundary tables + the splitter.

A tape is a straight-line program over a single-assignment RAM, so it
segments exactly like the EVM kernel (the JAX package's stark/DESIGN.md
"segmented wrap tapes"): slice the program into fixed-size chunks; each
chunk proves as its own system whose RAM imports the previous chunk's live cells
(timestamp-0 writes balanced by a MemBefore boundary table) and exports
the cells later chunks read (FINAL_EXPORT rows CTL'd to a MemAfter
boundary table). Adjacent chunks chain by boundary-table Merkle-cap
equality — the RvmMem twin of the EVM's MemBefore/MemAfter contract
(tables/memory_continuation.py; zk_evm's prover.rs:261-271).

Because the tape is single-assignment (every op writes a fresh address),
liveness is exact: a cell crosses boundary B iff it was written at or
before B and is read after B — no checkpoint/rollback analysis needed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..stark import Stark, Filter, ColExpr, col
from ..stark.lookup import CrossTableLookup, CtlView
from . import ram, vm
from ..tables import poseidon as ps
from ..timing import timed

# -- boundary table (FILTER, ADDR, VALUE) -------------------------------------

B_FILTER = 0
B_ADDR = 1
B_VALUE = 2
B_NUM_COLUMNS = 3


def boundary_trace(values: dict[int, int], min_rows: int = 2) -> np.ndarray:
    items = sorted(values.items())
    n = max(min_rows, 2)
    while n < len(items):
        n *= 2
    trace = np.zeros((B_NUM_COLUMNS, n), dtype=np.uint64)
    for r, (addr, val) in enumerate(items):
        trace[B_FILTER, r] = 1
        trace[B_ADDR, r] = addr
        trace[B_VALUE, r] = val
    return trace


def boundary_ctl_data():
    return (col(B_ADDR), col(B_VALUE))


def boundary_ctl_filter() -> Filter:
    return Filter(column=B_FILTER)


def boundary_looking_ram():
    """MemBefore rows injected into the RAM CTL as timestamp-0 writes
    (is_read=0, addr, value, ts=0) — tables/memory_continuation.py
    ctl_data_memory's shape for the scalar RAM."""
    return (ColExpr(const=0), col(B_ADDR), col(B_VALUE), ColExpr(const=0))


class RvmBoundaryStark(Stark):
    name = "rvm_boundary"
    num_columns = B_NUM_COLUMNS

    def __init__(self, name: str = "rvm_boundary"):
        self.name = name

    def eval(self, frame, cc):
        f = frame.local[B_FILTER]
        cc.constraint(f * (f - 1))

    def requires_ctls(self):
        return True


# -- chunked system -----------------------------------------------------------

RVM_T = 0
RAM_T = 1
POSEIDON_T = 2
BEFORE_T = 3
AFTER_T = 4


def chunk_ctls(npub: int, clk_base: int) -> list[CrossTableLookup]:
    """Per-chunk CTL set: the RAM bus gains the MemBefore looking view
    and global timestamps (clk_base offsets every channel's expression),
    plus the export CTL into MemAfter."""
    ram_looking = tuple(
        CtlView(table=RVM_T,
                columns=vm.ctl_looking_ram(npub, ch, clk_base=clk_base),
                filter=vm.ctl_looking_ram_filter(ch))
        for ch in range(vm.N_SLOTS)) + (
        CtlView(table=BEFORE_T, columns=boundary_looking_ram(),
                filter=boundary_ctl_filter()),)
    return [
        CrossTableLookup(
            name="rvm_ram",
            looking=ram_looking,
            looked=CtlView(table=RAM_T, columns=ram.ctl_data(),
                           filter=ram.ctl_filter())),
        CrossTableLookup(
            name="rvm_poseidon",
            looking=(CtlView(table=RVM_T,
                             columns=vm.ctl_looking_poseidon(npub),
                             filter=vm.ctl_looking_poseidon_filter()),),
            looked=CtlView(table=POSEIDON_T,
                           columns=ps.ctl_looked_permutation(),
                           filter=ps.ctl_looked_simple_filter())),
        CrossTableLookup(
            name="ram_after",
            looking=(CtlView(table=RAM_T, columns=ram.ctl_export_data(),
                             filter=ram.ctl_export_filter()),),
            looked=CtlView(table=AFTER_T, columns=boundary_ctl_data(),
                           filter=boundary_ctl_filter())),
    ]


@dataclass
class TapeChunk:
    index: int
    clk_base: int
    stark: vm.RvmStark
    rvm_trace: np.ndarray
    ram_trace: np.ndarray
    pose_ops: list
    before: dict
    after: dict


def split_tape(tape, rows_log: int) -> list[TapeChunk]:
    """Slice a finalized-able tape into 2^rows_log-op chunks with exact
    single-assignment liveness at every boundary."""
    return list(iter_split_tape(tape, rows_log))


def iter_split_tape(tape, rows_log: int):
    """`split_tape` one chunk at a time, in order: a caller that keeps
    only some chunks (or only a digest of their traces) never holds
    every chunk's traces at once."""
    if isinstance(tape, vm.NativeTape):
        yield from _split_tape_native(tape, rows_log)
        return
    from ..tables.poseidon import PoseidonSimpleOp
    assert all(v is not None for v in tape.public_inputs), \
        "unbound public inputs"
    lay = tape.lay
    C = 1 << rows_log
    n_ops = len(tape.rows)
    n_chunks = (n_ops + C - 1) // C
    if n_chunks <= 1:
        raise ValueError("tape fits one chunk; use Tape.finalize")

    # write/read clocks per address (ops record ts = clk*N_SLOTS+slot+1)
    write_clk: dict[int, int] = {}
    last_read_clk: dict[int, int] = {}
    for op in tape.ram_ops:
        clk = (op.timestamp - 1) // vm.N_SLOTS
        if op.is_read:
            last_read_clk[op.addr] = max(last_read_clk.get(op.addr, -1),
                                         clk)
        else:
            write_clk[op.addr] = clk

    for k in range(n_chunks):
        lo, hi = k * C, min((k + 1) * C, n_ops)
        rows = tape.rows[lo:hi]
        trace = np.zeros((lay["NUM_COLUMNS"], C), dtype=np.uint64)
        for r, row in enumerate(rows):
            for c, v in row.items():
                trace[c, r] = v % vm.P
        trace[lay["CLK"]] = np.arange(C, dtype=np.uint64)
        known = trace[:lay["NUM_KNOWN"]].copy()
        stark = vm.RvmStark(npub=tape.npub, known=known, clk_base=lo)

        # clk k's slots span ts in [k*N_SLOTS + 1, (k+1)*N_SLOTS]
        ts_lo = lo * vm.N_SLOTS + 1
        ts_hi = hi * vm.N_SLOTS
        chunk_ops = [o for o in tape.ram_ops
                     if ts_lo <= o.timestamp <= ts_hi]
        before = {a: tape.mem[a] for a, w in write_clk.items()
                  if w < lo and last_read_clk.get(a, -1) >= lo}
        after = {a: tape.mem[a] for a, w in write_clk.items()
                 if w < hi and last_read_clk.get(a, -1) >= hi}
        ram_trace = ram.generate_trace(chunk_ops, before_values=before,
                                       export_addrs=set(after))
        pose_inputs = [row for row in rows if row.get(vm.F_POSE)]
        pose_ops = [PoseidonSimpleOp(tuple(
            int(r[lay["PIN"][i]]) for i in range(12)))
            for r in pose_inputs]
        yield TapeChunk(index=k, clk_base=lo, stark=stark,
                        rvm_trace=trace, ram_trace=ram_trace,
                        pose_ops=pose_ops, before=before, after=after)


def _split_tape_native(tape: "vm.NativeTape", rows_log: int):
    """NativeTape fast path: traces, liveness and RAM traces come out of
    the C++ core as finished arrays (same chunk semantics as the python
    path; equality asserted in tests/test_tapecore.py)."""
    assert all(v is not None for v in tape.public_inputs), \
        "unbound public inputs"
    lay = tape.lay
    C = 1 << rows_log
    n_ops = len(tape.rows)
    n_chunks = (n_ops + C - 1) // C
    if n_chunks <= 1:
        raise ValueError("tape fits one chunk; use Tape.finalize")
    for k in range(n_chunks):
        lo, hi = k * C, min((k + 1) * C, n_ops)
        trace = tape.export_trace(lo, hi, C)
        known = trace[:lay["NUM_KNOWN"]].copy()
        stark = vm.RvmStark(npub=tape.npub, known=known, clk_base=lo)
        b_addrs, b_vals = tape.live_at(lo)
        a_addrs, a_vals = tape.live_at(hi)
        ram_trace = tape.ram_trace(lo, hi, before_addrs=b_addrs,
                                   export_addrs=a_addrs)
        yield TapeChunk(
            index=k, clk_base=lo, stark=stark, rvm_trace=trace,
            ram_trace=ram_trace, pose_ops=tape.export_pose_ops(lo, hi),
            before={int(a): int(v) for a, v in zip(b_addrs, b_vals)},
            after={int(a): int(v) for a, v in zip(a_addrs, a_vals)})


def prove_chunked(tape, config, rows_log: int, device=None):
    """Prove every chunk as its own 5-table system, on `device` (CUDA
    when not given). Returns (chunks, [(starks, AllProof)],
    public_inputs)."""
    with timed("split tape"):
        chunks = split_tape(tape, rows_log)
    pub = [int(v) for v in tape.public_inputs]
    out = []
    for ch in chunks:
        with timed(f"prove chunk {ch.index}"):
            out.append(prove_chunk(ch, pub, config, device=device))
    return chunks, out, pub


def prove_chunk(ch: TapeChunk, pub: list, config, device=None):
    """One chunk of `prove_chunked`: its 5-table system proved on
    `device` (CUDA when not given) with the tape's public inputs `pub`.
    Returns (starks, AllProof)."""
    from ..stark import prove_all
    starks = [ch.stark, ram.RvmMemStark(), ps.PoseidonStark(),
              RvmBoundaryStark("rvm_mem_before"),
              RvmBoundaryStark("rvm_mem_after")]
    traces = [ch.rvm_trace, ch.ram_trace,
              ps.generate_trace(ch.pose_ops) if ch.pose_ops else None,
              boundary_trace(ch.before) if ch.before else None,
              boundary_trace(ch.after) if ch.after else None]
    proof = prove_all(starks, traces, chunk_ctls(ch.stark.npub, ch.clk_base),
                      config, public_inputs=pub,
                      table_public_inputs={RVM_T: pub}, device=device)
    return starks, proof


def wrap_chunked_tape(t, chunks, proven, config, device=None):
    """Verify a WHOLE chunk chain in one tape: per-chunk AllStark replay
    (each chunk's program cap is a wrap constant), equal global publics
    across chunks, and the boundary-cap chain asserted on proof-data
    cells — one proof for the whole chunked tape, closing the recursion
    ladder over arbitrarily large wrap programs. Returns the global
    public-input cells. Each chunk's program cap is committed on
    `device` (CUDA when not given)."""
    from .verify_tape import verify_all_tape
    assert len(chunks) == len(proven)
    assert chunks[0].before == {} and chunks[-1].after == {}
    all_pubs = []
    all_results = []
    for ch, (starks, proof) in zip(chunks, proven):
        pubs, results = verify_all_tape(
            t, starks, proof, chunk_ctls(starks[RVM_T].npub,
                                         ch.clk_base), config,
            device=device)
        # link globally-observed publics to the Rvm's PUB bindings
        for g, r in zip(pubs, results[RVM_T].public_inputs):
            t.assert_eq(g, r)
        all_pubs.append(pubs)
        all_results.append(results)
    for pa, pb in zip(all_pubs, all_pubs[1:]):
        for ca, cb in zip(pa, pb):
            t.assert_eq(ca, cb)
    for ra, rb in zip(all_results, all_results[1:]):
        ma, mb = ra[AFTER_T], rb[BEFORE_T]
        assert ma is not None and mb is not None, \
            "boundary tables missing between chunks"
        for da, db in zip(ma.trace_cap, mb.trace_cap):
            for ca, cb in zip(da, db):
                t.assert_eq(ca, cb)
    return all_pubs[0]


def verify_chunked(chunks, proven, config,
                   expected_public_inputs=None, device=None) -> None:
    """Verify every chunk proof and the boundary-cap chain: chunk k's
    MemAfter trace cap must equal chunk k+1's MemBefore trace cap (the
    EVM's cap-chaining contract, orchestration/block.py
    check_segment_pair). The chunks' program caps are committed on
    `device` (CUDA when not given)."""
    assert len(chunks) == len(proven)
    for ch, (starks, proof) in zip(chunks, proven):
        verify_chunk(ch, starks, proof, config, expected_public_inputs,
                     device=device)
    assert chunks[0].before == {}, "first chunk must import nothing"
    assert chunks[-1].after == {}, "last chunk must export nothing"
    for (ca, (_, pa)), (cb, (_, pb)) in zip(zip(chunks, proven),
                                            list(zip(chunks, proven))[1:]):
        ma = pa.proofs[AFTER_T]
        mb = pb.proofs[BEFORE_T]
        if ma is None and mb is None:
            assert ca.after == {} and cb.before == {}
            continue
        assert ma is not None and mb is not None, \
            "boundary tables missing between chunks"
        assert [list(map(int, d)) for d in ma.trace_cap] == \
            [list(map(int, d)) for d in mb.trace_cap], \
            "MemAfter -> MemBefore boundary cap chain broken"


def verify_chunk(ch: TapeChunk, starks, proof, config,
                 expected_public_inputs=None, device=None) -> None:
    """One chunk of `verify_chunked`: its proof and its Rvm's public-input
    link, without the boundary-cap chain to its neighbours."""
    from ..stark import verify_all
    if expected_public_inputs is not None:
        assert list(proof.public_inputs) == \
            list(expected_public_inputs), "public inputs mismatch"
    assert list(proof.proofs[RVM_T].public_inputs) == \
        list(proof.public_inputs), "Rvm public input link mismatch"
    optional = tuple(
        i for i in (POSEIDON_T, BEFORE_T, AFTER_T)
        if proof.proofs[i] is None)
    verify_all(starks, proof, chunk_ctls(starks[RVM_T].npub, ch.clk_base),
               config, optional_tables=optional, device=device)
