"""The memory-continuation chain MemBefore -> Memory -> MemAfter as an
AllStark input: the traces of `all_stark.all_starks()`, with Memory,
MemBefore and MemAfter in use and every other table None. The JAX package
proves the same chain in `__graft_entry__.py`.

    words = preinitialized_words(3 << 18, seed=0)
    traces = chain_traces(words)
    proof = prove_all(all_starks(), traces, all_cross_table_lookups(), cfg)
"""

from __future__ import annotations

import numpy as np

from . import memory, memory_continuation
from .all_stark import NUM_TABLES, Table
from .segments import Segment

def preinitialized_words(n_words: int, seed: int = 0) -> list:
    """`n_words` ((context, segment, virt), value) pairs with random 256-bit
    values from numpy's generator at `seed`. The words fill six blocks
    of contiguous virtual addresses from 0, contexts 0-2 x {Code,
    MainMemory}, so the Memory trace needs few gap rows and every range
    check stays below its row count."""
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 32, size=(n_words, 8), dtype=np.uint32)
    raw = limbs.astype("<u4").tobytes()
    blocks = [(c, s) for c in range(3)
              for s in (Segment.Code, Segment.MainMemory)]
    per_block = -(-n_words // len(blocks))
    words = []
    for i in range(n_words):
        ctx, seg = blocks[i // per_block]
        value = int.from_bytes(raw[32 * i:32 * i + 32], "little")
        words.append(((ctx, seg, i % per_block), value))
    return words


def chain_traces(mem_before_values) -> list:
    """The AllStark traces of a segment whose memory starts as
    `mem_before_values` and sees no other operation: MemBefore holds the
    words, Memory writes them at timestamp 0, MemAfter reads them back."""
    mem_trace, mem_after = memory.generate_trace(
        [], mem_before_values=mem_before_values)
    traces = [None] * NUM_TABLES
    traces[Table.Memory] = mem_trace
    traces[Table.MemBefore] = memory_continuation.generate_trace(
        mem_before_values)
    traces[Table.MemAfter] = memory_continuation.generate_trace(mem_after)
    return traces
