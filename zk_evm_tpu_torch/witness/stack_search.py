"""Minimum-cost %stack expansion: Dijkstra over stack states.

The assembler's %stack directives ask for an arbitrary stack rewrite
(drop/keep/duplicate/reorder named slots, inject pushes). The reference
finds the cheapest POP/PUSH/DUP/SWAP sequence with a shortest-path
search whose edge costs weight CPU rows against memory-table rows
(cpu/kernel/stack/stack_manipulation.rs:90-167, 285-311); the naive
expansion in assembler.py is correct but spends extra cycles, and every
extra kernel cycle is a CPU-table row that must be proven.

State = tuple of stack items, index 0 = TOP (the assembler-local
convention). Candidate moves are pruned as in the reference
(next_ops, stack_manipulation.rs:206-266):
  - top-of-stack not needed in dst  -> POP is the only candidate;
  - src a (unique-item) permutation of dst -> the single greedy
    cycle-chasing swap (optimal for permutations);
  - PUSH/DUP only when dst still needs more copies of that item;
  - SWAP_i only if it lands one of the two touched items correctly.

Every found sequence is re-simulated before use; on node-budget
exhaustion the caller falls back to the naive expansion, so the search
is a pure cycle optimization, never a correctness dependency.
"""

from __future__ import annotations

import heapq

# Edge-cost weights: rows added to the CPU table (85 columns,
# tables/cpu_columns.py) vs the memory table (30 columns,
# tables/memory.py) per operation — mirrors the reference's
# StackOp::cost (stack_manipulation.rs:285-311). Only the ratio
# matters; hardcoded to keep the assembler jax-free.
_CPU_W = 85
_MEM_W = 30

MAX_NODES = 40_000


def _push_bytes(item) -> int:
    """Byte length of a PUSH's immediate (trimmed big-endian; labels are
    BYTES_PER_OFFSET=3)."""
    kind, value = item[1], item[2]
    if kind == "literal":
        v = int(value)
        return max(1, (v.bit_length() + 7) // 8)
    return 3


def _op_cost(op) -> int:
    name = op[0]
    if name == "pop":
        cpu, mem = 1, 1
    elif name == "dup":
        cpu, mem = 1, 2
    elif name == "swap":
        cpu, mem = 1, 3
    else:  # push
        cpu, mem = 1, _push_bytes(op[1]) + 1
    return cpu * _CPU_W + mem * _MEM_W


def _apply(stack: tuple, op) -> tuple | None:
    name = op[0]
    if name == "pop":
        return stack[1:] if stack else None
    if name == "push":
        return (op[1],) + stack
    if name == "dup":
        i = op[1]
        if i > len(stack):
            return None
        return (stack[i - 1],) + stack
    i = op[1]                                     # swap
    if i >= len(stack):
        return None
    lst = list(stack)
    lst[0], lst[i] = lst[i], lst[0]
    return tuple(lst)


def _perm_next_swap(cur: tuple, dst: tuple):
    """One step of the optimal top-swap routine for (unique-item)
    permutations: put the top in its place, else bring up the first
    misplaced item."""
    if cur[0] != dst[0]:
        q = dst.index(cur[0])
        return ("swap", q)
    p = next((i for i in range(len(cur)) if cur[i] != dst[i]), None)
    return None if p is None else ("swap", p)


def _candidates(cur: tuple, dst: tuple, push_items: list,
                wide: bool = False):
    if cur and cur[0] not in dst:
        return [("pop",)]
    if (len(cur) == len(dst) and len(set(cur)) == len(cur)
            and set(cur) == set(dst)):
        op = _perm_next_swap(cur, dst)
        return [op] if op and op[1] <= 16 else []
    ops = [("pop",)] if cur else []
    for it in push_items:
        if dst.count(it) > cur.count(it):
            ops.append(("push", it))
    for i in range(1, min(len(cur), 16) + 1):
        it = cur[i - 1]
        if dst.count(it) > cur.count(it):
            ops.append(("dup", i))
    # Positions are stable from the BOTTOM (pushes/pops act on top), so
    # "lands correctly" compares bottom-aligned slots: cur top-index j
    # corresponds to dst top-index j + d (stack_manipulation.rs:268-283).
    # `wide` drops that pruning (the retry pass: some below-top
    # reorderings need a swap that makes no immediate progress).
    d = len(dst) - len(cur)
    for i in range(1, min(len(cur), 16)):
        top_lands = 0 <= i + d < len(dst) and cur[0] == dst[i + d]
        other_lands = 0 <= d < len(dst) and cur[i] == dst[d]
        if wide or top_lands or other_lands:
            ops.append(("swap", i))
    return ops


def shortest_path(src: list, dst: list,
                  max_nodes: int = MAX_NODES) -> list | None:
    """Cheapest op sequence turning `src` into `dst` (index 0 = top).
    Items must be hashable; push-able items are tuples
    ("push", kind, value) and may repeat. Returns ops as
    [("pop",) | ("push", item) | ("dup", i) | ("swap", i), ...] or None
    if the node budget runs out. Runs the reference-pruned search
    first, then once more with the swap pruning dropped."""
    out = _search(src, dst, max_nodes, wide=False)
    if out is None:
        out = _search(src, dst, max_nodes, wide=True)
    return out


def _search(src: list, dst: list, max_nodes: int,
            wide: bool) -> list | None:
    src_t, dst_t = tuple(src), tuple(dst)
    push_items = []
    for it in dst_t:
        if isinstance(it, tuple) and it[0] == "push" \
                and it not in push_items:
            push_items.append(it)
    best = {src_t: (0, None, None)}               # state -> (cost, parent, op)
    tie = 0                                       # heap tiebreaker: states
    heap = [(0, 0, src_t)]                        # aren't orderable
    seen = 0
    while heap and seen < max_nodes:
        cost, _, cur = heapq.heappop(heap)
        if best[cur][0] < cost:
            continue
        seen += 1
        if cur == dst_t:
            ops = []
            st = cur
            while best[st][1] is not None:
                _, parent, op = best[st]
                ops.append(op)
                st = parent
            ops.reverse()
            # safety: re-simulate before trusting the result
            chk = src_t
            for op in ops:
                chk = _apply(chk, op)
                assert chk is not None
            assert chk == dst_t
            return ops
        for op in _candidates(cur, dst_t, push_items, wide=wide):
            nxt = _apply(cur, op)
            if nxt is None or len(nxt) > len(src_t) + len(dst_t):
                continue
            c = cost + _op_cost(op)
            if nxt not in best or c < best[nxt][0]:
                best[nxt] = (c, cur, op)
                tie += 1
                heapq.heappush(heap, (c, tie, nxt))
    return None
