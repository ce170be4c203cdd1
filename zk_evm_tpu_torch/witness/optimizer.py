"""Peephole optimizer over assembled kernel items.

Runs after %stack expansion, before label resolution — the same pipeline
position as the reference (cpu/kernel/assembler.rs:135-137), with the
same rule set (cpu/kernel/optimizer.rs:33-212): constant propagation,
identity operations, no-op jumps, swapped pushes, swaps before
commutative ops, push/dup-pop elimination, and the De Morgan rewrites.
Passes repeat until a fixpoint. Every rule is a strict window rewrite on
Push/StandardOp/label items, so labels, jumptables, BYTES blocks and
PROVER_INPUT markers are never disturbed.

Omitted relative to the reference: BYTE constant folding (the reference
folds via U256::byte's little-endian index; rather than inherit that
subtlety we skip the rule — it never fires in the current kernel).
"""

from __future__ import annotations

from . import asm_parser as ap

_U256 = (1 << 256) - 1

# Cost model for "is the rewrite an improvement": one CPU row per op
# dominates bytes of pushed immediates (same weights as stack_search;
# the reference uses cost_estimator.rs for this gate).
_CPU_W, _BYTE_W = 85, 30


def _lit(it):
    return (it.target.value
            if isinstance(it, ap.Push) and it.target.kind == "literal"
            else None)


def _op(it):
    return it.name if isinstance(it, ap.StandardOp) else None


def _is_push_or_dup(it):
    return isinstance(it, ap.Push) or \
        (isinstance(it, ap.StandardOp) and it.name.startswith("DUP"))


def _push(v: int) -> ap.Push:
    return ap.Push(ap.PushTarget("literal", v & _U256))


def _cost(items) -> int:
    c = 0
    for it in items:
        if isinstance(it, ap.Push):
            v = it.target.value
            nbytes = max(1, (int(v).bit_length() + 7) // 8) \
                if it.target.kind == "literal" else 3
            c += _CPU_W + _BYTE_W * (nbytes + 1)
        else:
            c += _CPU_W + _BYTE_W
    return c


def _bool(x: bool) -> int:
    return 1 if x else 0


def _binop(op: str, x: int, y: int):
    """BINOP(x, y) with x the top of stack (optimizer.rs:60-88);
    wrap-around u256 semantics."""
    if op == "ADD":
        return (x + y) & _U256
    if op == "SUB":
        return (x - y) & _U256
    if op == "MUL":
        return (x * y) & _U256
    if op == "DIV":
        return x // y if y else 0
    if op == "MOD":
        return x % y if y else 0
    if op == "EXP":
        return pow(x, y, 1 << 256)
    if op == "SHL":
        return (y << x) & _U256 if x < 256 else 0
    if op == "SHR":
        return y >> x if x < 256 else 0
    if op == "AND":
        return x & y
    if op == "OR":
        return x | y
    if op == "XOR":
        return x ^ y
    if op == "LT":
        return _bool(x < y)
    if op == "GT":
        return _bool(x > y)
    if op == "EQ":
        return _bool(x == y)
    return None


def _replace_windows(items, width, fn, if_better=False):
    """Slide a window over the items, applying fn(window)->list|None;
    restarts at the replacement point so cascades resolve in one call."""
    out = list(items)
    i = 0
    while i + width <= len(out):
        window = out[i:i + width]
        rep = fn(window)
        if rep is not None and (not if_better
                                or _cost(rep) < _cost(window)):
            out[i:i + width] = rep
            i = max(0, i - width + 1)
        else:
            i += 1
    return out


def _rule_const_unary(w):
    x = _lit(w[0])
    if x is None:
        return None
    if _op(w[1]) == "ISZERO":
        return [_push(_bool(x == 0))]
    if _op(w[1]) == "NOT":
        return [_push(~x & _U256)]
    return None


def _rule_const_binary(w):
    y, x, op = _lit(w[0]), _lit(w[1]), _op(w[2])
    if y is None or x is None or op is None:
        return None
    r = _binop(op, x, y)
    return None if r is None else [_push(r)]


def _rule_identity(w):
    x, op = _lit(w[0]), _op(w[1])
    if x is None:
        return None
    if (x == 0 and op in ("ADD", "OR", "XOR")) or (x == 1 and op == "MUL"):
        return []
    return None


def _rule_no_op_jump(w):
    if (isinstance(w[0], ap.Push) and w[0].target.kind == "label"
            and _op(w[1]) == "JUMP"
            and isinstance(w[2], (ap.GlobalLabel, ap.LocalLabel))
            and w[2].name == w[0].target.value):
        return [w[2]]
    return None


def _rule_swapped_pushes(w):
    if (isinstance(w[0], ap.Push) and isinstance(w[1], ap.Push)
            and _op(w[2]) == "SWAP1"):
        return [w[1], w[0]]
    return None


def _rule_swap_commutative(w):
    if _op(w[0]) == "SWAP1" and _op(w[1]) in ("ADD", "MUL", "AND",
                                              "OR", "XOR", "EQ"):
        return [w[1]]
    return None


def _rule_ignored_value(w):
    if _is_push_or_dup(w[0]) and _op(w[1]) == "POP":
        return []
    return None


def _rule_de_morgan(w):
    # w[2] must produce a value independent of the top of stack: DUP1
    # would copy the first NOT's output in the original but the raw
    # value after the rewrite, so it is excluded (DUPk, k>=2, reads a
    # depth the rewrite leaves unchanged).
    if (_is_push_or_dup(w[0]) and _op(w[1]) == "NOT"
            and _is_push_or_dup(w[2]) and _op(w[2]) != "DUP1"
            and _op(w[3]) == "NOT"
            and _op(w[4]) in ("AND", "OR")):
        flipped = "OR" if _op(w[4]) == "AND" else "AND"
        return [w[0], w[2], ap.StandardOp(flipped), ap.StandardOp("NOT")]
    return None


def optimize_once(items):
    items = _replace_windows(items, 2, _rule_const_unary, if_better=True)
    items = _replace_windows(items, 3, _rule_const_binary, if_better=True)
    items = _replace_windows(items, 2, _rule_identity)
    items = _replace_windows(items, 3, _rule_no_op_jump)
    items = _replace_windows(items, 3, _rule_swapped_pushes)
    items = _replace_windows(items, 2, _rule_swap_commutative)
    items = _replace_windows(items, 2, _rule_ignored_value)
    items = _replace_windows(items, 5, _rule_de_morgan)
    return items


def optimize_asm(items):
    """Apply all rules until fixpoint (optimizer.rs:13-31)."""
    while True:
        new = optimize_once(items)
        if new == items:
            return new
        items = new
