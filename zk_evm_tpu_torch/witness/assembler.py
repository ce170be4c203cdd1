"""Kernel assembler: parsed .asm items -> bytecode + labels.

Pass pipeline mirrors the reference's assembler (zk_evm's
evm_arithmetization/src/cpu/kernel/assembler.rs): expand feature blocks
(done at parse), expand macros (hygienic labels "@{counter}.{label}"),
inline @constants, expand %stack directives, then two-phase label
resolution and emission with 3-byte jump offsets (BYTES_PER_OFFSET). The
kernel code hash (keccak256 of the bytecode) binds proofs to the kernel.

%stack expansion: a minimum-cost Dijkstra search over stack states
(stack_search.py, the reference's stack_manipulation.rs analog) with a
provably-correct naive expansion as fallback (build the rotated target
block with DUPs/PUSHes on top, then drop the old items below it). The
peephole optimizer (optimizer.py) then runs over the expanded items.
Together they cut the kernel ~33% in cycles and ~11% in bytes vs the
naive-only round-1 build.

The assembler builds the interpreter's `Kernel` (witness/kernel.py). The
.asm sources are not in this repository: `combined_kernel` reads them
from a zk_evm checkout named by ZK_EVM_REFERENCE (or `asm_dir`), and
without one serves the frozen stock build, data/kernel_eth_mainnet.json.gz.
"""

from __future__ import annotations

import gzip
import json
import os

from . import asm_parser as ap
from . import optimizer
from . import stack_search
from .kernel import (CONSTANTS_PATH, FROZEN_KERNEL_PATH, Kernel,
                     kernel_to_json, load_frozen_kernel)

BYTES_PER_OFFSET = 3

# the kernel's .asm tree inside a zk_evm checkout
KERNEL_ASM_SUBDIR = "evm_arithmetization/src/cpu/kernel"


def load_tables():
    with open(CONSTANTS_PATH) as f:
        data = json.load(f)
    constants = {k: int(v) for k, v in data["constants"].items()}
    opcodes = dict(data["opcodes"])
    # cdk-only privileged opcodes: decoded at witness/transition.rs:96-98
    # but absent from the reference's opcodes.rs mnemonic table (no
    # shipped .asm emits them yet); named here so cdk kernel routines
    # and test harnesses can assemble them
    opcodes.setdefault("POSEIDON", 0x22)
    opcodes.setdefault("POSEIDON_GENERAL", 0x23)
    return constants, opcodes, data["kernel_files"]


# ---------------------------------------------------------------------------
# Macro expansion
# ---------------------------------------------------------------------------

def find_macros(files):
    macros = {}
    for items in files:
        for it in items:
            if isinstance(it, ap.MacroDef):
                sig = (it.name, len(it.params))
                assert sig not in macros, f"duplicate macro {sig}"
                macros[sig] = it
    return macros


def expand_macros(items, macros, counter):
    out = []
    for it in items:
        if isinstance(it, ap.MacroDef):
            continue
        if isinstance(it, ap.MacroCall):
            out.extend(expand_macro_call(it, macros, counter))
        elif isinstance(it, ap.Repeat):
            for _ in range(it.count):
                out.extend(expand_macros(it.body, macros, counter))
        else:
            out.append(it)
    return out


def expand_macro_call(call, macros, counter):
    sig = (call.name, len(call.args))
    macro = macros.get(sig)
    assert macro is not None, f"no such macro: {sig}"
    n = counter[0]
    counter[0] += 1

    def actual_label(lbl):
        return f"@{n}.{lbl}"

    def get_arg(var):
        idx = macro.params.index(var)
        return call.args[idx]

    expanded = []
    for it in macro.body:
        if isinstance(it, ap.MacroLabelDecl):
            expanded.append(ap.LocalLabel(actual_label(it.name)))
        elif isinstance(it, ap.Push) and it.target.kind == "macro_label":
            expanded.append(ap.Push(ap.PushTarget("label",
                                                  actual_label(it.target.value))))
        elif isinstance(it, ap.Push) and it.target.kind == "var":
            expanded.append(ap.Push(get_arg(it.target.value)))
        elif isinstance(it, ap.MacroCall):
            new_args = []
            for a in it.args:
                if a.kind == "var":
                    new_args.append(get_arg(a.value))
                elif a.kind == "macro_label":
                    new_args.append(ap.PushTarget("label",
                                                  actual_label(a.value)))
                else:
                    new_args.append(a)
            expanded.append(ap.MacroCall(it.name, new_args))
        elif isinstance(it, ap.StackManipulation):
            new_repl = []
            for r in it.replacements:
                if r.kind == "macro_label":
                    new_repl.append(ap.StackRepl("ident",
                                                 actual_label(r.value)))
                elif r.kind == "var":
                    a = get_arg(r.value)
                    new_repl.append(ap.StackRepl(
                        "literal" if a.kind == "literal" else
                        ("const" if a.kind == "const" else "ident"),
                        a.value))
                else:
                    new_repl.append(r)
            expanded.append(ap.StackManipulation(it.placeholders, new_repl))
        else:
            expanded.append(it)
    return expand_macros(expanded, macros, counter)


def inline_constants(items, constants):
    def rc(name):
        assert name in constants, f"no such constant: {name}"
        return constants[name]

    out = []
    for it in items:
        if isinstance(it, ap.Push) and it.target.kind == "const":
            out.append(ap.Push(ap.PushTarget("literal", rc(it.target.value))))
        elif isinstance(it, ap.Bytes):
            targets = []
            for t in it.targets:
                if isinstance(t, tuple) and t[0] == "const":
                    v = rc(t[1])
                    assert v < 256
                    targets.append(v)
                else:
                    targets.append(t)
            out.append(ap.Bytes(targets))
        elif isinstance(it, ap.StackManipulation):
            repls = [ap.StackRepl("literal", rc(r.value))
                     if r.kind == "const" else r for r in it.replacements]
            out.append(ap.StackManipulation(it.placeholders, repls))
        else:
            out.append(it)
    return out


# ---------------------------------------------------------------------------
# %stack expansion
# ---------------------------------------------------------------------------

def expand_stack(items):
    out = []
    for it in items:
        if isinstance(it, ap.StackManipulation):
            out.extend(_expand_stack_one(it))
        else:
            out.append(it)
    return out


def _expand_stack_one(it: ap.StackManipulation):
    blocks = {}
    src = []
    for name, n in it.placeholders:
        blocks[name] = n
        src.extend(f"@{name}.{i}" for i in range(n))
    dst = []
    for r in it.replacements:
        if r.kind == "ident" and r.value in blocks:
            dst.extend(f"@{r.value}.{i}" for i in range(blocks[r.value]))
        elif r.kind == "literal":
            dst.append(("push", ap.PushTarget("literal", r.value)))
        elif r.kind == "ident":
            dst.append(("push", ap.PushTarget("label", r.value)))
        else:
            raise AssertionError(f"unexpanded replacement {r}")

    # Minimum-cost search first (the reference's shortest_path,
    # stack_manipulation.rs:90-167); naive expansion is the fallback.
    sdst = [("push", d[1].kind, d[1].value) if isinstance(d, tuple)
            else d for d in dst]
    found = stack_search.shortest_path(src, sdst)
    if found is not None:
        out = []
        for op in found:
            if op[0] == "pop":
                out.append(ap.StandardOp("POP"))
            elif op[0] == "swap":
                out.append(ap.StandardOp(f"SWAP{op[1]}"))
            elif op[0] == "dup":
                out.append(ap.StandardOp(f"DUP{op[1]}"))
            else:
                out.append(ap.Push(ap.PushTarget(op[1][1], op[1][2])))
        return out

    ops = _try_naive(src, dst)
    if ops is not None:
        return ops

    # Delete unused source items first (SWAP to top + POP), tracking
    # positions, then handle what remains.
    ops = []
    cur = list(src)
    needed = [d for d in dst if not isinstance(d, tuple)]
    while True:
        unused = [i for i, x in enumerate(cur) if x not in needed]
        if not unused:
            break
        p = unused[0]
        if p == 0:
            ops.append(ap.StandardOp("POP"))
            cur.pop(0)
        else:
            assert p <= 16, f"%stack unused too deep: {it}"
            ops.append(ap.StandardOp(f"SWAP{p}"))
            cur[0], cur[p] = cur[p], cur[0]
            ops.append(ap.StandardOp("POP"))
            cur.pop(0)

    is_perm = (len(needed) == len(dst) == len(cur)
               and sorted(needed) == sorted(cur)
               and len(set(cur)) == len(cur))
    if is_perm:
        target = list(dst)
        while cur != target:
            if cur[0] != target[0]:
                q = target.index(cur[0])
                assert q <= 16, f"%stack swap too deep: {it}"
                ops.append(ap.StandardOp(f"SWAP{q}"))
                cur[0], cur[q] = cur[q], cur[0]
            else:
                p = next(i for i in range(len(cur)) if cur[i] != target[i])
                assert p <= 16, f"%stack swap too deep: {it}"
                ops.append(ap.StandardOp(f"SWAP{p}"))
                cur[0], cur[p] = cur[p], cur[0]
        return ops

    tail = _try_naive(cur, dst)
    assert tail is not None, f"%stack too complex for expansion: {it}"
    return ops + tail


def _try_naive(src, dst):
    """Build the rotated target block on top with DUP/PUSH, then drop the
    old items below (each drop rotates by one, pre-compensated). Returns
    None if it would exceed DUP16/SWAP16."""
    k = len(src)
    m = len(dst)
    ops: list = []
    if m == 0:
        return [ap.StandardOp("POP")] * k
    if m > 16:
        return None
    b = [dst[(j - k) % m] for j in range(m)]
    pushed = 0
    for e in reversed(b):
        if isinstance(e, tuple):
            ops.append(ap.Push(e[1]))
        else:
            j = src.index(e)
            depth = j + pushed + 1
            if depth > 16:
                return None
            ops.append(ap.StandardOp(f"DUP{depth}"))
        pushed += 1
    for _ in range(k):
        ops.append(ap.StandardOp(f"SWAP{m}"))
        ops.append(ap.StandardOp("POP"))
    return ops


# ---------------------------------------------------------------------------
# Label resolution + emission
# ---------------------------------------------------------------------------

def _push_size(target: ap.PushTarget) -> int:
    if target.kind == "literal":
        v = target.value
        return max((v.bit_length() + 7) // 8, 0)
    if target.kind == "label":
        return BYTES_PER_OFFSET
    raise AssertionError(f"unresolved push target {target}")


def assemble(files, constants, opcodes, optimize=False) -> Kernel:
    """files: list of parsed item lists (one per .asm file).
    `optimize` runs the peephole passes (optimizer.py) after %stack
    expansion, the reference's pipeline position
    (cpu/kernel/assembler.rs:135-137); the kernel build enables it,
    unit tests asserting exact opcode streams leave it off."""
    macros = find_macros(files)
    counter = [0]
    global_labels = {}
    prover_inputs = {}
    expanded_files = []
    local_labels_per_file = []
    offset = 0
    for items in files:
        items = expand_macros(items, macros, counter)
        items = inline_constants(items, constants)
        items = expand_stack(items)
        if optimize:
            items = optimizer.optimize_asm(items)
        local_labels = {}
        for it in items:
            if isinstance(it, ap.GlobalLabel):
                assert it.name not in global_labels, it.name
                global_labels[it.name] = offset
            elif isinstance(it, ap.LocalLabel):
                assert it.name not in local_labels, it.name
                local_labels[it.name] = offset
            elif isinstance(it, ap.Push):
                offset += 1 + _push_size(it.target)
            elif isinstance(it, ap.ProverInput):
                prover_inputs[offset] = it.path
                offset += 1
            elif isinstance(it, ap.StandardOp):
                offset += 1
            elif isinstance(it, ap.Bytes):
                offset += len(it.targets)
            elif isinstance(it, ap.Jumptable):
                offset += len(it.labels) * BYTES_PER_OFFSET
            else:
                raise AssertionError(f"unexpanded item {it}")
        expanded_files.append(items)
        local_labels_per_file.append(local_labels)

    code = bytearray()

    def label_bytes(label, local_labels):
        off = local_labels.get(label, global_labels.get(label))
        assert off is not None, f"no such label: {label}"
        return off.to_bytes(BYTES_PER_OFFSET, "big")

    for items, local_labels in zip(expanded_files, local_labels_per_file):
        for it in items:
            if isinstance(it, (ap.GlobalLabel, ap.LocalLabel)):
                continue
            if isinstance(it, ap.Push):
                if it.target.kind == "literal":
                    v = it.target.value
                    nbytes = max((v.bit_length() + 7) // 8, 0)
                    tb = v.to_bytes(nbytes, "big")
                else:
                    tb = label_bytes(it.target.value, local_labels)
                code.append(0x5F + len(tb))     # PUSH0..PUSH32
                code.extend(tb)
            elif isinstance(it, ap.ProverInput):
                code.append(opcodes["PROVER_INPUT"])
            elif isinstance(it, ap.StandardOp):
                code.append(opcodes[it.name])
            elif isinstance(it, ap.Bytes):
                code.extend(it.targets)
            elif isinstance(it, ap.Jumptable):
                for lbl in it.labels:
                    code.extend(label_bytes(lbl, local_labels))
    assert len(code) == offset, "code length doesn't match offset"

    from ..native import keccak256
    code = bytes(code)
    ordered = sorted(global_labels, key=lambda k: global_labels[k])
    return Kernel(code=code, code_hash=keccak256(code),
                  global_labels=global_labels, ordered_labels=ordered,
                  prover_inputs=prover_inputs)


def freeze_kernel(kernel: Kernel, path: str = FROZEN_KERNEL_PATH) -> None:
    """Serialize an assembled kernel to the vendored artifact (our own
    derived format — code bytes + labels + prover-input map), so the
    package proves without a reference checkout mounted. The reference
    ships the equivalent as a compile-time static (assembler.rs KERNEL
    Lazy); we ship the assembled bytes as package data."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with gzip.open(path, "wt") as f:
        json.dump(kernel_to_json(kernel), f)


# Kernel files gated by chain flavor, mirroring the #[cfg(feature)] file
# attributes in the reference's aggregator
# (zk_evm's evm_arithmetization/src/cpu/kernel/aggregator.rs:56-187):
# the eth-only files (blob txns, withdrawals, KZG point evaluation) are
# excluded from cdk_erigon/polygon_pos builds, and cdk_pre_execution only
# exists under cdk_erigon. (The commented-out bls381/util.asm and the
# flavor-foreign files remain in the DEFAULT eth build for kernel-hash
# stability with the vendored artifact; they assemble to dead code.)
_FILE_FEATURES = {
    "asm/core/withdrawals.asm": ("eth_mainnet",),
    "asm/core/precompiles/kzg_peval.asm": ("eth_mainnet",),
    "asm/transactions/type_3.asm": ("eth_mainnet",),
    "asm/cdk_pre_execution.asm": ("eth_mainnet", "cdk_erigon"),
}


def reference_asm_dir() -> str | None:
    """The kernel's .asm tree in the zk_evm checkout ZK_EVM_REFERENCE
    names, or None when it names none."""
    ref = os.environ.get("ZK_EVM_REFERENCE")
    return os.path.join(ref, KERNEL_ASM_SUBDIR) if ref else None


def combined_kernel(asm_dir: str | None = None,
                    active_features=("eth_mainnet",),
                    extra_sources=()) -> Kernel:
    """Assemble the full 159-file kernel. The .asm sources are data,
    loaded from the reference checkout (ZK_EVM_REFERENCE) by default;
    when no checkout is mounted (and the build is the stock
    eth_mainnet one) the vendored pre-assembled kernel artifact is
    used instead, so proving does not require the reference at runtime.
    Any other build without a tree raises FileNotFoundError.
    `extra_sources` appends additional .asm source strings (e.g. test
    harness routines that call kernel globals)."""
    constants, opcodes, kernel_files = load_tables()
    if tuple(active_features) != ("eth_mainnet",):
        kernel_files = [
            rel for rel in kernel_files
            if any(f in active_features
                   for f in _FILE_FEATURES.get(rel, active_features))]
    if asm_dir is None:
        asm_dir = reference_asm_dir()
        stock = active_features == ("eth_mainnet",) and not extra_sources
        if stock and (asm_dir is None or not os.path.isdir(asm_dir)):
            return load_frozen_kernel()
        if asm_dir is None:
            raise FileNotFoundError(
                "no kernel .asm tree: set ZK_EVM_REFERENCE to a zk_evm "
                "checkout or pass asm_dir")
    files = []
    for rel in kernel_files:
        with open(os.path.join(asm_dir, rel)) as f:
            src = f.read()
        files.append(ap.parse(src, active_features))
    for src in extra_sources:
        files.append(ap.parse(src, active_features))
    return assemble(files, constants, opcodes, optimize=True)
