"""Poseidon kernels of several source trees, side by side on one card.

    python3 -m zk_evm_tpu_torch.poseidon_ab PARENT_CSRC [NAME=CSRC ...]

Builds `poseidon.cu` and `poseidon_pallas.cu` of each `csrc` directory
with the package's nvcc flags (one nvcc per source, all started
together) into `build/ab/<name>/`; this checkout's own `csrc` is the tree
named `change`, the first argument the tree named `parent`. For each tree
it prints each kernel's registers and spills (ptxas) and the SASS
instructions one permutation issues (`cuobjdump -sass`): each round loop's
body times its trip count (4, 22 and 4), plus, in a permute kernel, the
instructions outside loops and, in a sponge kernel, the rest of the chunk
loop's body (a chunk's loads and barriers; a leaf's set-up and stores are
left out). Beside the total it prints the mix by opcode class
(`mix`: IMAD.WIDE, IMAD.HI, IMAD.X, IMAD.MOV, plain IMAD, IADD3, LOP3,
...), the number that says which pipe still holds a kernel back, and the
kernel's code size in instructions (`sass_static`). Then it
launches every tree's kernels through their C interfaces on the same
inputs, checks that all trees give the same words, and times each kernel
at the main path's shapes by CUDA events, trees in turn forward then
backward (parent, change, change, parent), beside the bound of
`bench.poseidon_bound_ms`. The planes kernels are timed on their own
(12, B) and (n_cols, n_rows) layouts, without the wrappers' transposes.
The sponge's C signature (m, n_rows, n_cols, ld, out, stream) is the same
in every tree; the TMA sponge also wants an even ld and a 16-byte-aligned
base, which the contiguous inputs here have.

Prints one JSON object a line and writes them all to
`chiprun_out/poseidon_ab.json`. Needs one CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from . import bench, cuda_build
from .hash import poseidon_fast
from .hash import poseidon_params as pp

ROOT = Path(__file__).resolve().parent.parent
SOURCES = ("poseidon", "poseidon_pallas")
PERMUTE_SHAPES = ((1 << 18,),)
SPONGE_SHAPES = ((30, 1 << 21), (523, 1 << 17), (64, 1 << 16),
                 (2431, 1 << 15))
LOOP_TRIPS = (4, 22, 4)
KERNEL_SYMBOLS = {
    "poseidon_permute": "poseidon_permute_kernel",
    "poseidon_sponge": "poseidon_sponge_kernel",
    "poseidon_pallas_permute": "poseidon_planes_permute_kernel",
    "poseidon_pallas_sponge": "poseidon_planes_sponge_kernel",
}
INTEGER_OPS = ("IMAD", "IADD3", "IADD", "ISETP", "LOP3", "LOP", "SHF", "SEL",
               "LEA", "PRMT", "IMNMX", "IABS", "SHL", "SHR", "BMSK")
IMAD_FORMS = ("WIDE", "HI", "X", "MOV", "SHL", "IADD")
REPS = 5
_c = ctypes.c_void_p
_i64 = ctypes.c_int64


def build(trees: dict) -> dict:
    """{tree: {source: (library, ptxas report)}}, every nvcc at once."""
    started = {}
    for tree, csrc in trees.items():
        out_dir = ROOT / "build" / "ab" / tree
        out_dir.mkdir(parents=True, exist_ok=True)
        for name in SOURCES:
            src = Path(csrc) / f"{name}.cu"
            so = out_dir / f"lib{name}.so"
            started[(tree, name)] = (cuda_build.start_nvcc(src, so), src, so)
    libs = {tree: {} for tree in trees}
    for (tree, name), (proc, src, so) in started.items():
        report = cuda_build.report_path(so)
        cuda_build.finish_nvcc(proc, src, report)
        libs[tree][name] = (so, report.read_text())
    return libs


def kernel_of(mangled: str) -> str | None:
    for name, symbol in KERNEL_SYMBOLS.items():
        if re.search(rf"\d{symbol}E", mangled):
            return name
    return None


def sass_functions(so: Path) -> dict:
    """{kernel: [(address, opcode, target or None)]} from cuobjdump."""
    cuobjdump = Path(cuda_build.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    funcs = {}
    current = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = kernel_of(m.group(1))
            if current:
                funcs[current] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(.*?)\s*;", line)
        if not (current and m):
            continue
        words = m.group(2).split()
        if words[0].startswith("@"):
            words = words[1:]
        op = words[0]
        target = None
        if op.startswith("BRA") and len(words) > 1:
            t = re.match(r"`?\(?(0x[0-9a-f]+)", words[-1])
            target = int(t.group(1), 16) if t else None
        funcs[current].append((int(m.group(1), 16), op, target))
    return funcs


def opcode_class(op: str) -> str:
    """IMAD split by its form (WIDE, HI, X, MOV, SHL, IADD; plain IMAD
    else); any other opcode by its name without modifiers."""
    parts = op.split(".")
    if parts[0] == "IMAD" and len(parts) > 1 and parts[1] in IMAD_FORMS:
        return f"IMAD.{parts[1]}"
    return parts[0]


def per_permutation(instrs: list) -> dict:
    """SASS instructions one permutation issues. The round loops are the
    three largest innermost loops (backward branches), weighted by
    LOOP_TRIPS in address order; the chunk loop, if one encloses them (a
    sponge), bounds what else counts once; a permute counts everything
    outside the round loops once. Smaller loops (barrier waits) count
    once."""
    loops = sorted((target, addr) for addr, op, target in instrs
                   if target is not None and target < addr)
    inner = [a for a in loops
             if not any(b != a and a[0] <= b[0] and b[1] <= a[1]
                        for b in loops)]
    rounds = sorted(sorted(inner, key=lambda l: l[1] - l[0])[-3:])
    outer = [a for a in loops if a not in rounds and all(
        a[0] <= r[0] and r[1] <= a[1] for r in rounds)]
    chunk = min(outer, key=lambda l: l[1] - l[0]) if outer else None
    shown = {"loops": [[hex(t), hex(a)] for t, a in loops],
             "chunk_loop": chunk and [hex(chunk[0]), hex(chunk[1])]}
    if len(rounds) != len(LOOP_TRIPS):
        return {**shown, "total": None, "integer": None, "imad": None}
    counts = {"total": 0, "integer": 0, "imad": 0, "imad_wide": 0}
    mix = {}
    for addr, op, target in instrs:
        if target is not None and target == addr or op == "NOP":
            continue                       # the end-of-kernel self-branch
        if chunk and not chunk[0] <= addr <= chunk[1]:
            continue                       # a leaf's set-up and stores
        weight = 1
        for (lo, hi), trips in zip(rounds, LOOP_TRIPS):
            if lo <= addr <= hi:
                weight = trips
        base = op.split(".")[0]
        cls = opcode_class(op)
        counts["total"] += weight
        counts["integer"] += weight * (base in INTEGER_OPS)
        counts["imad"] += weight * (base == "IMAD")
        counts["imad_wide"] += weight * (cls == "IMAD.WIDE")
        mix[cls] = mix.get(cls, 0) + weight
    counts["mix"] = dict(sorted(mix.items(), key=lambda kv: -kv[1]))
    return {**counts, **shown}


def load(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    for prefix in ("zk_poseidon", "zk_poseidon_pallas"):
        if hasattr(lib, f"{prefix}_set_round_constants"):
            break
    rcs = np.ascontiguousarray(pp.round_constants_np())
    fn = getattr(lib, f"{prefix}_set_round_constants")
    fn.argtypes = [_c]
    check(fn(rcs.ctypes.data), "round constants")
    if hasattr(lib, f"{prefix}_set_fast_constants"):
        fast = poseidon_fast.fast_constants_np()
        fn = getattr(lib, f"{prefix}_set_fast_constants")
        fn.argtypes = [_c, _i64]
        check(fn(fast.ctypes.data, len(fast)), "fast constants")
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def launcher(lib, kernel: str, x: torch.Tensor):
    """A function that launches `kernel` of `lib` on x and returns the
    output tensor it wrote."""
    stream = torch.cuda.current_stream().cuda_stream
    if kernel == "poseidon_permute":
        out = torch.empty_like(x)
        fn = lib.zk_poseidon_permute
        fn.argtypes = [_c, _c, _i64, _c]
        args = (x.data_ptr(), out.data_ptr(), x.shape[0], stream)
    elif kernel == "poseidon_sponge":
        n_cols, n_rows = x.shape
        out = torch.empty((n_rows, 4), dtype=torch.int64, device=x.device)
        fn = lib.zk_poseidon_sponge
        fn.argtypes = [_c, _i64, _i64, _i64, _i64, _c, _c]
        args = (x.data_ptr(), n_rows, n_cols, x.stride(1), x.stride(0),
                out.data_ptr(), stream)
    elif kernel == "poseidon_pallas_permute":
        out = torch.empty_like(x)                 # x: (12, B) planes
        fn = lib.zk_poseidon_pallas_permute
        fn.argtypes = [_c, _c, _i64, _i64, _c]
        args = (x.data_ptr(), out.data_ptr(), x.shape[1], x.stride(0),
                stream)
    else:
        n_cols, n_rows = x.shape
        out = torch.empty((4, n_rows), dtype=torch.int64, device=x.device)
        fn = lib.zk_poseidon_pallas_sponge
        fn.argtypes = [_c, _i64, _i64, _i64, _c, _c]
        args = (x.data_ptr(), n_rows, n_cols, x.stride(0), out.data_ptr(),
                stream)

    def run():
        check(fn(*args), f"{kernel} launch")
        return out
    return run


def emit(record: dict, sink: list) -> None:
    sink.append(record)
    print(json.dumps(record), flush=True)


def main(argv: list) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("poseidon_ab: no CUDA device")
    trees = {"parent": argv[0],
             **dict(a.split("=", 1) for a in argv[1:]),
             "change": str(ROOT / "zk_evm_tpu_torch" / "csrc")}
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    records = []
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip()
    clock = float(smi.split(",")[-1])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    emit({"device": torch.cuda.get_device_name(dev), "nvidia_smi": smi,
          "imad_per_permutation_bound": bench.IMAD_PER_PERMUTATION}, records)
    libs = build(trees)
    loaded = {}
    for tree, by_source in libs.items():
        for source, (so, report) in by_source.items():
            loaded[(tree, source)] = load(so)
            sass = sass_functions(so)
            for mangled, res in cuda_build.kernel_resources(report).items():
                kernel = kernel_of(mangled)
                rec = {"tree": tree, "kernel": kernel, **res}
                if kernel in sass:
                    rec["sass_static"] = len(sass[kernel])
                    rec["sass_per_permutation"] = per_permutation(
                        sass[kernel])
                emit(rec, records)
    rng = np.random.default_rng(bench.SEED)
    order = list(trees) + list(reversed(trees))
    work = [(k, s) for s in PERMUTE_SHAPES
            for k in ("poseidon_permute", "poseidon_pallas_permute")] \
        + [(k, s) for s in SPONGE_SHAPES
           for k in ("poseidon_sponge", "poseidon_pallas_sponge")]
    for kernel, shape in work:
        source = "poseidon_pallas" if "pallas" in kernel else "poseidon"
        if kernel == "poseidon_permute":
            dims = shape + (12,)
        elif kernel == "poseidon_pallas_permute":
            dims = (12,) + shape
        else:
            dims = shape
        x = bench.random_gf(rng, dims, dev).v
        runs = {t: launcher(loaded[(t, source)], kernel, x) for t in trees}
        want = runs["parent"]().clone()
        for tree, run in runs.items():
            if not torch.equal(run(), want):
                raise AssertionError(f"{kernel} {shape}: {tree} != parent")
        times = {t: [] for t in trees}
        for tree in order:
            times[tree].append(bench.cuda_ms(runs[tree], REPS))
        perms, nbytes = (bench.permute_work(shape[0]) if "permute" in kernel
                         else bench.sponge_work(*shape))
        bound_ms, bound_by = bench.poseidon_bound_ms(perms, nbytes, clock,
                                                    sms)
        emit({"kernel": kernel, "shape": list(shape), "equal": True,
              "ms": times, "bound_ms": bound_ms, "bound_by": bound_by,
              "mperm_s": {t: perms / (sum(v) / len(v)) / 1e3
                          for t, v in times.items()}}, records)
    out = ROOT / "chiprun_out" / "poseidon_ab.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(records, indent=1))


if __name__ == "__main__":
    main(sys.argv[1:])
