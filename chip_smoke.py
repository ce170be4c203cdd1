"""Smoke run of the PyTorch/CUDA port (zk_evm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA Poseidon kernels from zk_evm_tpu_torch/csrc/,
holds each against its plain PyTorch version and the python-int host twin,
commits a 64-poly trace (the commit-throughput shape), proves a 2^12-row
LogicStark on CUDA and on the CPU and compares the proofs byte for byte,
then proves and verifies a 2^16-row, 523-column LogicStark at the
standard config (84 FRI queries, 16-bit proof of work) through the
kernels. Field arithmetic is exact, so every comparison is bit-for-bit
equality: the tolerance is 0. Every phase raises on failure. Needs one
CUDA device; without one it exits non-zero and prints no result.

The last three lines of standard output are the kernels' JSON record, the
card's `nvidia-smi` name and power limit, and the result JSON.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import time

import numpy as np
import torch

from zk_evm_tpu_torch import cuda_build
from zk_evm_tpu_torch.challenger import Challenger
from zk_evm_tpu_torch.field import GF, host
from zk_evm_tpu_torch.hash import host_poseidon, poseidon, poseidon_dense
from zk_evm_tpu_torch.parallel import commit_cap
from zk_evm_tpu_torch.stark import (PolynomialBatch, StarkConfig,
                                    prove_stark, verify_stark)
from zk_evm_tpu_torch.stark.serialization import proof_to_json
from zk_evm_tpu_torch.tables import logic
from zk_evm_tpu_torch.timing import TimingTree, timed

P = host.P
SEED = 0
# shapes of each phase (see the module docstring)
PERMUTE_BATCHES = (1, 1000, 1 << 18)        # 2^18: the PoW grind batch
SPONGE_COLS = (5, 6, 8, 13, 17, 32, 64, 523)
SPONGE_ROWS = (1, 1000, 4096)
COMMIT_POLYS = 64
COMMIT_CHECK_LOG_ROWS = 12
COMMIT_LOG_ROWS = 15                        # the commit-throughput shape
LOGIC_CHECK_LOG_ROWS = 12
LOGIC_LOG_ROWS = 16
BOUNDARY = (0, 1, P - 1, (1 << 32) - 1, 1 << 32, 1 << 63)
KERNEL_SOURCE = "zk_evm_tpu_torch/csrc/poseidon.cu"
REPLACES = {
    "poseidon_permute": "zk_evm_tpu/hash/poseidon_dense.py:143",
    "poseidon_sponge": "zk_evm_tpu/hash/poseidon_dense.py:203",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def max_abs_err(got: GF, want: GF) -> int:
    """Largest |got - want| over the elements, as exact integers."""
    g = got.to_u64()
    w = want.to_u64()
    if g.shape != w.shape:
        raise AssertionError(f"shape {g.shape} != {w.shape}")
    bad = np.nonzero(g != w)
    if not len(bad[0]):
        return 0
    return max(abs(int(a) - int(b)) for a, b in zip(g[bad], w[bad]))


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call, by CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_gf(rng, shape, dev) -> GF:
    return GF.from_u64(rng.integers(0, P, size=shape, dtype=np.uint64), dev)


def phase_environment() -> str:
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda "
                         "is_available() is false); nothing was run")
    smi = nvidia_smi()
    log(f"device {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}")
    try:
        import triton
        log(f"triton {triton.__version__}")
    except ImportError:
        log("triton not installed")
    nvcc = subprocess.run([cuda_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    log(f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    log(f"jax importable: {importlib.util.find_spec('jax') is not None}")
    return smi


def phase_build() -> None:
    so = cuda_build.library_path("poseidon")
    how = "reused" if so.exists() else "built with nvcc"
    t0 = time.perf_counter()
    cuda_build.load("poseidon")
    log(f"build: csrc/poseidon.cu {how} and loaded in "
        f"{time.perf_counter() - t0:.2f} s ({so.name})")


def phase_permute(rng, dev) -> int:
    err = 0
    for batch in PERMUTE_BATCHES:
        states = rng.integers(0, P, size=(batch, 12), dtype=np.uint64)
        n_b = min(batch, 64)
        states[:n_b] = np.array(BOUNDARY, dtype=np.uint64)[
            rng.integers(0, len(BOUNDARY), size=(n_b, 12))]
        x = GF.from_u64(states, dev)
        got = poseidon_dense.permute_dense(x)
        want = poseidon.permute_plain(x)
        err = max(err, max_abs_err(got, want))
        out = got.to_u64()
        for r in range(min(batch, 4)):
            twin = host_poseidon.permute_py([int(v) for v in states[r]])
            if [int(v) for v in out[r]] != twin:
                raise AssertionError(f"permute row {r} != host twin")
        if err:
            raise AssertionError(f"permute kernel != plain at B={batch}")
    log(f"permute: kernel == plain == host twin (exact) at B = "
        f"{PERMUTE_BATCHES}")
    return err


def phase_sponge(rng, dev) -> int:
    err = 0
    for n_cols in SPONGE_COLS:
        for n_rows in SPONGE_ROWS:
            m = rng.integers(0, P, size=(n_cols, n_rows), dtype=np.uint64)
            mt = GF.from_u64(m, dev)
            got = poseidon_dense.sponge_dense(mt)
            want = poseidon.hash_rows_plain(mt.T)
            err = max(err, max_abs_err(got, want))
            if err:
                raise AssertionError(
                    f"sponge kernel != plain at {n_cols}x{n_rows}")
            twin = host_poseidon.hash_or_noop([int(v) for v in m[:, 0]])
            if [int(v) for v in got.to_u64()[0]] != twin:
                raise AssertionError(f"sponge {n_cols} cols != host twin")
    log(f"sponge: kernel == plain == host twin (exact) at n_cols "
        f"{SPONGE_COLS}, n_rows {SPONGE_ROWS}")
    return err


def phase_commit(rng, dev, smi: str) -> dict:
    polys = COMMIT_POLYS
    small = rng.integers(0, P, size=(polys, 1 << COMMIT_CHECK_LOG_ROWS),
                         dtype=np.uint64)
    cap_gpu = commit_cap(GF.from_u64(small, dev), cap_height=4).to_u64()
    cap_cpu = commit_cap(GF.from_u64(small), cap_height=4).to_u64()
    if not np.array_equal(cap_gpu, cap_cpu):
        raise AssertionError("commit_cap on CUDA != plain commit_cap on CPU")
    log(f"commit_cap {polys} x 2^{COMMIT_CHECK_LOG_ROWS}: CUDA cap == CPU "
        f"plain cap")

    n = 1 << COMMIT_LOG_ROWS
    values = random_gf(rng, (polys, n), dev)
    ms = cuda_ms(lambda: commit_cap(values, cap_height=4), reps=5)
    rate = polys * n / (ms / 1e3) / 1e6
    log(f"commit_cap {polys} x 2^{COMMIT_LOG_ROWS} (rate 1, cap 4): "
        f"{ms:.3f} ms, {rate:.2f} Melem/s [{smi}]")

    # each kernel beside its plain version, at the main path's shapes:
    # the commit's leaves (its LDE, 2n rows) and the PoW grind batch
    lde_t = random_gf(rng, (polys, 2 * n), dev)
    sp_ms = cuda_ms(lambda: poseidon_dense.sponge_dense(lde_t), reps=10)
    sp_plain = cuda_ms(lambda: poseidon.hash_rows_plain(lde_t.T), reps=1)
    batch = PERMUTE_BATCHES[-1]
    states = random_gf(rng, (batch, 12), dev)
    pm_ms = cuda_ms(lambda: poseidon_dense.permute_dense(states), reps=10)
    pm_plain = cuda_ms(lambda: poseidon.permute_plain(states), reps=1)
    log(f"sponge {polys} cols x {2 * n} rows: kernel {sp_ms:.3f} ms, plain "
        f"{sp_plain:.3f} ms [{smi}]")
    log(f"permute {batch} states: kernel {pm_ms:.3f} ms "
        f"({batch / pm_ms / 1e3:.2f} Mperm/s), plain {pm_plain:.3f} ms "
        f"[{smi}]")
    # the leaves of the 2^16-row Logic trace: 523 columns of its 2^17-row
    # LDE, compared at that very shape as well as timed
    wide = random_gf(rng, (logic.NUM_COLUMNS, 2 << LOGIC_LOG_ROWS), dev)
    if max_abs_err(poseidon_dense.sponge_dense(wide),
                   poseidon.hash_rows_plain(wide.T)):
        raise AssertionError("sponge kernel != plain at the Logic leaves")
    wide_ms = cuda_ms(lambda: poseidon_dense.sponge_dense(wide), reps=3)
    wide_plain = cuda_ms(lambda: poseidon.hash_rows_plain(wide.T), reps=1)
    log(f"sponge {logic.NUM_COLUMNS} cols x {2 << LOGIC_LOG_ROWS} rows "
        f"(the Logic trace leaves): kernel == plain; kernel {wide_ms:.3f} "
        f"ms, plain {wide_plain:.3f} ms [{smi}]")
    return {"commit_ms": ms, "commit_melem_s": rate,
            "poseidon_sponge": (sp_ms, sp_plain),
            "poseidon_permute": (pm_ms, pm_plain)}


def logic_trace(rng, log_rows: int) -> np.ndarray:
    n = 1 << log_rows
    ops = [(("and", "or", "xor")[int(k)],
            int.from_bytes(rng.bytes(32), "little"),
            int.from_bytes(rng.bytes(32), "little"))
           for k in rng.integers(0, 3, size=n)]
    return logic.generate_trace(ops, min_rows=n)


def phase_logic_small(rng, dev) -> None:
    trace = logic_trace(rng, LOGIC_CHECK_LOG_ROWS)
    cfg = StarkConfig.test_config()
    stark = logic.LogicStark()
    t0 = time.perf_counter()
    on_gpu = proof_to_json(prove_stark(stark, trace, cfg, Challenger(),
                                       device=dev))
    t1 = time.perf_counter()
    on_cpu = proof_to_json(prove_stark(stark, trace, cfg, Challenger()))
    t2 = time.perf_counter()
    if on_gpu != on_cpu:
        raise AssertionError("LogicStark: CUDA proof != CPU proof")
    log(f"LogicStark 2^{LOGIC_CHECK_LOG_ROWS} test config: CUDA proof == "
        f"CPU proof "
        f"({len(on_gpu)} bytes; CUDA {t1 - t0:.2f} s, CPU {t2 - t1:.2f} s)")


def phase_logic_full(rng, dev, smi: str) -> dict:
    trace = logic_trace(rng, LOGIC_LOG_ROWS)
    cfg = StarkConfig.standard_fast_config()
    stark = logic.LogicStark()
    torch.cuda.synchronize()
    for k in poseidon_dense.LAUNCHES:
        poseidon_dense.LAUNCHES[k] = 0
    tree = TimingTree(f"prove LogicStark 2^{LOGIC_LOG_ROWS}")
    with tree:
        with timed("commit trace"):
            batch = PolynomialBatch.from_values(
                GF.from_u64(trace, dev), rate_bits=cfg.rate_bits,
                cap_height=cfg.cap_height, hasher=cfg.hasher)
        proof = prove_stark(stark, trace, cfg, Challenger(),
                            trace_batch=batch)
    launches = dict(poseidon_dense.LAUNCHES)
    if batch.lde.device.type != "cuda":
        raise AssertionError(f"trace LDE on {batch.lde.device}, not cuda")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{k} kernel never launched in the prove")
    log(f"LogicStark 2^{LOGIC_LOG_ROWS} standard config, "
        f"{len(proof.fri_proof.query_rounds)} queries, pow witness "
        f"{proof.fri_proof.pow_witness} [{smi}]:")
    for node in tree.root.children:
        log(f"  {node.elapsed:9.3f} s  {node.name}")
    log(f"  {tree.root.elapsed:9.3f} s  total; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    verify_stark(stark, proof, cfg, Challenger())
    log(f"LogicStark 2^{LOGIC_LOG_ROWS} verified by the port's verifier in "
        f"{time.perf_counter() - t0:.2f} s; launches {launches}")
    return launches


def main() -> None:
    smi = phase_environment()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    rng = np.random.default_rng(SEED)
    phase_build()
    errs = {"poseidon_permute": phase_permute(rng, dev),
            "poseidon_sponge": phase_sponge(rng, dev)}
    times = phase_commit(rng, dev, smi)
    phase_logic_small(rng, dev)
    launches = phase_logic_full(rng, dev, smi)
    kernels = []
    for name, count in (("poseidon_permute", launches["permute"]),
                        ("poseidon_sponge", launches["sponge"])):
        ms, plain_ms = times[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": KERNEL_SOURCE, "replaces": REPLACES[name],
                        "launches": count, "max_abs_err": errs[name],
                        "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
