"""Benchmark of the port on one CUDA device: trace-commitment throughput
(the JAX package's `bench.py` metric) and the two Poseidon layouts.

    python3 -m zk_evm_tpu_torch.bench               # main(): one JSON line
    python3 -m zk_evm_tpu_torch.bench --layouts [log_b]
                                  # compare_poseidon_layouts: one JSON line

`main()` times, at `bench.py`'s shapes, `commit_cap` of 64 polys x 2^15
rows (2x LDE, leaf sponge, tree up to a height-4 cap), `lde_bitrev` at the
same shape, and the Poseidon permutation of 2^18 states, and prints
`{"metric": "trace_commit_throughput", "value", "unit", "ntt_gelem_s",
"poseidon_mperm_s", "platform": "cuda", "device"}`. Throughput is
elements (polys x rows) or permutations over the mean time of a call.

`compare_poseidon_layouts()` is the twin of the JAX package's
`scripts/prof_poseidon.py`: it checks that the dense kernels
(`hash/poseidon_dense.py`) and the planes kernels
(`hash/poseidon_pallas.py`) give identical results, then times both.

Times come from CUDA events around repeated calls after a warm-up call.
There is no CPU mode: without a CUDA device both raise.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from .field import GF, host
from . import ntt
from .hash import poseidon, poseidon_dense, poseidon_pallas
from .parallel import commit_cap

POLYS = 64
LOG_N = 15          # 2^15 rows -> 2^16-point LDE, 2M committed elements
LOG_PERM = 18
ITERS = 10
SEED = 42

# The least work of one permutation, in 32-bit integer multiply-adds, in
# its cheapest known form (fast partial rounds): 118 S-boxes (8 full
# rounds x 12 + 22 partial) of 4 Goldilocks products, each product 4
# 32x32-bit partial products; 8 dense MDS layers of 12 x 12 small-constant
# products of both 32-bit halves of each word; the 11 x 11 initial matrix
# of general products; 22 sparse layers of 22 general products plus one
# small-constant product of both halves.
IMAD_PER_PERMUTATION = (118 * 4 * 4 + 8 * 12 * 12 * 2 + 11 * 11 * 4
                        + 22 * (22 * 4 + 2))
IMAD_PER_SM_CLOCK = 64                      # Hopper's 32-bit IMAD issue rate
HBM_BYTES_S = 3.35e12                       # H100 SXM data sheet
# The least work of one keccak-f[1600] permutation in 32-bit logic and
# funnel-shift instructions, three-input LOP3s where they fuse: per round
# the column parities 20, rotl(C, 1) 10 funnel shifts, D applied 50 (one
# LOP3 a half, s ^ C[x-1] ^ rotl(C[x+1], 1)), rho 48, chi 50; iota 1 a
# round for the low half, plus 13 for the constants whose high half is
# nonzero.
INT_OPS_PER_KECCAK = 24 * (20 + 10 + 50 + 48 + 50 + 1) + 13
INT_OPS_PER_SM_CLOCK = 64                   # Hopper's 32-bit integer rate


def cuda_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("the benchmark needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


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


def _bound_ms(ops: int, per_sm_clock: int, nbytes: int, clock_mhz: float,
              sms: int) -> tuple[float, str]:
    ops_ms = ops / (sms * per_sm_clock * clock_mhz * 1e6) * 1e3
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms \
        else (bytes_ms, "bytes")


def poseidon_bound_ms(perms: int, nbytes: int, clock_mhz: float,
                      sms: int) -> tuple[float, str]:
    """(bound_ms, bound_by): the least time the card could take for
    `perms` permutations that read and write `nbytes` in all, the larger
    of their integer operations over the IMAD issue rate and their bytes
    over HBM."""
    return _bound_ms(perms * IMAD_PER_PERMUTATION, IMAD_PER_SM_CLOCK, nbytes,
                     clock_mhz, sms)


def keccak_bound_ms(perms: int, nbytes: int, clock_mhz: float,
                    sms: int) -> tuple[float, str]:
    """(bound_ms, bound_by) of `perms` keccak-f[1600] permutations that
    read and write `nbytes` in all: their logic instructions over the
    32-bit integer rate, or their bytes over HBM."""
    return _bound_ms(perms * INT_OPS_PER_KECCAK, INT_OPS_PER_SM_CLOCK,
                     nbytes, clock_mhz, sms)


def keccak_work(n_rows: int, width: int) -> tuple[int, int]:
    """(permutations, bytes) of keccak256 over n_rows rows of `width`
    words: width * 8 // 136 + 1 blocks a row, every word read once, a
    4-word digest written per row."""
    return n_rows * (width * 8 // 136 + 1), (width + 4) * n_rows * 8


def sponge_work(n_cols: int, n_rows: int) -> tuple[int, int]:
    """(permutations, bytes) of a sponge over n_rows leaves of n_cols
    words: every word read once, a 4-word digest written per leaf."""
    return n_rows * -(-n_cols // 8), (n_cols + 4) * n_rows * 8


def permute_work(batch: int) -> tuple[int, int]:
    """(permutations, bytes) of a permutation of `batch` states."""
    return batch, batch * 12 * 8 * 2


def random_gf(rng, shape, dev) -> GF:
    return GF.from_u64(rng.integers(0, host.P, size=shape, dtype=np.uint64),
                       dev)


def main() -> dict:
    dev = cuda_device()
    rng = np.random.default_rng(SEED)
    values = random_gf(rng, (POLYS, 1 << LOG_N), dev)
    elems = POLYS << LOG_N
    commit_ms = cuda_ms(lambda: commit_cap(values, cap_height=4), ITERS)
    lde_ms = cuda_ms(lambda: ntt.lde_bitrev(values, rate_bits=1), ITERS)
    states = random_gf(rng, (1 << LOG_PERM, 12), dev)
    perm_ms = cuda_ms(lambda: poseidon.permute(states), ITERS)
    out = {
        "metric": "trace_commit_throughput",
        "value": elems / commit_ms / 1e3,
        "unit": "Melem/s",
        "ntt_gelem_s": elems / lde_ms / 1e6,
        "poseidon_mperm_s": (1 << LOG_PERM) / perm_ms / 1e3,
        "platform": "cuda",
        "device": torch.cuda.get_device_name(dev),
    }
    print(json.dumps(out), flush=True)
    return out


def compare_poseidon_layouts(log_b: int = 18) -> dict:
    """Dense vs planes Poseidon kernels on the card: identical digests
    first (8192 states; a 64-column sponge over 8192 rows), then the
    permutation at 2^log_b states and the 64-column sponge over
    max(2^log_b / 16, 2048) rows, each by CUDA events."""
    dev = cuda_device()
    rng = np.random.default_rng(0)
    b = 1 << log_b
    st = random_gf(rng, (max(b, 8192), 12), dev)
    head = st[:8192]
    if not torch.equal(poseidon_pallas.permute_pallas(head).v,
                       poseidon_dense.permute_dense(head).v):
        raise AssertionError("permute: planes kernel != dense kernel")
    n_rows = max(b // 16, 2048)
    n_cols = 64
    mat = random_gf(rng, (n_cols, max(n_rows, 8192)), dev)
    head = mat[:, :8192]
    if not torch.equal(poseidon_pallas.sponge_pallas(head).v,
                       poseidon_dense.sponge_dense(head).v):
        raise AssertionError("sponge: planes kernel != dense kernel")
    st = st[:b]
    mat = GF(mat.v[:, :n_rows].contiguous())
    perms = n_rows * (n_cols // 8)
    dense_p = cuda_ms(lambda: poseidon_dense.permute_dense(st), ITERS)
    planes_p = cuda_ms(lambda: poseidon_pallas.permute_pallas(st), ITERS)
    dense_s = cuda_ms(lambda: poseidon_dense.sponge_dense(mat), ITERS)
    planes_s = cuda_ms(lambda: poseidon_pallas.sponge_pallas(mat), ITERS)
    out = {
        "batch": b, "sponge_cols": n_cols, "sponge_rows": n_rows,
        "equal": True,
        "permute_dense_ms": dense_p, "permute_planes_ms": planes_p,
        "permute_dense_mperm_s": b / dense_p / 1e3,
        "permute_planes_mperm_s": b / planes_p / 1e3,
        "sponge_dense_ms": dense_s, "sponge_planes_ms": planes_s,
        "sponge_dense_mperm_s": perms / dense_s / 1e3,
        "sponge_planes_mperm_s": perms / planes_s / 1e3,
        "device": torch.cuda.get_device_name(dev),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--layouts":
        compare_poseidon_layouts(int(sys.argv[2]) if len(sys.argv) > 2
                                 else 18)
    else:
        main()
