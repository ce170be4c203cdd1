"""Wrappers of the planes-layout CUDA Poseidon kernels
(csrc/poseidon_pallas.cu).

`permute_pallas` replaces the JAX package's `poseidon_pallas._permute_kernel`
and `sponge_pallas` its `poseidon_pallas._sponge_kernel`; the source file
says what bounds each kernel on the card and what its design does about
it (a 32-bit Goldilocks product, csrc/goldilocks32.cuh, whose python-int
twin is `goldilocks32.py`; the sponge's chunks staged by TMA).

Each wrapper takes a GF array. On a CPU tensor it runs the plain PyTorch
version (`poseidon.permute_plain` / `poseidon.hash_rows_plain`, which
compute the same function); on a CUDA tensor it launches its kernel on the
current stream or raises — there is no fallback. `LAUNCHES` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..field import GF
from .. import cuda_build
from . import poseidon, poseidon_fast
from . import poseidon_params as pp

LAUNCHES = {"permute": 0, "sponge": 0}

_c = ctypes.c_void_p
_i64 = ctypes.c_int64


def _library() -> ctypes.CDLL:
    with cuda_build.FIRST_USE:
        return _bind()


@lru_cache(maxsize=1)
def _bind() -> ctypes.CDLL:
    lib = cuda_build.load("poseidon_pallas")
    lib.zk_poseidon_pallas_mds_coef.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.zk_poseidon_pallas_mds_coef.restype = ctypes.c_int
    lib.zk_poseidon_pallas_set_round_constants.argtypes = [_c]
    lib.zk_poseidon_pallas_set_round_constants.restype = ctypes.c_int
    lib.zk_poseidon_pallas_set_fast_constants.argtypes = [_c, _i64]
    lib.zk_poseidon_pallas_set_fast_constants.restype = ctypes.c_int
    lib.zk_poseidon_pallas_permute.argtypes = [_c, _c, _i64, _i64, _c]
    lib.zk_poseidon_pallas_permute.restype = ctypes.c_int
    lib.zk_poseidon_pallas_sponge.argtypes = [_c, _i64, _i64, _i64, _c, _c]
    lib.zk_poseidon_pallas_sponge.restype = ctypes.c_int
    # the kernel's MDS is compiled in; it must be the parameter set's
    mat = poseidon.mds_matrix_np()
    for r in range(pp.WIDTH):
        for j in range(pp.WIDTH):
            if lib.zk_poseidon_pallas_mds_coef(r, j) != mat[r, j]:
                raise RuntimeError(
                    "poseidon_pallas.cu MDS differs from the params")
    return lib


def _ready(device_index: int) -> ctypes.CDLL:
    """The library with the round constants and the fast partial-round
    constants uploaded to this device (once a device, one thread at a
    time: a second card gets its own constants)."""
    with cuda_build.FIRST_USE:
        return _upload(device_index)


@lru_cache(maxsize=None)
def _upload(device_index: int) -> ctypes.CDLL:
    lib = _library()
    rcs = np.ascontiguousarray(pp.round_constants_np())
    fast = poseidon_fast.fast_constants_np()
    with torch.cuda.device(device_index):
        _check(lib.zk_poseidon_pallas_set_round_constants(rcs.ctypes.data),
               "uploading round constants")
        _check(lib.zk_poseidon_pallas_set_fast_constants(
            fast.ctypes.data, len(fast)),
            "uploading fast partial-round constants")
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"poseidon_pallas kernel {what}: CUDA error {err}")


def _cuda_int64(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got "
                         f"{x.device}")
    if x.dtype != torch.int64:
        raise TypeError(f"{what}: expected int64, got {x.dtype}")


def needs_aligned_copy(x: torch.Tensor) -> bool:
    """Whether the sponge kernel's tensor map cannot read the (n_cols,
    n_rows) int64 matrix x in place: its rows must be contiguous and must
    not overlap, its row stride `ld` even (a global stride that is a
    multiple of 16 bytes) and its base 16-byte aligned. The LDEs of the
    main path are contiguous and powers of two wide, so they are read in
    place."""
    ld, step = x.stride()
    return (step != 1 or ld < x.shape[1] or ld % 2 != 0
            or x.data_ptr() % 16 != 0)


def aligned_planes(x: torch.Tensor) -> torch.Tensor:
    """A copy of the (n_cols, n_rows) matrix x that the tensor map reads in
    place: a fresh allocation (16-byte aligned) with an even row stride,
    n_rows rounded up to even."""
    n_cols, n_rows = x.shape
    buf = torch.empty((n_cols, n_rows + n_rows % 2), dtype=x.dtype,
                      device=x.device)
    out = buf[:, :n_rows]
    out.copy_(x)
    return out


def permute_pallas(state: GF) -> GF:
    """Poseidon permutation of a (B, 12) GF state, any B. The kernel works
    on the (12, B) planes: the state goes in transposed and comes back
    transposed, as the JAX package's `_permute_pallas_jit` does."""
    x = state.v
    if x.ndim != 2 or x.shape[1] != pp.WIDTH:
        raise ValueError(f"permute: expected (B, 12), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return poseidon.permute_plain(state)
    _cuda_int64(x, "permute")
    planes = x.t().contiguous()                 # (12, B)
    out = torch.empty_like(planes)
    lib = _ready(x.device.index)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _check(lib.zk_poseidon_pallas_permute(
            planes.data_ptr(), out.data_ptr(), x.shape[0], planes.stride(0),
            stream), "permute launch")
    cuda_build.count_launch(LAUNCHES, "permute")
    return GF(out.t().contiguous())


def sponge_pallas(matrix_t: GF) -> GF:
    """Digests of the COLUMNS of a (n_cols, n_rows) GF matrix, n_cols > 4,
    any n_rows: returns (n_rows, 4), equal to
    poseidon.hash_rows_plain(matrix_t.T). The matrix is read in place when
    the tensor map can read it (`needs_aligned_copy`; the LDE's layout),
    else from one aligned copy; the kernel writes (4, n_rows) digest
    planes, which are transposed on return."""
    x = matrix_t.v
    if x.ndim != 2 or x.shape[0] <= 4:
        raise ValueError(
            f"sponge: expected (n_cols > 4, n_rows), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return poseidon.hash_rows_plain(matrix_t.T)
    _cuda_int64(x, "sponge")
    if needs_aligned_copy(x):
        x = aligned_planes(x)
    n_cols, n_rows = x.shape
    out = torch.empty((4, n_rows), dtype=torch.int64, device=x.device)
    lib = _ready(x.device.index)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _check(lib.zk_poseidon_pallas_sponge(
            x.data_ptr(), n_rows, n_cols, x.stride(0), out.data_ptr(),
            stream), "sponge launch")
    cuda_build.count_launch(LAUNCHES, "sponge")
    return GF(out.t().contiguous())
