"""keccak256 Merkle hashing on the tensors' device: the Keccak commitment
trees of StarkConfig.hasher="keccak".

The port of the JAX package's `hash/keccak_device.py` (plain XLA there, on
(lo, hi) u32 lane pairs). Digest law, bit for bit the host twin's
(merkle/keccak_host.py): a leaf of at most 4 values passes through
zero-padded (`hash_or_noop`); a wider leaf is the keccak256 of its le64
packing; an inner node is keccak256(left || right); each 64-bit digest
limb is made canonical Goldilocks.

`keccak_rows` is the one entry to the hash: on a CPU tensor it runs the
plain version (`keccak_rows_plain`, int64 torch ops over all rows at
once); on a CUDA tensor it launches the hand-written kernel
(csrc/keccak.cu) on the current stream or raises — there is no fallback.
`LAUNCHES` counts kernel launches, so a run can show that its main path
went through the kernel.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from .. import cuda_build
from ..field import GF
from ..field import goldilocks as gl
from .keccak_np import _R, _RC

LAUNCHES = {"rows": 0}

_RATE_LANES = 17
_SIGN = -(1 << 63)                 # lane pattern of 0x80 in the top byte
_RC_I64 = _RC.view("<i8").tolist()
# lane (x, y) at flat index x + 5 y; rho rotates it left by _R[x][y], and
# pi moves it to (y, 2x + 3y): PI_SRC[dst] is the lane that lands at dst
_ROT = [_R[i % 5][i // 5] for i in range(25)]
_PI_SRC = [0] * 25
for _x in range(5):
    for _y in range(5):
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y


def _rotl1(v: torch.Tensor) -> torch.Tensor:
    return (v << 1) | ((v >> 63) & 1)


def keccak_f1600_plain(state: torch.Tensor) -> torch.Tensor:
    """Keccak-f[1600] of (k, 5, 5) int64 lanes (u64 bit patterns), lane
    (x, y) at [:, y, x] (hash/keccak_np.py's layout), plain PyTorch. On
    int64 `>>` sign-extends, so every right shift is masked."""
    k = state.shape[0]
    dev = state.device
    rot = torch.tensor(_ROT, dtype=torch.int64, device=dev)
    # rho's right half: v >> (64 - r) keeping r bits; lane 0 (r = 0) keeps
    # none, so its shift is taken as 0 and masked away
    rshift = (64 - rot) % 64
    rmask = (torch.ones_like(rot) << rot) - 1
    pi_src = torch.tensor(_PI_SRC, dtype=torch.int64, device=dev)
    s = state.reshape(k, 5, 5)
    for rc in _RC_I64:
        # theta
        c = s[:, 0] ^ s[:, 1] ^ s[:, 2] ^ s[:, 3] ^ s[:, 4]       # (k, x)
        d = c.roll(1, dims=1) ^ _rotl1(c.roll(-1, dims=1))
        flat = (s ^ d[:, None, :]).reshape(k, 25)
        # rho, then pi
        flat = (flat << rot) | ((flat >> rshift) & rmask)
        b = flat.index_select(1, pi_src).reshape(k, 5, 5)
        # chi
        s = b ^ (~b.roll(-1, dims=2) & b.roll(-2, dims=2))
        # iota
        s[:, 0, 0] ^= rc
    return s


def keccak_rows_plain(x: GF) -> GF:
    """keccak256 of each row of an (n, width) GF matrix, the row's words
    little-endian: (n, 4) canonical digest limbs. Plain PyTorch, all rows
    at once: the kernel's plain version."""
    n, width = x.shape
    n_blocks = width * 8 // 136 + 1
    total = n_blocks * _RATE_LANES
    lanes = torch.zeros((n, total), dtype=torch.int64, device=x.device)
    lanes[:, :width] = x.v
    lanes[:, width] ^= 0x01                  # pad10*1: 0x01 after the message
    lanes[:, total - 1] ^= _SIGN             # and 0x80 in the last byte
    s = torch.zeros((n, 25), dtype=torch.int64, device=x.device)
    for b in range(n_blocks):
        s[:, :_RATE_LANES] ^= lanes[:, b * _RATE_LANES:(b + 1) * _RATE_LANES]
        s = keccak_f1600_plain(s.reshape(n, 5, 5)).reshape(n, 25)
    return GF(gl._canon(s[:, :4]))      # p subtracted where >= p


def _library() -> ctypes.CDLL:
    with cuda_build.FIRST_USE:
        return _bind()


@lru_cache(maxsize=1)
def _bind() -> ctypes.CDLL:
    lib = cuda_build.load("keccak")
    c, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.zk_keccak_rows.argtypes = [c, i64, i64, i64, i64, c, c]
    lib.zk_keccak_rows.restype = ctypes.c_int
    return lib


def keccak_rows(x: GF) -> GF:
    """keccak256 of each row of an (n, width) GF matrix: (n, 4) canonical
    digest limbs. A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel, which reads the matrix through its strides (the
    prover passes `lde.T`)."""
    v = x.v
    if v.ndim != 2:
        raise ValueError(f"keccak rows: expected (n, width), got "
                         f"{tuple(v.shape)}")
    if v.device.type == "cpu":
        return keccak_rows_plain(x)
    if v.device.type != "cuda":
        raise ValueError(f"keccak rows: expected a CPU or CUDA tensor, got "
                         f"{v.device}")
    if v.dtype != torch.int64:
        raise TypeError(f"keccak rows: expected int64, got {v.dtype}")
    n, width = v.shape
    out = torch.empty((n, 4), dtype=torch.int64, device=v.device)
    lib = _library()
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = lib.zk_keccak_rows(v.data_ptr(), n, width, v.stride(0),
                                 v.stride(1), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"keccak kernel launch: CUDA error {err}")
    cuda_build.count_launch(LAUNCHES, "rows")
    return GF(out)


def _noop_pad(leaves: GF) -> GF:
    n, width = leaves.shape
    if width == 4:
        return leaves
    return GF.concatenate([leaves, GF.zeros((n, 4 - width), leaves.device)],
                          axis=1)


def hash_rows(leaves: GF) -> GF:
    """Leaf digests: hash_or_noop (<= 4 values pass through zero-padded,
    merkle/keccak_host.py law), else keccak256 of the le64 packing."""
    if leaves.shape[1] <= 4:
        return _noop_pad(leaves)
    return keccak_rows(leaves)


def compress(level: GF) -> GF:
    """One tree level: keccak256(left_digest || right_digest) of
    consecutive digests."""
    return keccak_rows(level.reshape(-1, 8))


def hash_rows_plain(leaves: GF) -> GF:
    """`hash_rows` with the plain version on any device."""
    if leaves.shape[1] <= 4:
        return _noop_pad(leaves)
    return keccak_rows_plain(leaves)


def compress_plain(level: GF) -> GF:
    """`compress` with the plain version on any device."""
    return keccak_rows_plain(level.reshape(-1, 8))

