"""Batched Poseidon permutation, leaf sponge and two-to-one compression.

The state is a ``GF`` array of shape ``(..., 12)``; leading dimensions are
batch dimensions, so one call hashes a whole Merkle level or leaf matrix.

`permute`, `hash_rows` and `compress` are the entry points. On a CUDA
tensor they run the hand-written kernels of ``poseidon_dense`` (one thread
per state, all 30 rounds in registers); on a CPU tensor they run the plain
PyTorch versions below, `permute_plain` and `hash_rows_plain`, which the
CPU tests hold against the JAX package and the exact host twin, and which
the chip check holds the kernels against.

The plain MDS multiply exploits the small circulant (entries < 2^6): each
element splits into two 32-bit halves, each half's matrix-vector product is
an exact integer sum (< 2^42, so one float64 matmul computes it
exactly), and one Goldilocks reduction per element follows — no general
field multiplies.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..field import GF
from ..field import goldilocks as gl
from . import poseidon_params as pp
from . import poseidon_dense


@lru_cache(maxsize=1)
def mds_matrix_np() -> np.ndarray:
    """(12, 12) int64 matrix M with out[r] = sum_j M[r, j] * in[j]:
    M[r, j] = circ[(j - r) mod 12] + diag[r] * (j == r)."""
    params = pp.default_params()
    w = params.width
    m = np.zeros((w, w), dtype=np.int64)
    for r in range(w):
        for j in range(w):
            m[r, j] = params.mds_circ[(j - r) % w]
        m[r, r] += params.mds_diag[r]
    return m


def _mds(x: torch.Tensor, mat_t: torch.Tensor) -> torch.Tensor:
    """Circulant-MDS multiply along the last axis (size 12); `mat_t` is
    the transposed matrix as float64. Every product and partial sum is an
    integer below 2^42 < 2^53, so one float64 matmul computes both
    halves' sums exactly (on the CPU about 3x faster than int64 products
    and sums)."""
    halves = torch.stack([x & gl.M32, (x >> 32) & gl.M32])
    acc_lo, acc_hi = (halves.to(torch.float64) @ mat_t).to(torch.int64)
    # value = acc_lo + acc_hi * 2^32 < 2^74: carry into a 96-bit limb form
    h = acc_hi + (acc_lo >> 32)                     # < 2^43
    n0 = (acc_lo & gl.M32) | ((h & gl.M32) << 32)
    return gl.reduce128(n0, h >> 32, torch.zeros_like(h))


def _sbox7(x: torch.Tensor) -> torch.Tensor:
    x2 = gl.square(x)
    x3 = gl.mul(x2, x)
    return gl.mul(gl.square(x3), x)


def permute_plain(state: GF) -> GF:
    """Poseidon permutation over a (..., 12) GF state, plain PyTorch."""
    params = pp.default_params()
    dev = state.device
    rcs = gl.from_u64(pp.round_constants_np(), dev)
    mat_t = torch.from_numpy(mds_matrix_np().T.astype(np.float64)).to(dev)
    h = params.half_full_rounds
    n_partial = params.n_partial_rounds
    s = state.v
    for rnd in range(params.n_rounds):
        s = gl.add(s, rcs[rnd])
        if h <= rnd < h + n_partial:
            s = torch.cat([_sbox7(s[..., :1]), s[..., 1:]], dim=-1)
        else:
            s = _sbox7(s)
        s = _mds(s, mat_t)
    return GF(s)


def hash_rows_plain(matrix: GF) -> GF:
    """Rate-8 overwrite-mode sponge of each row of an (n_rows, n_cols)
    matrix with n_cols > 4, plain PyTorch. A trailing partial chunk
    overwrites only its own lanes."""
    n_rows, n_cols = matrix.shape
    state = GF.zeros((n_rows, pp.WIDTH), matrix.device)
    for off in range(0, n_cols, pp.RATE):
        chunk = matrix[:, off:off + pp.RATE]
        k = chunk.shape[1]
        state = permute_plain(GF.concatenate([chunk, state[:, k:]], axis=1))
    return state[:, :4]


def permute(state: GF) -> GF:
    """Poseidon permutation over a (..., 12) GF state."""
    batch = state.shape[:-1]
    out = poseidon_dense.permute_dense(state.reshape(-1, pp.WIDTH))
    return out.reshape(*batch, pp.WIDTH)


def hash_rows(matrix: GF) -> GF:
    """Hash each row of a (n_rows, n_cols) GF matrix to a 4-element digest.

    Overwrite-mode sponge, rate 8; rows with <= 4 columns are zero-padded
    passthrough digests (leaf `hash_or_noop` semantics). The sponge kernel
    reads the (n_cols, n_rows) view, so a caller passing `lde.T` hands it
    the LDE's own layout without a copy."""
    n_rows, n_cols = matrix.shape
    if n_cols <= 4:
        pad = GF.zeros((n_rows, 4 - n_cols), matrix.device)
        return GF.concatenate([matrix, pad], axis=1)
    return poseidon_dense.sponge_dense(matrix.T)


def compress(left: GF, right: GF) -> GF:
    """Batched two-to-one compression: (..., 4) x (..., 4) -> (..., 4)."""
    batch = left.shape[:-1]
    zeros = GF.zeros(batch + (pp.WIDTH - 8,), left.device)
    state = GF.concatenate([left, right, zeros], axis=-1)
    return permute(state)[..., :4]
