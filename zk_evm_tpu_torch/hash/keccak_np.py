"""Vectorized keccak256 over batches of equal-length messages (numpy).

Host-side batch hasher backing the Keccak Merkle commitment config
(merkle/keccak_tree.py) — the twin of zk_evm's
KeccakGoldilocksConfig outer hasher (plonky2 config used by every
integration test, e.g. evm_arithmetization/tests/
simple_transfer.rs:24,30). One keccak-f1600 pass permutes the whole
batch as (k, 5, 5) u64 lane planes; byte-exact vs the scalar
native.keccak256 (asserted in tests/test_torch_keccak.py). A jax-free
copy of the JAX package's `hash/keccak_np.py`.
"""

from __future__ import annotations

import numpy as np

# rotation offsets r[x][y] and round constants (public Keccak parameters;
# same tables as tables/keccak.py)
_R = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_RC = np.array([
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
], dtype=np.uint64)

_RATE_BYTES = 136          # keccak256: rate 1088 bits, capacity 512
_RATE_LANES = 17


def _rotl(v: np.ndarray, n: int) -> np.ndarray:
    n %= 64
    if n == 0:
        return v
    return (v << np.uint64(n)) | (v >> np.uint64(64 - n))


def keccak_f1600(state: np.ndarray) -> np.ndarray:
    """In-place-style permutation of (k, 5, 5) u64 lanes, lane (x, y)
    at state[:, y, x] (y-major, matching tables/keccak.py)."""
    s = state
    for rc in _RC:
        # theta
        c = np.bitwise_xor.reduce(s, axis=1)            # [k, x]
        d = np.empty_like(c)
        for x in range(5):
            d[:, x] = c[:, (x + 4) % 5] ^ _rotl(c[:, (x + 1) % 5], 1)
        s = s ^ d[:, None, :]
        # rho + pi
        b = np.empty_like(s)
        for x in range(5):
            for y in range(5):
                b[:, (2 * x + 3 * y) % 5, y] = _rotl(s[:, y, x], _R[x][y])
        # chi
        s = b ^ (~np.roll(b, -1, axis=2) & np.roll(b, -2, axis=2))
        # iota
        s[:, 0, 0] ^= rc
    return s


def keccak256_batch(msgs: np.ndarray) -> np.ndarray:
    """keccak256 of k equal-length messages: (k, L) uint8 -> (k, 32)
    uint8."""
    k, L = msgs.shape
    n_blocks = L // _RATE_BYTES + 1
    padded = np.zeros((k, n_blocks * _RATE_BYTES), dtype=np.uint8)
    padded[:, :L] = msgs
    padded[:, L] = 0x01                       # pad10*1 (keccak 0x01 .. 0x80)
    padded[:, -1] ^= 0x80
    lanes = padded.view("<u8").reshape(k, n_blocks, _RATE_LANES)
    state = np.zeros((k, 5, 5), dtype=np.uint64)
    flat = state.reshape(k, 25)
    for b in range(n_blocks):
        flat[:, :_RATE_LANES] ^= lanes[:, b]
        state = keccak_f1600(flat.reshape(k, 5, 5))
        flat = state.reshape(k, 25)
    return flat[:, :4].copy().view(np.uint8).reshape(k, 32)
