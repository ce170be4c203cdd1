"""Keccak Merkle hasher config (host path).

The reference exposes two plonky2 hasher configs: Poseidon (the inner,
recursion-friendly one) and Keccak — used as the OUTER config of its
integration-test proofs (evm_arithmetization/tests/add11_yml.rs et al.,
`type C = KeccakGoldilocksConfig`) because keccak256 is what EVM-side
verifiers compute cheaply. The TPU framework mirrors that split: Poseidon
digests ride the chip for every in-prover commitment, and this module is
the Keccak twin for host-built, outward-facing artifacts (externally
checkable Merkle roots over proof/public-value payloads).

Digest law (self-consistent, documented — plonky2 crates are not in the
checkout, see stark/DESIGN.md):
  leaf    d = keccak256(le64(v_0) || ... || le64(v_{n-1}))   for n > 4,
          identity zero-padded to 4 elements otherwise (hash_or_noop)
  inner   d = keccak256(bytes(left) || bytes(right))
  field   the 32-byte digest splits into 4 little-endian u64 limbs, each
          reduced mod p so digests live in GF^4 and can be observed by
          the Poseidon transcript exactly like native caps.
"""

from __future__ import annotations

from ..field import host
from ..native import keccak256


def _le_bytes(values) -> bytes:
    return b"".join(int(v).to_bytes(8, "little") for v in values)


def _to_digest(raw: bytes) -> list[int]:
    return [int.from_bytes(raw[i:i + 8], "little") % host.P
            for i in range(0, 32, 8)]


def hash_or_noop(values) -> list[int]:
    vals = [int(v) for v in values]
    if len(vals) <= 4:
        return vals + [0] * (4 - len(vals))
    return _to_digest(keccak256(_le_bytes(vals)))


def two_to_one(left, right) -> list[int]:
    return _to_digest(keccak256(_le_bytes(left) + _le_bytes(right)))


def build_tree(leaves, cap_height: int):
    """Host Keccak cap tree: returns (levels, cap) — same shape contract
    as merkle.host.build_tree."""
    level = [hash_or_noop(row) for row in leaves]
    levels = [level]
    while len(levels[-1]) > (1 << cap_height):
        cur = levels[-1]
        levels.append([two_to_one(cur[i], cur[i + 1])
                       for i in range(0, len(cur), 2)])
    return levels, levels[-1]


def verify_path(leaf_values, index: int, path, cap,
                path_len: int | None = None) -> bool:
    """Same shape-enforcing contract as merkle.host.verify_path (path
    length mandatory against adversarial truncation)."""
    if path_len is not None and len(path) != path_len:
        return False
    if index < 0 or index >= len(cap) << len(path):
        return False
    digest = hash_or_noop(leaf_values)
    idx = index
    for sib in path:
        if len(sib) != 4:
            return False
        if idx & 1:
            digest = two_to_one(sib, digest)
        else:
            digest = two_to_one(digest, sib)
        idx >>= 1
    return digest == list(cap[idx])
