"""Host-side Merkle verification (exact ints) — used by the proof verifier
and as the test oracle for the device tree builder."""

from __future__ import annotations

from ..hash import host_poseidon as hp


def verify_path(leaf_values: list[int], index: int,
                path: list[list[int]], cap: list[list[int]],
                path_len: int | None = None) -> bool:
    """Check a Merkle path against a cap. `cap` is a list of 4-element
    digests; the path stops at cap level.

    `path_len` is the expected number of path levels
    (log2(num_leaves) - cap_height). Passing it is mandatory for
    adversarial inputs: hash_or_noop is the identity on <=4-element
    leaves, so without the length check a cap entry "verifies" with an
    empty path and internal digests verify with truncated paths
    (the reference enforces these shapes at deserialization,
    proof.rs/fri validation)."""
    if path_len is not None and len(path) != path_len:
        return False
    if index < 0 or index >= len(cap) << len(path):
        return False
    digest = hp.hash_or_noop(leaf_values)
    idx = index
    for sib in path:
        if len(sib) != 4:
            return False
        if idx & 1:
            digest = hp.two_to_one(sib, digest)
        else:
            digest = hp.two_to_one(digest, sib)
        idx >>= 1
    return digest == list(cap[idx])


def build_tree(leaves: list[list[int]], cap_height: int):
    """Reference (slow) host tree: returns (levels, cap)."""
    level = [hp.hash_or_noop(row) for row in leaves]
    levels = [level]
    while len(levels[-1]) > (1 << cap_height):
        cur = levels[-1]
        levels.append([hp.two_to_one(cur[i], cur[i + 1])
                       for i in range(0, len(cur), 2)])
    return levels, levels[-1]
