from .tree import MerkleTree, build_tree
from . import host as host_merkle


def build_commitment_tree(leaves, cap_height: int = 4,
                          hasher: str = "poseidon"):
    """Commitment-tree dispatch on StarkConfig.hasher. The port has the
    Poseidon tree only; the Keccak hasher configs come in a later slice."""
    if hasher != "poseidon":
        raise NotImplementedError(f"hasher {hasher!r}: later slice")
    return build_tree(leaves, cap_height=cap_height)


def path_verifier(hasher: str = "poseidon"):
    """The host verify_path for a hasher config."""
    if hasher != "poseidon":
        raise NotImplementedError(f"hasher {hasher!r}: later slice")
    return host_merkle.verify_path


__all__ = ["MerkleTree", "build_tree", "build_commitment_tree",
           "path_verifier", "host_merkle"]
