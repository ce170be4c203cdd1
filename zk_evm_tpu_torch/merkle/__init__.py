from .tree import (MerkleTree, build_tree, build_tree_from_blocks,
                   build_tree_keccak_device, build_tree_mesh)
from . import host as host_merkle
from . import keccak_host as keccak_merkle
from . import paths


def build_commitment_tree(leaves, cap_height: int = 4,
                          hasher: str = "poseidon", mesh=None):
    """Commitment-tree dispatch on StarkConfig.hasher: the Poseidon tree
    (sponge and permute kernels on CUDA), the Keccak tree on the leaves'
    device ("keccak": the keccak256 rows kernel on CUDA; zk_evm's
    KeccakGoldilocksConfig twin, tests/simple_transfer.rs:24,30), or the
    host-numpy Keccak tree ("keccak_host", the bit-exactness ground
    truth), which takes CPU leaves only: on the card the Keccak tree is
    "keccak". With a `mesh` (`parallel.Mesh`) the row blocks are hashed
    over its devices (`build_tree_mesh`); "keccak_host" refuses one."""
    if mesh is not None:
        return build_tree_mesh(leaves, mesh, cap_height, hasher)
    if hasher == "keccak":
        return build_tree_keccak_device(leaves, cap_height)
    if hasher == "keccak_host":
        if leaves.device.type != "cpu":
            raise ValueError(f'hasher="keccak_host" hashes CPU leaves on the '
                             f'host; got leaves on {leaves.device} (use '
                             f'hasher="keccak" there)')
        import numpy as np
        from .keccak_tree import build_tree_keccak
        return build_tree_keccak(np.asarray(leaves.to_u64()), cap_height)
    assert hasher == "poseidon", hasher
    return build_tree(leaves, cap_height=cap_height)


def path_verifier(hasher: str = "poseidon"):
    """The host verify_path for a hasher config."""
    if hasher in ("keccak", "keccak_host"):
        return keccak_merkle.verify_path
    assert hasher == "poseidon", hasher
    return host_merkle.verify_path


def paths_verifier(hasher: str = "poseidon"):
    """The host verify_paths (many openings of one tree) for a hasher
    config."""
    if hasher in ("keccak", "keccak_host"):
        return paths.verify_paths_keccak
    assert hasher == "poseidon", hasher
    return paths.verify_paths


__all__ = ["MerkleTree", "build_tree", "build_commitment_tree",
           "build_tree_from_blocks", "build_tree_mesh",
           "path_verifier", "paths_verifier", "host_merkle",
           "keccak_merkle"]
