from . import poseidon_params, host_poseidon, poseidon

__all__ = ["poseidon_params", "host_poseidon", "poseidon"]
