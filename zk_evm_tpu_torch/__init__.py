"""PyTorch/CUDA port of the zk_evm_tpu STARK prover.

Module paths mirror the JAX package: `zk_evm_tpu/X/y.py` is ported at
`zk_evm_tpu_torch/X/y.py`. This package imports torch and numpy and never
jax. Field arrays are int64 tensors holding u64 bit patterns; the Poseidon
permutation and leaf sponge run as hand-written CUDA kernels on CUDA
tensors (`hash/poseidon_dense.py`, `csrc/poseidon.cu`) and as plain
PyTorch on CPU tensors.
"""
