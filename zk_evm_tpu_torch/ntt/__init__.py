from .ntt import (
    fft, ifft, lde_bitrev, bit_reverse, powers,
    bit_reverse_indices, lde_from_coeffs_bitrev, coset_ifft_from_bitrev,
)
from . import host as host_ntt

__all__ = [
    "fft", "ifft", "lde_bitrev", "bit_reverse", "powers",
    "bit_reverse_indices", "lde_from_coeffs_bitrev",
    "coset_ifft_from_bitrev", "host_ntt",
]
