from .ntt import (
    fft, fft_bitrev, ifft, coset_fft, lde_bitrev, bit_reverse, powers,
    bit_reverse_indices, lde_from_coeffs_bitrev, coset_ifft_from_bitrev,
)
from . import host as host_ntt

__all__ = [
    "fft", "fft_bitrev", "ifft", "coset_fft", "lde_bitrev", "bit_reverse",
    "powers", "bit_reverse_indices", "lde_from_coeffs_bitrev",
    "coset_ifft_from_bitrev", "host_ntt",
]
