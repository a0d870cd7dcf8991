"""Wavelet denoising of the port: single- and multi-level shrinkage (the
fused denoise on the card), packet and dual-tree denoising."""

from .denoiser import denoise, denoise_fixed, denoise_multilevel, threshold_coeffs
from .dtcwt_shrink import dtcwt_denoise
from .packet import denoise_packet

__all__ = [
    "denoise",
    "denoise_fixed",
    "denoise_multilevel",
    "dtcwt_denoise",
    "denoise_packet",
    "threshold_coeffs",
]
