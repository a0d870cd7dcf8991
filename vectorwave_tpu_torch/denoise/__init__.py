"""Wavelet denoising of the port: single- and multi-level shrinkage (the
fused denoise on the card), block shrinkage, packet and dual-tree denoising
in 1-D and 2-D."""

from .denoiser import (
    denoise,
    denoise_block,
    denoise_fixed,
    denoise_multilevel,
    threshold_coeffs,
)
from .dtcwt_shrink import dtcwt2_denoise, dtcwt_denoise
from .packet import denoise_packet, denoise_packet2

__all__ = [
    "denoise",
    "denoise_block",
    "denoise_fixed",
    "denoise_multilevel",
    "denoise_packet",
    "denoise_packet2",
    "dtcwt2_denoise",
    "dtcwt_denoise",
    "threshold_coeffs",
]
