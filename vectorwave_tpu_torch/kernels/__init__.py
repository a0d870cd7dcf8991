"""Kernel tier of the port: hand-written CUDA kernels for Hopper, their
plain PyTorch versions and the differentiable entry points.  Nothing is
built when this package is imported; the kernels compile at first launch
(``_build.library``)."""

from .modwt_fused import (
    fused_analysis,
    fused_denoise_multilevel,
    fused_synthesis,
    kernel_available,
    modwt_roundtrip_fused,
    total_halo,
)

__all__ = [
    "fused_analysis",
    "fused_denoise_multilevel",
    "fused_synthesis",
    "kernel_available",
    "modwt_roundtrip_fused",
    "total_halo",
]
