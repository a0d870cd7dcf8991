"""Iterative wavelet-domain optimization of the port: matching pursuit
(the sparse inverse problems and deconvolution are still to port)."""

from .mp import MPResult, matching_pursuit

__all__ = [
    "MPResult",
    "matching_pursuit",
]
