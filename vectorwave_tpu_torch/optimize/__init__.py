"""Iterative wavelet-domain optimization of the port: sparse inverse problems
(FISTA over the MODWT frame), ForWaRD deconvolution and matching pursuit."""

from .deconvolve import DeconvolutionResult, deconvolve, deconvolve2
from .mp import MPResult, matching_pursuit
from .sparse import SparseRecovery, bpdn, fista, inpaint, inpaint2, sparse_recover

__all__ = [
    "MPResult",
    "matching_pursuit",
    "DeconvolutionResult",
    "deconvolve",
    "deconvolve2",
    "SparseRecovery",
    "bpdn",
    "fista",
    "inpaint",
    "inpaint2",
    "sparse_recover",
]
