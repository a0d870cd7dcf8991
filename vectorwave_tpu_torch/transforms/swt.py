"""Stationary Wavelet Transform (SWT) facade over the MODWT.

Counterpart of ``vectorwave_tpu/transforms/swt.py``: the SWT is the same
undecimated cascade as the multi-level MODWT, exposed with SWT conventions.
Each operation returns a new coefficient set; nothing is edited in place.
On an eligible CUDA tensor the decomposition and the reconstruction are one
kernel launch each (periodic, zero and symmetric boundaries); the
thresholds run as plain PyTorch ops between them.
"""

from __future__ import annotations

import torch

from ..errors import ErrorCode, InvalidArgumentError
from ..ops.thresholds import apply_threshold, mad_sigma, universal_threshold
from .multilevel import MultiLevelMODWTResult, imodwt_multilevel, modwt_multilevel

#: SWT coefficients are identical to multi-level MODWT coefficients.
SWTResult = MultiLevelMODWTResult


def swt(
    x: torch.Tensor,
    wavelet,
    *,
    levels: int | None = None,
    boundary: str = "periodic",
) -> SWTResult:
    """Forward SWT."""
    return modwt_multilevel(x, wavelet, levels=levels, boundary=boundary)


def iswt(result: SWTResult, wavelet, *, boundary: str = "periodic") -> torch.Tensor:
    """Inverse SWT."""
    return imodwt_multilevel(result, wavelet, boundary=boundary)


def threshold_level(
    result: SWTResult,
    level: int,
    threshold,
    *,
    mode: str = "soft",
) -> SWTResult:
    """Threshold one detail level; returns a new result."""
    details = list(result.details)
    details[level - 1] = apply_threshold(details[level - 1], threshold, mode)
    return SWTResult(tuple(details), result.approx)


def apply_universal_threshold(result: SWTResult, *, mode: str = "soft") -> SWTResult:
    """Universal threshold on every detail level, sigma from the finest level."""
    sigma = mad_sigma(result.details[0])
    threshold = universal_threshold(result.signal_length, sigma)
    details = tuple(apply_threshold(d, threshold, mode) for d in result.details)
    return SWTResult(details, result.approx)


def swt_denoise(
    x: torch.Tensor,
    wavelet,
    *,
    levels: int | None = None,
    threshold: float | None = None,
    mode: str = "soft",
    boundary: str = "periodic",
) -> torch.Tensor:
    """Decompose, threshold, reconstruct.

    ``threshold=None`` (or a negative number) selects the universal
    threshold, sigma from the MAD of the finest detail.
    """
    result = swt(x, wavelet, levels=levels, boundary=boundary)
    if threshold is None or (isinstance(threshold, (int, float)) and threshold < 0):
        result = apply_universal_threshold(result, mode=mode)
    else:
        details = tuple(apply_threshold(d, threshold, mode) for d in result.details)
        result = SWTResult(details, result.approx)
    return iswt(result, wavelet, boundary=boundary)


def extract_level(
    x: torch.Tensor,
    wavelet,
    levels: int,
    target_level: int,
    *,
    boundary: str = "periodic",
) -> torch.Tensor:
    """Band isolation: zero all levels but ``target_level`` and reconstruct
    (0 selects the approximation band)."""
    if not 0 <= target_level <= levels:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL,
            f"target_level must be in [0, {levels}], got {target_level}",
        )
    result = swt(x, wavelet, levels=levels, boundary=boundary)
    details = tuple(
        d if level == target_level else torch.zeros_like(d)
        for level, d in enumerate(result.details, start=1)
    )
    approx = result.approx if target_level == 0 else torch.zeros_like(result.approx)
    return iswt(SWTResult(details, approx), wavelet, boundary=boundary)


def mra(
    x: torch.Tensor,
    wavelet,
    *,
    levels: int | None = None,
    boundary: str = "periodic",
) -> tuple[torch.Tensor, ...]:
    """Multi-resolution analysis: per-band reconstructions (details 1..J,
    then the smooth), which sum exactly to the signal under periodic
    boundaries; they share one decomposition."""
    result = swt(x, wavelet, levels=levels, boundary=boundary)
    zero = torch.zeros_like(result.approx)
    bands = []
    for level in range(1, result.levels + 1):
        details = tuple(
            d if j == level else torch.zeros_like(d)
            for j, d in enumerate(result.details, start=1)
        )
        bands.append(iswt(SWTResult(details, zero), wavelet, boundary=boundary))
    bands.append(iswt(
        SWTResult(tuple(torch.zeros_like(d) for d in result.details), result.approx),
        wavelet, boundary=boundary,
    ))
    return tuple(bands)
