"""2-D Stationary Wavelet Transform facade over the 2-D MODWT.

Counterpart of ``vectorwave_tpu/transforms/swt2.py``: the 2-D analogue of
:mod:`.swt`.  The coefficients are those of :func:`.twodim.modwt2_multilevel`,
so everything here edits that engine's results (which run on the 2-D kernel
tier for an eligible CUDA tensor); nothing is edited in place.
"""

from __future__ import annotations

import torch

from ..errors import ErrorCode, InvalidArgumentError
from .twodim import MultiLevelMODWT2Result, denoise2, imodwt2_multilevel, modwt2_multilevel

__all__ = [
    "SWT2Result",
    "swt2",
    "iswt2",
    "swt2_denoise",
    "extract_level2",
    "mra2",
]

#: 2-D SWT coefficients are identical to multi-level 2-D MODWT coefficients.
SWT2Result = MultiLevelMODWT2Result


def swt2(x: torch.Tensor, wavelet, *, levels: int, boundary: str = "periodic") -> SWT2Result:
    """Forward 2-D SWT (undecimated; per-level ``(lh, hl, hh)`` and the final
    ``ll``)."""
    return modwt2_multilevel(x, wavelet, levels=levels, boundary=boundary)


def iswt2(result: SWT2Result, wavelet, *, boundary: str = "periodic") -> torch.Tensor:
    """Inverse 2-D SWT (exact reconstruction under periodic boundaries)."""
    return imodwt2_multilevel(result, wavelet, boundary=boundary)


def swt2_denoise(
    x: torch.Tensor,
    wavelet,
    *,
    levels: int = 3,
    method: str = "universal",
    mode: str = "soft",
    boundary: str = "periodic",
) -> torch.Tensor:
    """Shift-invariant 2-D denoising in SWT terms (:func:`.twodim.denoise2`:
    sigma from the finest diagonal band)."""
    return denoise2(x, wavelet, levels=levels, method=method, mode=mode,
                    boundary=boundary)


def extract_level2(
    x: torch.Tensor,
    wavelet,
    levels: int,
    target_level: int,
    *,
    boundary: str = "periodic",
) -> torch.Tensor:
    """Band isolation: zero every band but ``target_level``'s three
    orientation bands and reconstruct (0 selects the smooth ``ll`` band)."""
    if not 0 <= target_level <= levels:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL,
            f"target_level must be in [0, {levels}], got {target_level}",
        )
    result = swt2(x, wavelet, levels=levels, boundary=boundary)
    details = tuple(
        trip if level == target_level else tuple(torch.zeros_like(p) for p in trip)
        for level, trip in enumerate(result.details, start=1)
    )
    approx = result.approx if target_level == 0 else torch.zeros_like(result.approx)
    return iswt2(SWT2Result(details, approx), wavelet, boundary=boundary)


def mra2(
    x: torch.Tensor,
    wavelet,
    *,
    levels: int,
    boundary: str = "periodic",
) -> tuple[torch.Tensor, ...]:
    """2-D multi-resolution analysis: additive per-scale reconstructions
    (detail images 1..J, then the smooth), which sum exactly to the image
    under periodic boundaries; they share one decomposition."""
    result = swt2(x, wavelet, levels=levels, boundary=boundary)
    zeros = tuple(tuple(torch.zeros_like(p) for p in trip) for trip in result.details)
    zero_ll = torch.zeros_like(result.approx)
    bands = []
    for level in range(1, levels + 1):
        details = tuple(
            result.details[j - 1] if j == level else zeros[j - 1]
            for j in range(1, levels + 1)
        )
        bands.append(iswt2(SWT2Result(details, zero_ll), wavelet, boundary=boundary))
    bands.append(iswt2(SWT2Result(zeros, result.approx), wavelet, boundary=boundary))
    return tuple(bands)
