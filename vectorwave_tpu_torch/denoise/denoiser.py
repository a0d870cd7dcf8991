"""MODWT-based wavelet denoising.

Counterpart of ``vectorwave_tpu/denoise/denoiser.py``: single-level
:func:`denoise` and :func:`denoise_fixed`, and the multi-level
:func:`denoise_multilevel` and :func:`denoise_block`: sigma from the MAD of
the finest detail, a level-dependent threshold rule (or NeighBlock block
shrinkage), shrinkage of the detail planes, reconstruction.  For the sigma-only rules
(universal, minimax) on an eligible CUDA tensor the whole pipeline is one
launch of the fused denoise kernel, and the coefficient planes never reach
device memory.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import get_sigma_estimator
from ..errors import ErrorCode, InvalidArgumentError
from ..kernels.modwt_composite import denoise_tile
from ..kernels.modwt_fused import _INV_SQRT2, fused_denoise_multilevel
from ..ops.thresholds import (
    apply_threshold,
    block_shrink,
    mad_sigma,
    minimax_threshold,
    select_threshold,
    universal_threshold,
)
from ..transforms.modwt import MODWTResult, _resolve_discrete, imodwt, modwt
from ..transforms.multilevel import (
    MultiLevelMODWTResult,
    _kernel_eligible,
    _resolve_tier,
    imodwt_multilevel,
    max_levels,
    modwt_multilevel,
)


def denoise(
    x: torch.Tensor,
    wavelet,
    *,
    method: str = "universal",
    mode: str = "soft",
    boundary: str = "periodic",
) -> torch.Tensor:
    """Single-level denoise: sigma from the MAD of the detail, the threshold
    selected by ``method``, applied to the detail only, then the inverse."""
    res = modwt(x, wavelet, boundary=boundary)
    sigma = mad_sigma(res.detail)
    threshold = select_threshold(res.detail, sigma, method)
    denoised = MODWTResult(res.approx, apply_threshold(res.detail, threshold, mode))
    return imodwt(denoised, wavelet, boundary=boundary)


def denoise_fixed(
    x: torch.Tensor,
    wavelet,
    threshold,
    *,
    mode: str = "soft",
    boundary: str = "periodic",
) -> torch.Tensor:
    """Single-level denoise with an explicit threshold."""
    res = modwt(x, wavelet, boundary=boundary)
    denoised = MODWTResult(res.approx, apply_threshold(res.detail, threshold, mode))
    return imodwt(denoised, wavelet, boundary=boundary)


def threshold_coeffs(
    result: MultiLevelMODWTResult,
    sigma,
    *,
    method: str = "universal",
    mode: str = "soft",
) -> MultiLevelMODWTResult:
    """Level-dependent thresholding of a multi-level decomposition: at level
    j the noise std scales as ``sigma / sqrt(2^j)`` under the per-stage MODWT
    filter scaling, each level's threshold is selected with that sigma, and
    only the details are shrunk."""
    new_details = []
    for level, detail in enumerate(result.details, start=1):
        level_sigma = sigma / math.sqrt(2.0**level)
        threshold = select_threshold(detail, level_sigma, method)
        new_details.append(apply_threshold(detail, threshold, mode))
    return MultiLevelMODWTResult(tuple(new_details), result.approx)


def denoise_multilevel(
    x: torch.Tensor,
    wavelet,
    *,
    levels: int | None = None,
    method: str = "universal",
    mode: str = "soft",
    boundary: str = "periodic",
    tolerance: float | None = None,
    precision: str | None = None,
) -> torch.Tensor:
    """Multi-level denoise with level-dependent thresholds.

    For the sigma-only rules (universal/minimax) on periodic/zero boundaries
    and an eligible CUDA tensor, the whole pipeline is one fused kernel;
    sigma then comes from the decimated MAD of :func:`_fused_sigma`.  Other
    rules (SURE/Bayes/FDR), symmetric boundaries and CPU tensors take the
    materializing path: ``modwt_multilevel``, the thresholds,
    ``imodwt_multilevel``, which on an eligible CUDA tensor is one analysis
    and one (symmetric) synthesis kernel launch.

    ``tolerance=``/``precision=`` route the precision tier like
    :func:`~..transforms.multilevel.modwt_multilevel`.  A tolerance below the
    float32 tier clamps to it (the output is a float32 signal); an explicit
    ``precision='exact'`` raises.
    """
    tier = _resolve_tier(tolerance, precision)
    if tier == "exact":
        if precision is not None:
            raise InvalidArgumentError(
                ErrorCode.CFG_INVALID_CONFIG,
                "denoise_multilevel cannot serve precision='exact': the "
                "denoised output is f32, so the float32 tier is the floor "
                "on this surface",
                suggestions=("Pass tolerance= instead (clamps to float32)",),
            )
        tier = "float32"
    fused = _try_fused_denoise(x, wavelet, levels, method, mode, boundary,
                               precision=tier)
    if fused is not None:
        return fused
    res = modwt_multilevel(x, wavelet, levels=levels, boundary=boundary,
                           precision=tier)
    sigma = mad_sigma(res.details[0])  # finest scale estimates the noise floor
    denoised = threshold_coeffs(res, sigma, method=method, mode=mode)
    return imodwt_multilevel(denoised, wavelet, boundary=boundary, precision=tier)


def fused_denoise_serves(x, w, levels: int, method: str, mode: str, boundary: str) -> bool:
    """Whether :func:`denoise_multilevel` takes the one-pass fused kernel for
    this call: a sigma-only rule (universal, minimax) in soft or hard mode,
    a periodic or zero boundary, two levels or more, the cascade pair's gate
    under the configured backend (``_kernel_eligible``) and the denoise
    kernel's own room (``modwt_composite.denoise_tile``)."""
    return (method in ("universal", "minimax") and mode in ("soft", "hard")
            and not boundary.lower().startswith("sym") and levels >= 2
            and _kernel_eligible(x, w, levels, boundary)
            and denoise_tile(w.filter_length, levels) is not None)


def fused_denoise_thresholds(x, w, levels: int, method: str, boundary: str) -> torch.Tensor:
    """The fused route's per-level thresholds, ``[..., levels]`` float32:
    sigma from :func:`_fused_sigma`, scaled by ``1/sqrt(2^j)`` at level j,
    through the method's rule."""
    sigma = _fused_sigma(x, w, boundary)  # [..., 1]
    rule = universal_threshold if method == "universal" else minimax_threshold
    return torch.cat(
        [
            rule(x.shape[-1], sigma / math.sqrt(2.0**level)).to(torch.float32)
            for level in range(1, levels + 1)
        ],
        dim=-1,
    )


def _try_fused_denoise(x, wavelet, levels, method, mode, boundary, precision=None):
    """The fused denoise where :func:`fused_denoise_serves` admits the call;
    None = take the 3-call path."""
    w = _resolve_discrete(wavelet)
    if levels is None:
        levels = max_levels(x.shape[-1], w)
    if not fused_denoise_serves(x, w, levels, method, mode, boundary):
        return None
    return fused_denoise_multilevel(
        x, w, levels=levels, thresholds=fused_denoise_thresholds(x, w, levels, method, boundary),
        boundary=boundary, mode=mode, precision=precision,
    )


#: Decimated sigma: signals shorter than this keep the full-sample median;
#: longer ones subsample ~1/64 of their 128-sample rows (>= _SIGMA_MIN_ROWS).
_SIGMA_DECIMATE_MIN_N = 32768
_SIGMA_MIN_ROWS = 8
#: Row width of the subsample.  It decides which samples enter the median,
#: so it is part of the estimator, not a memory layout.
_SIGMA_ROW = 128


def _fused_sigma(x, w, boundary):
    """MAD sigma of the level-1 detail for the fused denoise router.

    For large signals (``config.set_sigma_estimator`` = auto/decimated) the
    MAD is taken over the level-1 detail of a strided subsample of
    128-sample rows, rows ``i * stride`` for ``i < n_sub``, with ``n_sub =
    max(8, rows // 64)`` (>= 1024 samples).  Each selected row's detail
    needs the row before it: row ``i * stride - 1``, which for ``i = 0`` is
    the last row (periodic) or zeros (zero boundary).  The detail is
    computed in full float32 from float32 taps, as the JAX package does;
    the median is exact over the subsample.
    """
    est = get_sigma_estimator()
    n = x.shape[-1]
    lead = x.shape[:-1]
    r = n // _SIGMA_ROW if n % _SIGMA_ROW == 0 else 0
    want_decimated = est == "decimated" or (
        est == "auto" and n >= _SIGMA_DECIMATE_MIN_N
    )
    if not want_decimated or r < 4 * _SIGMA_MIN_ROWS:
        return mad_sigma(modwt(x, w, boundary=boundary).detail)
    n_sub = max(_SIGMA_MIN_ROWS, r // 64)
    stride = r // n_sub
    high = (np.asarray(w.dec_hi, np.float64) * _INV_SQRT2).astype(np.float32)
    if len(high) > _SIGMA_ROW:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            "decimated sigma needs a filter no longer than one row",
            context={"taps": len(high)},
        )
    x3 = x.reshape(-1, r, _SIGMA_ROW).to(torch.float32)
    rows = x3[:, ::stride, :][:, :n_sub, :]
    before = x3[:, stride - 1 :: stride, :][:, : n_sub - 1, :]
    if boundary.lower().startswith("per"):
        first = x3[:, r - 1 : r, :]
    else:
        first = torch.zeros_like(x3[:, :1, :])
    window = torch.cat([torch.cat([first, before], dim=1), rows], dim=-1)
    # Fused multiply-adds in float32 (the exact product and the sum rounded
    # once, through float64), taps from last to first, with the previous
    # row's and the row's own contributions summed apart and then added:
    # the summation order of the JAX package's banded row product, so the
    # two packages pick the same order statistics bit for bit.
    from_before = torch.arange(_SIGMA_ROW, device=x.device) < torch.arange(
        len(high), device=x.device
    )[:, None]  # [taps, row]: tap k reads the previous row for lanes < k
    part_before = torch.zeros_like(rows)
    part_own = torch.zeros_like(rows)
    for k in range(len(high) - 1, -1, -1):
        view = window[..., _SIGMA_ROW - k : 2 * _SIGMA_ROW - k].to(torch.float64)
        tap = float(high[k])
        mask = from_before[k]
        part_before = (part_before + torch.where(mask, view, 0.0) * tap).to(torch.float32)
        part_own = (part_own + torch.where(mask, 0.0, view) * tap).to(torch.float32)
    d1 = part_before + part_own
    return mad_sigma(d1.reshape(-1, n_sub * _SIGMA_ROW)).reshape(lead + (1,))


def denoise_block(
    x: torch.Tensor,
    wavelet,
    *,
    levels: int | None = None,
    boundary: str = "periodic",
    block_size: int | None = None,
) -> torch.Tensor:
    """Multi-level NeighBlock denoise.

    Like :func:`denoise_multilevel`, but each detail level is shrunk in
    blocks with :func:`~vectorwave_tpu_torch.ops.thresholds.block_shrink`: a
    strong neighbour rescues weak coefficients inside a feature.  The
    per-level noise floor follows the same ``sigma / sqrt(2^j)`` MODWT
    scaling as :func:`threshold_coeffs`.  On an eligible CUDA tensor the
    transform pair is one analysis and one synthesis kernel launch.
    """
    res = modwt_multilevel(x, wavelet, levels=levels, boundary=boundary)
    sigma = mad_sigma(res.details[0])
    new_details = []
    for level, detail in enumerate(res.details, start=1):
        level_sigma = sigma / math.sqrt(2.0**level)
        new_details.append(block_shrink(detail, level_sigma, block_size=block_size))
    denoised = MultiLevelMODWTResult(tuple(new_details), res.approx)
    return imodwt_multilevel(denoised, wavelet, boundary=boundary)
