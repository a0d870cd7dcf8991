"""Wavelet-domain long-memory analysis: Hurst estimation and a variance
change test.

Counterpart of ``vectorwave_tpu/transforms/longmemory.py``:

* :func:`hurst_exponent`, the Abry-Veitch log-scale regression of the
  wavelet variance: ``nu_j^2 ~ tau_j^(alpha - 1)`` for an ``f^-alpha``
  spectrum, the log of each estimate debiased by ``psi(eta_j/2) -
  ln(eta_j/2)`` and weighted by the inverse of its variance
  ``psi'(eta_j/2)`` (Abry & Veitch 1998, eqs. 6-8);
* :func:`variance_change_test`, the Inclan-Tiao rotated cumulative sum of
  the squared boundary-free DWT details at one level (Percival-Walden
  section 9.6), whose statistic follows the Kolmogorov distribution under a
  constant variance.

Both are batched over leading axes: the regression is a closed-form
weighted least squares over the level axis, the test one ``cumsum`` and a
reduction.  The Kolmogorov quantile is a host-side bisection.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..errors import ErrorCode, InvalidArgumentError
from ..ops.dwt import wavedec
from .modwt import _resolve_discrete
from .variance import wavelet_variance

__all__ = [
    "HurstResult",
    "VarianceChangeResult",
    "hurst_exponent",
    "variance_change_test",
    "kolmogorov_critical_value",
]

_LN2 = math.log(2.0)


class HurstResult(NamedTuple):
    """Batched long-memory fit (leading axes follow the input signal).

    ``slope`` is the raw log2-variance against log2-scale slope (``alpha -
    1`` for an ``f^-alpha`` spectrum); ``hurst``/``stderr`` its model
    mapping.  ``variance`` holds the per-level wavelet variances and
    ``scales`` the corresponding ``tau_j``.
    """

    hurst: torch.Tensor
    slope: torch.Tensor
    intercept: torch.Tensor
    stderr: torch.Tensor
    variance: torch.Tensor
    scales: np.ndarray

    @property
    def spectral_exponent(self) -> torch.Tensor:
        """``alpha`` of the implied ``f^-alpha`` spectrum (= slope + 1)."""
        return self.slope + 1.0


def hurst_exponent(
    x: torch.Tensor,
    wavelet="db4",
    levels: int | None = None,
    *,
    model: str = "fgn",
    min_level: int = 1,
    max_level: int | None = None,
    dt: float = 1.0,
) -> HurstResult:
    """Abry-Veitch wavelet estimate of the Hurst exponent.

    ``model="fgn"`` treats ``x`` as a stationary (fGn-like) series,
    ``H = (slope + 2) / 2``: white noise gives 0.5.  ``model="fbm"`` treats
    it as a nonstationary random walk, ``H = slope / 2``: a cumulative sum
    of white noise gives 0.5.  ``min_level``/``max_level`` bound the
    octaves entering the fit.
    """
    model_l = model.lower()
    if model_l not in ("fgn", "fbm"):
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"model must be 'fgn' or 'fbm', got {model!r}",
        )
    r = wavelet_variance(x, wavelet, levels, dt=dt)
    j_hi = r.n_levels if max_level is None else max_level
    if not (1 <= min_level < j_hi <= r.n_levels):
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL,
            f"need 1 <= min_level < max_level <= {r.n_levels} for a 2-point "
            f"fit, got min_level={min_level}, max_level={j_hi}",
        )
    var = r.variance[..., min_level - 1:j_hi]
    eta = torch.as_tensor(r.edof[min_level - 1:j_hi], dtype=var.dtype, device=var.device)
    octave = torch.arange(min_level - 1, j_hi, dtype=var.dtype, device=var.device)

    # the debiased log2 variance and its exact chi-squared sampling variance
    y = torch.log2(torch.clamp_min(var, torch.finfo(var.dtype).tiny))
    y = y - (torch.special.digamma(eta / 2.0) - torch.log(eta / 2.0)) / _LN2
    wt = (_LN2**2) / torch.special.polygamma(1, eta / 2.0)

    s0 = wt.sum()
    s1 = (wt * octave).sum()
    s2 = (wt * octave * octave).sum()
    det = s0 * s2 - s1 * s1
    wy = (wt * y).sum(dim=-1)
    wty = (wt * octave * y).sum(dim=-1)
    slope = (s0 * wty - s1 * wy) / det
    intercept = (s2 * wy - s1 * wty) / det
    stderr_slope = torch.sqrt(s0 / det)
    hurst = (slope + 2.0) / 2.0 if model_l == "fgn" else slope / 2.0
    return HurstResult(hurst, slope, intercept,
                       torch.broadcast_to(stderr_slope / 2.0, slope.shape),
                       r.variance, r.scales)


# ---------------------------------------------------------------------------
# Variance change-point test
# ---------------------------------------------------------------------------


class VarianceChangeResult(NamedTuple):
    """Inclan-Tiao test outcome; leading axes follow the input signal.

    ``statistic`` is ``sqrt(M/2) * max_k |CUSUM_k|`` (Kolmogorov-distributed
    under the constant-variance null), ``location`` the approximate signal
    index of the CUSUM's argmax (the likeliest change point, to within the
    decimation stride ``2^level``).
    """

    statistic: torch.Tensor
    critical_value: float
    reject: torch.Tensor
    location: torch.Tensor
    level: int


def kolmogorov_critical_value(confidence: float) -> float:
    """Quantile of the Kolmogorov distribution
    ``K(x) = 1 - 2 sum (-1)^(k-1) exp(-2 k^2 x^2)``."""
    if not 0.0 < confidence < 1.0:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"confidence must be in (0, 1), got {confidence}",
        )

    def cdf(v: float) -> float:
        return 1.0 - 2.0 * sum(
            (-1.0) ** (k - 1) * math.exp(-2.0 * k * k * v * v) for k in range(1, 101)
        )

    lo, hi = 1e-3, 4.0
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if cdf(mid) < confidence:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def variance_change_test(
    x: torch.Tensor,
    wavelet="db4",
    level: int = 1,
    *,
    confidence: float = 0.95,
) -> VarianceChangeResult:
    """Test for a variance change through the level-``level`` DWT details.

    The signal is cut to a multiple of ``2^level`` and decomposed with the
    decimated pyramid; the first ``ceil((L-2)(1-2^-j))`` boundary-affected
    coefficients are dropped (Percival-Walden eq. 146b), and the normalized
    rotated cumulative sum of the remaining ``M`` squares is a Brownian
    bridge under homogeneity.  Decimated details of a white-ish series are
    nearly uncorrelated, so the Kolmogorov null keeps its nominal size.
    """
    if level < 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL, f"level must be >= 1, got {level}"
        )
    w = _resolve_discrete(wavelet)
    n = x.shape[-1]
    stride = 1 << level
    usable = (n // stride) * stride
    n_boundary = math.ceil((w.filter_length - 2) * (1.0 - 2.0**-level))
    m = usable // stride - n_boundary
    if m < 8:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL,
            f"level {level} leaves {max(m, 0)} boundary-free DWT "
            f"coefficients at N={n}; need >= 8",
        )
    d = wavedec(x[..., :usable], w, levels=level, boundary="periodic").details[-1]
    sq = torch.square(d[..., n_boundary:])
    total = sq.sum(dim=-1, keepdim=True)
    p = torch.cumsum(sq, dim=-1) / torch.clamp_min(total, torch.finfo(sq.dtype).tiny)
    k = torch.arange(1, m + 1, dtype=sq.dtype, device=sq.device) / m
    dev = torch.abs(p - k)
    stat = math.sqrt(m / 2.0) * dev.amax(dim=-1)
    crit = kolmogorov_critical_value(confidence)
    loc = (n_boundary + 1 + dev.argmax(dim=-1)) * stride
    return VarianceChangeResult(stat, crit, stat > crit, loc, level)
