"""MODWT wavelet variance, covariance and correlation (Percival-Walden).

Counterpart of ``vectorwave_tpu/transforms/variance.py``: the
scale-by-scale decomposition of a process variance,

    var(X) = sum_j nu_j^2,   nu_j^2 = E[d_{j,t}^2]  (MODWT detail at level j)

estimated without bias by averaging only the ``M_j = N - L_j + 1``
coefficients the circular boundary does not reach
(``L_j = (L-1)(2^j - 1) + 1``), with chi-squared intervals from the
equivalent degrees of freedom ``eta3 = max(M_j / 2^j, 1)`` and
Wilson-Hilferty quantiles.

Each estimator is one ``modwt_multilevel`` call (periodic; on a card the
cascade analysis kernel's one launch where its gate admits the shape) and a
mean per level.  The online form folds the details of either streaming step
(``modwt_stream_block`` or ``modwt_stream_block_kernel``, zero boundary)
into per-level sums; its counters are Python ints and numpy, as the port's
other streaming states keep theirs.
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import NamedTuple

import numpy as np
import torch

from ..convert import _device
from ..errors import ErrorCode, InvalidArgumentError
from .modwt import _resolve_discrete
from .multilevel import max_levels, modwt_multilevel

__all__ = [
    "WaveletVarianceResult",
    "VarianceStreamState",
    "variance_stream_init",
    "variance_stream_update",
    "variance_stream_result",
    "wavelet_variance",
    "wavelet_covariance",
    "wavelet_correlation",
]


class WaveletVarianceResult(NamedTuple):
    """Per-level estimates, each ``[..., J]`` (level ``j`` at index ``j-1``).

    ``edof`` carries the chi-squared equivalent degrees of freedom used for
    the interval; ``scales`` the physical scale ``tau_j = 2^(j-1) * dt``.
    """

    variance: torch.Tensor
    ci_low: torch.Tensor
    ci_high: torch.Tensor
    edof: np.ndarray
    scales: np.ndarray

    @property
    def n_levels(self) -> int:
        return self.variance.shape[-1]


def _chi2_quantile(p: float, k: np.ndarray) -> np.ndarray:
    """Wilson-Hilferty chi-squared quantile (vectorized over dof ``k``)."""
    z = NormalDist().inv_cdf(p)
    h = 2.0 / (9.0 * k)
    return k * (1.0 - h + z * np.sqrt(h)) ** 3


def cascade_length(filter_length: int, level: int) -> int:
    """Width of the level-j MODWT filter in the raw signal,
    ``L_j = (2^j - 1)(L - 1) + 1`` (Percival-Walden eq. 96a); the
    coefficients ``t >= L_j - 1`` reach no boundary."""
    return ((1 << level) - 1) * (filter_length - 1) + 1


def _interior_stats(details, other, filter_length: int, n: int,
                    unbiased: bool) -> tuple[torch.Tensor, np.ndarray]:
    """Per-level mean of ``d_x * d_y`` over the boundary-free coefficients:
    (``[..., J]`` stats, ``[J]`` effective sample counts)."""
    stats = []
    counts = np.empty(len(details))
    for j, d in enumerate(details, start=1):
        dy = d if other is None else other[j - 1]
        start = cascade_length(filter_length, j) - 1 if unbiased else 0
        stats.append((d * dy)[..., start:].mean(dim=-1))
        counts[j - 1] = n - start
    return torch.stack(stats, dim=-1), counts


def _resolve_levels(x: torch.Tensor, wavelet, levels, unbiased: bool) -> int:
    w = _resolve_discrete(wavelet)
    n = x.shape[-1]
    if unbiased:
        deepest = 0
        while cascade_length(w.filter_length, deepest + 1) <= n:
            deepest += 1
        deepest = min(deepest, max_levels(n, w))
    else:
        deepest = max(1, int(math.floor(math.log2(max(n, 2)))))
    if levels is None:
        return max(1, deepest)
    if levels < 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL, f"levels must be >= 1, got {levels}"
        )
    if unbiased and cascade_length(w.filter_length, levels) > n:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL,
            f"level {levels} has no boundary-free coefficients at N={n} "
            f"(L_j = {cascade_length(w.filter_length, levels)})",
            suggestions=(f"Use levels <= {deepest} or unbiased=False",),
        )
    return levels


def _with_intervals(var: torch.Tensor, counts: np.ndarray, confidence: float,
                    dt: float) -> WaveletVarianceResult:
    """The chi-squared interval of each level's estimate."""
    levels = var.shape[-1]
    edof = np.maximum(counts / np.exp2(np.arange(1, levels + 1)), 1.0)
    alpha = 1.0 - confidence
    q_hi = _chi2_quantile(1.0 - alpha / 2.0, edof)
    q_lo = _chi2_quantile(alpha / 2.0, edof)
    eta, hi, lo = torch.as_tensor(np.stack([edof, q_hi, q_lo]), dtype=var.dtype,
                                  device=var.device)  # one copy to the device
    ci_low = eta * var / hi
    ci_high = eta * var / lo
    scales = (2.0 ** np.arange(levels)) * dt
    return WaveletVarianceResult(var, ci_low, ci_high, edof, scales)


def wavelet_variance(
    x: torch.Tensor,
    wavelet="db4",
    levels: int | None = None,
    *,
    unbiased: bool = True,
    confidence: float = 0.95,
    dt: float = 1.0,
) -> WaveletVarianceResult:
    """Scale-by-scale variance decomposition with chi-squared intervals.

    ``unbiased=True`` (default) averages only boundary-free coefficients
    (Percival-Walden eq. 306); ``unbiased=False`` averages all ``N`` (the
    energy decomposition: summed over levels plus the approximation's term
    it gives the signal's energy).  Detail filters sum to zero, so the
    series mean drops out.
    """
    w = _resolve_discrete(wavelet)
    levels = _resolve_levels(x, w, levels, unbiased)
    res = modwt_multilevel(x, w, levels=levels, boundary="periodic")
    var, counts = _interior_stats(res.details, None, w.filter_length, x.shape[-1], unbiased)
    return _with_intervals(var, counts, confidence, dt)


def wavelet_covariance(
    x: torch.Tensor,
    y: torch.Tensor,
    wavelet="db4",
    levels: int | None = None,
    *,
    unbiased: bool = True,
    dt: float = 1.0,
) -> tuple[torch.Tensor, np.ndarray]:
    """Per-level wavelet covariance of two series: ``([..., J], scales)``."""
    if x.shape[-1] != y.shape[-1]:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"series lengths differ: {x.shape[-1]} vs {y.shape[-1]}",
        )
    w = _resolve_discrete(wavelet)
    levels = _resolve_levels(x, w, levels, unbiased)
    rx = modwt_multilevel(x, w, levels=levels, boundary="periodic")
    ry = modwt_multilevel(y, w, levels=levels, boundary="periodic")
    cov, _ = _interior_stats(rx.details, ry.details, w.filter_length, x.shape[-1], unbiased)
    return cov, (2.0 ** np.arange(levels)) * dt


def wavelet_correlation(
    x: torch.Tensor,
    y: torch.Tensor,
    wavelet="db4",
    levels: int | None = None,
    *,
    unbiased: bool = True,
    dt: float = 1.0,
) -> tuple[torch.Tensor, np.ndarray]:
    """Per-level wavelet correlation ``rho_j in [-1, 1]``: ``([..., J], scales)``.

    Four transforms, as the JAX package computes it: the covariance's two
    and one for each variance."""
    w = _resolve_discrete(wavelet)
    levels = _resolve_levels(x, w, levels, unbiased)
    cov, scales = wavelet_covariance(x, y, w, levels, unbiased=unbiased, dt=dt)
    vx = wavelet_variance(x, w, levels, unbiased=unbiased).variance
    vy = wavelet_variance(y, w, levels, unbiased=unbiased).variance
    return cov / torch.sqrt(vx * vy), scales


# ---------------------------------------------------------------------------
# Streaming (online) wavelet variance
# ---------------------------------------------------------------------------


class VarianceStreamState(NamedTuple):
    """Online accumulator: per-level sum of squared boundary-free details.

    The unbiased estimator uses exactly the coefficients that involve no
    boundary extension (``t >= L_j - 1``), and those are the same in the
    zero-boundary streaming transform and the periodic whole-signal one, so
    the streamed estimate equals :func:`wavelet_variance` of the whole
    signal.  ``counts`` and ``position`` are host numbers.
    """

    sumsq: torch.Tensor  # [..., J]
    counts: np.ndarray  # [J] int64: effective samples per level
    position: int  # samples seen so far


def variance_stream_init(
    wavelet="db4",
    levels: int = 4,
    *,
    batch_shape: tuple[int, ...] = (),
    dtype=torch.float32,
    device="cuda",
) -> VarianceStreamState:
    """An empty accumulator on ``device`` (default: the card; without one it
    raises; pass ``device="cpu"`` for the CPU)."""
    if levels < 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL, f"levels must be >= 1, got {levels}"
        )
    _resolve_discrete(wavelet)
    return VarianceStreamState(
        torch.zeros(tuple(batch_shape) + (levels,), dtype=dtype, device=_device(device)),
        np.zeros(levels, dtype=np.int64),
        0,
    )


def variance_stream_update(
    state: VarianceStreamState,
    details,
    wavelet,
) -> VarianceStreamState:
    """Fold one streamed block's detail coefficients into the accumulator.

    ``details`` is ``MultiLevelMODWTResult.details`` of a zero-boundary
    streaming step (``modwt_stream_block`` or
    ``modwt_stream_block_kernel``).  A level's coefficients before global
    time ``L_j - 1`` reach the stream's start and are left out.
    """
    w = _resolve_discrete(wavelet)
    levels = state.counts.shape[0]
    if len(details) != levels:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL,
            f"state has {levels} levels, block has {len(details)}",
        )
    block_len = details[0].shape[-1]
    sums = []
    counts = state.counts.copy()
    for j, d in enumerate(details, start=1):
        skip = min(max(cascade_length(w.filter_length, j) - 1 - state.position, 0),
                   block_len)
        kept = d[..., skip:]
        sums.append((kept * kept).sum(dim=-1).to(state.sumsq.dtype))
        counts[j - 1] += block_len - skip
    return VarianceStreamState(state.sumsq + torch.stack(sums, dim=-1), counts,
                               state.position + block_len)


def variance_stream_result(
    state: VarianceStreamState,
    *,
    confidence: float = 0.95,
    dt: float = 1.0,
) -> WaveletVarianceResult:
    """The online estimate so far, with its chi-squared intervals."""
    counts = np.maximum(np.asarray(state.counts), 1)
    var = state.sumsq / torch.as_tensor(counts, dtype=state.sumsq.dtype,
                                        device=state.sumsq.device)
    return _with_intervals(var, counts, confidence, dt)
