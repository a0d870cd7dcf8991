"""Multifractal analysis through wavelet leaders (Wendt-Abry estimators).

Counterpart of ``vectorwave_tpu/transforms/multifractal.py``: where
``hurst_exponent`` fits one scaling exponent, this estimates the
singularity spectrum ``D(h)`` from wavelet leaders (Wendt & Abry, IEEE
Trans. Signal Proc. 55(10), 2007), running maxima up the dyadic tree (a
cascade of pairwise maxima and a 3-neighbourhood maximum per level), and
every estimator is a weighted linear regression over levels:

* ``zeta(q)``, the slope over j of ``log2 S(q, j)``, ``S(q,j) = mean_k L_{j,k}^q``;
* ``h(q), D(q)``, the spectrum in parametric form from ``U(q,j) = sum R log2 L``
  and ``V(q,j) = sum R log2 R`` with ``R = L^q / sum L^q``;
* the log-cumulants ``c1, c2``, slopes of the per-level mean and variance of
  ``log L`` (``c2 = 0`` for a monofractal).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..errors import ErrorCode, InvalidArgumentError
from ..ops.dwt import wavedec
from .modwt import _resolve_discrete

__all__ = [
    "MultifractalResult",
    "wavelet_leaders",
    "multifractal_spectrum",
]


class MultifractalResult(NamedTuple):
    """Leader-based multifractal estimates over a fixed ``q`` grid."""

    qs: tuple[float, ...]
    zeta: torch.Tensor  # [..., Q] scaling exponents
    h: torch.Tensor  # [..., Q] regularity exponents (decreasing in q)
    D: torch.Tensor  # [..., Q] spectrum values (<= 1)
    c1: torch.Tensor  # [...] first log-cumulant slope (typical h)
    c2: torch.Tensor  # [...] second log-cumulant slope (0 => monofractal)
    levels: tuple[int, ...]  # octaves used in the regressions

    def spectrum_width(self) -> torch.Tensor:
        """``max h - min h`` over the q grid: 0 for a monofractal."""
        return self.h.amax(dim=-1) - self.h.amin(dim=-1)


def wavelet_leaders(
    x: torch.Tensor,
    wavelet="db3",
    *,
    levels: int | None = None,
    boundary: str = "periodic",
) -> list[torch.Tensor]:
    """Per-octave wavelet leaders ``L_j`` of ``[..., N]`` signals.

    ``L_{j,k} = sup |c_{j',k'}|`` over the coefficients at scales ``j' <= j``
    whose support lies under the 3-neighbourhood ``{k-1, k, k+1}`` of
    position ``k``, as a pairwise-max cascade up the dyadic tree.
    Coefficients take the L1 normalization (``2^{-j/2}`` times the DWT's),
    under which ``L_j ~ 2^{j h}`` at a point of regularity ``h``.
    """
    dec = wavedec(x, wavelet, levels=levels, boundary=boundary)
    leaders = []
    carry = None  # running sup over finer scales, at the previous resolution
    for j, detail in enumerate(dec.details, start=1):
        c_abs = torch.abs(detail) * (2.0 ** (-j / 2.0))  # L1 normalization
        if carry is None:
            carry = c_abs
        else:
            n_half = 2 * (carry.shape[-1] // 2)
            pooled = torch.maximum(carry[..., 0:n_half:2], carry[..., 1:n_half:2])
            if carry.shape[-1] % 2:  # the odd leftover folds into the last parent
                last = torch.maximum(pooled[..., -1:], carry[..., -1:])
                pooled = torch.cat([pooled[..., :-1], last], dim=-1)
            pooled = pooled[..., : detail.shape[-1]]
            pad = detail.shape[-1] - pooled.shape[-1]
            if pad > 0:
                pooled = torch.nn.functional.pad(pooled, (0, pad))
            carry = torch.maximum(c_abs, pooled)
        left = torch.roll(carry, 1, dims=-1)
        right = torch.roll(carry, -1, dims=-1)
        leaders.append(torch.maximum(carry, torch.maximum(left, right)))
    return leaders


def _fit_slope(ys: torch.Tensor, js: np.ndarray, weights: np.ndarray) -> torch.Tensor:
    """Weighted least-squares slope of ``ys`` (``[..., J]``) against octaves."""
    w = weights / weights.sum()
    jbar = float((w * js).sum())
    denom = float((w * (js - jbar) ** 2).sum())
    coef = torch.as_tensor(w * (js - jbar) / denom, dtype=ys.dtype, device=ys.device)
    return ys @ coef


def _safe_log2(r: torch.Tensor) -> torch.Tensor:
    return torch.log2(torch.clamp_min(r, torch.finfo(r.dtype).tiny))


def multifractal_spectrum(
    x: torch.Tensor,
    wavelet="db3",
    *,
    qs: Sequence[float] = (-5, -3, -2, -1, -0.5, 0.5, 1, 2, 3, 5),
    min_level: int = 2,
    max_level: int | None = None,
    boundary: str = "periodic",
) -> MultifractalResult:
    """``zeta(q)``, the singularity spectrum ``(h(q), D(q))`` and the
    log-cumulants ``c1, c2`` from the wavelet leaders of ``[..., N]``
    signals.

    ``min_level`` drops the finest octaves; ``max_level`` defaults to the
    deepest octave with at least 8 leaders.  The regressions weight each
    octave by its leader count.
    """
    qs = tuple(float(q) for q in qs)
    if len(qs) == 0:
        raise InvalidArgumentError(ErrorCode.VAL_EMPTY_SIGNAL, "qs must be non-empty")
    if any(q == 0.0 for q in qs):
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            "q = 0 is degenerate (S(0,j) == 1); use small +-q instead",
        )
    w = _resolve_discrete(wavelet)
    n = x.shape[-1]
    # the deepest octave with >= 8 leaders, within the dyadic divisibility
    # the decimated cascade needs (N % 2^j == 0)
    divis = (n & -n).bit_length() - 1 if n else 0
    deepest = min(int(math.floor(math.log2(max(n // 8, 2)))), divis)
    if max_level is None:
        max_level = deepest
    max_level = min(max_level, deepest)
    if max_level < min_level + 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_TOO_SHORT,
            f"Need at least two octaves in [{min_level}, {max_level}] "
            f"(signal length {n}); lower min_level or provide longer data",
        )
    leaders = wavelet_leaders(x, w, levels=max_level, boundary=boundary)
    # Periodic decimation joins the signal's ends; a non-periodic signal has
    # a jump there whose leaders would dominate the coarse sups, so the
    # positions the filter and the 3-neighbourhood carry it to are trimmed.
    trim = w.filter_length
    trimmed = []
    for lam in leaders:
        n_j = lam.shape[-1]
        t = min(trim, max((n_j - 4) // 2, 0))
        trimmed.append(lam[..., t: n_j - t] if t else lam)
    leaders = trimmed
    js = np.arange(min_level, max_level + 1, dtype=np.float64)
    counts = np.array([leaders[int(j) - 1].shape[-1] for j in js], dtype=np.float64)

    dtype = x.dtype if x.dtype == torch.float64 else torch.float32
    q_arr = torch.tensor(qs, dtype=dtype, device=x.device)
    log_s, u_stat, v_stat, m1, m2 = [], [], [], [], []
    for j in js:
        lam = leaders[int(j) - 1]
        # a relative floor: an exactly-zero leader floored at finfo.tiny
        # would overflow lam^q for q < 0; 1e-7 keeps lam^q finite in
        # float32 down to q = -5, far below any real leader's range
        floor = 1e-7 * lam.amax(dim=-1, keepdim=True)
        lam = torch.maximum(lam, torch.clamp_min(floor, torch.finfo(lam.dtype).tiny))
        log_lam = torch.log2(lam)
        # [..., Q, K] powers in max-shifted log space, finite for |q| <= 5
        # whatever the leaders' magnitude: S(q) = 2^(q log_max) mean(2^(q dlog))
        log_max = log_lam.amax(dim=-1, keepdim=True)
        powed = torch.exp2(q_arr[:, None] * (log_lam - log_max)[..., None, :])
        s = powed.mean(dim=-1)
        r = powed / powed.sum(dim=-1, keepdim=True)
        log_s.append(q_arr * log_max + torch.log2(s))
        u_stat.append((r * log_lam[..., None, :]).sum(dim=-1))
        v_stat.append((r * _safe_log2(r)).sum(dim=-1))
        m1.append(log_lam.mean(dim=-1))
        m2.append(log_lam.var(dim=-1, unbiased=False))

    log_s = torch.stack(log_s, dim=-1)  # [..., Q, J]
    u_stat = torch.stack(u_stat, dim=-1)
    v_stat = torch.stack(v_stat, dim=-1)
    zeta = _fit_slope(log_s, js, counts)
    h = _fit_slope(u_stat, js, counts)
    log_counts = torch.log2(torch.as_tensor(counts, dtype=log_s.dtype, device=log_s.device))
    d = 1.0 + _fit_slope(v_stat + log_counts, js, counts)
    # cumulants: Cum_m[ln L_j] ~ c_m j ln 2 and the statistics are log2-based,
    # so c1 = slope(mean log2 L) and c2 = slope(var log2 L) ln 2
    c1 = _fit_slope(torch.stack(m1, dim=-1), js, counts)
    c2 = _fit_slope(torch.stack(m2, dim=-1), js, counts) * math.log(2.0)
    return MultifractalResult(qs, zeta, h, d, c1, c2, tuple(int(j) for j in js))
