"""CWT significance testing against red-noise backgrounds (Torrence & Compo).

Counterpart of ``vectorwave_tpu/transforms/significance.py``: the
chi-squared test of wavelet power against an AR(1) ("red noise") null, the
lag-1 estimator, the cone of influence, and the Monte Carlo coherence test
on phase-randomized surrogates.

The null expectation is exact for this package's own filter bank: the CWT
row of a unit impulse is each scale's impulse response H_s, and for a
stationary null with PSD S(f), ``E|W(s, t)|^2 = mean_f S(f) |H_s(f)|^2``.
``|W|^2 / E|W|^2`` is then chi-squared with 2 degrees of freedom for
complex or analytic coefficients and 1 for real ones.

Randomness comes from an explicit ``torch.Generator``; without one the
surrogates draw from a generator seeded 0 (``coherence_significance``: 7)
on the input's device, so a call is repeatable.
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..convert import _device
from ..errors import ErrorCode, InvalidArgumentError
from .cwt import CWTResult, _resolve_continuous, cwt, validate_scales

__all__ = [
    "ar1_coefficient",
    "coherence_significance",
    "cone_of_influence",
    "phase_randomized_surrogates",
    "significance_levels",
    "significant_power",
    "SignificanceResult",
]


def ar1_coefficient(x: torch.Tensor) -> torch.Tensor:
    """Lag-1 autocorrelation (the red-noise null's ``a``), ``[...]``, of the
    mean-removed series, clipped to [0, 1)."""
    xc = x - x.mean(dim=-1, keepdim=True)
    num = (xc[..., 1:] * xc[..., :-1]).sum(dim=-1)
    den = (xc**2).sum(dim=-1)
    return torch.clamp(num / torch.clamp_min(den, 1e-30), 0.0, 1.0 - 1e-6)


def _chi2_quantile_scalar(q: float, dof: float) -> float:
    if abs(dof - 2.0) < 1e-9:
        return -2.0 * math.log(1.0 - q)  # exact for 2 dof
    if abs(dof - 1.0) < 1e-9:
        return NormalDist().inv_cdf((1.0 + q) / 2.0) ** 2  # exact for 1 dof
    z = NormalDist().inv_cdf(q)
    h = 2.0 / (9.0 * dof)
    return dof * (1.0 - h + z * math.sqrt(h)) ** 3


def _bank_power_response(scales: tuple[float, ...], wavelet, n: int, analytic: bool,
                         device: torch.device) -> torch.Tensor:
    """``|H_s(f)|^2`` of the package's CWT filters, ``[S, N]`` in float64:
    the periodic CWT of a centred unit impulse is the bank's impulse
    response."""
    delta = torch.zeros(n, dtype=torch.float64, device=device)
    delta[n // 2] = 1.0
    r = cwt(delta, scales, wavelet, analytic=analytic, boundary="periodic")
    return torch.fft.fft(r.coeffs, dim=-1).abs() ** 2


def _levels_device(device, *values) -> torch.device:
    """The device of the first tensor among ``values``, else ``device``
    (raising for a card that is not there)."""
    for v in values:
        if isinstance(v, torch.Tensor):
            return v.device
    return _device(device)


def significance_levels(
    scales: Sequence[float],
    wavelet="morl",
    *,
    n: int,
    lag1: torch.Tensor | float,
    variance: torch.Tensor | float = 1.0,
    confidence: float = 0.95,
    analytic: bool = True,
    dt: float = 1.0,
    device="cuda",
) -> torch.Tensor:
    """Per-scale power significance levels ``[..., S]`` (float64) for
    length-``n`` signals under an AR(1) null.

    ``lag1``/``variance`` may be scalars or batched tensors (as returned by
    :func:`ar1_coefficient` / ``x.var(dim=-1, correction=0)``); the levels
    are computed on their device, or on ``device`` (default: the card; pass
    ``device="cpu"`` for the CPU) when both are numbers.  ``analytic`` must
    match how the scalogram was computed (2 dof complex, 1 dof real).
    """
    scales = validate_scales(scales)
    if not (0.0 < confidence < 1.0):
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"confidence must be in (0, 1), got {confidence}",
        )
    del dt  # scales and lag1 are both in sample units; dt only relabels axes
    dev = _levels_device(device, lag1, variance)
    h2 = _bank_power_response(scales, wavelet, n, analytic, dev)  # [S, N]
    a = torch.as_tensor(lag1, dtype=torch.float64, device=dev)[..., None, None]
    var = torch.as_tensor(variance, dtype=torch.float64, device=dev)[..., None]
    cosf = torch.as_tensor(np.cos(2.0 * np.pi * np.fft.fftfreq(n)), device=dev)  # [N]
    psd = (1.0 - a**2) / (1.0 + a**2 - 2.0 * a * cosf)  # [..., 1, N]
    expected = var * (psd * h2).mean(dim=-1)  # [..., S]
    dof = 2.0 if analytic else 1.0
    return expected * (_chi2_quantile_scalar(confidence, dof) / dof)


class SignificanceResult(NamedTuple):
    """Per-scale levels ``[..., S]`` + boolean mask ``[..., S, N]``."""

    levels: torch.Tensor
    mask: torch.Tensor
    coi_scales: torch.Tensor  # [N] max reliable scale per time


def cone_of_influence(
    n: int,
    *,
    dt: float = 1.0,
    device="cuda",
) -> torch.Tensor:
    """Max reliable scale per time position, ``[N]`` float64 on ``device``
    (default: the card; ``device="cpu"`` for the CPU): ``min(t, N-1-t) * dt
    / sqrt(2)``, the e-folding time of a Gaussian-envelope wavelet being
    ``sqrt(2) * s`` in this package's scale convention."""
    if n < 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_TOO_SHORT, f"signal length must be >= 1, got {n}"
        )
    t = np.arange(n, dtype=np.float64)
    dist = np.minimum(t, n - 1 - t) * dt
    return torch.as_tensor(dist / math.sqrt(2.0), device=_device(device))


def significant_power(
    result: CWTResult,
    x: torch.Tensor,
    wavelet="morl",
    *,
    confidence: float = 0.95,
    lag1: torch.Tensor | float | None = None,
    dt: float = 1.0,
) -> SignificanceResult:
    """Test a scalogram against the AR(1) null fitted to ``x`` itself:
    per-scale levels, the mask (power above its level AND inside the cone of
    influence) and the cone.  ``wavelet`` must be the one that produced
    ``result``."""
    _resolve_continuous(wavelet)
    power = result.coeffs.abs() ** 2
    analytic = result.coeffs.is_complex()
    a = ar1_coefficient(x) if lag1 is None else torch.as_tensor(lag1, device=x.device)
    var = x.var(dim=-1, correction=0)
    n = power.shape[-1]
    levels = significance_levels(result.scales, wavelet, n=n, lag1=a, variance=var,
                                 confidence=confidence, analytic=analytic, dt=dt)
    coi = cone_of_influence(n, dt=dt, device=x.device)
    scale_col = torch.as_tensor(np.asarray(result.scales), device=x.device)[:, None]
    mask = (power > levels[..., None]) & (scale_col <= coi[None, :])
    return SignificanceResult(levels, mask, coi)


def _surrogates_from_phases(x: torch.Tensor, phases: torch.Tensor) -> torch.Tensor:
    """``[K, ..., N]`` surrogates: x's spectrum rotated by ``phases`` (``[K,
    ..., N // 2 + 1]``), with DC (and Nyquist, for even N) kept real."""
    n = x.shape[-1]
    spec = torch.fft.rfft(x, dim=-1)
    keep = torch.zeros(spec.shape[-1], dtype=phases.dtype, device=phases.device)
    keep[0] = 1.0
    if n % 2 == 0:
        keep[-1] = 1.0
    phases = phases * (1.0 - keep)
    rot = torch.polar(torch.ones_like(phases), phases)
    return torch.fft.irfft(spec[None] * rot, n=n, dim=-1).to(x.dtype)


def _generator(generator, seed: int, device: torch.device) -> torch.Generator:
    if generator is not None:
        return generator
    return torch.Generator(device=device).manual_seed(seed)


def phase_randomized_surrogates(
    x: torch.Tensor, n_surrogates: int, *, generator: torch.Generator | None = None
) -> torch.Tensor:
    """``[K, ..., N]`` surrogates with x's exact power spectrum but phases
    drawn uniformly in [0, 2 pi) from ``generator`` (default: one seeded 0
    on x's device) — the standard null for coherence and phase-locking tests."""
    if n_surrogates < 1:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"n_surrogates must be >= 1, got {n_surrogates}",
        )
    gen = _generator(generator, 0, x.device)
    real_dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    shape = (n_surrogates, *x.shape[:-1], x.shape[-1] // 2 + 1)
    phases = torch.rand(shape, generator=gen, dtype=real_dtype, device=x.device)
    return _surrogates_from_phases(x, phases * (2.0 * math.pi))


def coherence_significance(
    x: torch.Tensor,
    y: torch.Tensor,
    scales: Sequence[float],
    wavelet="morl",
    *,
    n_surrogates: int = 64,
    confidence: float = 0.95,
    generator: torch.Generator | None = None,
    **coherence_kwargs,
) -> torch.Tensor:
    """Per-scale coherence significance levels ``[..., S]`` by Monte Carlo:
    the wavelet coherence of ``n_surrogates`` phase-randomized surrogate
    pairs in one batched call, and the ``confidence`` quantile (linear
    interpolation) of their time-averaged coherence.  Both surrogate sets
    draw from ``generator`` in turn (default: one seeded 7 on x's device).
    Observed ``mean_coherence()`` above this level rejects independence."""
    from .xwt import wavelet_coherence

    if not (0.0 < confidence < 1.0):
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"confidence must be in (0, 1), got {confidence}",
        )
    gen = _generator(generator, 7, x.device)
    sx = phase_randomized_surrogates(x, n_surrogates, generator=gen)
    sy = phase_randomized_surrogates(y, n_surrogates, generator=gen)
    null = wavelet_coherence(sx, sy, scales, wavelet, **coherence_kwargs).mean_coherence()
    return torch.quantile(null, confidence, dim=0)
