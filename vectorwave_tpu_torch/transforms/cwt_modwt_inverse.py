"""MODWT-based inverse CWT.

Counterpart of ``vectorwave_tpu/transforms/cwt_modwt_inverse.py``:
reconstruct a signal from CWT coefficients by mapping dyadic CWT scales onto
MODWT levels and running the inverse MODWT.  The per-level gains are
calibrated once (least squares on a seeded broadband signal, transformed on
the coefficients' device in their dtype), which keeps the error at the low
end of the 3-10% this route is known for on log-spaced scale grids.  On the
card the calibration's ``modwt_multilevel`` and every call's
``imodwt_multilevel`` run the cascade pair's kernels.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..wavelets.registry import as_wavelet
from .cwt import CWTResult, _resolve_continuous, cwt
from .multilevel import (
    MultiLevelMODWTResult,
    imodwt_multilevel,
    max_levels,
    modwt_multilevel,
)

_GAIN_CACHE: dict[tuple, tuple] = {}


def _level_scale_map(
    scales: tuple[float, ...], cwt_fc: float, levels: int
) -> list[list[int]]:
    """CWT scale rows whose center frequency falls in each MODWT level's
    octave [1/2^(j+1), 1/2^j] cycles/sample (the dyadic scale -> level
    mapping, widened to every voice in the octave)."""
    freqs = [cwt_fc / s for s in scales]
    mapping: list[list[int]] = []
    for level in range(1, levels + 1):
        f_lo, f_hi = 1.0 / (1 << (level + 1)), 1.0 / (1 << level)
        rows = [i for i, f in enumerate(freqs) if f_lo <= f < f_hi]
        if not rows:  # fall back to the nearest single row
            target = cwt_fc / (3.0 / (1 << (level + 2)))
            rows = [int(np.argmin([abs(s - target) for s in scales]))]
        mapping.append(rows)
    return mapping


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float64).numpy()


def _calibrated_gains(cwt_wavelet, modwt_wavelet, scales: tuple[float, ...], levels: int,
                      n: int, dtype: torch.dtype, device: torch.device):
    """Per-level (shifts, gains) mapping CWT rows onto MODWT detail
    coefficients, fitted on a seeded broadband signal (cached per wavelets,
    scales, levels, length, dtype and device).

    The CWT uses zero-phase centered wavelets while MODWT details are causal,
    so each row needs a circular time shift before an amplitude gain.
    """
    w_cwt = _resolve_continuous(cwt_wavelet)
    w_modwt = as_wavelet(modwt_wavelet)
    key = (w_cwt.name, w_modwt.name, scales, levels, n, dtype, device)
    cached = _GAIN_CACHE.get(key)
    if cached is not None:
        return cached
    rng = np.random.default_rng(999)
    x = torch.from_numpy(rng.standard_normal(n)).to(device=device, dtype=dtype)
    coeffs = cwt(x, scales, w_cwt, boundary="periodic").coeffs
    coeffs = _host(coeffs.real if coeffs.is_complex() else coeffs)
    mapping = _level_scale_map(scales, w_cwt.center_frequency, levels)
    ref = modwt_multilevel(x, w_modwt, levels=levels)
    shifts: list[list[int]] = []
    weights: list[np.ndarray] = []
    for level, rows in enumerate(mapping, start=1):
        target = _host(ref.details[level - 1])
        level_shifts = []
        aligned_rows = []
        for row in rows:
            source = coeffs[row]
            # circular cross-correlation via FFT for the best alignment
            xc = np.fft.irfft(np.fft.rfft(target) * np.conj(np.fft.rfft(source)), n)
            shift = int(np.argmax(np.abs(xc)))
            level_shifts.append(shift)
            aligned_rows.append(np.roll(source, shift))
        design = np.stack(aligned_rows, axis=1)
        w_fit, *_ = np.linalg.lstsq(design, target, rcond=None)
        shifts.append(level_shifts)
        weights.append(w_fit)
    _GAIN_CACHE[key] = (shifts, weights)
    return shifts, weights


def modwt_based_icwt(
    result: CWTResult,
    cwt_wavelet="morl",
    *,
    modwt_wavelet: str = "sym4",
    approx: torch.Tensor | None = None,
) -> torch.Tensor:
    """Reconstruct from CWT coefficients via the MODWT inverse.

    ``approx``: optional coarse approximation band (e.g. from a MODWT of the
    same signal); without it the sub-band content below the deepest mapped
    level is unrecoverable from band-pass CWT rows alone.
    """
    w_cwt = _resolve_continuous(cwt_wavelet)
    scales = tuple(result.scales)
    n = result.coeffs.shape[-1]
    levels = max(2, min(max_levels(n, modwt_wavelet), int(math.log2(max(scales)))))
    mapping = _level_scale_map(scales, w_cwt.center_frequency, levels)
    coeffs = result.coeffs.real if result.coeffs.is_complex() else result.coeffs
    shifts, weights = _calibrated_gains(
        w_cwt, modwt_wavelet, scales, levels, n, coeffs.dtype, coeffs.device
    )
    details = []
    for level, rows in enumerate(mapping, start=1):
        acc = None
        for row, shift, wgt in zip(rows, shifts[level - 1], weights[level - 1]):
            term = torch.roll(coeffs[..., row, :], int(shift), dims=-1) * float(wgt)
            acc = term if acc is None else acc + term
        details.append(acc)
    details = tuple(details)
    approx_band = torch.zeros_like(details[0]) if approx is None else approx
    return imodwt_multilevel(
        MultiLevelMODWTResult(details, approx_band), modwt_wavelet
    )
