"""Empirical wavelet transform: a band decomposition fitted to the signal.

Counterpart of ``vectorwave_tpu/transforms/ewt.py`` (Gilles, IEEE TSP
2013): the signal's own spectrum is segmented between its dominant peaks
and a Meyer-style tight frame is built on the segments, so the modes sum
back to the signal exactly.

* :func:`ewt_boundaries` works on the host: one ``.cpu()`` of the
  ``[N/2 + 1]`` mean amplitude spectrum (computed in float64 on the input's
  device), smoothed, and the ``n_bands - 1`` lowest minima between its most
  prominent peaks; it returns plain floats.
* :func:`ewt` / :func:`iewt` take those boundaries as a tuple, or as a 1-D
  tensor (the bank is then built in the tensor's dtype on the input's
  device, differentiable in the boundaries).  The Meyer windows satisfy
  ``sum g_k(w)^2 = 1``, so the synthesis (filter again and sum) is exact.
* :func:`ewt_hilbert` returns each mode's analytic signal.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..errors import ErrorCode, InvalidArgumentError, InvalidSignalError
from ..ops.constants import kept

__all__ = ["ewt_boundaries", "ewt", "iewt", "ewt_hilbert", "ewt_filterbank"]


def ewt_boundaries(x, n_bands: int, *, smooth: int = 9) -> tuple[float, ...]:
    """``n_bands - 1`` spectral boundaries in cycles/sample.

    Peaks of the smoothed mean amplitude spectrum are ranked by prominence;
    each boundary sits at the spectrum's minimum between two consecutive
    kept peaks (Gilles' "lowest minima" rule).
    """
    if n_bands < 2:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG, f"n_bands must be >= 2, got {n_bands}"
        )
    t = torch.as_tensor(x).to(torch.float64)
    rows = t.reshape(-1, t.shape[-1]) if t.dim() > 1 else t[None]
    n = rows.shape[-1]
    spec = torch.abs(torch.fft.rfft(rows, dim=-1)).mean(dim=0).cpu().numpy()
    spec[0] = 0.0  # DC belongs to the first band regardless
    if smooth > 1:
        kernel = np.hanning(smooth + 2)[1:-1]
        spec = np.convolve(spec, kernel / kernel.sum(), mode="same")
    peaks = [
        k for k in range(1, len(spec) - 1)
        if spec[k] >= spec[k - 1] and spec[k] > spec[k + 1]
    ]
    if len(peaks) < n_bands:
        raise InvalidSignalError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"Spectrum has only {len(peaks)} peaks; cannot split into {n_bands} bands",
            suggestions=("Reduce n_bands or smooth less",),
        )

    def _prominence(k: int) -> float:
        # walk each way to the nearest strictly higher sample (or the edge),
        # keeping the minimum; the prominence is the height above the higher
        # of the two bases, so ripples on one hump do not crowd out a band
        h = spec[k]
        left_min, j = h, k - 1
        while j >= 0 and spec[j] < h:
            left_min = min(left_min, spec[j])
            j -= 1
        right_min, j = h, k + 1
        while j < len(spec) and spec[j] < h:
            right_min = min(right_min, spec[j])
            j += 1
        return float(h - max(left_min, right_min))

    top = sorted(sorted(peaks, key=lambda k: -_prominence(k))[:n_bands])
    freqs = np.fft.rfftfreq(n)
    bounds = []
    for left, right in zip(top[:-1], top[1:]):
        k_min = left + int(np.argmin(spec[left: right + 1]))
        bounds.append(float(freqs[k_min]))
    return tuple(bounds)


def _meyer_windows(freqs: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """Meyer-style windows ``[n_bands, F]``.

    The classical construction's piecewise clamps are the ``clamp`` inside
    beta, so the windows are differentiable in the boundaries.  The
    transition half-widths follow Gilles eq. 2.9 (the largest gamma keeping
    the transitions disjoint).
    """
    half = bounds.new_tensor([0.5])
    zero = bounds.new_tensor([0.0])
    nxt = torch.cat([bounds[1:], half])
    prev = torch.cat([zero, bounds[:-1]])
    g = 0.45 * torch.minimum(
        (bounds - prev) / torch.clamp_min(bounds + prev, 1e-12),
        (nxt - bounds) / (nxt + bounds),
    )
    gammas = torch.clamp_min(g, 1e-6)
    wn = bounds[:, None]
    gm = gammas[:, None]
    t = torch.clamp((freqs[None, :] - (1 - gm) * wn) / (2 * gm * wn), 0.0, 1.0)
    beta = t**4 * (35 - 84 * t + 70 * t**2 - 20 * t**3)
    rises = torch.sin(0.5 * math.pi * beta)  # [K, F] 0 -> 1 per transition
    falls = torch.cos(0.5 * math.pi * beta)  # [K, F] 1 -> 0
    k = bounds.shape[0]
    wins = [falls[0]]
    for band in range(1, k):
        wins.append(rises[band - 1] * falls[band])
    wins.append(rises[k - 1])
    return torch.stack(wins)


def _validate_bounds_values(vals) -> tuple[float, ...]:
    vals = tuple(float(v) for v in vals)
    if not vals or any(not 0.0 < b < 0.5 for b in vals) or any(
        b2 <= b1 for b1, b2 in zip(vals, vals[1:])
    ):
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"boundaries must be strictly increasing in (0, 0.5): {vals}",
        )
    return vals


def _rfft_freqs(n: int, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.fft.rfftfreq(n), dtype=dtype, device=device)


def ewt_filterbank(n: int, boundaries, dtype=np.float32) -> np.ndarray:
    """The tight-frame windows ``[n_bands, n//2+1]`` (their squares sum to
    1), built in float64 and returned as a numpy array of ``dtype``."""
    bounds = _validate_bounds_values(boundaries)
    out = _meyer_windows(_rfft_freqs(n, torch.float64, "cpu"),
                         torch.tensor(bounds, dtype=torch.float64))
    return out.numpy().astype(dtype)


def _resolve_bank(n: int, boundaries, dtype, device) -> torch.Tensor:
    """A tuple: the float64 bank, validated; a tensor: validated likewise
    (a decreasing one would clamp gamma and break the frame), then built in
    ``dtype`` on ``device`` from the tensor, differentiable in it."""
    if isinstance(boundaries, torch.Tensor):
        _validate_bounds_values(boundaries.detach().cpu().reshape(-1).tolist())
        return _meyer_windows(_rfft_freqs(n, dtype, device),
                              boundaries.to(device=device, dtype=dtype))
    return _tuple_bank(n, tuple(float(b) for b in boundaries), dtype, device)


@functools.lru_cache(maxsize=32)
@kept
def _tuple_bank(n: int, boundaries: tuple[float, ...], dtype, device) -> torch.Tensor:
    """The float64-built bank of a boundary tuple in ``dtype`` on
    ``device``, kept per length, tuple, dtype and device (the JAX package
    builds it once per trace)."""
    return torch.from_numpy(ewt_filterbank(n, boundaries, np.float64)).to(
        device=device, dtype=dtype)


def _real_dtype(x: torch.Tensor) -> torch.dtype:
    return x.dtype if x.dtype.is_floating_point else torch.float32


def ewt(x: torch.Tensor, boundaries) -> torch.Tensor:
    """Split ``[..., N]`` into ``[..., n_bands, N]`` modes.

    ``boundaries`` split ``(0, 0.5)`` cycles/sample; band 0 holds DC up to
    the first.  :func:`iewt` of the modes is ``x`` (a tight frame).  Pass
    a tuple (from :func:`ewt_boundaries`) for the float64-built bank or a
    ``[n_bands - 1]`` tensor to build it from the tensor.
    """
    n = x.shape[-1]
    real_dtype = _real_dtype(x)
    bank = _resolve_bank(n, boundaries, real_dtype, x.device)
    spec = torch.fft.rfft(x.to(real_dtype), dim=-1)
    return torch.fft.irfft(spec[..., None, :] * bank, n=n, dim=-1)


def iewt(components: torch.Tensor, boundaries) -> torch.Tensor:
    """Exact inverse: filter each mode again and sum (the frame's adjoint)."""
    n = components.shape[-1]
    bank = _resolve_bank(n, boundaries, components.dtype, components.device)
    spec = torch.fft.rfft(components, dim=-1)
    return torch.fft.irfft((spec * bank).sum(dim=-2), n=n, dim=-1)


def ewt_hilbert(x: torch.Tensor, boundaries) -> torch.Tensor:
    """Complex analytic modes ``[..., n_bands, N]``: ``abs`` gives each
    mode's instantaneous amplitude, the phase's derivative its frequency."""
    comps = ewt(x, boundaries)
    n = comps.shape[-1]
    spec = torch.fft.fft(comps, dim=-1)
    # scipy.signal.hilbert's weights: DC and an even length's Nyquist stay 1
    mult = np.zeros(n)
    mult[0] = 1.0
    if n % 2 == 0:
        mult[n // 2] = 1.0
        mult[1: n // 2] = 2.0
    else:
        mult[1: (n + 1) // 2] = 2.0
    return torch.fft.ifft(spec * torch.as_tensor(mult, dtype=spec.dtype, device=spec.device),
                          dim=-1)
