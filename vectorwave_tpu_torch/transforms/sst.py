"""Synchrosqueezing transform (SST): sharp time-frequency reassignment.

Counterpart of ``vectorwave_tpu/transforms/sst.py`` (Daubechies–Lu–Wu
synchrosqueezing): CWT energy smeared across scales is reassigned to each
coefficient's instantaneous frequency, collapsing a blurred ridge into a
near-line.

* The reassignment uses the wrap-free phase increment ``angle(W_{t+1}
  conj W_t)`` and runs as ONE scatter-add over the bin axis: each
  coefficient adds into the bin of its frequency, and the dropped ones
  (out of band, non-positive frequency, below ``gamma``) into a discard bin
  past the last.  The JAX package sums one masked copy of the field per
  bin; the sums are the same, in another order (on the card the atomic adds
  take any order).
* The per-scale weights are the inverse CWT's single-sum weights
  (``dlog s / sqrt(s)``), so the bins summed reproduce the inverse CWT's
  accumulator and :func:`isst` shares ``icwt``'s equalizer.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..errors import ErrorCode, InvalidArgumentError
from .cwt import _equalizer, _log_weights, _resolve_continuous, cwt, validate_scales
from .xwt import instantaneous_frequency

__all__ = [
    "SSTResult",
    "synchrosqueeze",
    "isst",
    "extract_mode",
    "dominant_frequencies",
]


class SSTResult(NamedTuple):
    """Synchrosqueezed transform ``[..., B, N]`` over frequency bins.

    ``freqs`` are the log-spaced bin centres (cycles/sample), ascending.
    ``scales``/``boundary`` record the originating CWT for inversion.
    """

    coeffs: torch.Tensor
    freqs: np.ndarray
    scales: tuple[float, ...]
    boundary: str = "zero"

    @property
    def n_bins(self) -> int:
        return len(self.freqs)

    def power(self) -> torch.Tensor:
        return self.coeffs.abs() ** 2


def _bin_indices(r_coeffs: torch.Tensor, inst: torch.Tensor, f_lo: float, dlf: float,
                 n_bins: int, gamma: float) -> torch.Tensor:
    """The bin of each (scale, time) coefficient, ``n_bins`` (the discard
    bin) where it is dropped."""
    safe = (inst > 0) & (r_coeffs.abs() > gamma)
    logf = torch.log(torch.where(safe, inst, 1.0))
    idx = torch.round((logf - math.log(f_lo)) / dlf).to(torch.long)
    return torch.where(safe & (idx >= 0) & (idx < n_bins), idx, n_bins)


def _squeeze(contrib: torch.Tensor, idx: torch.Tensor, n_bins: int) -> torch.Tensor:
    """``[..., S, N]`` complex contributions into ``[..., n_bins, N]`` bins
    by one scatter-add (real and imaginary parts as a trailing pair)."""
    parts = torch.view_as_real(contrib)  # [..., S, N, 2]
    out = parts.new_zeros(parts.shape[:-3] + (n_bins + 1,) + parts.shape[-2:])
    out.scatter_add_(-3, idx[..., None].expand(parts.shape), parts)
    return torch.view_as_complex(out[..., :n_bins, :, :].contiguous())


def synchrosqueeze(
    x: torch.Tensor,
    scales: Sequence[float],
    wavelet="morl",
    *,
    n_bins: int | None = None,
    boundary: str = "zero",
    gamma: float = 0.0,
) -> SSTResult:
    """Synchrosqueezed CWT of a real signal.

    Computes the analytic CWT, estimates each coefficient's instantaneous
    frequency, and reassigns the (inverse-weighted) coefficient into the
    log-spaced frequency bin containing it.  ``gamma`` (absolute magnitude)
    drops coefficients too small for a stable phase estimate.
    """
    w = _resolve_continuous(wavelet)
    scales = validate_scales(scales)
    if gamma < 0:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG, f"gamma must be >= 0, got {gamma}"
        )
    analytic = not bool(getattr(w, "is_complex", False))
    r = cwt(x, scales, w, analytic=analytic, boundary=boundary)
    inst = instantaneous_frequency(r)  # cycles/sample
    n_bins = len(scales) if n_bins is None else int(n_bins)
    if n_bins < 2:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG, f"n_bins must be >= 2, got {n_bins}"
        )
    f_grid = w.center_frequency / np.asarray(scales, dtype=np.float64)
    f_lo, f_hi = float(f_grid.min()), float(f_grid.max())
    freqs = np.geomspace(f_lo, f_hi, n_bins)
    dlf = math.log(f_hi / f_lo) / (n_bins - 1)
    weights = torch.as_tensor(_log_weights(scales), dtype=r.coeffs.real.dtype,
                              device=r.coeffs.device)
    idx = _bin_indices(r.coeffs, inst, f_lo, dlf, n_bins, gamma)
    return SSTResult(_squeeze(r.coeffs * weights[:, None], idx, n_bins), freqs, scales, boundary)


def _equalize(acc: torch.Tensor, wavelet, scales, n: int, boundary: str) -> torch.Tensor:
    """icwt's aggregate-response equalizer applied to an accumulator row."""
    w = _resolve_continuous(wavelet)
    complex_dtype = torch.complex128 if acc.dtype == torch.float64 else torch.complex64
    inv = _equalizer(w, tuple(scales), n, boundary, complex_dtype, acc.device)
    return torch.fft.irfft(torch.fft.rfft(acc, dim=-1) * inv, n=n, dim=-1).to(acc.dtype)


def isst(result: SSTResult, wavelet="morl") -> torch.Tensor:
    """Invert the synchrosqueezed transform (all bins): the bins summed are
    the inverse CWT's single-sum accumulator, equalized as ``icwt`` does."""
    acc = result.coeffs.sum(dim=-2).real
    return _equalize(acc, wavelet, result.scales, result.coeffs.shape[-1], result.boundary)


def dominant_frequencies(result: SSTResult) -> torch.Tensor:
    """Per-time frequency of the strongest bin ``[..., N]`` (cycles/sample)."""
    idx = result.coeffs.abs().argmax(dim=-2)
    return torch.as_tensor(result.freqs, device=result.coeffs.device)[idx]


def extract_mode(
    result: SSTResult,
    mode_freqs: torch.Tensor,
    wavelet="morl",
    *,
    bandwidth_octaves: float = 0.5,
) -> torch.Tensor:
    """Reconstruct one oscillatory mode from its frequency track
    ``mode_freqs`` (``[..., N]``: a constant, :func:`dominant_frequencies`
    or a ridge mapped through ``scale_to_frequency``): the bins within
    ``bandwidth_octaves / 2`` of the track, summed and equalized."""
    if bandwidth_octaves <= 0:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"bandwidth_octaves must be > 0, got {bandwidth_octaves}",
        )
    real_dtype = result.coeffs.real.dtype
    dev = result.coeffs.device
    f_bins = torch.as_tensor(result.freqs, dtype=real_dtype, device=dev)  # [B]
    mode = torch.as_tensor(mode_freqs, dtype=real_dtype, device=dev)
    ratio = torch.log2(f_bins[:, None] / torch.clamp_min(mode[..., None, :], 1e-12))
    mask = ratio.abs() <= bandwidth_octaves / 2.0
    acc = (result.coeffs * mask).sum(dim=-2).real
    return _equalize(acc, wavelet, result.scales, result.coeffs.shape[-1], result.boundary)
