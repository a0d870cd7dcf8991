"""Core à trous (MODWT) convolution ops in plain PyTorch.

Counterpart of ``vectorwave_tpu/ops/convolve.py``.  The hot loop is
``W_t = sum_l h_l * X_{(t - 2^(j-1) l) mod N}``, written as a sum of rolled
(or, for zero padding, sliced) copies of the signal: a static unroll over
the small base filter with the stride baked in, so the inserted à trous
zeros are never touched.  These are the plain versions; the multi-level
kernels live in :mod:`vectorwave_tpu_torch.kernels`.

Nothing here calls ``conv1d``: cuDNN runs float32 convolutions in TF32 by
default, which keeps about three decimal digits.

Boundary semantics:

* ``periodic``  — indices wrap mod N.
* ``zero``      — indices outside [0, N) contribute zero.
* ``symmetric`` — half-point symmetric extension, period 2N: a periodic
  convolution over ``cat([x, flip(x)])``.

All ops work over the last axis and broadcast over leading batch axes.  The
generalized index is ``idx = t + sign*spacing*l + offset``, which covers
analysis (sign=-1), adjoint synthesis (sign=+1) and the symmetric-alignment
offsets.
"""

from __future__ import annotations

from collections import OrderedDict
from collections.abc import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..errors import ErrorCode, InvalidArgumentError
from .constants import kept

_VALID_BOUNDARIES = ("periodic", "zero", "symmetric")

_BOUNDARY_ALIASES = {
    "zero_padding": "zero",
    "zeropadding": "zero",
    "circular": "periodic",
    "wrap": "periodic",
    "sym": "symmetric",
    "reflect": "symmetric",
}


def _normalize_boundary(boundary: str) -> str:
    b = boundary.lower()
    b = _BOUNDARY_ALIASES.get(b, b)
    if b not in _VALID_BOUNDARIES:
        raise InvalidArgumentError(
            ErrorCode.CFG_UNSUPPORTED_BOUNDARY,
            f"Unknown boundary mode: {boundary!r}",
            suggestions=(f"Use one of {_VALID_BOUNDARIES}",),
        )
    return b


def effective_length(filter_length: int, level: int) -> int:
    """Length of the level-j à trous filter: (L0-1)*2^(j-1) + 1."""
    return (filter_length - 1) * (1 << (level - 1)) + 1


def _deltas(n_taps: int, spacing: int, sign: int, offset: int) -> list[int]:
    return [offset + sign * spacing * k for k in range(n_taps)]


#: Device memory the filter spectra of the FFT route may hold at once.
SPECTRUM_CACHE_BYTES = 64 << 20
_SPECTRA: OrderedDict = OrderedDict()
_TAPS: dict = {}


def _filter_spectrum(taps: tuple, spacing: int, n: int, dtype: torch.dtype,
                     device: torch.device) -> torch.Tensor:
    """The spectrum of the filter upsampled by ``spacing`` and wrapped into
    length n, made on ``device``: the taps (copied there once per filter)
    strided into zeros, then an FFT of n.  A filter longer than n, which
    wraps onto itself, is wrapped on the host.  The least recently used
    spectra go once the cache holds more than :data:`SPECTRUM_CACHE_BYTES`."""
    key = (taps, spacing, n, dtype, device)
    spec = _SPECTRA.get(key)
    if spec is not None:
        _SPECTRA.move_to_end(key)
        return spec
    spec = _SPECTRA[key] = _build_spectrum(taps, spacing, n, dtype, device)
    held = sum(s.numel() * s.element_size() for s in _SPECTRA.values())
    while held > SPECTRUM_CACHE_BYTES and len(_SPECTRA) > 1:
        _, old = _SPECTRA.popitem(last=False)
        held -= old.numel() * old.element_size()
    return spec


@kept
def _build_spectrum(taps: tuple, spacing: int, n: int, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    span = (len(taps) - 1) * spacing + 1
    if span <= n:
        base = _TAPS.get((taps, device))
        if base is None:
            base = _TAPS[(taps, device)] = torch.tensor(taps, dtype=torch.float64,
                                                        device=device)
        h = torch.zeros(n, dtype=torch.float64, device=device)
        h[:span:spacing] = base
    else:
        wrapped = np.zeros(n)
        np.add.at(wrapped, np.arange(len(taps)) * spacing % n, np.asarray(taps))
        h = torch.from_numpy(wrapped).to(device)
    return torch.fft.rfft(h).to(dtype)


def _fft_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _taps(filt) -> tuple:
    return tuple(np.asarray(filt, dtype=np.float64).tolist())


def fft_circular_convolve(
    x: torch.Tensor, filt, *, spacing: int = 1, sign: int = -1
) -> torch.Tensor:
    """FFT periodic convolution with one filter upsampled by ``spacing``
    (for long base filters; see ``ops.facade.should_use_fft``): ``sign=-1``
    the analysis convolution, ``sign=+1`` the adjoint correlation (the
    conjugate spectrum).  The filter's spectrum is the one
    :func:`fft_analysis_pair` takes, cached per filter, size and device."""
    n = x.shape[-1]
    spec_x = torch.fft.rfft(x.to(_fft_dtype(x)), dim=-1)
    spec_h = _filter_spectrum(_taps(filt), spacing, n, spec_x.dtype, x.device)
    if sign > 0:
        spec_h = spec_h.conj()
    return torch.fft.irfft(spec_x * spec_h, n=n, dim=-1).to(x.dtype)


def fft_analysis_pair(
    x: torch.Tensor, low, high, *, spacing: int = 1
) -> tuple[torch.Tensor, torch.Tensor]:
    """FFT periodic analysis for both filters with one signal FFT (for long
    base filters; see ``ops.facade.should_use_fft``)."""
    n = x.shape[-1]
    spec_x = torch.fft.rfft(x.to(_fft_dtype(x)), dim=-1)

    def spec_of(filt):
        return _filter_spectrum(_taps(filt), spacing, n, spec_x.dtype, x.device)

    approx = torch.fft.irfft(spec_x * spec_of(low), n=n, dim=-1)
    detail = torch.fft.irfft(spec_x * spec_of(high), n=n, dim=-1)
    return approx.to(x.dtype), detail.to(x.dtype)


def _roll_sum(
    x: torch.Tensor, taps: Sequence[tuple[int, float]], axis_len: int
) -> torch.Tensor:
    """sum_k c_k * roll(x, -delta_k) along the last axis."""
    out = None
    for delta, coeff in taps:
        shift = -delta % axis_len
        term = torch.roll(x, shifts=shift, dims=-1) if shift else x
        term = term * coeff
        out = term if out is None else out + term
    assert out is not None
    return out


def atrous_convolve(
    x: torch.Tensor,
    filt,
    *,
    spacing: int = 1,
    boundary: str = "periodic",
    sign: int = -1,
    offset: int = 0,
) -> torch.Tensor:
    """Generalized à trous convolution:
    ``out[t] = sum_l f[l] * x_ext[t + sign*spacing*l + offset]``.

    Args:
      x: ``[..., N]`` signal(s).
      filt: 1-D base filter (host constant).
      spacing: à trous stride ``2^(j-1)`` for level j.
      boundary: periodic / zero / symmetric extension.
      sign: -1 for analysis (causal), +1 for the adjoint synthesis indexing.
      offset: additional index offset (symmetric-alignment tau shifts).

    Returns:
      ``[..., N]`` filtered output, same dtype as ``x``.
    """
    boundary = _normalize_boundary(boundary)
    filt_np = np.asarray(filt)
    n = x.shape[-1]
    taps = list(zip(_deltas(len(filt_np), spacing, sign, offset), filt_np.tolist()))

    if boundary == "periodic":
        return _roll_sum(x, taps, n)

    if boundary == "symmetric":
        ext = torch.cat([x, torch.flip(x, dims=(-1,))], dim=-1)
        return _roll_sum(ext, taps, 2 * n)[..., :n]

    # zero padding: pad so every delta lands in-bounds, then static slices
    deltas = [d for d, _ in taps]
    pad_left = max(0, -min(deltas))
    pad_right = max(0, max(deltas))
    padded = F.pad(x, (pad_left, pad_right))
    out = None
    for delta, coeff in taps:
        start = pad_left + delta
        term = padded[..., start : start + n] * coeff
        out = term if out is None else out + term
    assert out is not None
    return out


def atrous_analysis_pair(
    x: torch.Tensor,
    low,
    high,
    *,
    spacing: int = 1,
    boundary: str = "periodic",
) -> tuple[torch.Tensor, torch.Tensor]:
    """One-pass low+high analysis convolution (approx, detail): both outputs
    reuse the same rolled/extended views of ``x``."""
    boundary = _normalize_boundary(boundary)
    low_np = np.asarray(low)
    high_np = np.asarray(high)
    n = x.shape[-1]
    n_taps = len(low_np)
    if len(high_np) != n_taps:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            "low and high filters must have the same length",
            context={"low": len(low_np), "high": n_taps},
        )

    if boundary == "zero":
        pad_left = spacing * (n_taps - 1)
        padded = F.pad(x, (pad_left, 0))
        views = [
            padded[..., pad_left - spacing * k : pad_left - spacing * k + n]
            for k in range(n_taps)
        ]
    else:
        if boundary == "periodic":
            ext, wrap = x, n
        else:
            ext, wrap = torch.cat([x, torch.flip(x, dims=(-1,))], dim=-1), 2 * n
        views = []
        for k in range(n_taps):
            shift = spacing * k % wrap
            view = torch.roll(ext, shifts=shift, dims=-1) if shift else ext
            views.append(view[..., :n] if boundary == "symmetric" else view)

    approx = None
    detail = None
    for k, view in enumerate(views):
        a = view * float(low_np[k])
        d = view * float(high_np[k])
        approx = a if approx is None else approx + a
        detail = d if detail is None else detail + d
    return approx, detail


def host_complex(t: torch.Tensor) -> np.ndarray:
    """A tensor from any device as a host ndarray: complex128 for complex
    tensors, float64 for real ones (the JAX package's ``host_complex``)."""
    t = t.detach().cpu()
    return t.to(torch.complex128).numpy() if t.is_complex() else t.to(torch.float64).numpy()
