"""Single-level MODWT forward/inverse.

Counterpart of ``vectorwave_tpu/transforms/modwt.py``: plain functions over
``[..., N]`` tensors.  Filters are scaled by 1/sqrt(2) (the MODWT
shift-invariance scaling); leading axes are batch axes.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..errors import ErrorCode, InvalidArgumentError, InvalidSignalError
from ..ops.convolve import atrous_analysis_pair, atrous_convolve, fft_analysis_pair
from ..ops.facade import should_use_fft
from ..wavelets.base import DiscreteWavelet
from ..wavelets.registry import as_wavelet

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


class MODWTResult(NamedTuple):
    """Single-level MODWT coefficients; both fields have the input's shape."""

    approx: torch.Tensor
    detail: torch.Tensor

    @property
    def signal_length(self) -> int:
        return self.approx.shape[-1]

    def is_valid(self) -> torch.Tensor:
        """Finite-coefficient check."""
        return torch.isfinite(self.approx).all() & torch.isfinite(self.detail).all()

    def energy(self) -> torch.Tensor:
        return (self.approx**2).sum(dim=-1) + (self.detail**2).sum(dim=-1)


def _resolve_discrete(wavelet) -> DiscreteWavelet:
    w = as_wavelet(wavelet)
    if not isinstance(w, DiscreteWavelet):
        raise InvalidArgumentError(
            ErrorCode.CFG_UNSUPPORTED_TRANSFORM,
            f"Wavelet {w.name!r} is continuous; MODWT requires a discrete wavelet",
            suggestions=("Use cwt() for continuous wavelets",),
        )
    return w


def _validate_signal(x: torch.Tensor, min_length: int = 1) -> None:
    if x.ndim < 1 or x.shape[-1] < min_length:
        raise InvalidSignalError(
            ErrorCode.VAL_TOO_SHORT,
            f"Signal length {x.shape[-1] if x.ndim else 0} below minimum {min_length}",
            context={"shape": tuple(x.shape)},
        )


def modwt(x: torch.Tensor, wavelet, *, boundary: str = "periodic") -> MODWTResult:
    """Single-level forward MODWT.

    Args:
      x: ``[..., N]`` real signal(s); any N >= 1.
      wavelet: registry name or :class:`DiscreteWavelet`.
      boundary: ``periodic`` (exact reconstruction), ``zero`` or ``symmetric``.
    """
    w = _resolve_discrete(wavelet)
    _validate_signal(x)
    low = w.dec_lo * _INV_SQRT2
    high = w.dec_hi * _INV_SQRT2
    if boundary.lower().startswith("per") and should_use_fft(
        x.shape[-1], w.filter_length, x.device
    ):
        return MODWTResult(*fft_analysis_pair(x, low, high, spacing=1))
    approx, detail = atrous_analysis_pair(x, low, high, spacing=1, boundary=boundary)
    return MODWTResult(approx, detail)


def imodwt(result, wavelet, *, boundary: str = "periodic") -> torch.Tensor:
    """Single-level inverse MODWT.

    Periodic/zero use adjoint ``(t+l)`` synthesis indexing; symmetric uses
    the time-reversed ``(t-l)`` reconstruction with symmetric extension.
    """
    approx, detail = result
    w = _resolve_discrete(wavelet)
    low = w.rec_lo * _INV_SQRT2
    high = w.rec_hi * _INV_SQRT2
    sign = -1 if boundary.lower().startswith("sym") else +1
    rec_a = atrous_convolve(approx, low, spacing=1, boundary=boundary, sign=sign)
    rec_d = atrous_convolve(detail, high, spacing=1, boundary=boundary, sign=sign)
    return rec_a + rec_d
