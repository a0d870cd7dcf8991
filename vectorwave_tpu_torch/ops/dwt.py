"""Decimated (fast) wavelet transform: DWT, IDWT, wavedec and waverec.

Counterpart of ``vectorwave_tpu/ops/dwt.py``, in plain PyTorch (no kernel):

* forward: ``out[i] = sum_j f[j] * x[(2i + j) mod N]`` (convolve and
  downsample by 2; periodic wrap or zero padding);
* inverse: the adjoint scatter ``out[(2i + j) mod N] += c[i] * f[j]``
  (upsample by 2 and convolve).

Every tap is one rolled or sliced tensor op.  Unlike the MODWT these use the
unscaled filters (the decimated convention, sum h = sqrt(2)).  All functions
broadcast over leading batch axes and work on the last axis.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..errors import ErrorCode, InvalidArgumentError
from .convolve import _normalize_boundary


def _check_even(n: int) -> None:
    if n % 2 != 0:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"Decimated DWT requires an even signal length, got {n}",
            suggestions=("Pad the signal by one sample (e.g. edge padding)",),
        )


def _dwt_boundary(boundary: str) -> str:
    b = _normalize_boundary(boundary)
    if b == "symmetric":
        raise InvalidArgumentError(
            ErrorCode.CFG_UNSUPPORTED_BOUNDARY,
            "Decimated DWT supports periodic/zero boundaries",
            suggestions=("Use boundary='periodic' or 'zero'",),
        )
    return b


def convolve_downsample(
    x: torch.Tensor,
    filt,
    *,
    boundary: str = "periodic",
    offset: int = 0,
) -> torch.Tensor:
    """``out[i] = sum_j f[j] x[(2i+j+offset) mod N]`` -> length N//2.

    ``offset`` is 0 for orthogonal wavelets; biorthogonal ones use a
    per-branch parity offset (:func:`_bior_parities`).
    """
    b = _dwt_boundary(boundary)
    filt_np = np.asarray(filt)
    n = x.shape[-1]
    _check_even(n)
    out = None
    if b == "periodic":
        for j, fj in enumerate(filt_np.tolist()):
            shift = j + offset
            term = (torch.roll(x, -shift, dims=-1) if shift % n else x)[..., ::2] * fj
            out = term if out is None else out + term
    else:
        padded = F.pad(x, (0, len(filt_np) + offset))
        for j, fj in enumerate(filt_np.tolist()):
            term = padded[..., j + offset : j + offset + n : 2] * fj
            out = term if out is None else out + term
    assert out is not None
    return out


def upsample_convolve(
    coeffs: torch.Tensor,
    filt,
    n_out: int,
    *,
    boundary: str = "periodic",
    offset: int = 0,
) -> torch.Tensor:
    """Adjoint scatter: ``out[(2i+j+offset) mod n_out] += c[i] f[j]``."""
    b = _dwt_boundary(boundary)
    filt_np = np.asarray(filt)
    up = coeffs.new_zeros(coeffs.shape[:-1] + (n_out,))
    up[..., ::2] = coeffs
    out = None
    if b == "periodic":
        for j, fj in enumerate(filt_np.tolist()):
            shift = j + offset
            term = (torch.roll(up, shift, dims=-1) if shift % n_out else up) * fj
            out = term if out is None else out + term
    else:
        pad = len(filt_np) + offset
        padded = F.pad(up, (pad, 0))
        for j, fj in enumerate(filt_np.tolist()):
            start = pad - (j + offset)
            term = padded[..., start : start + n_out] * fj
            out = term if out is None else out + term
    assert out is not None
    return out


_PARITY_CACHE: dict[str, tuple[int, int]] = {}


def _bior_parities(w) -> tuple[int, int]:
    """Per-branch parity offsets (p_h, p_g) for decimated perfect
    reconstruction.

    Orthogonal wavelets: (0, 0), since the synthesis is the exact adjoint of
    the analysis.  A biorthogonal pair reconstructs only at one relative
    parity between its (dec, rec) filters, found once per wavelet by an
    exact numpy probe.
    """
    if w.rec_lo is w.dec_lo or np.array_equal(w.rec_lo, w.dec_lo):
        return (0, 0)
    cached = _PARITY_CACHE.get(w.name)
    if cached is not None:
        return cached
    rng = np.random.default_rng(12345)
    n = 64
    x = rng.standard_normal(n)

    def down(sig, f, p):
        out = np.zeros(n // 2)
        for i in range(n // 2):
            for j, fj in enumerate(f):
                out[i] += sig[(2 * i + j + p) % n] * fj
        return out

    def up(c, f, p):
        out = np.zeros(n)
        for i, ci in enumerate(c):
            for j, fj in enumerate(f):
                out[(2 * i + j + p) % n] += ci * fj
        return out

    best, best_err = (0, 0), np.inf
    for p_h in (0, 1):
        for p_g in (0, 1):
            rec = up(down(x, w.dec_lo, p_h), w.rec_lo, p_h) + up(
                down(x, w.dec_hi, p_g), w.rec_hi, p_g
            )
            err = float(np.max(np.abs(rec - x)))
            if err < best_err:
                best, best_err = (p_h, p_g), err
    _PARITY_CACHE[w.name] = best
    return best


class DWTResult(NamedTuple):
    """Single-level decimated coefficients (each ``[..., N/2]``)."""

    approx: torch.Tensor
    detail: torch.Tensor


def dwt(x: torch.Tensor, wavelet, *, boundary: str = "periodic") -> DWTResult:
    """Single-level decimated DWT (convolve and downsample both branches)."""
    from ..transforms.modwt import _resolve_discrete, _validate_signal

    w = _resolve_discrete(wavelet)
    _validate_signal(x, min_length=2)
    p_h, p_g = _bior_parities(w)
    return DWTResult(
        convolve_downsample(x, w.dec_lo, boundary=boundary, offset=p_h),
        convolve_downsample(x, w.dec_hi, boundary=boundary, offset=p_g),
    )


def idwt(
    approx: torch.Tensor,
    detail: torch.Tensor,
    wavelet,
    *,
    boundary: str = "periodic",
) -> torch.Tensor:
    """Single-level inverse: ``up(a) (*) rec_lo + up(d) (*) rec_hi``."""
    from ..transforms.modwt import _resolve_discrete

    w = _resolve_discrete(wavelet)
    n_out = 2 * approx.shape[-1]
    p_h, p_g = _bior_parities(w)
    return upsample_convolve(
        approx, w.rec_lo, n_out, boundary=boundary, offset=p_h
    ) + upsample_convolve(detail, w.rec_hi, n_out, boundary=boundary, offset=p_g)


class WavedecResult(NamedTuple):
    """Multi-level decimated coefficients: details per level (``details[j-1]``
    has length ``N / 2^j``) plus the coarsest approximation."""

    details: tuple[torch.Tensor, ...]
    approx: torch.Tensor

    @property
    def levels(self) -> int:
        return len(self.details)


def max_dwt_levels(signal_length: int, wavelet) -> int:
    """Deepest cascade with even lengths throughout and length >= filter."""
    from ..transforms.modwt import _resolve_discrete

    w = _resolve_discrete(wavelet)
    levels = 0
    n = signal_length
    while n % 2 == 0 and n // 2 >= w.filter_length:
        n //= 2
        levels += 1
    return levels


def wavedec(
    x: torch.Tensor,
    wavelet,
    *,
    levels: int | None = None,
    boundary: str = "periodic",
) -> WavedecResult:
    """Multi-level decimated decomposition (pyramid cascade on the approx)."""
    n = x.shape[-1]
    if levels is None:
        levels = max_dwt_levels(n, wavelet)
    if levels < 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL,
            f"levels must be >= 1, got {levels}",
            context={"signal_length": n},
        )
    if n % (1 << levels) != 0:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"Signal length {n} must be divisible by 2^levels = {1 << levels}",
            suggestions=("Reduce levels or pad the signal",),
        )
    details = []
    current = x
    for _ in range(levels):
        res = dwt(current, wavelet, boundary=boundary)
        details.append(res.detail)
        current = res.approx
    return WavedecResult(tuple(details), current)


def waverec(result: WavedecResult, wavelet, *, boundary: str = "periodic") -> torch.Tensor:
    """Multi-level reconstruction, coarsest to finest."""
    current = result.approx
    for level in range(result.levels, 0, -1):
        current = idwt(current, result.details[level - 1], wavelet, boundary=boundary)
    return current
