"""2-D continuous wavelet transform over scales and orientations.

Counterpart of ``vectorwave_tpu/transforms/cwt2.py``: directional texture
and edge analysis of images over a scale x angle grid, in the frequency
domain.

* A wavelet is defined by its 2-D spectrum ``psi_hat(kx, ky)`` (angular
  frequency, radians/sample) written for torch tensors.  The scale-``s``,
  angle-``theta`` filter is ``s * psi_hat(s * R_{-theta} k)``, normalised
  in L2 so magnitudes compare across scales.
* :func:`cwt2` takes one ``fft2`` of the image and, a chunk of scales at a
  time (at most ``_CHUNK_BYTES`` of products, at least one scale),
  multiplies the filters (built on the image's device from the formula on
  the rotated grids of the call) and transforms back into the
  ``[..., S, A, H, W]`` result, so the result is the one large field the
  call holds.  Real isotropic wavelets take the half-spectrum ``rfft2``
  path.
* :func:`icwt2` inverts by least squares in the frequency domain,
  ``x_hat = sum(conj(g) c) / sum(|g|^2)`` where the bank covers the
  spectrum; DC is never covered (``mean`` restores it).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..errors import ErrorCode, InvalidArgumentError, InvalidSignalError

__all__ = [
    "ContinuousWavelet2D",
    "CWT2Result",
    "morlet2",
    "mexican_hat2",
    "gaussian2",
    "cwt2",
    "icwt2",
    "scale_to_frequency2",
    "scales_for_frequencies2",
]


class ContinuousWavelet2D(NamedTuple):
    """A 2-D continuous wavelet, defined by its spectrum.

    ``psi_hat(kx, ky)`` maps torch tensors of angular frequencies to the
    (unnormalised) spectrum, on their device and in their dtype.
    """

    name: str
    psi_hat: Callable
    is_complex: bool  # one-sided spectrum -> complex coefficients
    isotropic: bool  # rotation has no effect; angles must be (0,)
    peak_freq: float  # |k| at the scale-1 spectral peak (radians/sample)


@functools.lru_cache(maxsize=64)
def _l2_norm(w: ContinuousWavelet2D) -> float:
    """||psi||_2 at scale 1 from the spectrum (Parseval), on a float64 host
    grid of 2048 x 2048 (about 0.1 s), kept for each wavelet object; the
    constructors below return one object per argument set, so a call by
    name finds it kept."""
    k = torch.linspace(-math.pi * 8, math.pi * 8, 2048, dtype=torch.float64)
    kx, ky = torch.meshgrid(k, k, indexing="ij")
    vals = torch.abs(torch.as_tensor(w.psi_hat(kx, ky))) ** 2
    dk = (k[1] - k[0]).item()
    return math.sqrt(vals.sum().item() * dk * dk) / (2.0 * math.pi)


@functools.lru_cache(maxsize=None)
def morlet2(omega0: float = 5.336, aniso: float = 1.0) -> ContinuousWavelet2D:
    """2-D Morlet: a Gaussian envelope around the carrier ``(omega0, 0)``.

    ``aniso > 1`` narrows the envelope across the carrier (sharper
    orientation selectivity).  ``omega0 >= 5`` keeps the admissibility
    correction below 1e-5 (omitted, as in the 1-D family).
    """
    if omega0 < 2.0:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"morlet2 needs omega0 >= 2 (admissibility), got {omega0}",
        )

    def psi_hat(kx, ky):
        return torch.exp(-0.5 * ((kx - omega0) ** 2 + (aniso * ky) ** 2))

    return ContinuousWavelet2D(f"morl2-{omega0:g}", psi_hat, True, False, float(omega0))


@functools.lru_cache(maxsize=None)
def mexican_hat2() -> ContinuousWavelet2D:
    """Isotropic 2-D Mexican hat (the negative Laplacian of a Gaussian):
    ``psi_hat = |k|^2 exp(-|k|^2 / 2)``; real coefficients, a blob detector."""

    def psi_hat(kx, ky):
        k2 = kx * kx + ky * ky
        return k2 * torch.exp(-0.5 * k2)

    return ContinuousWavelet2D("mexh2", psi_hat, False, True, math.sqrt(2.0))


@functools.lru_cache(maxsize=None)
def gaussian2(order: int = 2, *, directional: bool = False) -> ContinuousWavelet2D:
    """The Gaussian-derivative family.

    ``directional=False``: isotropic ``|k|^m exp(-|k|^2/2)`` (a radial ridge
    detector; real).  ``directional=True``: ``(i kx)^m exp(-|k|^2/2)``, the
    m-th derivative along the rotated x axis; complex for odd m and
    orientation-selective for every m.
    """
    if order < 1:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG, f"order must be >= 1, got {order}"
        )
    if directional:

        def psi_hat(kx, ky):
            return (1j * kx) ** order * torch.exp(-0.5 * (kx * kx + ky * ky))

    else:

        def psi_hat(kx, ky):
            k2 = kx * kx + ky * ky
            return k2 ** (order / 2.0) * torch.exp(-0.5 * k2)

    return ContinuousWavelet2D(
        f"gaus2-{order}{'d' if directional else ''}",
        psi_hat,
        directional,
        not directional,
        math.sqrt(float(order)),
    )


_NAMED = {
    "morl2": morlet2,
    "mexh2": mexican_hat2,
    "gaus2": gaussian2,
}


def _resolve_2d(wavelet) -> ContinuousWavelet2D:
    if isinstance(wavelet, ContinuousWavelet2D):
        return wavelet
    if isinstance(wavelet, str):
        key = wavelet.lower()
        if key in _NAMED:
            return _NAMED[key]()
        raise InvalidArgumentError(
            ErrorCode.CFG_UNSUPPORTED_WAVELET,
            f"Unknown 2-D wavelet {wavelet!r}",
            suggestions=(f"Use one of {sorted(_NAMED)} or a ContinuousWavelet2D instance",),
        )
    raise InvalidArgumentError(
        ErrorCode.CFG_UNSUPPORTED_WAVELET,
        f"Expected a name or ContinuousWavelet2D, got {type(wavelet).__name__}",
    )


def scale_to_frequency2(wavelet, scale: float) -> float:
    """Radial frequency (cycles/sample) the given scale responds to most."""
    w = _resolve_2d(wavelet)
    return w.peak_freq / (2.0 * math.pi * float(scale))


def scales_for_frequencies2(wavelet, freqs: Sequence[float]) -> tuple[float, ...]:
    """Scales whose spectral peaks sit at the given radial frequencies."""
    w = _resolve_2d(wavelet)
    out = []
    for f in freqs:
        if f <= 0:
            raise InvalidArgumentError(
                ErrorCode.CFG_INVALID_CONFIG, f"frequency must be > 0, got {f}"
            )
        out.append(w.peak_freq / (2.0 * math.pi * float(f)))
    return tuple(out)


class CWT2Result(NamedTuple):
    """Coefficients ``[..., S, A, H, W]`` plus the analysis grid."""

    coeffs: torch.Tensor
    scales: tuple[float, ...]
    angles: tuple[float, ...]
    boundary: str

    def magnitude(self) -> torch.Tensor:
        return torch.abs(self.coeffs)

    def power(self) -> torch.Tensor:
        return torch.abs(self.coeffs) ** 2

    def scalogram(self) -> torch.Tensor:
        """Total power per (scale, angle) cell: ``[..., S, A]``."""
        return (torch.abs(self.coeffs) ** 2).sum(dim=(-2, -1))

    def dominant_orientation(self) -> torch.Tensor:
        """Per-pixel argmax angle over scales and angles: ``[..., H, W]``."""
        power = torch.abs(self.coeffs) ** 2
        idx = power.amax(dim=-4).argmax(dim=-3)
        return torch.tensor(self.angles, dtype=torch.float32, device=idx.device)[idx]


def _validate(scales, angles, w: ContinuousWavelet2D):
    scales = tuple(float(s) for s in np.atleast_1d(np.asarray(scales)))
    if len(scales) == 0:
        raise InvalidArgumentError(ErrorCode.VAL_EMPTY_SIGNAL, "scales must be non-empty")
    if any(s <= 0 or not math.isfinite(s) for s in scales):
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG, f"scales must be positive finite: {scales}"
        )
    angles = tuple(float(a) for a in np.atleast_1d(np.asarray(angles)))
    if len(angles) == 0:
        raise InvalidArgumentError(ErrorCode.VAL_EMPTY_SIGNAL, "angles must be non-empty")
    if w.isotropic and len(angles) > 1:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"{w.name} is isotropic: rotation is a no-op, use angles=(0.0,)",
            suggestions=("Pick a directional wavelet (morl2, gaus2 directional) for "
                         "orientation analysis",),
        )
    return scales, angles


def _freq_grids(fh: int, fw: int, real: bool, dtype, device):
    """Angular-frequency meshes ``[fh, fwk]`` of an ``fh x fw`` transform."""
    ky = 2.0 * math.pi * torch.as_tensor(np.fft.fftfreq(fh), dtype=dtype, device=device)
    fx = np.fft.rfftfreq(fw) if real else np.fft.fftfreq(fw)
    kx = 2.0 * math.pi * torch.as_tensor(fx, dtype=dtype, device=device)
    return torch.meshgrid(ky, kx, indexing="ij")


def _rotated_grids(angles, fh, fw, real, dtype, device):
    """The frequency plane rotated by ``-theta`` for every angle,
    ``k' = R_{-theta} k``: (kx', ky'), each ``[A, fh, fwk]``."""
    kyg, kxg = _freq_grids(fh, fw, real, dtype, device)
    trig = torch.tensor([[math.cos(t) for t in angles], [math.sin(t) for t in angles]],
                        dtype=dtype, device=device)[..., None, None]
    c, sn = trig[0], trig[1]
    return c * kxg + sn * kyg, -sn * kxg + c * kyg


def _filters(w, scales, grids, norm: float) -> torch.Tensor:
    """Conjugate filters ``[S, A, fh, fwk]`` of the given scales on rotated
    grids."""
    kxr, kyr = grids
    col = torch.tensor([list(scales), [s / norm for s in scales]], dtype=kxr.dtype,
                       device=kxr.device)[..., None, None, None]
    return torch.conj(w.psi_hat(col[0] * kxr, col[0] * kyr) * col[1])


def _bank(w, scales, angles, fh, fw, real, dtype, device):
    """Conjugate filter bank ``[S, A, fh, fwk]`` built on ``device``."""
    return _filters(w, scales, _rotated_grids(angles, fh, fw, real, dtype, device),
                    _l2_norm(w))


#: the most bytes of filters or products one chunk of scales may take (a
#: chunk holds at least one scale), so a call holds its result and a few
#: times this beside it: a cap on memory, not a speed setting.  At 256^2
#: (8 angles, complex64) all of 16 scales fit one chunk; at 1024^2 a chunk
#: is one scale, 1/16 of the 1.07 GB result.
_CHUNK_BYTES = 1 << 26


def _chunks(n_scales: int, per_scale_bytes: int) -> list[slice]:
    step = max(1, _CHUNK_BYTES // max(per_scale_bytes, 1))
    return [slice(i, min(i + step, n_scales)) for i in range(0, n_scales, step)]


def _fft_dims(h, wd, boundary, max_scale):
    if boundary == "periodic":
        return h, wd
    pad = int(math.ceil(5.0 * max_scale))
    return 1 << (h + 2 * pad - 1).bit_length(), 1 << (wd + 2 * pad - 1).bit_length()


def _real_dtype(t: torch.Tensor) -> torch.dtype:
    return t.dtype if t.dtype.is_floating_point else torch.float32


def cwt2(
    image: torch.Tensor,
    scales: Sequence[float],
    wavelet="morl2",
    *,
    angles: Sequence[float] = (0.0,),
    boundary: str = "periodic",
) -> CWT2Result:
    """2-D CWT of ``[..., H, W]`` images over a scale x angle grid.

    ``boundary``: ``periodic`` (FFT-native) or ``zero`` (each dimension
    padded to the next power of two past the largest filter's support).
    The coefficients ``[..., S, A, H, W]`` are complex for one-sided
    wavelets (morl2, directional gaus2), real for real isotropic ones
    (mexh2, radial gaus2).
    """
    w = _resolve_2d(wavelet)
    scales, angles = _validate(scales, angles, w)
    if image.dim() < 2:
        raise InvalidSignalError(
            ErrorCode.VAL_INVALID_SHAPE, f"cwt2 expects [..., H, W], got shape {tuple(image.shape)}"
        )
    h, wd = image.shape[-2], image.shape[-1]
    if h < 2 or wd < 2:
        raise InvalidSignalError(ErrorCode.VAL_TOO_SHORT, f"image {h}x{wd} below minimum 2x2")
    if boundary not in ("periodic", "zero"):
        raise InvalidArgumentError(
            ErrorCode.CFG_UNSUPPORTED_BOUNDARY, f"cwt2 supports periodic/zero, got {boundary!r}"
        )
    fh, fw = _fft_dims(h, wd, boundary, max(scales))
    real_dtype = _real_dtype(image)
    x = image.to(real_dtype)
    dev = x.device
    use_real = not w.is_complex
    norm = _l2_norm(w)
    if use_real:
        spec = torch.fft.rfft2(x, s=(fh, fw))
        out_dtype = real_dtype
    else:
        spec = torch.fft.fft2(x, s=(fh, fw))
        out_dtype = spec.dtype
    out = torch.empty(x.shape[:-2] + (len(scales), len(angles), h, wd), dtype=out_dtype,
                      device=dev)
    grids = _rotated_grids(angles, fh, fw, use_real, real_dtype, dev)
    for part in _chunks(len(scales), len(angles) * spec.numel() * spec.element_size()):
        prod = spec[..., None, None, :, :] * _filters(w, scales[part], grids, norm)
        if use_real:
            out[..., part, :, :, :] = torch.fft.irfft2(prod, s=(fh, fw))[..., :h, :wd]
        else:
            out[..., part, :, :, :] = torch.fft.ifft2(prod)[..., :h, :wd]
    return CWT2Result(out, scales, angles, boundary)


def _reflect_spectrum(a: torch.Tensor) -> torch.Tensor:
    """``conj(A(-k))`` on an fft2 grid (the Hermitian-mirror spectrum)."""
    out = torch.conj(a)
    for ax in (-2, -1):
        out = torch.roll(torch.flip(out, dims=(ax,)), 1, dims=ax)
    return out


def icwt2(
    result: CWT2Result,
    wavelet="morl2",
    *,
    mean: float | torch.Tensor = 0.0,
    floor: float = 1e-3,
) -> torch.Tensor:
    """Least-squares inverse of :func:`cwt2`.

    Divides the bank-adjoint accumulation by the aggregate response
    ``sum |g|^2`` where it exceeds ``floor * max`` (the 2-D analogue of the
    1-D equalized ``icwt``).  Exact up to the spectral regions the grid does
    not cover (pick scales with :func:`scales_for_frequencies2`); DC is
    never covered, and ``mean`` restores it.  The inverse runs on the crop
    grid with the periodic operator: exact for periodic transforms,
    approximate for zero-boundary ones, as in the 1-D transforms.
    """
    w = _resolve_2d(wavelet)
    coeffs = result.coeffs
    h, wd = coeffs.shape[-2], coeffs.shape[-1]
    real_out = not coeffs.is_complex()
    real_dtype = coeffs.dtype if real_out else coeffs.real.dtype
    dev = coeffs.device
    norm = _l2_norm(w)

    response = acc = None
    grids = _rotated_grids(result.angles, h, wd, real_out, real_dtype, dev)
    per_scale = coeffs[..., 0, :, :, :].numel() * 2 * coeffs.real.element_size()
    for part in _chunks(len(result.scales), per_scale):
        bank = _filters(w, result.scales[part], grids, norm)
        c = coeffs[..., part, :, :, :]
        spec = torch.fft.rfft2(c, s=(h, wd)) if real_out else torch.fft.fft2(c, s=(h, wd))
        term = (torch.conj(bank) * spec).sum(dim=(-4, -3))
        resp = (torch.abs(bank) ** 2).sum(dim=(0, 1))
        acc = term if acc is None else acc + term
        response = resp if response is None else response + resp
    cutoff = floor * response.max()
    inv = torch.where(response > cutoff, 1.0 / torch.maximum(response, cutoff),
                      torch.zeros((), dtype=response.dtype, device=dev))

    if real_out:
        out = torch.fft.irfft2(acc * inv, s=(h, wd))[..., :h, :wd].to(real_dtype)
    else:
        # One-sided wavelets cover each +-k pair once (angles in [0, pi)) or
        # twice (the full circle); the estimate is combined with its
        # Hermitian reflection, weighted by the side(s) the bank covered, so
        # both layouts invert exactly.
        mask = (response > cutoff).to(real_dtype)
        x_ls = acc * inv * mask
        x_ref = _reflect_spectrum(x_ls)
        m_ref = _reflect_spectrum(mask)
        x_hat = (x_ls * mask + x_ref * m_ref) / torch.clamp_min(mask + m_ref, 1.0)
        out = torch.fft.ifft2(x_hat).real[..., :h, :wd].to(real_dtype)
    return out + mean
