"""Fourier-wavelet regularized deconvolution (ForWaRD).

Counterpart of ``vectorwave_tpu/optimize/deconvolve.py``: recover ``x`` from
``y = kernel (*) x + noise`` (circular convolution, known kernel) by
composing two estimators (Neelamani, Choi & Baraniuk 2004):

1. the Fourier step, a Wiener-regularized inverse whose signal PSD is a
   thresholded periodogram: ``S_x(f) = (|Y|^2 - N sigma^2)/|H|^2`` only
   where ``|Y(f)|^2 > c N sigma^2`` (``c = ln N + 2``, just above the
   expected maximum of N Exp(1) noise bins), zero elsewhere;
2. the wavelet step: the residual noise is coloured by the regularized
   inverse, so each MODWT detail level is shrunk with its own exact noise
   std ``sigma_j = sigma * ||g_j (*) phi||_2``, from the level's equivalent
   filter response times the Wiener transfer function.

One FFT pair and the MODWT pair: on an eligible CUDA tensor the wavelet step
is one cascade analysis and one cascade synthesis launch (1-D, at its
default 4 levels for sym8) or one 2-D kernel launch per level each way.  The
noise probe of 1-D ``deconvolve`` is a one-level MODWT, which takes the plain
route (the 1-D kernels serve two levels or more); the 2-D probe takes one
2-D analysis launch.  The level responses are numpy constants, kept per
(length, wavelet, levels).  The kernel's spectrum is computed on the input's
device, and the Fourier step stays in the input's complex dtype: complex64
for float32 input (the JAX package builds the spectrum on the host in
complex128, which under x64 promotes a float32 signal's Wiener step to
complex128).  Periodic boundary only, as the circular model is.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..errors import ErrorCode, InvalidArgumentError
from ..ops.thresholds import apply_threshold, mad_sigma, select_threshold
from ..transforms.modwt import _resolve_discrete
from ..transforms.multilevel import (
    MultiLevelMODWTResult,
    imodwt_multilevel,
    max_levels,
    modwt_multilevel,
)
from ..transforms.twodim import MultiLevelMODWT2Result, imodwt2_multilevel, modwt2_multilevel

__all__ = ["DeconvolutionResult", "deconvolve", "deconvolve2"]


class DeconvolutionResult(NamedTuple):
    """Deconvolution output plus diagnostics.

    ``signal`` is the final estimate; ``wiener`` the intermediate Fourier
    step; ``sigma`` the (estimated or given) noise std, trailing singleton
    axis; ``level_sigmas`` the per-level coloured-noise stds the wavelet step
    used (``[..., 1]`` tensors, finest first; ``(lh, hl, hh)`` triples in
    2-D).
    """

    signal: torch.Tensor
    wiener: torch.Tensor
    sigma: torch.Tensor
    level_sigmas: tuple


def _level_responses(n: int, w, levels: int) -> list[np.ndarray]:
    """|DFT|^2 of each equivalent MODWT detail filter (finest first): the
    level-j à trous filter is the base filter upsampled by ``2^(j-1)``, whose
    DFT is the base DFT index-dilated mod ``n``,
    ``G_j(k) = H_hi(2^(j-1) k) prod_{m<j-1} H_lo(2^m k)``, with the per-stage
    1/sqrt(2) scaling."""
    return _axis_responses(n, w, levels)[0]


def _axis_responses(n: int, w, levels: int) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """(detail |G_j|^2, lowpass-cascade |L_j|^2) per level, finest first."""
    return _axis_responses_cached(
        n, np.ascontiguousarray(w.dec_lo, np.float64).tobytes(),
        np.ascontiguousarray(w.dec_hi, np.float64).tobytes(), levels,
    )


@functools.lru_cache(maxsize=64)
def _axis_responses_cached(n: int, dec_lo: bytes, dec_hi: bytes, levels: int):
    inv_sqrt2 = 1.0 / np.sqrt(2.0)
    lo = np.fft.fft(np.frombuffer(dec_lo, np.float64) * inv_sqrt2, n=n)
    hi = np.fft.fft(np.frombuffer(dec_hi, np.float64) * inv_sqrt2, n=n)
    freqs = np.arange(n)
    details = []
    lowpass = []
    prod = np.ones(n, dtype=complex)
    for j in range(1, levels + 1):
        dilated = (freqs * (1 << (j - 1))) % n
        details.append(np.abs(hi[dilated] * prod) ** 2)
        prod = prod * lo[dilated]
        lowpass.append(np.abs(prod) ** 2)
    for arr in (*details, *lowpass):
        arr.setflags(write=False)
    return details, lowpass


def _checked_kernel(kernel, ndim: int, limit: tuple[int, ...]) -> np.ndarray:
    kernel_np = np.asarray(kernel, dtype=np.float64)
    if (kernel_np.ndim != ndim or kernel_np.size == 0
            or any(k > m for k, m in zip(kernel_np.shape, limit))):
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"kernel must be {ndim}-D with at most {'x'.join(map(str, limit))} taps, got "
            f"shape {kernel_np.shape}",
        )
    if not np.isfinite(kernel_np).all() or not np.abs(kernel_np).sum() > 0.0:
        raise InvalidArgumentError(
            ErrorCode.VAL_NON_FINITE_VALUES, "kernel must be finite and nonzero"
        )
    return kernel_np


def _real_dtype(y: torch.Tensor) -> torch.dtype:
    return y.dtype if y.is_floating_point() else torch.float64


def _kernel_spectrum(kernel_np: np.ndarray, shape: tuple[int, ...], real_dtype, device):
    """The DFT of the kernel zero-padded to ``shape``, computed on the
    input's device in its dtype (complex64 for float32): a host FFT of a
    2048 x 2048 PSF would take longer than the whole deconvolution."""
    padded = torch.zeros(shape, dtype=real_dtype, device=device)
    padded[tuple(slice(0, k) for k in kernel_np.shape)] = torch.from_numpy(kernel_np).to(
        device=device, dtype=real_dtype)
    return torch.fft.fftn(padded)


def _wiener(yf, h_full, sigma, n_total, psd_threshold):
    """The thresholded-periodogram Wiener transfer function ``phi``."""
    noise_power = (sigma**2) * n_total  # E|W(f)|^2 per bin
    h_pow = h_full.abs() ** 2
    y_pow = yf.abs() ** 2
    sig_power = torch.where(
        y_pow > psd_threshold * noise_power,
        torch.clamp(y_pow - noise_power, min=0.0) / torch.clamp(h_pow, min=1e-12),
        torch.zeros((), dtype=y_pow.dtype, device=y_pow.device),
    )
    return torch.conj(h_full) * sig_power / (h_pow * sig_power + noise_power + 1e-30)


def deconvolve(
    y: torch.Tensor,
    kernel,
    wavelet="sym8",
    *,
    levels: int | None = None,
    sigma=None,
    method: str = "universal",
    mode: str = "hard",
    psd_threshold: float | None = None,
) -> DeconvolutionResult:
    """ForWaRD deconvolution of ``y = kernel (*) x + noise`` (circular).

    ``kernel`` is the impulse response with its peak at index 0 (use
    ``numpy.fft.ifftshift`` for a centred kernel); it is zero-padded to the
    signal length.  ``sigma`` overrides the noise estimate (the MAD of the
    finest MODWT detail of ``y``, corrected for the per-stage 1/sqrt(2)
    scaling).  ``method``/``mode`` pick the wavelet step's threshold rule and
    shape (default hard, the ForWaRD paper's choice); ``psd_threshold``
    overrides the periodogram keep-bin factor ``c`` (default ``ln N + 2``).
    Broadcasts over leading batch axes.
    """
    w = _resolve_discrete(wavelet)
    n = y.shape[-1]
    kernel_np = _checked_kernel(kernel, 1, (n,))
    if levels is None:
        levels = min(4, max_levels(n, w))

    real_dtype = _real_dtype(y)
    y = y.to(real_dtype)
    h_full = _kernel_spectrum(kernel_np, (n,), real_dtype, y.device)

    if sigma is None:
        finest = modwt_multilevel(y, w, levels=1).details[0]
        sigma = mad_sigma(finest) * math.sqrt(2.0)  # undo the 1/sqrt(2) stage
    else:
        sigma = torch.as_tensor(sigma, dtype=real_dtype, device=y.device)
        if sigma.dim() == 0 or sigma.shape[-1] != 1:
            sigma = sigma[..., None]

    # --- Fourier step: Wiener inverse with a thresholded-periodogram PSD ---
    if psd_threshold is None:
        psd_threshold = math.log(n) + 2.0
    yf = torch.fft.fft(y)
    phi = _wiener(yf, h_full, sigma, n, psd_threshold)
    wiener = torch.fft.ifft(phi * yf).real.to(real_dtype)

    # --- wavelet step: shrink with the exact coloured-noise level stds ---
    phi_pow = phi.abs() ** 2  # [..., N]
    level_sigmas = []
    for g_pow in _level_responses(n, w, levels):
        g = torch.tensor(g_pow, device=y.device, dtype=phi_pow.dtype)
        gain = torch.sqrt((g * phi_pow).mean(dim=-1, keepdim=True))
        level_sigmas.append((sigma * gain).to(real_dtype))

    tree = modwt_multilevel(wiener, w, levels=levels)
    new_details = []
    for detail, level_sigma in zip(tree.details, level_sigmas):
        thr = select_threshold(detail, level_sigma, method)
        new_details.append(apply_threshold(detail, thr, mode))
    est = imodwt_multilevel(MultiLevelMODWTResult(tuple(new_details), tree.approx), w)
    return DeconvolutionResult(est, wiener, sigma, tuple(level_sigmas))


def deconvolve2(
    y: torch.Tensor,
    kernel,
    wavelet="sym8",
    *,
    levels: int | None = None,
    sigma=None,
    method: str = "universal",
    mode: str = "hard",
    psd_threshold: float | None = None,
) -> DeconvolutionResult:
    """ForWaRD image deblurring: ``y = kernel (*) x + noise`` (2-D circular).

    The same two-step estimator as :func:`deconvolve` over the last two
    axes: the thresholded-periodogram Wiener inverse (``N = H*W`` bins),
    then shrinkage of every separable MODWT2 subband with its exact
    coloured-noise std, the level-j band responses being outer products of
    the 1-D dilation-product responses (``lh_j = L_j(kh) G_j(kw)``,
    ``hl_j = G_j(kh) L_j(kw)``, ``hh_j = G_j(kh) G_j(kw)``).  ``kernel`` is a
    2-D PSF with its peak at index (0, 0); ``level_sigmas`` holds per-level
    ``(lh, hl, hh)`` std triples.  Broadcasts over leading batch axes.
    """
    w = _resolve_discrete(wavelet)
    if y.dim() < 2:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"deconvolve2 needs [..., H, W] input, got shape {tuple(y.shape)}",
        )
    h_dim, w_dim = y.shape[-2], y.shape[-1]
    kernel_np = _checked_kernel(kernel, 2, (h_dim, w_dim))
    if levels is None:
        levels = min(3, max_levels(min(h_dim, w_dim), w))

    real_dtype = _real_dtype(y)
    y = y.to(real_dtype)
    h_full = _kernel_spectrum(kernel_np, (h_dim, w_dim), real_dtype, y.device)

    if sigma is None:
        finest_hh = modwt2_multilevel(y, w, levels=1).details[0][2]
        flat = finest_hh.reshape(finest_hh.shape[:-2] + (-1,))
        sigma = (mad_sigma(flat) * 2.0)[..., None]  # undo two 1/sqrt(2) stages; [..., 1, 1]
    else:
        sigma = torch.as_tensor(sigma, dtype=real_dtype, device=y.device)
        while sigma.dim() < 2 or sigma.shape[-1] != 1 or sigma.shape[-2] != 1:
            sigma = sigma[..., None]

    n_total = h_dim * w_dim
    if psd_threshold is None:
        psd_threshold = math.log(n_total) + 2.0
    yf = torch.fft.fft2(y)
    phi = _wiener(yf, h_full, sigma, n_total, psd_threshold)
    wiener = torch.fft.ifft2(phi * yf).real.to(real_dtype)

    phi_pow = phi.abs() ** 2  # [..., H, W]
    g_h, l_h = _axis_responses(h_dim, w, levels)
    g_w, l_w = _axis_responses(w_dim, w, levels)
    sigma_flat = sigma[..., 0, 0][..., None, None]

    def vec(arr):
        return torch.tensor(arr, device=y.device, dtype=phi_pow.dtype)

    def band_sigma(row_pow: np.ndarray, col_pow: np.ndarray) -> torch.Tensor:
        band = torch.outer(vec(row_pow), vec(col_pow))
        return sigma_flat * torch.sqrt((band * phi_pow).mean(dim=(-1, -2), keepdim=True))

    tree = modwt2_multilevel(wiener, w, levels=levels)
    new_details = []
    level_sigmas = []
    for j, (lh, hl, hh) in enumerate(tree.details):
        triple = (
            band_sigma(l_h[j], g_w[j]),  # lh: low along H, high along W
            band_sigma(g_h[j], l_w[j]),  # hl
            band_sigma(g_h[j], g_w[j]),  # hh
        )
        bands = []
        for plane, s in zip((lh, hl, hh), triple):
            flat = plane.reshape(plane.shape[:-2] + (-1,))
            thr = select_threshold(flat, s[..., 0, :], method)
            bands.append(apply_threshold(flat, thr, mode).reshape(plane.shape))
        new_details.append(tuple(bands))
        level_sigmas.append(triple)
    est = imodwt2_multilevel(MultiLevelMODWT2Result(tuple(new_details), tree.approx), w)
    return DeconvolutionResult(est, wiener, sigma, tuple(level_sigmas))
