"""Bivariate shrinkage denoising on the dual-tree complex wavelet transform.

Counterpart of ``vectorwave_tpu/denoise/dtcwt_shrink.py``, in 1-D and 2-D.  The
Sendur-Selesnick estimator (IEEE SPL 2002): wavelet coefficients and their
parents (same position, next coarser level) are strongly dependent; modeling
the pair with a circular-symmetric bivariate Laplacian gives the MAP
shrinkage

    w_hat = w * max(0, sqrt(|w|^2 + |w_parent|^2) - lam) / sqrt(...)
    lam   = sqrt(3) * sigma_n^2 / sigma_local

which zeroes coefficients only when child and parent are small.  On the
DTCWT the rule acts on complex magnitudes (shift-invariant envelopes), so
edges neither ring nor shift.  Noise sigma_n comes from the finest level's
MAD; the local signal sigma from a moving window of |w|^2 (7 samples, or
7x7 on an image), floored by the noise power.
"""

from __future__ import annotations

import math

import torch

from ..transforms.dtcwt import DTCWTResult, dtcwt, idtcwt
from ..transforms.dtcwt2 import DTCWT2Result, dtcwt2, idtcwt2
from .packet import _median_last

_MAD = 0.6745


def _local_power(mag2: torch.Tensor, window: int, axes) -> torch.Tensor:
    """Moving average of ``mag2`` over ``window`` per listed axis (periodic)."""
    out = mag2
    for ax in axes:
        acc = None
        for offset in range(-(window // 2), window - window // 2):
            term = torch.roll(out, offset, dims=ax) if offset else out
            acc = term if acc is None else acc + term
        out = acc / window
    return out


def _bivariate(child: torch.Tensor, parent_mag2: torch.Tensor,
               sigma_n2: torch.Tensor, window: int, axes) -> torch.Tensor:
    mag2 = child.abs() ** 2
    local = _local_power(mag2, window, axes)
    sigma_local = torch.sqrt(torch.clamp(local - sigma_n2, min=1e-12))
    lam = math.sqrt(3.0) * sigma_n2 / sigma_local
    r = torch.sqrt(mag2 + parent_mag2)
    gain = torch.clamp(r - lam, min=0.0) / torch.clamp(r, min=1e-12)
    return child * gain


def _upsample_parent(mag2: torch.Tensor, target_shape, axes) -> torch.Tensor:
    """Repeat the parent's |w|^2 onto the child grid (nearest neighbour)."""
    out = mag2
    for ax in axes:
        out = torch.repeat_interleave(out, 2, dim=ax)
        if out.shape[ax] != target_shape[ax]:
            out = out.narrow(ax, 0, target_shape[ax])
    return out


def dtcwt_denoise(
    x: torch.Tensor,
    wavelet="sym8",
    *,
    levels: int = 5,
    window: int = 7,
    noise_sigma: float | None = None,
) -> torch.Tensor:
    """Bivariate-shrinkage denoising of ``[..., N]`` signals."""
    res = dtcwt(x, wavelet, levels=levels)
    finest = res.highpasses[0]
    if noise_sigma is None:
        re = finest.real
        sigma_n = _median_last((re - _median_last(re)).abs()) / _MAD * math.sqrt(2.0)
    else:
        sigma_n = torch.as_tensor(noise_sigma, dtype=finest.real.dtype, device=x.device)
    sigma_n2 = sigma_n**2
    new_hp = []
    for j, z in enumerate(res.highpasses, start=1):
        if j < res.levels:
            parent = res.highpasses[j]
            p2 = _upsample_parent(parent.abs() ** 2, z.shape, axes=(z.ndim - 1,))
        else:
            p2 = torch.zeros_like(z.real)
        new_hp.append(_bivariate(z, p2, sigma_n2, window, (z.ndim - 1,)))
    return idtcwt(DTCWTResult(tuple(new_hp), res.lowpass_a, res.lowpass_b), wavelet)


def dtcwt2_denoise(
    image: torch.Tensor,
    wavelet="sym8",
    *,
    levels: int = 4,
    window: int = 7,
    noise_sigma: float | None = None,
) -> torch.Tensor:
    """Bivariate-shrinkage denoising of ``[..., H, W]`` images (all six
    oriented subbands, parent = same orientation one level coarser).  The
    noise MAD is a median over each band's whole plane, the two middle
    values of an even count averaged."""
    res = dtcwt2(image, wavelet, levels=levels)
    finest = res.highpasses[0]
    if noise_sigma is None:
        re = finest.real
        flat = re.reshape(re.shape[:-2] + (-1,))
        mad = _median_last((flat - _median_last(flat)).abs())
        sigma_n = (mad / _MAD * math.sqrt(2.0))[..., None]
    else:
        sigma_n = torch.as_tensor(noise_sigma, dtype=finest.real.dtype, device=image.device)
    sigma_n2 = sigma_n**2
    axes = (finest.dim() - 2, finest.dim() - 1)
    new_hp = []
    for j, z in enumerate(res.highpasses, start=1):
        if j < res.levels:
            p2 = _upsample_parent(res.highpasses[j].abs() ** 2, z.shape, axes=axes)
        else:
            p2 = torch.zeros_like(z.real)
        new_hp.append(_bivariate(z, p2, sigma_n2, window, axes))
    return idtcwt2(DTCWT2Result(tuple(new_hp), res.lowpasses), wavelet)
