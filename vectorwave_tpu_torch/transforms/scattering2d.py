"""2-D wavelet scattering: translation-invariant texture features.

Counterpart of ``vectorwave_tpu/transforms/scattering2d.py``, the image
form of :mod:`.scattering` (the Bruna-Mallat scattering network): oriented
Morlet responses, modulus, and a ``2^J`` Gaussian average,

    S0        = x * phi_J
    S1(j,t)   = |x * psi_{j,t}| * phi_J          (J scales x L angles)
    S2(p1,p2) = ||x * psi_{p1}| * psi_{p2}| * phi_J,   j2 > j1

The filters are :mod:`.cwt2`'s 2-D Morlet spectrum, built on the image's
device once per image size (the JAX package builds them once per trace);
each order is one batched ``fft2`` product over a stacked path axis.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from ..errors import ErrorCode, InvalidArgumentError, InvalidSignalError
from ..ops.constants import kept
from .cwt2 import _bank, _freq_grids, morlet2
from .scattering import _dtypes

__all__ = ["Scattering2DResult", "scattering2d"]

#: the mother Morlet peaks at omega0 rad; the finest band sits near 0.35
#: cycles/sample: scale0 = omega0 / (2 pi 0.35)
_OMEGA0 = 5.336


class Scattering2DResult(NamedTuple):
    """Scattering coefficients at stride ``2^J`` (spatial axes last)."""

    s0: torch.Tensor  # [..., H', W']
    s1: torch.Tensor  # [..., J*L, H', W']
    s2: torch.Tensor | None  # [..., n2, H', W']
    meta1: tuple[tuple[int, int], ...]  # (scale j, angle index) per s1 path
    pairs: tuple[tuple[int, int], ...]  # (path1, path2) per s2 path

    def feature_vector(self) -> torch.Tensor:
        """Spatially averaged log features ``[..., 1 + n1 + n2]``."""
        eps = 1e-8
        feats = [torch.log(self.s0.mean(dim=(-2, -1))[..., None] ** 2 + eps),
                 torch.log(self.s1.mean(dim=(-2, -1)) + eps)]
        if self.s2 is not None:
            feats.append(torch.log(self.s2.mean(dim=(-2, -1)) + eps))
        return torch.cat(feats, dim=-1)

    def angle_energy(self, scale: int, n_angles: int | None = None) -> torch.Tensor:
        """``[..., L]`` first-order energy per angle at dyadic ``scale``;
        ``n_angles`` defaults to the transform's own ``L`` (from ``meta1``)."""
        if n_angles is None:
            n_angles = max(angle for _, angle in self.meta1) + 1
        sel = self.s1[..., scale * n_angles: (scale + 1) * n_angles, :, :]
        return (sel**2).sum(dim=(-2, -1))


def scattering2d(
    image: torch.Tensor,
    *,
    J: int = 3,
    L: int = 8,
    order: int = 2,
    stride: int | None = None,
    aniso: float = 0.5,
) -> Scattering2DResult:
    """Scattering coefficients of ``[..., H, W]`` images (periodic).

    ``J``: dyadic scales, an averaging window of ``2^J`` pixels; ``L``:
    orientations per scale over ``[0, pi)``; ``order``: 1 or 2;
    ``stride``: the output subsampling, ``2^J`` by default; ``aniso``: the
    Morlet anisotropy (``> 1`` narrows each angular wedge; the default 0.5
    widens it so ``L`` orientations cover ``[0, pi)`` without gaps).
    """
    if image.dim() < 2:
        raise InvalidSignalError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"scattering2d expects [..., H, W], got {tuple(image.shape)}",
        )
    h, w = image.shape[-2], image.shape[-1]
    if order not in (1, 2):
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG, f"order must be 1 or 2, got {order}"
        )
    if stride is None:
        stride = 1 << J
    if h % stride or w % stride:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE, f"stride {stride} must divide H={h} and W={w}"
        )
    if min(h, w) < (1 << J):
        raise InvalidSignalError(
            ErrorCode.VAL_TOO_SHORT, f"Image {h}x{w} below the averaging scale 2^J={1 << J}"
        )
    real_dtype, cdtype = _dtypes(image)
    x = image.to(real_dtype)
    bank, phi, meta1, pairs, sel1, bank2 = _device_bank(h, w, J, L, aniso, real_dtype, cdtype,
                                                        x.device)

    def lowpass(u):
        out = torch.fft.irfft2(torch.fft.rfft2(u) * phi, s=(h, w))
        return out[..., ::stride, ::stride]

    s0 = lowpass(x)
    spec_x = torch.fft.fft2(x).to(cdtype)
    u1 = torch.abs(torch.fft.ifft2(spec_x[..., None, :, :] * bank))
    s1 = lowpass(u1)
    if order == 1:
        return Scattering2DResult(s0, s1, None, meta1, ())
    if pairs:
        u2 = torch.abs(torch.fft.ifft2(torch.fft.fft2(u1.index_select(-3, sel1)).to(cdtype)
                                       * bank2))
        s2 = lowpass(u2)
    else:
        s2 = torch.zeros(x.shape[:-2] + (0, h // stride, w // stride), dtype=real_dtype,
                         device=x.device)
    return Scattering2DResult(s0, s1, s2, meta1, pairs)


@functools.lru_cache(maxsize=16)
@kept
def _device_bank(h, w, J, L, aniso, real_dtype, cdtype, device):
    """The filters of one image size on ``device``, built once: the oriented
    Morlet bank ``[J*L, h, w]``, the Gaussian lowpass at ``2^J`` on the
    half spectrum, the first-order paths, the second-order pairs
    (``j2 > j1``), the first-order index of each pair and the pairs'
    filters."""
    wav = morlet2(_OMEGA0, aniso)
    scale0 = _OMEGA0 / (2.0 * math.pi * 0.35)
    scales = tuple(scale0 * (1 << j) for j in range(J))
    angles = tuple(math.pi * i / L for i in range(L))
    bank = _bank(wav, scales, angles, h, w, False, real_dtype, device)
    bank = bank.reshape(J * L, h, w).to(cdtype)
    meta1 = tuple((j, i) for j in range(J) for i in range(L))
    kyg, kxg = _freq_grids(h, w, True, real_dtype, device)
    sigma_t = 0.55 * (1 << J)
    phi = torch.exp(-0.5 * sigma_t**2 * (kyg**2 + kxg**2))
    pairs = tuple((p1, p2) for p1, (j1, _) in enumerate(meta1)
                  for p2, (j2, _) in enumerate(meta1) if j2 > j1)
    sel1 = torch.as_tensor([p[0] for p in pairs], dtype=torch.long, device=device)
    bank2 = bank[torch.as_tensor([p[1] for p in pairs], dtype=torch.long, device=device)]
    return bank, phi, meta1, pairs, sel1, bank2
