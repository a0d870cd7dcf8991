"""Wavelet scattering transform (1-D): translation-invariant features.

Counterpart of ``vectorwave_tpu/transforms/scattering.py``: Mallat's
scattering network (Group Invariant Scattering, CPAM 2012), a cascade of
wavelet-modulus operators followed by a lowpass average,

    S0        = x * phi_J
    S1(l1)    = |x * psi_{l1}| * phi_J
    S2(l1,l2) = ||x * psi_{l1}| * psi_{l2}| * phi_J,  xi_{l2} < xi_{l1}

locally invariant to translation up to ``2^J``.  The filter bank (Morlet
band-passes, ``Q`` per octave, and a Gaussian lowpass) is sampled in the
frequency domain on the host and kept on the device once per signal length
(the JAX package builds it once per trace), and each order is one batched
FFT product over a stacked path axis on the input's device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..errors import ErrorCode, InvalidArgumentError, InvalidSignalError
from ..ops.constants import kept

__all__ = ["ScatteringResult", "scattering1d", "scattering_filterbank"]


class ScatteringResult(NamedTuple):
    """Scattering coefficients at stride ``2^J`` (time axis last).

    ``s1`` carries the path axis ``n1`` (one per first-order wavelet,
    highest frequency first); ``s2``'s paths are ``pairs`` (indices into the
    first- and second-order banks).
    """

    s0: torch.Tensor  # [..., T]
    s1: torch.Tensor  # [..., n1, T]
    s2: torch.Tensor | None  # [..., n2, T] or None for order 1
    xi1: tuple[float, ...]  # first-order centre frequencies (cycles/sample)
    xi2: tuple[float, ...]  # second-order centre frequencies
    pairs: tuple[tuple[int, int], ...]  # (i1, i2) path indices for s2

    def feature_vector(self) -> torch.Tensor:
        """Time-averaged log features ``[..., 1 + n1 + n2]`` (the usual
        classification front end)."""
        eps = 1e-8
        feats = [torch.log(self.s0.mean(dim=-1, keepdim=True) ** 2 + eps),
                 torch.log(self.s1.mean(dim=-1) + eps)]
        if self.s2 is not None:
            feats.append(torch.log(self.s2.mean(dim=-1) + eps))
        return torch.cat(feats, dim=-1)


def _morlet_hat(n: int, xi: float, sigma: float) -> np.ndarray:
    """Frequency-sampled Morlet band-pass (analytic: support on [0, 0.5])."""
    freqs = np.fft.fftfreq(n)
    g = np.exp(-((freqs - xi) ** 2) / (2 * sigma**2))
    # admissibility: subtract the DC leak so psi_hat(0) = 0 exactly
    corr = np.exp(-(xi**2) / (2 * sigma**2))
    g = g - corr * np.exp(-(freqs**2) / (2 * sigma**2))
    g[freqs < 0] = 0.0
    return g


def _gauss_hat(n: int, sigma_t: float) -> np.ndarray:
    freqs = np.fft.fftfreq(n)
    return np.exp(-2 * (np.pi * sigma_t * freqs) ** 2)


def scattering_filterbank(n: int, J: int, Q: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(psi_hat ``[n_filters, n]``, xi ``[n_filters]``, phi_hat ``[n]``) for
    length-n signals: a geometric ladder of Morlets from 0.425 down to the
    averaging band, Q per octave, and a Gaussian lowpass at scale 2^J."""
    xis = []
    xi = 0.425
    xi_min = max(1.0 / (1 << J), 2.0 / n)
    while xi > xi_min:
        xis.append(xi)
        xi *= 2.0 ** (-1.0 / Q)
    if not xis:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"No wavelets fit: J={J} leaves no band above {xi_min}",
            suggestions=("Reduce J or increase the signal length",),
        )
    # quality-factor bandwidth, wider for small Q so the octaves stay covered
    denom = (2.0 ** (1.0 / Q) - 1.0) * 2.5
    psis = np.stack([_morlet_hat(n, x, max(x * denom, 1.0 / n)) for x in xis])
    phi = _gauss_hat(n, sigma_t=0.35 * (1 << J))
    return psis, np.asarray(xis), phi


def _dtypes(x: torch.Tensor) -> tuple[torch.dtype, torch.dtype]:
    """(real, complex) dtypes of a computation on ``x``."""
    real = x.dtype if x.dtype.is_floating_point else torch.float32
    return real, torch.complex128 if real == torch.float64 else torch.complex64


def scattering1d(
    x: torch.Tensor,
    *,
    J: int = 6,
    Q: int = 8,
    order: int = 2,
    Q2: int = 1,
    stride: int | None = None,
) -> ScatteringResult:
    """Scattering coefficients of ``[..., N]`` signals (periodic boundary).

    ``J``: the averaging scale ``2^J`` samples; ``Q``: first-order wavelets
    per octave; ``order``: 1 or 2; ``Q2``: second-order wavelets per
    octave; ``stride``: the output subsampling, ``2^J`` by default.  The
    coefficients are non-negative.
    """
    n = x.shape[-1]
    if n < (1 << J):
        raise InvalidSignalError(
            ErrorCode.VAL_TOO_SHORT,
            f"Signal length {n} below the averaging scale 2^J={1 << J}",
        )
    if order not in (1, 2):
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG, f"order must be 1 or 2, got {order}"
        )
    if stride is None:
        stride = 1 << J
    if n % stride:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"stride {stride} must divide the signal length {n}",
        )
    real_dtype, cdtype = _dtypes(x)
    x = x.to(real_dtype)
    phi_d, psi1_d, xi1, xi2, pairs, sel1, bank2 = _device_bank(
        n, J, Q, Q2, real_dtype, cdtype, x.device)

    def lowpass(u):  # real input, real averaged output, subsampled
        out = torch.fft.irfft(torch.fft.rfft(u, dim=-1) * phi_d, n=n, dim=-1)
        return out[..., ::stride]

    s0 = lowpass(x)
    # order 1: one batched complex product over the filter axis
    spec_x = torch.fft.fft(x, dim=-1).to(cdtype)
    u1 = torch.abs(torch.fft.ifft(spec_x[..., None, :] * psi1_d, dim=-1))
    s1 = lowpass(u1)
    if order == 1:
        return ScatteringResult(s0, s1, None, xi1, (), ())

    # order 2: only paths of decreasing frequency carry energy
    if pairs:
        spec_u1 = torch.fft.fft(u1.index_select(-2, sel1), dim=-1).to(cdtype)
        u2 = torch.abs(torch.fft.ifft(spec_u1 * bank2, dim=-1))
        s2 = lowpass(u2)
    else:
        s2 = torch.zeros(x.shape[:-1] + (0, n // stride), dtype=real_dtype, device=x.device)
    return ScatteringResult(s0, s1, s2, xi1, xi2, pairs)


@functools.lru_cache(maxsize=16)
@kept
def _device_bank(n, J, Q, Q2, real_dtype, cdtype, device):
    """The filters of one signal length on ``device``, built once: the
    lowpass ``[n//2 + 1]``, the first-order bank ``[n1, n]``, the centre
    frequencies, the second-order paths, the first-order index of each path
    and the paths' second-order filters ``[n2, n]``.  Each bank is rounded to
    the real dtype before it turns complex, as the reference does."""
    psi1, xi1, phi = scattering_filterbank(n, J, Q)
    psi2, xi2, _ = scattering_filterbank(n, J, Q2)

    def bank(psi):
        return torch.as_tensor(psi, dtype=real_dtype, device=device).to(cdtype)

    pairs = tuple((i1, i2) for i1 in range(len(xi1)) for i2 in range(len(xi2))
                  if xi2[i2] < 0.5 * xi1[i1])
    sel1 = torch.as_tensor([p[0] for p in pairs], dtype=torch.long, device=device)
    bank2 = bank(psi2[[p[1] for p in pairs]]) if pairs else None
    return (torch.as_tensor(phi[: n // 2 + 1], dtype=real_dtype, device=device), bank(psi1),
            tuple(float(v) for v in xi1), tuple(float(v) for v in xi2), pairs, sel1, bank2)
