"""Fourier-constructed orthogonal families: Discrete Meyer and Battle-Lemarié.

Counterpart of ``vectorwave_tpu/wavelets/fourier_families.py`` (the 62-tap
FIR Meyer ``dmey`` and ``blem1``-``blem5``), kept identical so that both
packages generate the same filters.

Both families have closed-form *frequency domain* definitions; the FIR filters
are derived here the principled way — sample the exact conjugate mirror filter
``H(omega) = sqrt(2) * Phi(2 omega) / Phi(omega)`` on a dense grid, inverse
FFT, truncate to the customary filter lengths and renormalize.  The
truncation error is the only approximation: the resulting filters satisfy the
orthogonality conditions one to several orders of magnitude tighter than the
customary hardcoded tables (e.g. BLEM filters at <=1e-3 instead of 20%).
"""

from __future__ import annotations

import functools
import math
from fractions import Fraction

import numpy as np

from .base import DiscreteWavelet, orthogonal_wavelet

_SQRT2 = math.sqrt(2.0)
_GRID = 1 << 13  # frequency sampling resolution


def _meyer_nu(x: np.ndarray) -> np.ndarray:
    """Meyer auxiliary polynomial nu(x) = x^4 (35 - 84x + 70x^2 - 20x^3)."""
    x = np.clip(x, 0.0, 1.0)
    return x**4 * (35.0 - 84.0 * x + 70.0 * x**2 - 20.0 * x**3)


def _meyer_phi_hat(omega: np.ndarray) -> np.ndarray:
    """Meyer scaling function Fourier transform (C^3 taper)."""
    aw = np.abs(omega)
    out = np.zeros_like(aw)
    flat = aw <= 2 * np.pi / 3
    taper = (aw > 2 * np.pi / 3) & (aw <= 4 * np.pi / 3)
    out[flat] = 1.0
    out[taper] = np.cos(np.pi / 2 * _meyer_nu(3 * aw[taper] / (2 * np.pi) - 1))
    return out


@functools.lru_cache(maxsize=None)
def dmey_filter(length: int = 62) -> np.ndarray:
    """FIR Meyer low-pass, 62 taps by default.

    H(omega) = sqrt(2) Phi(2 omega) on [-pi, pi] (since Phi(omega) = 1 on the
    support of Phi(2 omega)); inverse DFT and symmetric truncation.
    """
    from ._cache import cached_filter

    return cached_filter(f"dmey{length}", lambda: _dmey_filter_uncached(length))


def _dmey_filter_uncached(length: int) -> np.ndarray:
    m = _GRID
    omega = 2 * np.pi * np.fft.fftfreq(m)
    spectrum = _SQRT2 * _meyer_phi_hat(2 * omega)
    taps = np.real(np.fft.ifft(spectrum))
    half = length // 2
    centered = np.roll(taps, half)[:length]
    centered *= _SQRT2 / centered.sum()
    return centered


def _bspline_integer_samples(p: int) -> list[Fraction]:
    """Exact values N_p(1..p-1) of the order-p cardinal B-spline at integers."""
    # Cox-de Boor over integer knots, evaluated exactly with fractions.
    values = {1: {0: Fraction(1)}}  # N_1(x) = 1 on [0,1): N_1(j+0)=1 at j=0
    # evaluate via recursion N_p(x) = x/(p-1) N_{p-1}(x) + (p-x)/(p-1) N_{p-1}(x-1)
    def n_val(p_: int, x: Fraction) -> Fraction:
        if p_ == 1:
            return Fraction(1) if 0 <= x < 1 else Fraction(0)
        return (x * n_val(p_ - 1, x) + (p_ - x) * n_val(p_ - 1, x - 1)) / (p_ - 1)

    return [n_val(p, Fraction(j)) for j in range(1, p)]


def _spline_autocorr_spectrum(order: int, omega: np.ndarray) -> np.ndarray:
    """A(omega) = sum_k |B_hat_m(omega + 2 pi k)|^2, exact trig polynomial.

    Equals the Fourier series of the sampled autocorrelation
    r(n) = N_{2(m+1)}(m+1+n).
    """
    p = 2 * (order + 1)
    samples = _bspline_integer_samples(p)  # N_p at 1..p-1
    center = order + 1
    acc = np.full_like(omega, float(samples[center - 1]))
    for n in range(1, order + 1):
        acc = acc + 2.0 * float(samples[center - 1 + n]) * np.cos(n * omega)
    return acc


@functools.lru_cache(maxsize=None)
def battle_lemarie_filter(order: int, length: int | None = None) -> np.ndarray:
    """Battle-Lemarié low-pass of spline order m, truncated to ``length`` taps.

    Default lengths 4(m+1) = 8/12/16/20/24 are the customary blem1-5 ones;
    the true filter has two-sided exponential tails (decay ~0.5/tap for m=1),
    so these short truncations are inherently approximate (~1e-2
    orthogonality residual).  Pass a larger ``length`` (e.g. 64) for
    near-exact filters.
    """
    if not 1 <= order <= 5:
        raise ValueError(f"Battle-Lemarié order must be in [1, 5], got {order}")

    if length is None:
        length = 4 * (order + 1)

    from ._cache import cached_filter

    return cached_filter(f"blem{order}_{length}",
                         lambda: _battle_lemarie_filter_uncached(order, length))


def _battle_lemarie_filter_uncached(order: int, length: int) -> np.ndarray:
    m = _GRID
    omega = 2 * np.pi * np.fft.fftfreq(m)
    a_w = _spline_autocorr_spectrum(order, omega)
    a_2w = _spline_autocorr_spectrum(order, 2 * omega)
    ratio = np.cos(omega / 2.0) ** (order + 1) * np.sqrt(a_w / a_2w)
    if order % 2 == 0:  # even-order spline: half-sample phase
        spectrum = _SQRT2 * ratio * np.exp(-1j * omega / 2.0)
    else:
        spectrum = _SQRT2 * ratio.astype(np.complex128)
    taps = np.real(np.fft.ifft(spectrum))
    # choose the length-tap window capturing maximal energy (the filter has
    # two-sided exponentially decaying tails; a centered-by-index window is
    # slightly suboptimal for even orders)
    rolled = np.roll(taps, m // 2)
    energy = rolled**2
    windows = np.convolve(energy, np.ones(length), mode="valid")
    start = int(np.argmax(windows))
    centered = rolled[start : start + length]
    centered *= _SQRT2 / centered.sum()
    return centered


def discrete_meyer() -> DiscreteWavelet:
    """dmey — 62-tap FIR Meyer."""
    return orthogonal_wavelet(
        "dmey", "DiscreteMeyer", dmey_filter(), 0, "Discrete (FIR) Meyer wavelet"
    )


def battle_lemarie(order: int) -> DiscreteWavelet:
    """blemN — orthonormalized spline wavelet."""
    return orthogonal_wavelet(
        f"blem{order}",
        "BattleLemarie",
        battle_lemarie_filter(order),
        order + 1,
        f"Battle-Lemarié spline wavelet of order {order}",
    )
