"""Scaling filters of the benchmark's wavelets, frozen from published tables.

``db4`` is Daubechies' extremal-phase filter with four vanishing moments
(I. Daubechies, *Ten Lectures on Wavelets*, SIAM 1992, Table 6.1, N = 4).
The digits are the double-precision rounding of the filter as the spectral
factorisation of the Daubechies polynomial gives it at 60 digits
(``tests/test_portbench_reference.py`` derives it again), ordered as the
MODWT below indexes it: ``h[0]`` multiplies the newest sample.  The wavelet
filter is the quadrature mirror ``g[k] = (-1)^k h[L-1-k]``.
"""

from __future__ import annotations

SCALING = {
    "db4": (
        0.2303778133088965, 0.7148465705529157, 0.6308807679298589,
        -0.027983769416859854, -0.18703481171909309, 0.030841381835560764,
        0.0328830116668852, -0.010597401785069032,
    ),
}


def wavelet_filter(h) -> tuple[float, ...]:
    """The quadrature mirror of a scaling filter."""
    n = len(h)
    return tuple((-1.0) ** k * h[n - 1 - k] for k in range(n))
