"""Orthogonal wavelet families generated by spectral factorization.

Counterpart of ``vectorwave_tpu/wavelets/orthogonal.py``, with the same
algorithm: every order of haar, db and sym is generated from the defining
equations via spectral factorization of the Daubechies half-band polynomial
at 80 digits, so the filters satisfy sum(h)=sqrt(2), orthogonality and
vanishing moments to ~1e-12 even at db38.  No table is hardcoded.

Algorithm (Daubechies, "Ten Lectures on Wavelets", ch. 6):

1. ``P(y) = sum_{k=0}^{p-1} C(p-1+k, k) y^k`` — the unique minimal-degree
   solution of the Bezout identity for a half-band filter with ``p`` zeros
   at pi.
2. Roots of ``P`` in ``y`` map to quadruples/pairs in ``z`` via
   ``y = (2 - z - 1/z)/4``, i.e. ``z^2 - (2 - 4y) z + 1 = 0``.
3. Extremal-phase (db): keep roots with |z| < 1.  Least-asymmetric (sym):
   choose, per conjugate root group, the inside or outside root so the filter
   phase is closest to linear.
4. ``H(z) = norm * (1+z)^p * prod_i (z - z_i)``, normalized so sum(h)=sqrt(2).

The resulting tables match the published Daubechies/PyWavelets values (the
same tables the reference hardcodes, e.g. ``Daubechies.java:61-88``) in the
reference's big-endian ordering: ``h[0] = 0.4829...`` for db2.
"""

from __future__ import annotations

import functools
import math

import mpmath as mp
import numpy as np

from .base import DiscreteWavelet, orthogonal_wavelet

_SQRT2 = math.sqrt(2.0)

# Working precision for the factorization.  High-order Daubechies polynomials
# are badly conditioned in double precision (db38 loses ~8 digits); 80 digits
# keeps every order exact to float64 (the reference notes the same instability,
# Daubechies.java:307-310).
_MP_DPS = 80


def _halfband_y_roots(p: int) -> list[mp.mpc]:
    """Roots of P(y) = sum_{k<p} C(p-1+k, k) y^k at high precision."""
    if p == 1:  # Haar: P(y) = 1, no roots
        return []
    with mp.workdps(_MP_DPS):
        coeffs = [mp.mpf(math.comb(p - 1 + k, k)) for k in range(p - 1, -1, -1)]
        return list(mp.polyroots(coeffs, maxsteps=300, extraprec=200))


def _z_root_pair(y: mp.mpc) -> tuple[mp.mpc, mp.mpc]:
    """Solve z^2 - (2-4y) z + 1 = 0; returns (inside, outside) unit-circle roots."""
    c = 1 - 2 * y
    disc = mp.sqrt(c * c - 1)
    z1 = c + disc
    z2 = c - disc
    if abs(z1) <= abs(z2):
        return z1, z2
    return z2, z1


def _poly_from_roots(roots: list[mp.mpc]) -> list[mp.mpc]:
    """Monic polynomial (ascending coeffs) with the given roots."""
    poly = [mp.mpc(1)]
    for r in roots:
        nxt = [mp.mpc(0)] * (len(poly) + 1)
        for i, c in enumerate(poly):
            nxt[i + 1] += c
            nxt[i] -= r * c
        poly = nxt
    return poly


def _build_filter(p: int, z_roots: list[mp.mpc]) -> np.ndarray:
    """h = normalize( (1+z)^p * prod (z - z_i) ), reference big-endian order."""
    with mp.workdps(_MP_DPS):
        root_poly = _poly_from_roots(z_roots)
        binom = [mp.mpf(math.comb(p, k)) for k in range(p + 1)]
        full = [mp.mpc(0)] * (len(binom) + len(root_poly) - 1)
        for i, b in enumerate(binom):
            for j, r in enumerate(root_poly):
                full[i + j] += b * r
        h = [mp.re(c) for c in full]
        total = sum(h)
        scale = mp.sqrt(2) / total
        h64 = np.array([float(c * scale) for c in h])
    # Reference/Table-6.1 ordering puts the dominant taps first (db2 starts
    # 0.4829..., Daubechies.java:61-65); flip if factorization produced the
    # mirror ordering.
    mid = h64.shape[0] // 2
    if np.sum(h64[:mid] ** 2) < np.sum(h64[mid:] ** 2):
        h64 = h64[::-1]
    return h64


def _group_y_roots(y_roots: list[mp.mpc]) -> list[tuple[mp.mpc, ...]]:
    """Group roots of the real polynomial P into real singletons and conjugate pairs."""
    used = [False] * len(y_roots)
    groups: list[tuple[mp.mpc, ...]] = []
    for i, y in enumerate(y_roots):
        if used[i]:
            continue
        used[i] = True
        if abs(mp.im(y)) < mp.mpf("1e-40") * max(mp.mpf(1), abs(mp.re(y))):
            groups.append((y,))
            continue
        # find conjugate partner
        best_j, best_d = -1, mp.inf
        for j in range(i + 1, len(y_roots)):
            if used[j]:
                continue
            d = abs(y_roots[j] - mp.conj(y))
            if d < best_d:
                best_d, best_j = d, j
        if best_j >= 0:
            used[best_j] = True
            groups.append((y, y_roots[best_j]))
        else:  # pragma: no cover - defensive
            groups.append((y,))
    return groups


@functools.lru_cache(maxsize=None)
def daubechies_filter(p: int) -> np.ndarray:
    """Extremal-phase Daubechies low-pass filter with p vanishing moments (2p taps)."""
    if p < 1:
        raise ValueError(f"Daubechies order must be >= 1, got {p}")
    if p == 1:
        return np.array([1.0 / _SQRT2, 1.0 / _SQRT2])

    from ._cache import cached_filter

    return cached_filter(f"db{p}", lambda: _daubechies_filter_uncached(p))


def _daubechies_filter_uncached(p: int) -> np.ndarray:
    with mp.workdps(_MP_DPS):
        y_roots = _halfband_y_roots(p)
        z_roots = [_z_root_pair(y)[0] for y in y_roots]  # all inside: minimum phase
        return _build_filter(p, z_roots)


def _phase_nonlinearity(h: np.ndarray) -> float:
    """Weighted deviation of the group delay from constant — symlet criterion."""
    n_fft = 1 << max(10, (len(h) * 8).bit_length())
    spectrum = np.fft.rfft(h, n_fft)
    mag2 = np.abs(spectrum) ** 2
    # group delay via d/dw of phase: tau(w) = Re( FFT(n*h) / FFT(h) )
    weighted = np.fft.rfft(np.arange(len(h)) * h, n_fft)
    with np.errstate(divide="ignore", invalid="ignore"):
        tau = np.real(weighted / spectrum)
    good = mag2 > 1e-9 * mag2.max()
    tau = tau[good]
    w = mag2[good]
    mean = np.sum(tau * w) / np.sum(w)
    return float(np.sum(w * (tau - mean) ** 2) / np.sum(w))


@functools.lru_cache(maxsize=None)
def symlet_filter(p: int) -> np.ndarray:
    """Least-asymmetric Daubechies (symlet) low-pass filter, p moments (2p taps).

    Enumerates inside/outside choices per conjugate root group and keeps the
    filter whose group delay is flattest (Daubechies' least-asymmetric
    criterion).  Matches the published sym tables (reference: Symlet.java).
    """
    if p < 2:
        raise ValueError(f"Symlet order must be >= 2, got {p}")

    from ._cache import cached_filter

    return cached_filter(f"sym{p}", lambda: _symlet_filter_uncached(p))


def _symlet_filter_uncached(p: int) -> np.ndarray:
    with mp.workdps(_MP_DPS):
        y_roots = _halfband_y_roots(p)
        groups = _group_y_roots(y_roots)
        pairs = [[_z_root_pair(y) for y in group] for group in groups]
    n_groups = len(groups)
    # Enumerate in fast double precision first, then rebuild the winner at
    # high precision.
    best: tuple[float, int] | None = None
    for mask in range(1 << n_groups):
        z_roots_f: list[complex] = []
        for gi, group_pairs in enumerate(pairs):
            take_outside = bool((mask >> gi) & 1)
            for inside, outside in group_pairs:
                z_roots_f.append(complex(outside if take_outside else inside))
        h = _build_filter_f64(p, z_roots_f)
        score = _phase_nonlinearity(h)
        if best is None or score < best[0] - 1e-15:
            best = (score, mask)
    assert best is not None
    mask = best[1]
    with mp.workdps(_MP_DPS):
        z_roots = []
        for gi, group_pairs in enumerate(pairs):
            take_outside = bool((mask >> gi) & 1)
            for inside, outside in group_pairs:
                z_roots.append(outside if take_outside else inside)
        return _build_filter(p, z_roots)


def _build_filter_f64(p: int, z_roots: list[complex]) -> np.ndarray:
    """Double-precision variant of _build_filter for candidate scoring."""
    poly = np.array([1.0 + 0j])
    for r in z_roots:
        poly = np.convolve(poly, np.array([-r, 1.0 + 0j]))
    binom = np.array([math.comb(p, k) for k in range(p + 1)], dtype=np.float64)
    full = np.convolve(binom, poly)
    h = np.real(full)
    h = h * (_SQRT2 / h.sum())
    mid = h.shape[0] // 2
    if np.sum(h[:mid] ** 2) < np.sum(h[mid:] ** 2):
        h = h[::-1]
    return h


def haar() -> DiscreteWavelet:
    """Haar wavelet (reference: api/Haar.java:38-46)."""
    return orthogonal_wavelet(
        "haar", "Haar", np.array([1.0 / _SQRT2, 1.0 / _SQRT2]), 1, "Haar wavelet"
    )


def daubechies(order: int) -> DiscreteWavelet:
    """Daubechies dbN (N vanishing moments, 2N taps); reference: Daubechies.java."""
    return orthogonal_wavelet(
        f"db{order}",
        "Daubechies",
        daubechies_filter(order),
        order,
        f"Daubechies wavelet of order {order}",
    )


def symlet(order: int) -> DiscreteWavelet:
    """Symlet symN (least-asymmetric, N moments, 2N taps); reference: Symlet.java."""
    return orthogonal_wavelet(
        f"sym{order}",
        "Symlet",
        symlet_filter(order),
        order,
        f"Symlet (least-asymmetric Daubechies) of order {order}",
    )
