"""Biorthogonal spline (CDF) wavelets, generated from the Cohen-Daubechies-
Feauveau construction.

Counterpart of ``vectorwave_tpu/wavelets/biorthogonal.py`` (bior1.1-6.8 and
rbio1.1-6.8), kept identical so that both packages generate the same
filters.  Instead of tables, every pair is generated from the defining
construction:

* ``rec_lo``: B-spline binomial filter ``sqrt(2) * 2^-Nr * C(Nr, k)`` times the
  root factors assigned to the synthesis side.
* ``dec_lo``: ``sqrt(2) * 2^-Nd * (1+z)^Nd`` times the factors assigned to the
  analysis side, where the factors come from the degree L-1 = (Nr+Nd)/2 - 1
  Daubechies half-band polynomial ``P(y)``; each root ``y_i`` maps to the
  palindromic quadratic ``z^2 - (2-4 y_i) z + 1``.

Families 1.x / 2.x / 3.x are pure splines (all of P on the analysis side);
bior4.4 splits P's real root to synthesis and the complex pair to analysis —
that split IS the JPEG2000 CDF 9/7 pair; bior5.5 and bior6.8 use balanced
splits.  Both filters are normalized to sum = sqrt(2), which pins the
half-band product at omega=0 and yields exact perfect reconstruction; the
relative analysis/synthesis delay is resolved by a numeric polyphase
self-check at build time (the reason PyWavelets pads these tables with zeros).

Note: bior5.5/6.8 use the principled CDF splits, which reconstruct exactly
without a compensating reconstruction scaling.
"""

from __future__ import annotations

import functools
import math

import mpmath as mp
import numpy as np

from .base import DiscreteWavelet, biorthogonal_wavelet, qmf_alternate

_SQRT2 = math.sqrt(2.0)

#: (Nr, Nd) -> how many of P's root-groups go to the synthesis (rec) side.
#: Spline families put everything on the analysis side (0); 4.4/5.5/6.8 split.
_VARIANTS: dict[tuple[int, int], int] = {
    (1, 1): 0, (1, 3): 0, (1, 5): 0,
    (2, 2): 0, (2, 4): 0, (2, 6): 0, (2, 8): 0,
    (3, 1): 0, (3, 3): 0, (3, 5): 0, (3, 7): 0, (3, 9): 0,
    (4, 4): 1,  # CDF 9/7: real root -> synthesis, complex pair -> analysis
    (5, 5): 1,  # balanced split of the degree-4 half-band polynomial
    (6, 8): 1,  # one conjugate pair -> synthesis (lengths 11 / 17)
}


def _halfband_roots(big_l: int) -> list[tuple[mp.mpc, ...]]:
    """Root groups (real singletons / conjugate pairs) of P(y), sorted by |Im|
    then Re so the split assignment is deterministic."""
    from .orthogonal import _group_y_roots, _halfband_y_roots

    if big_l <= 1:
        return []
    roots = _halfband_y_roots(big_l)
    groups = _group_y_roots(roots)
    return sorted(groups, key=lambda g: (abs(mp.im(g[0])), mp.re(g[0])))


def _factor_poly(groups: list[tuple[mp.mpc, ...]]) -> list[mp.mpf]:
    """Product of palindromic quadratics z^2 - (2-4y)z + 1 over all roots."""
    poly = [mp.mpf(1)]
    for group in groups:
        for y in group:
            quad = [mp.mpf(1), -(2 - 4 * y), mp.mpf(1)]
            nxt = [mp.mpc(0)] * (len(poly) + 2)
            for i, c in enumerate(poly):
                for j, q in enumerate(quad):
                    nxt[i + j] += c * q
            poly = nxt
    return [mp.re(c) for c in poly]


def _lowpass(order: int, groups: list[tuple[mp.mpc, ...]]) -> np.ndarray:
    """sqrt(2)-normalized (1+z)^order times assigned root factors."""
    with mp.workdps(60):
        binom = [mp.mpf(math.comb(order, k)) for k in range(order + 1)]
        factors = _factor_poly(groups)
        full = [mp.mpf(0)] * (len(binom) + len(factors) - 1)
        for i, b in enumerate(binom):
            for j, f in enumerate(factors):
                full[i + j] += b * f
        total = sum(full)
        return np.array([float(c * mp.sqrt(2) / total) for c in full])


def _roundtrip_error(dec_lo: np.ndarray, rec_lo: np.ndarray) -> float:
    """Max MODWT periodic round-trip error for a candidate alignment."""
    dec_hi = qmf_alternate(rec_lo)
    rec_hi = qmf_alternate(dec_lo)
    rng = np.random.default_rng(123)
    n = 64
    x = rng.standard_normal(n)
    inv_s = 1.0 / _SQRT2
    a = np.zeros(n)
    d = np.zeros(n)
    for t in range(n):
        a[t] = sum(inv_s * dec_lo[l] * x[(t - l) % n] for l in range(len(dec_lo)))
        d[t] = sum(inv_s * dec_hi[l] * x[(t - l) % n] for l in range(len(dec_hi)))
    xr = np.zeros(n)
    for t in range(n):
        xr[t] = sum(inv_s * rec_lo[l] * a[(t + l) % n] for l in range(len(rec_lo))) + sum(
            inv_s * rec_hi[l] * d[(t + l) % n] for l in range(len(rec_hi))
        )
    return float(np.max(np.abs(x - xr)))


@functools.lru_cache(maxsize=None)
def biorthogonal_filters(nr: int, nd: int) -> tuple[np.ndarray, np.ndarray]:
    """(dec_lo, rec_lo) for biorNr.Nd, aligned for exact MODWT reconstruction."""
    if (nr, nd) not in _VARIANTS:
        raise ValueError(f"Unsupported biorthogonal variant bior{nr}.{nd}")

    from ._cache import cached_filter

    packed = cached_filter(f"bior{nr}.{nd}", lambda: _biorthogonal_packed_uncached(nr, nd))
    split = int(packed[0])
    return packed[1 : 1 + split], packed[1 + split :]


def _biorthogonal_packed_uncached(nr: int, nd: int) -> np.ndarray:
    big_l = (nr + nd) // 2
    groups = _halfband_roots(big_l)
    n_rec_groups = _VARIANTS[(nr, nd)]
    rec_groups = groups[:n_rec_groups]
    dec_groups = groups[n_rec_groups:]
    dec_lo = _lowpass(nd, dec_groups)
    rec_lo = _lowpass(nr, rec_groups)
    # Equalize lengths with centered zero padding (both filters are
    # symmetric and share length parity), so the alternating-sign QMF
    # construction produces phase-aligned high-pass filters — this is
    # exactly why the published tables carry leading/trailing zeros.
    diff = len(dec_lo) - len(rec_lo)
    half = abs(diff) // 2
    if diff > 0:
        rec_lo = np.concatenate([np.zeros(half), rec_lo, np.zeros(abs(diff) - half)])
    elif diff < 0:
        dec_lo = np.concatenate([np.zeros(half), dec_lo, np.zeros(abs(diff) - half)])
    # Resolve any residual one-sample polyphase delay by a tiny search.
    best = None
    for pad_dec in range(2):
        for pad_rec in range(2):
            cand_dec = np.concatenate([np.zeros(pad_dec), dec_lo, np.zeros(pad_rec)])
            cand_rec = np.concatenate([np.zeros(pad_rec), rec_lo, np.zeros(pad_dec)])
            err = _roundtrip_error(cand_dec, cand_rec)
            if best is None or err < best[0]:
                best = (err, cand_dec, cand_rec)
    err, dec_best, rec_best = best
    if err > 1e-10:
        raise AssertionError(
            f"bior{nr}.{nd} alignment search failed (best error {err:.2e})"
        )
    # pack both into one array for the table: [len_dec, dec..., rec...]
    return np.concatenate([[len(dec_best)], dec_best, rec_best])


def biorthogonal(nr: int, nd: int) -> DiscreteWavelet:
    """biorNr.Nd: synthesis spline order Nr, Nd dual vanishing moments."""
    dec_lo, rec_lo = biorthogonal_filters(nr, nd)
    return biorthogonal_wavelet(
        f"bior{nr}.{nd}",
        "BiorthogonalSpline",
        dec_lo,
        rec_lo,
        nd,
        f"Biorthogonal spline wavelet {nr}.{nd}",
    )


def reverse_biorthogonal(nr: int, nd: int) -> DiscreteWavelet:
    """rbioNr.Nd: the bior pair with analysis/synthesis roles swapped
    (analysis spline order Nr)."""
    dec_lo, rec_lo = biorthogonal_filters(nr, nd)
    return biorthogonal_wavelet(
        f"rbio{nr}.{nd}",
        "ReverseBiorthogonalSpline",
        rec_lo,
        dec_lo,
        nr,
        f"Reverse biorthogonal spline wavelet {nr}.{nd}",
    )


VARIANTS = tuple(sorted(_VARIANTS))
