"""Coiflet wavelets: published seeds refined to machine precision.

Counterpart of ``vectorwave_tpu/wavelets/coiflets.py`` (coif1-coif17), kept
identical so that both packages generate the same filters.  Published coiflet
tables are rounded (off by about 1e-4 for coif2); here the table values are
used only as Newton seeds and the filters are re-solved against the defining
equations, so every order satisfies orthogonality and the moment conditions to
~1e-13 or better.

Defining system for coif_K (length 6K, solved by Gauss-Newton least squares):

* normalization  ``sum h = sqrt(2)``
* orthogonality  ``sum_n h_n h_{n+2m} = delta_m`` for m = 0..3K-1
* 2K vanishing wavelet moments   ``sum_n (-1)^n n^j h_n = 0``, j = 0..2K-1
* 2K-1 vanishing scaling moments ``sum_n (n-tau)^j h_n = 0``, j = 1..2K-1,
  with the moment center tau inferred from the seed.

The system is consistent (coiflets exist) though formally overdetermined;
double-precision Gauss-Newton converges in a few steps, with an mpmath polish
for the ill-conditioned high orders.
"""

from __future__ import annotations

import functools
import math

import mpmath as mp
import numpy as np

from ._coiflet_seeds import SEEDS
from .base import DiscreteWavelet, orthogonal_wavelet

_SQRT2 = math.sqrt(2.0)

MAX_ORDER = max(SEEDS)


def _system(h: np.ndarray, order: int, tau: int) -> tuple[np.ndarray, np.ndarray]:
    """Residual vector and Jacobian of the coiflet defining equations."""
    length = 6 * order
    n = np.arange(length, dtype=np.float64)
    eqs: list[float] = []
    jac: list[np.ndarray] = []
    eqs.append(h.sum() - _SQRT2)
    jac.append(np.ones(length))
    eqs.append(float((h * h).sum() - 1.0))
    jac.append(2 * h)
    for m in range(1, 3 * order):
        eqs.append(float((h[: -2 * m] * h[2 * m :]).sum()))
        row = np.zeros(length)
        row[: -2 * m] += h[2 * m :]
        row[2 * m :] += h[: -2 * m]
        jac.append(row)
    sign = np.where(n.astype(int) % 2 == 0, 1.0, -1.0)
    for j in range(2 * order):
        w = sign * n**j
        eqs.append(float((w * h).sum()))
        jac.append(w)
    for j in range(1, 2 * order):
        w = (n - tau) ** j
        eqs.append(float((w * h).sum()))
        jac.append(w)
    return np.asarray(eqs), np.asarray(jac)


def _refine_f64(h: np.ndarray, order: int, tau: int) -> np.ndarray:
    for _ in range(12):
        r, jac = _system(h, order, tau)
        scale = np.abs(jac).max(axis=1)
        scale[scale == 0] = 1.0
        step, *_ = np.linalg.lstsq(jac / scale[:, None], -r / scale, rcond=None)
        h = h + step
        if np.abs(step).max() < 1e-15:
            break
    return h


def _max_scaled_residual(h: np.ndarray, order: int, tau: int) -> float:
    r, jac = _system(h, order, tau)
    scale = np.abs(jac).max(axis=1)
    scale[scale == 0] = 1.0
    return float(np.abs(r / scale).max())


def _refine_mp(h: np.ndarray, order: int, tau: int, dps: int = 50) -> np.ndarray:
    """High-precision Gauss-Newton polish for ill-conditioned orders."""
    length = 6 * order
    with mp.workdps(dps):
        hv = mp.matrix([mp.mpf(v) for v in h])

        def build():
            rows = []
            res = []
            rows.append([mp.mpf(1)] * length)
            res.append(sum(hv) - mp.sqrt(2))
            rows.append([2 * hv[i] for i in range(length)])
            res.append(sum(hv[i] ** 2 for i in range(length)) - 1)
            for m in range(1, 3 * order):
                res.append(sum(hv[i] * hv[i + 2 * m] for i in range(length - 2 * m)))
                row = [mp.mpf(0)] * length
                for i in range(length - 2 * m):
                    row[i] += hv[i + 2 * m]
                    row[i + 2 * m] += hv[i]
                rows.append(row)
            for j in range(2 * order):
                w = [(-1) ** i * mp.mpf(i) ** j for i in range(length)]
                rows.append(w)
                res.append(sum(w[i] * hv[i] for i in range(length)))
            for j in range(1, 2 * order):
                w = [mp.mpf(i - tau) ** j for i in range(length)]
                rows.append(w)
                res.append(sum(w[i] * hv[i] for i in range(length)))
            # row scaling
            mat = mp.matrix(len(rows), length)
            rvec = mp.matrix(len(rows), 1)
            for ri, (row, rv) in enumerate(zip(rows, res)):
                s = max(abs(c) for c in row)
                if s == 0:
                    s = mp.mpf(1)
                for ci in range(length):
                    mat[ri, ci] = row[ci] / s
                rvec[ri] = -rv / s
            return mat, rvec

        for _ in range(4):
            mat, rvec = build()
            # Levenberg-Marquardt step: the system is overdetermined but
            # consistent, so the Jacobian is rank-deficient at the solution;
            # a tiny ridge keeps the normal equations solvable.
            jt = mat.T
            jtj = jt * mat
            lam = mp.mpf("1e-24") * max(abs(jtj[i, i]) for i in range(length))
            for i in range(length):
                jtj[i, i] += lam
            step = mp.lu_solve(jtj, jt * rvec)
            for i in range(length):
                hv[i] += step[i]
            if max(abs(s) for s in step) < mp.mpf("1e-30"):
                break
        return np.array([float(v) for v in hv])


@functools.lru_cache(maxsize=None)
def coiflet_filter(order: int) -> np.ndarray:
    if order < 1 or order > MAX_ORDER:
        raise ValueError(f"Coiflet order must be in [1, {MAX_ORDER}], got {order}")

    from ._cache import cached_filter

    return cached_filter(f"coif{order}", lambda: _coiflet_filter_uncached(order))


def _coiflet_filter_uncached(order: int) -> np.ndarray:
    seed = np.asarray(SEEDS[order], dtype=np.float64)
    n = np.arange(len(seed))
    tau = round(float((n * seed).sum()) / _SQRT2)
    h = _refine_f64(seed, order, tau)
    if _max_scaled_residual(h, order, tau) > 1e-13:
        h = _refine_mp(h, order, tau)
    return h


def coiflet(order: int) -> DiscreteWavelet:
    """Coiflet coifN (2N vanishing wavelet moments, 6N taps)."""
    return orthogonal_wavelet(
        f"coif{order}",
        "Coiflet",
        coiflet_filter(order),
        2 * order,
        f"Coiflet wavelet of order {order}",
    )
