"""The periodic CWT's reference for the port's parity tests.

A periodic CWT row of scale s is the correlation of the signal with the
taps ``c_k = psi(k / s) / sqrt(s)``, ``|k| <= h(s)``, taken modulo N: where
the support is longer than N (2h + 1 > N) the taps that land on one slot
add.  The JAX package's bank keeps one tap a slot there
(``vectorwave_tpu/transforms/cwt.py:122``), so the tests hold such rows to
this reference, summed in float64 from the JAX package's wavelets (whose
``psi`` the port's equals to 1e-14), and the rows that fit to JAX.
"""

import numpy as np

import vectorwave_tpu as vw
from vectorwave_tpu.transforms import cwt as jcwt


def wraps(name: str, scale: float, n: int) -> bool:
    """Whether the scale's support of 2h + 1 taps is longer than ``n``."""
    return 2 * jcwt._half_support(scale, vw.wavelet(name).bandwidth) + 1 > n


def folded_taps(name: str, scale: float, n: int) -> np.ndarray:
    """The taps summed modulo ``n``: slot j holds every c_k with k = j mod n."""
    w = vw.wavelet(name)
    h = jcwt._half_support(scale, w.bandwidth)
    k = np.arange(-h, h + 1)
    vals = np.asarray(w.psi(k / scale)) / np.sqrt(scale)
    folded = np.zeros(n, dtype=vals.dtype)
    np.add.at(folded, k % n, vals)
    return folded


def correlation_matrix(name: str, scale: float, n: int) -> np.ndarray:
    """``G`` with ``G[t, m] = conj(f[(m - t) mod n])``: the row is ``x @ G.T``
    and the gradient of ``sum(w * row)`` with respect to a real x is
    ``Re(w @ G)``."""
    t = np.arange(n)
    return np.conj(folded_taps(name, scale, n))[(t[None, :] - t[:, None]) % n]


def periodic_correlation(x, name: str, scale: float) -> np.ndarray:
    """``out[..., t] = sum_k x[..., (t + k) mod N] conj(c_k)``."""
    x = np.asarray(x, np.float64)
    return x @ correlation_matrix(name, scale, x.shape[-1]).T
