"""The plain reference: the periodic MODWT and its inverse, in float64
PyTorch on any device.

It imports nothing of the program under test.  Every function takes
``[rows, N]`` float64 and returns float64; the harness feeds it blocks of
rows so that it fits beside the program's outputs.  The formulas follow
Percival and Walden, *Wavelet Methods for Time Series Analysis* (2000),
section 5.4, with the level-j filters at stride ``2^(j-1)`` and
``1/sqrt(2)`` per stage, every index modulo N:

* analysis ``V_j[t] = sum_l h_l V_{j-1}[t - 2^(j-1) l]`` (``W_j`` with ``g``);
* inverse ``V_{j-1}[t] = sum_l h_l V_j[t + 2^(j-1) l] + sum_l g_l
  W_j[t + 2^(j-1) l]``.
"""

from __future__ import annotations

import math

import torch

from .taps import SCALING, wavelet_filter


def filters(wavelet: str) -> tuple[tuple[float, ...], tuple[float, ...]]:
    """``(h, g)`` scaled by ``1/sqrt(2)``, the MODWT's per-stage filters."""
    h = SCALING[wavelet]
    s = 1.0 / math.sqrt(2.0)
    return tuple(c * s for c in h), tuple(c * s for c in wavelet_filter(h))


def _check_boundary(boundary: str) -> None:
    if boundary != "periodic":
        raise ValueError(f"the reference computes the periodic MODWT only, not {boundary!r}")


def _filter(x: torch.Tensor, taps, deltas) -> torch.Tensor:
    """``out[t] = sum_k taps[k] x[(t + deltas[k]) mod N]``."""
    n = x.shape[-1]
    t = torch.arange(n, device=x.device)
    out = torch.zeros_like(x)
    for c, d in zip(taps, deltas):
        out += c * x.index_select(-1, (t + d) % n)
    return out


def analysis(x: torch.Tensor, wavelet: str, levels: int, boundary: str = "periodic"):
    """``[W_1, ..., W_J], V_J``."""
    _check_boundary(boundary)
    h, g = filters(wavelet)
    details, cur = [], x
    for j in range(1, levels + 1):
        deltas = [-(1 << (j - 1)) * k for k in range(len(h))]
        details.append(_filter(cur, g, deltas))
        cur = _filter(cur, h, deltas)
    return details, cur


def synthesis(details, approx: torch.Tensor, wavelet: str,
              boundary: str = "periodic") -> torch.Tensor:
    """The inverse, coarsest level first."""
    _check_boundary(boundary)
    h, g = filters(wavelet)
    cur = approx
    for j in range(len(details), 0, -1):
        deltas = [(1 << (j - 1)) * k for k in range(len(h))]
        cur = _filter(cur, h, deltas) + _filter(details[j - 1], g, deltas)
    return cur
