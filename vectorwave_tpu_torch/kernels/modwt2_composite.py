"""The 2-D MODWT in composite form: per-axis composite filters, plain PyTorch.

Counterpart of ``vectorwave_tpu/kernels/modwt2_mxu.py``.  The separable 2-D
à trous pyramid unrolls into per-axis composite filters: level-j bands are
``x *w F_j *h G_j`` with each axis filter one of the 1-D cascade composites
``A_j = h_j o ... o h_1`` and ``D_j = g_j o A_{j-1}`` (à trous upsampled, the
per-stage 1/sqrt(2) composed in), and the inverse telescopes exactly.  The
JAX module applies them as banded 128-lane matmuls; here each composite is
applied along its axis as a sum of rolled (periodic) or sliced (zero) copies.

Nothing on the main path calls this module.  It is the independent oracle
the 2-D kernel tier is held against: a per-level cascade whose edge is
applied to ``LL_{j-1}`` equals the composite form for periodic and zero
edges, because analysis reads only backward and synthesis only forward.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import ErrorCode, InvalidArgumentError
from ..ops.convolve import atrous_convolve
from .modwt_composite import _upsample_filter
from .modwt_fused import _kernel_boundary, _kernel_filters


def composite_planes_split(low, high, levels: int):
    """``([D_1..D_J], [A_1..A_J])`` causal composite filters per level (the
    1-D ``composite_plane_filters`` keeps only A_J; 2-D needs every A_j)."""
    ds, as_ = [], []
    acc = np.array([1.0])
    for j in range(1, levels + 1):
        s = 1 << (j - 1)
        ds.append(np.convolve(acc, _upsample_filter(np.asarray(high), s)))
        acc = np.convolve(acc, _upsample_filter(np.asarray(low), s))
        as_.append(acc.copy())
    return ds, as_


def _edge(boundary: str) -> str:
    edge = _kernel_boundary(boundary, "the 2-D composite form")
    if edge == "symmetric":
        raise InvalidArgumentError(
            ErrorCode.CFG_UNSUPPORTED_BOUNDARY,
            "The composite form serves periodic and zero boundaries",
        )
    return edge


def _along_w(x, filt, sign, edge):
    return atrous_convolve(x, filt, spacing=1, boundary=edge, sign=sign)


def _along_h(x, filt, sign, edge):
    return _along_w(x.transpose(-1, -2), filt, sign, edge).transpose(-1, -2)


def _composites(w, levels: int, synthesis: bool):
    lo, hi = _kernel_filters(w, synthesis)
    return composite_planes_split(np.array(lo), np.array(hi), levels)


def modwt2_multilevel_composite(x: torch.Tensor, w, levels: int, boundary: str):
    """J-level separable 2-D MODWT ``[..., H, W]`` -> ``(((lh, hl, hh) per
    level), ll_J)`` through the composite filters (backward reads along each
    axis).  ``lh`` is low along H and high along W."""
    edge = _edge(boundary)
    ds, as_ = _composites(w, levels, synthesis=False)
    details = []
    ll = None
    for j in range(levels):
        rows_d = _along_w(x, ds[j], -1, edge)
        rows_a = _along_w(x, as_[j], -1, edge)
        details.append((_along_h(rows_d, as_[j], -1, edge),
                        _along_h(rows_a, ds[j], -1, edge),
                        _along_h(rows_d, ds[j], -1, edge)))
        if j == levels - 1:
            ll = _along_h(rows_a, as_[j], -1, edge)
    return tuple(details), ll


def imodwt2_multilevel_composite(details, approx: torch.Tensor, w, boundary: str):
    """Inverse of :func:`modwt2_multilevel_composite` (forward reads): with
    ``U_j = D~h hl_j (+ A~h ll_J at J)`` and ``V_j = A~h lh_j + D~h hh_j``,
    the image is ``sum_j A~w_j U_j + D~w_j V_j``."""
    edge = _edge(boundary)
    levels = len(details)
    ds, as_ = _composites(w, levels, synthesis=True)
    out = None
    for j in range(levels):
        lh, hl, hh = details[j]
        u = _along_h(hl, ds[j], +1, edge)
        if j == levels - 1:
            u = u + _along_h(approx, as_[j], +1, edge)
        v = _along_h(lh, as_[j], +1, edge) + _along_h(hh, ds[j], +1, edge)
        term = _along_w(u, as_[j], +1, edge) + _along_w(v, ds[j], +1, edge)
        out = term if out is None else out + term
    return out
