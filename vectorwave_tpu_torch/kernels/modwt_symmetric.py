"""Symmetric-boundary MODWT in the kernel tier.

Counterpart of ``vectorwave_tpu/kernels/modwt_symmetric.py``.  The per-level
mirror of the evolving approximation is not a filter composition, but only
the first and last outputs ever read across a mirror:

* **Analysis** is causal, so it reads across the mirror at the signal start
  only.  One launch of the analysis kernel in its mirror mode
  (:func:`.modwt_cascade.cascade_analysis`, the counterpart of the JAX
  package's ``run_analysis_mxu(..., symmetric=True)``) reflects each
  level's input at the start before the level runs.  It serves N >=
  (L-1) 2^(J-1), where one reflection is the period-2N extension: a
  shorter CUDA signal is refused (the router sends it to the plain path),
  and a CPU one runs the plain cascade at any N.
* **Synthesis** reads both ways.  Away from the edges it is the sum of the
  planes, zero outside the signal, each filtered by the composition of the
  alignment-shifted per-level ops (:func:`symmetric_synthesis_plane_filters`);
  the first ``span_l`` and last ``span_r`` outputs come from the plain
  symmetric inverse of a head window of ``span_l + 2 span_r + 1`` and a tail
  window of ``span_r + 2 span_l + 1`` samples, sized so that the window's far
  mirror cannot reach the spliced outputs.  One launch of the symmetric
  synthesis kernel runs the composition level by level and applies the
  splice on its store.

Both are differentiable (``torch.autograd.Function``).  Outputs at ``p >=
S`` (S = (L-1)(2^J-1), the cascade span) equal the zero-boundary transform,
so the analysis backward is the synthesis kernel in zero mode on the
cotangent masked to ``p >= S``, plus the VJP of the plain symmetric cascade
on the first S samples, recomputed in the backward; the synthesis backward
is the symmetric kernel's adjoint mode on the cotangent's interior (the
kernel reads it as zero outside, with no mask pass), plus the head and tail
slabs, which autograd carries on through the plain head and tail inverses.

The JAX package's long-filter body path (``_symsyn_core``), which exists
because its splice slab holds at most 8 rows, has no counterpart: every
span whose windows fit one block's shared memory is served by the same
kernel, and the router sends the rest to the plain path.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import ErrorCode, InvalidArgumentError
from ..ops.convolve import atrous_analysis_pair
from ..transforms.multilevel import (
    MultiLevelMODWTResult,
    _symmetric_alignment,
    _tau_j,
    imodwt_multilevel,
)
from . import modwt_cascade, modwt_composite
from .modwt_composite import _compute_dtype, composite_halo_samples, mirror_reach

# --- alignment-composed per-plane synthesis filters (numpy) ------------------------


def symmetric_level_ops(w, levels: int) -> tuple[tuple[int, int, int, int], ...]:
    """Per level j, ``(a_sign, a_offset, d_sign, d_offset)`` of the
    alignment-shifted symmetric inverse: level j's ops read
    ``c_j[t + a_sign 2^(j-1) l + a_offset]`` and ``d_j[t + d_sign 2^(j-1) l +
    d_offset]`` (``imodwt_multilevel``'s symmetric semantics)."""
    ops = []
    for j in range(1, levels + 1):
        dec = _symmetric_alignment(w, j)
        tau_h = _tau_j(w.rec_lo.shape[0], j) + dec.delta_approx
        tau_g = _tau_j(w.rec_hi.shape[0], j) + dec.delta_detail
        ops.append((
            1 if dec.approx_plus else -1, -tau_h if dec.approx_plus else tau_h,
            1 if dec.detail_plus else -1, -tau_g if dec.detail_plus else tau_g,
        ))
    return tuple(ops)


def _op_filter(base: np.ndarray, spacing: int, sign: int, offset: int):
    """Dense (taps ascending by delta, start_delta) for the per-level op
    ``out[t] = sum_l base[l] * in[t + sign*spacing*l + offset]``."""
    arr = np.zeros(spacing * (len(base) - 1) + 1, dtype=np.float64)
    arr[::spacing] = base
    if sign == +1:
        return arr, offset
    return arr[::-1].copy(), offset - spacing * (len(base) - 1)


def _compose(f1, s1, f2, s2):
    return np.convolve(f1, f2), s1 + s2


def plane_filters(filters, ops):
    """[(taps, start_delta)] for planes [d1..dJ, aJ]: each plane's
    contribution to the reconstruction through the composed ops, with the
    (scaled) synthesis ``filters`` = (lo, hi)."""
    low = np.asarray(filters[0], dtype=np.float64)
    high = np.asarray(filters[1], dtype=np.float64)
    planes = []
    pre = (np.array([1.0]), 0)  # A_1 o ... o A_{j-1}
    for j, (sa, oa, sd, od) in enumerate(ops, start=1):
        planes.append(_compose(*pre, *_op_filter(high, 1 << (j - 1), sd, od)))
        pre = _compose(*pre, *_op_filter(low, 1 << (j - 1), sa, oa))
    planes.append(pre)
    return planes


def symmetric_synthesis_plane_filters(w, levels: int):
    """:func:`plane_filters` of wavelet ``w``'s symmetric inverse."""
    from .modwt_fused import _kernel_filters

    return plane_filters(_kernel_filters(w, synthesis=True), symmetric_level_ops(w, levels))


def _rebase(plane_filters):
    """Global rebase to non-negative taps: returns (dense tuples, G, d_max)
    with ``f'_p[tau] = f_p[tau - G]`` and ``G = -min start`` so reads become
    ``plane'[t + tau] = plane[t + tau - G]`` (left-extend each plane by G)."""
    g = max(0, -min(s for _, s in plane_filters))
    d_max = max(s + len(a) - 1 for a, s in plane_filters)
    dense = []
    for arr, start in plane_filters:
        f = np.zeros(start + g + len(arr), dtype=np.float64)
        f[start + g:] = arr
        dense.append(tuple(f.tolist()))
    return tuple(dense), g, d_max


# --- plain symmetric cascades -------------------------------------------------------


def _symmetric_cascade(x: torch.Tensor, filters, levels: int) -> list[torch.Tensor]:
    """[d_1, ..., d_J, a_J] of the plain symmetric analysis cascade."""
    low, high = filters
    cur = x
    planes = []
    for j in range(1, levels + 1):
        cur, detail = atrous_analysis_pair(
            cur, low, high, spacing=1 << (j - 1), boundary="symmetric"
        )
        planes.append(detail)
    planes.append(cur)
    return planes


def _symmetric_inverse(planes, w) -> torch.Tensor:
    return imodwt_multilevel(
        MultiLevelMODWTResult(tuple(planes[:-1]), planes[-1]), w,
        boundary="symmetric", backend="torch",
    )


# --- gates --------------------------------------------------------------------------


def analysis_fits(taps: int, levels: int) -> bool:
    """Whether the symmetric analysis kernel (the analysis kernel's mirror
    mode, at a tile of at least (L-1) 2^(J-1)) and its backward (the
    zero-mode synthesis, at a tile of >= 128) fit one block."""
    return (
        modwt_composite.analysis_tile(taps, levels, mirror=True) is not None
        and modwt_composite._fitting_tile(
            lambda t: modwt_composite.synthesis_shared_bytes(taps, levels, t),
            modwt_composite.SYNTHESIS_TILE) is not None
    )


def synthesis_windows(taps: int, ops) -> tuple[int, int, int, int]:
    """(span_l, span_r, head window, tail window) of the symmetric synthesis."""
    span_l, span_r = modwt_composite.symmetric_spans(taps, tuple(ops))
    return span_l, span_r, span_l + 2 * span_r + 1, span_r + 2 * span_l + 1


def synthesis_fits(taps: int, ops, n: int) -> bool:
    """Whether the symmetric synthesis kernel serves n samples: the head and
    tail windows do not overlap, and the kernel and its adjoint fit one
    block at a tile of >= 128."""
    _, _, w_head, w_tail = synthesis_windows(taps, ops)
    return n >= w_head + w_tail and all(
        modwt_composite.symmetric_tile(taps, tuple(ops), adjoint) is not None
        for adjoint in (False, True)
    )


def route_fits(w, levels: int, n: int, synthesis: bool) -> bool:
    """The router's symmetric gate: the signal holds the mirror's reach,
    (L-1) 2^(J-1) samples (analysis), the splice windows do not overlap
    (synthesis), and the kernels of that direction fit shared memory."""
    taps = w.filter_length
    if synthesis:
        return synthesis_fits(taps, symmetric_level_ops(w, levels), n)
    return n >= mirror_reach(taps, levels) and analysis_fits(taps, levels)


def _refuse(entry: str, taps: int, levels: int, n: int) -> InvalidArgumentError:
    return InvalidArgumentError(
        ErrorCode.VAL_TOO_LARGE,
        f"{entry}: the symmetric kernel tier does not serve this call (its "
        "windows do not fit shared memory, the splice windows overlap, or the "
        "signal is shorter than the mirror's reach)",
        context={"taps": taps, "levels": levels, "n": n},
        suggestions=("Use backend='torch' (or 'auto') for this shape",),
    )


# --- differentiable entry points -------------------------------------------------------


class _SymmetricAnalysis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, levels, filters):
        ctx.levels, ctx.filters = levels, filters
        ctx.save_for_backward(x)
        return modwt_cascade.cascade_analysis(x, levels, filters, "mirror")

    @staticmethod
    def backward(ctx, *cots):
        (x,) = ctx.saved_tensors
        n = x.shape[-1]
        cut = min(composite_halo_samples(len(ctx.filters[0]), ctx.levels), n)
        body = torch.arange(n, device=x.device) >= cut
        gx = modwt_composite.synthesis(
            tuple((c * body).contiguous() for c in cots), ctx.levels, ctx.filters, False
        )
        with torch.enable_grad():
            head = x[..., :cut].detach().to(_compute_dtype(x)).requires_grad_(True)
            planes = _symmetric_cascade(head, ctx.filters, ctx.levels)
            (ghead,) = torch.autograd.grad(
                planes, head, [c[..., :cut].to(head.dtype) for c in cots]
            )
        gx[..., :cut] += ghead.to(gx.dtype)
        return gx, None, None


class _SymmetricSynthesis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, head, tail, levels, filters, ops, *planes):
        ctx.levels, ctx.filters, ctx.ops = levels, filters, ops
        ctx.spans, ctx.dtypes = (head.shape[-1], tail.shape[-1]), (head.dtype, tail.dtype)
        return modwt_composite.symmetric_synthesis(planes, head, tail, levels, filters, ops)

    @staticmethod
    def backward(ctx, cot):
        span_l, span_r = ctx.spans
        n = cot.shape[-1]
        grads = modwt_composite.symmetric_adjoint(
            cot.contiguous(), ctx.levels, ctx.filters, ctx.ops, span_l, span_r
        )
        ghead = cot[..., :span_l].to(ctx.dtypes[0])
        gtail = cot[..., n - span_r :].to(ctx.dtypes[1])
        return (ghead, gtail, None, None, None, *grads)


def fused_symmetric_analysis(x: torch.Tensor, w, *, levels: int) -> tuple[torch.Tensor, ...]:
    """Symmetric J-level analysis of ``[B, N]`` signals -> the J+1 planes
    ``(d_1, ..., d_J, a_J)``: on a CUDA tensor one launch of the analysis
    kernel in mirror mode, for N >= (L-1) 2^(J-1); on a CPU tensor the plain
    symmetric cascade, any N."""
    from .modwt_fused import _kernel_filters

    filters = _kernel_filters(w, synthesis=False)
    taps, n = len(filters[0]), x.shape[-1]
    if x.device.type != "cpu" and not (
            analysis_fits(taps, levels) and n >= mirror_reach(taps, levels)):
        raise _refuse("fused_analysis", taps, levels, n)
    return _SymmetricAnalysis.apply(x, levels, filters)


def fused_symmetric_synthesis(planes, w) -> torch.Tensor:
    """Symmetric inverse of the J+1 ``[B, N]`` planes ``(d_1, ..., d_J,
    a_J)``: one launch of the symmetric synthesis kernel, its first span_l
    and last span_r outputs spliced from the plain symmetric inverse of the
    head and tail windows.  The kernel's gates (windows that fit shared
    memory and do not overlap) hold for CUDA tensors only: CPU planes they
    would refuse take the plain symmetric inverse, at any shape it serves."""
    from .modwt_fused import _kernel_filters

    levels = len(planes) - 1
    filters = _kernel_filters(w, synthesis=True)
    ops = symmetric_level_ops(w, levels)
    taps = len(filters[0])
    n = planes[0].shape[-1]
    if not synthesis_fits(taps, ops, n):
        if planes[0].device.type == "cpu":
            return _symmetric_inverse(planes, w)
        raise _refuse("fused_synthesis", taps, levels, n)
    span_l, span_r, w_head, w_tail = synthesis_windows(taps, ops)
    cd = _compute_dtype(planes[0])
    head = _symmetric_inverse([p[..., :w_head].to(cd) for p in planes], w)
    tail = _symmetric_inverse([p[..., n - w_tail :].to(cd) for p in planes], w)
    return _SymmetricSynthesis.apply(
        head[..., :span_l].contiguous(), tail[..., w_tail - span_r :].contiguous(),
        levels, filters, ops, *planes,
    )
