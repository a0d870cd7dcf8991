"""Kernel tier of the multi-level MODWT: public entry points.

Counterpart of ``vectorwave_tpu/kernels/modwt_pallas.py``.  The compute
lives in :mod:`.modwt_composite` (hand-written CUDA kernels and their plain
versions); this module keeps the public surface: halo math, the
differentiable :func:`fused_analysis` / :func:`fused_synthesis`, the fused
denoise and the one-pass round trip.  Symmetric boundaries go to
:mod:`.modwt_symmetric`: the analysis kernel's per-level mirror mode, and
the symmetric synthesis kernel with its edge splice.

The analysis map A and synthesis map S are linear, and for periodic and
zero boundaries the synthesis structure with the analysis filters is exactly
A^T (each level's (t+l) correlation is the transpose of the (t-l)
convolution).  So each gradient runs the opposite kernel with the forward
map's own filters: one kernel pass per gradient, and no extra kernel.  The
fused denoise's gradient is S^T (the analysis kernel on the reconstruction
taps), the shrink mask recomputed by one more analysis, and A^T.

Precision: ``precision=`` names one of the JAX package's tiers (float32,
bf16_3x, bf16).  Every tier runs the same fp32 kernel, whose error is within
the contract of each; the argument is validated and otherwise has no
effect until tensor-core tiers exist.
"""

from __future__ import annotations

import math

import torch

from ..config import _VALID_PRECISIONS, get_fused_precision
from ..errors import ErrorCode, InvalidArgumentError
from . import modwt_composite

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def kernel_available() -> bool:
    """Whether the CUDA kernel tier can run here: a CUDA device of compute
    capability 9.0 (Hopper), for which the kernels are built (``sm_90a``)."""
    return torch.cuda.is_available() and torch.cuda.get_device_capability() == (9, 0)


def total_halo(filter_length: int, levels: int) -> int:
    """Cumulative cascade halo: sum_j (L0-1) 2^(j-1) = (L0-1)(2^J - 1)."""
    return (filter_length - 1) * ((1 << levels) - 1)


def _kernel_filters(w, synthesis: bool) -> tuple[tuple[float, ...], tuple[float, ...]]:
    if synthesis:
        return (
            tuple((w.rec_lo * _INV_SQRT2).tolist()),
            tuple((w.rec_hi * _INV_SQRT2).tolist()),
        )
    return (
        tuple((w.dec_lo * _INV_SQRT2).tolist()),
        tuple((w.dec_hi * _INV_SQRT2).tolist()),
    )


def _check_precision(precision: str | None) -> None:
    prec = precision or get_fused_precision()
    if prec not in _VALID_PRECISIONS:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"Precision {prec!r} is not served by the kernel tier",
            suggestions=(f"Use one of {_VALID_PRECISIONS}",),
        )


def _kernel_boundary(boundary: str, entry: str) -> str:
    """``'periodic'``, ``'zero'`` or ``'symmetric'``; unknown names raise."""
    b = boundary.lower()
    for name in ("periodic", "zero", "symmetric"):
        if b.startswith(name[:3]):
            return name
    raise InvalidArgumentError(
        ErrorCode.CFG_UNSUPPORTED_BOUNDARY,
        f"Unknown boundary for {entry}: {boundary!r}",
        suggestions=("Use 'periodic', 'zero' or 'symmetric'",),
    )


class _Analysis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, levels, filters, periodic):
        ctx.levels, ctx.filters, ctx.periodic = levels, filters, periodic
        return modwt_composite.analysis(x, levels, filters, periodic)

    @staticmethod
    def backward(ctx, *grads):
        g = tuple(t.contiguous() for t in grads)
        gx = modwt_composite.synthesis(g, ctx.levels, ctx.filters, ctx.periodic)
        return gx, None, None, None


class _Synthesis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, levels, filters, periodic, *planes):
        ctx.levels, ctx.filters, ctx.periodic = levels, filters, periodic
        return modwt_composite.synthesis(planes, levels, filters, periodic)

    @staticmethod
    def backward(ctx, grad):
        planes = modwt_composite.analysis(
            grad.contiguous(), ctx.levels, ctx.filters, ctx.periodic
        )
        return (None, None, None, *planes)


class _Denoise(torch.autograd.Function):
    """The fused denoise with the JAX package's recompute-based adjoint
    (``modwt_pallas._fused_denoise_bwd``): with S^T the analysis kernel on
    the reconstruction taps and A^T the synthesis kernel on the decomposition
    taps, ``dx = A^T(mask * S^T g)``, the mask ``|d_j| > t_j`` recomputed by
    one more analysis (the approximation plane unmasked), and
    ``d/dt_j = -sum sign(d_j) mask_j (S^T g)_j`` for soft, 0 for hard.  The
    round trip (``mode='none'``) is ``A^T S^T g`` with no mask."""

    @staticmethod
    def forward(ctx, x, thresholds, levels, filters_dec, filters_rec, periodic, mode):
        ctx.save_for_backward(x, thresholds)
        ctx.args = (levels, filters_dec, filters_rec, periodic, mode)
        return modwt_composite.denoise(x, thresholds, levels, filters_dec, filters_rec,
                                       periodic, mode)

    @staticmethod
    def backward(ctx, g):
        x, th = ctx.saved_tensors
        levels, filters_dec, filters_rec, periodic, mode = ctx.args
        gs = modwt_composite.analysis(g.contiguous(), levels, filters_rec, periodic)
        if mode == "none":
            dx = modwt_composite.synthesis(gs, levels, filters_dec, periodic)
            return dx, torch.zeros_like(th), None, None, None, None, None
        d = modwt_composite.analysis(x, levels, filters_dec, periodic)
        masks = [d[j].abs() > th[:, j : j + 1].to(d[j].dtype) for j in range(levels)]
        gd = tuple(torch.where(masks[j], gs[j], torch.zeros_like(gs[j]))
                   for j in range(levels)) + (gs[levels],)
        dx = modwt_composite.synthesis(gd, levels, filters_dec, periodic)
        if mode == "soft":
            dth = torch.stack([
                (-torch.sign(d[j]) * gd[j]).sum(dim=-1, dtype=torch.float64)
                for j in range(levels)
            ], dim=-1).to(th.dtype)
        else:
            dth = torch.zeros_like(th)
        return dx, dth, None, None, None, None, None


def fused_analysis(
    x: torch.Tensor,
    wavelet,
    *,
    levels: int,
    boundary: str = "periodic",
    precision: str | None = None,
):
    """Fused J-level MODWT analysis of ``[..., N]`` signals: returns
    ``(details tuple, approx)``.

    Periodic, zero or symmetric boundary.  On a CUDA tensor it is one launch
    of the analysis kernel (for symmetric, in its per-level mirror mode,
    which serves N >= (L-1) 2^(J-1)); on a CPU tensor the kernel's plain
    version.  Differentiable: the gradient is one synthesis pass (for
    symmetric, plus the VJP of the plain symmetric cascade on the first
    (L-1)(2^J-1) samples).
    """
    from ..transforms.modwt import _resolve_discrete
    from .modwt_symmetric import fused_symmetric_analysis

    w = _resolve_discrete(wavelet)
    edge = _kernel_boundary(boundary, "fused_analysis")
    _check_precision(precision)
    lead, n = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, n).contiguous()
    if edge == "symmetric":
        planes = fused_symmetric_analysis(x2, w, levels=levels)
    else:
        planes = _Analysis.apply(
            x2, levels, _kernel_filters(w, synthesis=False), edge == "periodic"
        )
    planes = tuple(p.reshape(lead + (n,)) for p in planes)
    return planes[:levels], planes[levels]


def fused_synthesis(
    details,
    approx: torch.Tensor,
    wavelet,
    *,
    boundary: str = "periodic",
    precision: str | None = None,
) -> torch.Tensor:
    """Fused J-level inverse MODWT from ``(details, approx)``: the adjoint of
    :func:`fused_analysis` for periodic and zero boundaries, the
    alignment-shifted symmetric inverse for symmetric (one launch of the
    symmetric synthesis kernel, its edges spliced from the plain inverse of
    short head and tail windows)."""
    from ..transforms.modwt import _resolve_discrete
    from .modwt_symmetric import fused_symmetric_synthesis

    w = _resolve_discrete(wavelet)
    edge = _kernel_boundary(boundary, "fused_synthesis")
    _check_precision(precision)
    levels = len(details)
    lead, n = approx.shape[:-1], approx.shape[-1]
    planes = [p.reshape(-1, n).contiguous() for p in (*details, approx)]
    if edge == "symmetric":
        out = fused_symmetric_synthesis(planes, w)
    else:
        out = _Synthesis.apply(
            levels, _kernel_filters(w, synthesis=True), edge == "periodic", *planes
        )
    return out.reshape(lead + (n,))


def fused_denoise_multilevel(
    x: torch.Tensor,
    wavelet,
    *,
    levels: int,
    thresholds: torch.Tensor,  # [..., levels] per (signal, level)
    boundary: str = "periodic",
    mode: str = "soft",
    precision: str | None = None,
) -> torch.Tensor | None:
    """One-kernel denoise: analysis -> per-level threshold -> synthesis,
    with the coefficient planes kept in shared memory.

    Returns None for a symmetric boundary (the caller takes the 3-call
    path), as the JAX package does.  Any N is served.  Differentiable in x
    and in the thresholds (:class:`_Denoise`): on a CUDA tensor the backward
    launches the analysis kernel twice and the synthesis kernel once (once
    each for ``mode='none'``); on a CPU tensor the same backward runs their
    plain versions.
    """
    from ..transforms.modwt import _resolve_discrete

    edge = _kernel_boundary(boundary, "fused_denoise_multilevel")
    if edge == "symmetric":
        return None
    _check_precision(precision)
    w = _resolve_discrete(wavelet)
    lead, n = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, n).contiguous()
    th_dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    th2 = thresholds.reshape(-1, thresholds.shape[-1]).to(th_dtype).contiguous()
    out = _Denoise.apply(
        x2, th2, levels, _kernel_filters(w, synthesis=False),
        _kernel_filters(w, synthesis=True), edge == "periodic", mode,
    )
    return out.reshape(lead + (n,))


def modwt_roundtrip_fused(
    x: torch.Tensor,
    wavelet,
    *,
    levels: int,
    boundary: str = "periodic",
    precision: str | None = None,
) -> torch.Tensor:
    """Fused analysis -> synthesis round trip in one kernel pass (the
    ``mode='none'`` case of the fused denoise): device memory sees only x in
    and x out.  Periodic or zero boundary; a symmetric boundary takes the
    two-call path (:func:`fused_analysis` then :func:`fused_synthesis`), as
    in the JAX package."""
    dummy = torch.zeros(x.shape[:-1] + (levels,), dtype=torch.float32, device=x.device)
    out = fused_denoise_multilevel(
        x, wavelet, levels=levels, thresholds=dummy, boundary=boundary,
        mode="none", precision=precision,
    )
    if out is None:
        details, approx = fused_analysis(x, wavelet, levels=levels, boundary=boundary,
                                         precision=precision)
        out = fused_synthesis(details, approx, wavelet, boundary=boundary,
                              precision=precision)
    return out
