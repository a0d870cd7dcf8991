"""The per-level cascade pair: ``run_analysis_mxu`` and ``run_synthesis_mxu``.

Counterpart of the cascade half of ``vectorwave_tpu/kernels/modwt_mxu.py``
(``run_analysis_mxu``, ``run_synthesis_mxu`` and the two Pallas kernels they
launch, which run the J-level à trous cascade level by level as banded
matmuls on 128-lane rows); :mod:`.modwt_composite` is the counterpart of the
composite half.  The per-level cascade is what the port's analysis and
synthesis kernels run, so the two wrappers launch those:

===========================  ======================  =========================
wrapper                      CUDA source             TPU kernel it replaces
===========================  ======================  =========================
:func:`run_analysis_mxu`     ``modwt_analysis.cu``   ``_mxu_analysis_call``
:func:`run_synthesis_mxu`    ``modwt_synthesis.cu``  ``_mxu_synthesis_call``
===========================  ======================  =========================

Their launches count under ``modwt_mxu_analysis`` and ``modwt_mxu_synthesis``
in :data:`.modwt_composite.LAUNCHES`.

``symmetric=True`` is the analysis kernel's mirror edge, whatever
``periodic`` says: before each level the approximation is reflected at the
signal start (half point), as the TPU kernel does in its first tile.  The
kernel serves N >= (L-1) 2^(J-1).  Below that the plain symmetric cascade,
which reflects again with period 2N, is the definition; the TPU kernel reads
its zero padding there and strays from it.

The TPU layout does not carry over: no band matrices, row shifts, 128-lane
row view or VMEM budget.  ``tile`` (a layout hint for the TPU kernels) and
``interpret`` (the CPU path is the plain version) are accepted and have no
effect: the kernels take their own tiles from the taps and levels (and, for
the mirror, at least (L-1) 2^(J-1)).  Every precision name runs the fp32
kernel, whose error is within each tier's contract, and an unknown one
raises.  The JAX pair has no gradient: a CUDA input that requires grad
raises, and the plain path on the CPU differentiates.
"""

from __future__ import annotations

import torch

from ..errors import ErrorCode, InvalidArgumentError
from . import modwt_composite
from .modwt_composite import _compute_dtype

PRECISIONS = ("float32", "bf16_3x", "bf16")


def _check_precision(precision) -> None:
    if precision not in PRECISIONS:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"unknown precision {precision!r}",
            suggestions=(f"Use one of {PRECISIONS}",),
        )


def _refuse_grad(entry: str, tensors) -> None:
    if (tensors[0].device.type == "cuda" and torch.is_grad_enabled()
            and any(t.requires_grad for t in tensors)):
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"{entry} has no gradient on the card",
            suggestions=("Run it under torch.no_grad(), or differentiate through "
                         "fused_analysis / fused_synthesis",),
        )


def analysis_plain(x, levels, filters, edge) -> tuple[torch.Tensor, ...]:
    """Plain version of :func:`cascade_analysis`: the zero or periodic
    cascade of :func:`.modwt_composite.analysis_plain`, or for the mirror
    the plain symmetric cascade (period 2N, so any N)."""
    if edge != "mirror":
        return modwt_composite.analysis_plain(x, levels, filters, edge == "periodic")
    from .modwt_symmetric import _symmetric_cascade

    planes = _symmetric_cascade(x.to(_compute_dtype(x)), filters, levels)
    return tuple(p.to(x.dtype) for p in planes)


def cascade_analysis(x, levels, filters, edge):
    """[B, N] -> (d_1, ..., d_J, a_J) with left edge ``edge`` (``'zero'``,
    ``'periodic'`` or ``'mirror'``): the plain version on a CPU tensor, one
    launch of the analysis kernel on a CUDA one."""
    if x.device.type == "cpu":
        return analysis_plain(x, levels, filters, edge)
    return modwt_composite.launch_analysis(x, levels, filters, edge, "modwt_mxu_analysis")


def run_analysis_mxu(x, levels, filters, periodic, tile, precision, interpret,
                     symmetric=False):
    """[B, N] float32 or bfloat16 -> the J+1 planes (d_1, ..., d_J, a_J);
    any N.  ``symmetric=True``: the per-level half-point mirror at the signal
    start, whatever ``periodic`` says."""
    _check_precision(precision)
    _refuse_grad("run_analysis_mxu", (x,))
    edge = "mirror" if symmetric else ("periodic" if periodic else "zero")
    return cascade_analysis(x, levels, filters, edge)


def run_synthesis_mxu(coeff_planes, levels, filters, periodic, tile, precision,
                      interpret):
    """J+1 [B, N] planes (d_1, ..., d_J, a_J) -> [B, N]; periodic or zero
    right edge, any N."""
    _check_precision(precision)
    planes = tuple(coeff_planes)
    _refuse_grad("run_synthesis_mxu", planes)
    if planes[0].device.type == "cpu":
        return modwt_composite.synthesis_plain(planes, levels, filters, periodic)
    return modwt_composite.launch_synthesis(planes, levels, filters, periodic,
                                            "modwt_mxu_synthesis")
