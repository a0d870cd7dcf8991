"""The multi-level MODWT filter-bank kernels: wrappers, plain versions and
launch counters.

Counterpart of the composite part of ``vectorwave_tpu/kernels/modwt_mxu.py``
(``run_analysis_composite``, ``run_synthesis_composite``,
``run_denoise_composite`` and the three Pallas kernels they launch) and of
the two Pallas kernels of ``vectorwave_tpu/kernels/modwt_exact.py``.  Each
kernel is a hand-written CUDA kernel for Hopper in ``csrc/``:

============================  =================================  =============================
wrapper                       CUDA source                        TPU kernel it replaces
============================  =================================  =============================
:func:`analysis`              ``modwt_analysis.cu``              ``_composite_analysis_call``
:func:`synthesis`             ``modwt_synthesis.cu``             ``_composite_synthesis_call``
:func:`denoise`               ``modwt_denoise.cu``               ``_composite_denoise_call``
:func:`exact_analysis`        ``modwt_exact_analysis.cu``        ``_exact_analysis_call``
:func:`exact_synthesis`       ``modwt_exact_synthesis.cu``       ``_exact_synthesis_call``
:func:`symmetric_synthesis`   ``modwt_symmetric_synthesis.cu``   ``_symsyn2_call``
:func:`symmetric_adjoint`     ``modwt_symmetric_synthesis.cu``   ``_symsyn_adjoint_kernel``
============================  =================================  =============================

The first two kernels also replace ``_mxu_analysis_call`` and
``_mxu_synthesis_call``, through the wrappers of :mod:`.modwt_cascade`,
which launch them with :func:`launch_analysis` (whose mirror edge is the
symmetric analysis) and :func:`launch_synthesis`.

A wrapper given a CPU tensor runs its plain version (``*_plain``), a cascade
of rolled sums in plain PyTorch; given a CUDA tensor it launches its kernel
or raises.  Each launch adds one to its entry of :data:`LAUNCHES`, so a run
can show that it went through the kernels; the 2-D level kernels of
:mod:`.modwt2` and the cascade wrappers count there too.

:func:`analysis` and :func:`denoise` take an external left ``halo``, ``[B,
H]`` raw samples just before each row (the streaming tier's carry, the JAX
package's ``run_analysis_composite(halo=)`` and
``run_denoise_composite_stream``): the row is extended by the halo on the
left, zeros before it, and zeros past N.  Their plain versions are the
zero-boundary cascade of ``[halo | x]`` sliced back to N (the denoise's
synthesis then block-local with zero coefficients past N).  Each mode counts
under its own entry of :data:`LAUNCHES` (``modwt_analysis_external``,
``modwt_denoise_stream``), as do the halos below.

:func:`synthesis` takes an external right ``halo``, one ``[B, H]`` tensor
per plane holding the samples just right of the plane's end (the JAX
package's ``run_synthesis_composite(halo=)``, the tiled tier's neighbour
exchange): each plane is extended by its halo on the right and by zeros
after it, and its plain version is the zero-boundary synthesis of ``[plane
| halo]`` sliced to the first N.  The exact pair takes the same two halos on
(hi, lo) pairs: :func:`exact_analysis` a ``[B, H]`` left halo of raw float32
samples whose lo word is zero, :func:`exact_synthesis` one ``(hi, lo)``
right-halo pair per plane.  No halo combines with a periodic boundary.

``filters`` arguments are ``(lo, hi)`` tuples of Python floats, already
scaled by 1/sqrt(2) per stage (``modwt_fused._kernel_filters``).  The
first three kernels and the symmetric pair compute in fp32 and store in the
input type (float32 or bfloat16); the plain versions of the first three
compute in float64 for float64 input and in float32 otherwise, those of the
symmetric pair always in float64 (their composed filters have hundreds to
~10^5 taps, whose float32 sum would stray further than the kernel's
cascade).  The exact pair reads and writes float32 (hi, lo) pairs
and computes in float64, as do its plain versions.

The symmetric pair takes ``ops``, one ``(a_sign, a_offset, d_sign,
d_offset)`` per level (``modwt_symmetric.symmetric_level_ops``): level j's
synthesis ops read ``c_j[t + a_sign 2^(j-1) l + a_offset]`` and
``d_j[t + d_sign 2^(j-1) l + d_offset]``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..errors import ErrorCode, InvalidArgumentError
from ..ops.constants import kept
from ..ops.convolve import atrous_analysis_pair, atrous_convolve
from ._build import library

#: Kernel launches since the last :func:`reset_launches`, by kernel and
#: mode.  The cascade wrappers of :mod:`.modwt_cascade` launch the analysis
#: and synthesis kernels too, and count under ``modwt_mxu_*``; the bank
#: kernels of :mod:`.modwt_bank` count under ``modwt_bank_*``.  A launch that
#: reads a neighbour's samples counts under its mode's own entry, not its
#: kernel's: the analysis's external left edge and the synthesis's external
#: right halo (``*_external``), the denoise's stream mode
#: (``modwt_denoise_stream``), the exact pair's halos (``*_halo``; a split
#: plan runs on the extended rows and counts as the plain launches).
LAUNCHES = {"modwt_analysis": 0, "modwt_synthesis": 0, "modwt_denoise": 0,
            "modwt_exact_analysis": 0, "modwt_exact_synthesis": 0,
            "modwt_symmetric_synthesis": 0, "modwt_symmetric_adjoint": 0,
            "modwt2_analysis": 0, "modwt2_synthesis": 0,
            "modwt_mxu_analysis": 0, "modwt_mxu_synthesis": 0,
            "modwt_bank_analysis": 0, "modwt_bank_synthesis": 0,
            "modwt_analysis_external": 0, "modwt_synthesis_external": 0,
            "modwt_denoise_stream": 0, "modwt_exact_analysis_halo": 0,
            "modwt_exact_synthesis_halo": 0}

#: Outputs per block, per kernel (the denoise kernel holds J planes of its
#: tile in shared memory, so its tile is smaller).  The cascade pair's, the
#: denoise's, the exact pair's and the symmetric synthesis's are preferred
#: tiles: the library clamps each to the row and halves it until a block
#: fits (``vw_modwt_analysis_tile``, ``vw_modwt_synthesis_tile``,
#: ``vw_modwt_denoise_tile``, ``vw_modwt_exact_analysis_tile``,
#: ``vw_modwt_exact_synthesis_tile``, ``vw_modwt_symmetric_synthesis_tile``).
#: Measured (tools/ab_port_kernels.py pair ptiles, config #2 and 128 / 1024
#: x 8192 on an H100): 4096 beats 2048 by a quarter in the analysis and a
#: tenth in the synthesis, larger tiles gain at most 3%.
ANALYSIS_TILE = 4096
SYNTHESIS_TILE = 4096
DENOISE_TILE = 1024
EXACT_TILE = 2048
#: The preferred launch tiles of the denoise kernel and of the exact
#: synthesis's window launches; the gates keep DENOISE_TILE's and
#: EXACT_TILE's rules.  Measured (tools/ab_port_kernels.py denoise dtiles
#: exactsyn xtiles, config #2 and 1024 x 8192 on an H100): the denoise at
#: 2048 is 1.5x faster than at 1024 (its window's 2 S recompute), the exact
#: synthesis at 4096 1.26x faster than at 2048.
DENOISE_LAUNCH_TILE = 2048
EXACT_SYNTHESIS_LAUNCH_TILE = 4096
#: The gates' symmetric tile (both directions) and the preferred tiles of
#: the symmetric synthesis's forward and adjoint launches and of the exact
#: analysis's window launches.  Measured (tools/ab_port_kernels.py symsyn
#: stiles symadj adjtiles exactana etiles, config #2 on an H100): the
#: symmetric synthesis at 4096 1.21x faster than at 2048 and 3% faster than
#: at 8192; its adjoint at 2048 / 3072 / 4096 / 8192 0.2187 / 0.1819 /
#: 0.1566 / 0.1562 ms (db4 J=6), sym8 J=8 0.4938 / 0.4530 / 0.3940 / 0.3276;
#: the exact analysis at 4096 1.11x faster than at 2048.
SYMMETRIC_TILE = 2048
SYMMETRIC_LAUNCH_TILE = 4096
SYMMETRIC_ADJOINT_LAUNCH_TILE = 8192
EXACT_ANALYSIS_LAUNCH_TILE = 4096
#: Ints per level of a symmetric plan (``kPlanStride`` in the CUDA source).
PLAN_STRIDE = 8
#: Dynamic shared memory one block may use on Hopper (227 KB).
SHARED_LIMIT = 232448

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = {"none": 0, "soft": 1, "hard": 2}
#: Left edges of the analysis kernel (``CascadeEdge`` in the CUDA source):
#: zero, periodic, the per-level mirror of the symmetric analysis, or an
#: external halo.
EDGES = {"zero": 0, "periodic": 1, "mirror": 2, "external": 3}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def composite_halo_samples(filter_length: int, levels: int) -> int:
    """Cumulative cascade support: (L0-1)(2^J - 1) samples."""
    return (filter_length - 1) * ((1 << levels) - 1)


def mirror_reach(filter_length: int, levels: int) -> int:
    """(L0-1) 2^(J-1): how far the deepest level reads before an output.  The
    analysis kernel's mirror mode serves n >= it (the reflection's sources
    lie in the signal) and needs a tile of at least it (they lie in block
    0's window)."""
    return (filter_length - 1) << (levels - 1)


def _upsample_filter(f: np.ndarray, s: int) -> np.ndarray:
    if s == 1:
        return np.asarray(f, dtype=np.float64)
    out = np.zeros((len(f) - 1) * s + 1, dtype=np.float64)
    out[::s] = f
    return out


def composite_plane_filters(
    low: np.ndarray, high: np.ndarray, levels: int
) -> list[np.ndarray]:
    """Causal composite filters [d1, ..., dJ, aJ]: d_j = g_j * h_{j-1} * ...
    * h_1 (à trous upsampled).  The kernels run the cascade instead of these
    filters; the composition documents what each plane is and lets tests
    check that the two agree."""
    comps = []
    acc = np.array([1.0])
    for j in range(1, levels + 1):
        s = 1 << (j - 1)
        comps.append(np.convolve(acc, _upsample_filter(high, s)))
        acc = np.convolve(acc, _upsample_filter(low, s))
    comps.append(acc)
    return comps


# --- shared-memory budget ---------------------------------------------------


def analysis_shared_bytes(taps: int, levels: int, tile: int = ANALYSIS_TILE) -> int:
    """The room the routers' gates ask of an analysis block: taps + two rows
    of tile + span.  The kernel's own layout (taps padded to steps of 8,
    rows on 16 bytes, detail staging where it fits) and its tile are the
    library's; it launches every shape this rule admits, which the card's
    tests hold for every filter length and depth."""
    return 4 * (2 * taps + 2 * (tile + composite_halo_samples(taps, levels)))


def analysis_tile(taps: int, levels: int, mirror: bool = False) -> int | None:
    """The gates' analysis tile: :data:`ANALYSIS_TILE` halved until
    :func:`analysis_shared_bytes` fits (None below 128); in mirror mode at
    least :func:`mirror_reach` (None where that does not fit)."""
    tile = _fitting_tile(lambda t: analysis_shared_bytes(taps, levels, t), ANALYSIS_TILE)
    if not mirror:
        return tile
    tile = max(tile or 0, mirror_reach(taps, levels))
    return tile if analysis_shared_bytes(taps, levels, tile) <= SHARED_LIMIT else None


def synthesis_shared_bytes(taps: int, levels: int, tile: int = SYNTHESIS_TILE) -> int:
    """The room the routers' gates ask of a synthesis block: taps + three
    rows of tile + span (the library's own layout, as for
    :func:`analysis_shared_bytes`)."""
    return 4 * (2 * taps + 3 * (tile + composite_halo_samples(taps, levels)))


def denoise_shared_bytes(taps: int, levels: int, tile: int = DENOISE_TILE) -> int:
    """The room the gates ask of a denoise block: both tap pairs, two rows
    of tile + 2 span and J plane rows of tile + span.  The kernel's own
    layout and tile are the library's (``vw_modwt_denoise_tile``); it
    launches every shape this rule admits, which the card's tests hold for
    every filter length and depth."""
    span = composite_halo_samples(taps, levels)
    return 4 * (4 * taps + 2 * (tile + 2 * span) + levels * (tile + span))


def denoise_tile(taps: int, levels: int) -> int | None:
    """The denoise kernel's tile: :data:`DENOISE_TILE` halved until one
    block fits shared memory (None below 128)."""
    return _fitting_tile(lambda t: denoise_shared_bytes(taps, levels, t), DENOISE_TILE)


def exact_analysis_shared_bytes(taps: int, levels: int, tile: int = EXACT_TILE,
                                first_level: int = 1) -> int:
    """The room :func:`exact_launches` asks of an exact analysis block:
    fp64 taps + two rows of tile + span, for the levels first_level ..
    first_level + levels - 1.  The kernel's layout and launch tile are the
    library's (``vw_modwt_exact_analysis_tile``); it launches every window
    launch of the plans, which the card's tests hold."""
    span = composite_halo_samples(taps, levels) << (first_level - 1)
    return 8 * (2 * taps + 2 * (tile + span))


def exact_synthesis_shared_bytes(taps: int, levels: int, tile: int = EXACT_TILE,
                                 first_level: int = 1) -> int:
    """The room :func:`exact_launches` asks of an exact synthesis block:
    fp64 taps + three rows of tile + span.  The kernel's layout and launch
    tile are the library's (``vw_modwt_exact_synthesis_tile``); it launches
    every window launch of the plans, which the card's tests hold."""
    span = composite_halo_samples(taps, levels) << (first_level - 1)
    return 8 * (2 * taps + 3 * (tile + span))


def _reach(sign: int, offset: int, spacing: int, taps: int) -> tuple[int, int]:
    """Least and greatest read offset of ``in[t + sign*spacing*l + offset]``."""
    far = offset + sign * spacing * (taps - 1)
    return min(offset, far), max(offset, far)


@functools.lru_cache(maxsize=256)
def symmetric_spans(taps: int, ops: tuple) -> tuple[int, int]:
    """(span_l, span_r) of the symmetric synthesis: how far the composed
    plane filters read before and after an output (G and d_max of
    ``modwt_symmetric._rebase``, which the first and last outputs splice)."""
    lo = hi = 0
    starts, ends = [], []
    for j, (sa, oa, sd, od) in enumerate(ops, start=1):
        s = 1 << (j - 1)
        dlo, dhi = _reach(sd, od, s, taps)
        starts.append(lo + dlo)
        ends.append(hi + dhi)
        alo, ahi = _reach(sa, oa, s, taps)
        lo, hi = lo + alo, hi + ahi
    starts.append(lo)
    ends.append(hi)
    return max(0, -min(starts)), max(0, max(ends))


@functools.lru_cache(maxsize=256)
def symmetric_plan(taps: int, ops: tuple, tile: int, adjoint: bool):
    """The windows of the symmetric kernel, ``(plan, width)``: PLAN_STRIDE
    ints per level (see ``csrc/modwt_symmetric_synthesis.cu``) and the
    longest window.  Windows are relative to a block's first output and hold
    every value the level needs, unclipped to [0, n)."""
    levels = len(ops)
    plan = [0] * (PLAN_STRIDE * levels)
    width = tile
    if not adjoint:  # coarse <- fine: c_j and d_j windows from c_{j-1}'s
        e, length = 0, tile
        for j, (sa, oa, sd, od) in enumerate(ops, start=1):
            s = 1 << (j - 1)
            alo, ahi = _reach(sa, oa, s, taps)
            dlo, dhi = _reach(sd, od, s, taps)
            ej, ed = e + alo, e + dlo
            plan[PLAN_STRIDE * (j - 1): PLAN_STRIDE * j] = [
                ej, length + ahi - alo, ed, e + oa - ej, sa * s, e + od - ed, sd * s, 0]
            width = max(width, length + ahi - alo, length + dhi - dlo)
            e, length = ej, length + ahi - alo
        return tuple(plan), width
    e, length = 0, tile  # v_J; v_{j-1} holds what v_j and grad d_j read
    for j in range(levels, 0, -1):
        sa, oa, sd, od = ops[j - 1]
        s = 1 << (j - 1)
        alo, ahi = _reach(sa, oa, s, taps)
        dlo, dhi = _reach(sd, od, s, taps)
        first = min(e - ahi, -dhi)
        last = max(e + length - 1 - alo, tile - 1 - dlo)
        plan[PLAN_STRIDE * (j - 1): PLAN_STRIDE * j] = [
            first, last - first + 1, e - oa - first, -sa * s, -od - first, -sd * s, 0, 0]
        width = max(width, last - first + 1)
        e, length = first, last - first + 1
    return tuple(plan), width


def symmetric_shared_bytes(taps: int, ops: tuple, tile: int, adjoint: bool) -> int:
    """The room the gates ask of a symmetric block: taps + three rows of the
    widest window (two in adjoint mode).  The kernels' layouts and launch
    tiles are the library's (``vw_modwt_symmetric_synthesis_tile``,
    ``vw_modwt_symmetric_adjoint_tile``); they launch every shape this rule
    admits, which the card's tests hold."""
    width = symmetric_plan(taps, ops, tile, adjoint)[1]
    return 4 * (2 * taps + (2 if adjoint else 3) * width)


def symmetric_tile(taps: int, ops: tuple, adjoint: bool) -> int | None:
    """The symmetric kernel's tile, halved from SYMMETRIC_TILE until a block
    fits shared memory (None below 128)."""
    return _fitting_tile(lambda t: symmetric_shared_bytes(taps, ops, t, adjoint),
                         SYMMETRIC_TILE)


def kernels_fit(taps: int, levels: int) -> bool:
    """Whether the cascade pair fits one block's shared memory at a tile of
    2048, its first tile (the H100 counterpart of the JAX router's halo
    check): the analysis and the synthesis, each the other's backward, so a
    route of either direction asks for both.  The fused denoise asks for its
    own room (:func:`denoise_tile`)."""
    return max(
        analysis_shared_bytes(taps, levels, 2048),
        synthesis_shared_bytes(taps, levels, 2048),
    ) <= SHARED_LIMIT


# --- plain versions -----------------------------------------------------------


def _compute_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _boundary(periodic: bool) -> str:
    return "periodic" if periodic else "zero"


def _analysis_cascade(x, levels, filters, periodic, first_level=1) -> list[torch.Tensor]:
    """[d_1, ..., d_J, a_J] in the compute dtype, unrounded (the cascade may
    start at ``first_level``, stride 2^(first_level-1))."""
    lo, hi = filters
    cur = x.to(_compute_dtype(x))
    planes = []
    for level in range(first_level, first_level + levels):
        cur, detail = atrous_analysis_pair(
            cur, lo, hi, spacing=1 << (level - 1), boundary=_boundary(periodic)
        )
        planes.append(detail)
    planes.append(cur)
    return planes


def _synthesis_cascade(planes, levels, filters, periodic, first_level=1) -> torch.Tensor:
    lo, hi = filters
    cd = _compute_dtype(planes[-1])
    cur = planes[levels].to(cd)
    for i in range(levels - 1, -1, -1):
        spacing = 1 << (first_level - 1 + i)
        cur = atrous_convolve(
            cur, lo, spacing=spacing, boundary=_boundary(periodic), sign=+1
        ) + atrous_convolve(
            planes[i].to(cd), hi, spacing=spacing,
            boundary=_boundary(periodic), sign=+1,
        )
    return cur


def _external_cascade(x, halo, levels, filters) -> list[torch.Tensor]:
    """The zero-boundary cascade of ``[halo | x]``, sliced back to x's N."""
    h = halo.shape[-1]
    planes = _analysis_cascade(torch.cat([halo.to(x.dtype), x], dim=-1), levels,
                               filters, False)
    return [p[..., h:] for p in planes]


def analysis_plain(x, levels, filters, periodic, head=None, halo=None
                   ) -> tuple[torch.Tensor, ...]:
    """Plain version of :func:`analysis`: the per-level cascade as rolled sums
    (of ``[halo | x]`` with a zero edge, sliced back to N, given a halo),
    with each plane's first ``head.shape[-1]`` outputs taken from ``head``."""
    if halo is not None:
        _refuse_periodic_halo(periodic)
        planes = _external_cascade(x, halo, levels, filters)
    else:
        planes = _analysis_cascade(x, levels, filters, periodic)
    if head is not None:
        cut = head.shape[-1]
        planes = [torch.cat([h.to(p.dtype), p[..., cut:]], dim=-1)
                  for h, p in zip(head, planes)]
    return tuple(p.to(x.dtype) for p in planes)


def _right_extended(planes, halo) -> list[torch.Tensor]:
    """Each plane followed by its right halo."""
    return [torch.cat([p, h.to(p.dtype)], dim=-1) for p, h in zip(planes, halo)]


def synthesis_plain(planes, levels, filters, periodic, halo=None) -> torch.Tensor:
    """Plain version of :func:`synthesis` (given a right ``halo``, the
    zero-boundary synthesis of each ``[plane | halo]``, sliced to N)."""
    if halo is None:
        return _synthesis_cascade(planes, levels, filters, periodic).to(planes[0].dtype)
    _check_halo_count(halo, levels)
    _refuse_periodic_halo(periodic)
    n = planes[0].shape[-1]
    out = _synthesis_cascade(_right_extended(planes, halo), levels, filters, False)
    return out[..., :n].to(planes[0].dtype)


def _combine(hi: torch.Tensor, lo: torch.Tensor | None) -> torch.Tensor:
    v = hi.to(torch.float64)
    return v if lo is None else v + lo.to(torch.float64)


def _split_pair(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float64 -> float32 (hi, lo): hi the rounded value, lo the rounded rest."""
    hi = v.to(torch.float32)
    return hi, (v - hi.to(torch.float64)).to(torch.float32)


def exact_analysis_plain(x, x_lo, levels, filters, periodic, first_level=1, halo=None):
    """Plain version of :func:`exact_analysis`: the float64 cascade of
    hi + lo (of ``[halo | x]`` with a zero edge, sliced back to N, given a
    left halo), each plane split into a float32 pair."""
    v = _combine(x, x_lo)
    if halo is None:
        planes = _analysis_cascade(v, levels, filters, periodic, first_level)
    else:
        _refuse_periodic_halo(periodic)
        h = halo.shape[-1]
        planes = _analysis_cascade(torch.cat([halo.to(torch.float64), v], dim=-1), levels,
                                   filters, False, first_level)
        planes = [p[..., h:] for p in planes]
    return tuple(_split_pair(p) for p in planes)


def exact_synthesis_plain(pairs, levels, filters, periodic, first_level=1, halo=None):
    """Plain version of :func:`exact_synthesis` (given right halo pairs,
    the zero-boundary synthesis of each ``[plane | halo]``, sliced to N)."""
    planes = [_combine(hi, lo) for hi, lo in pairs]
    if halo is None:
        return _split_pair(_synthesis_cascade(planes, levels, filters, periodic,
                                              first_level))
    _check_halo_count(halo, levels)
    _refuse_periodic_halo(periodic)
    n = planes[0].shape[-1]
    ext = _right_extended(planes, [_combine(hi, lo) for hi, lo in halo])
    return _split_pair(_synthesis_cascade(ext, levels, filters, False, first_level)[..., :n])


def _dense_plane_filters(filters, ops):
    from .modwt_symmetric import _rebase, plane_filters

    return _rebase(plane_filters(filters, ops))


def symmetric_synthesis_plain(planes, head, tail, levels, filters, ops) -> torch.Tensor:
    """Plain version of :func:`symmetric_synthesis`, its definition: every
    plane, zero outside [0, n), filtered by its rebased composed filter,
    ``out[t] = sum_p sum_tau f'_p[tau] plane_p[t + tau - G]``, summed in
    float64; then the first span_l outputs come from ``head`` and the last
    span_r from ``tail``."""
    dense, g, d_max = _dense_plane_filters(filters, ops)
    cd = torch.float64
    n = planes[0].shape[-1]
    right = max(d_max, 0)
    out = None
    for f, plane in zip(dense, planes):
        padded = torch.nn.functional.pad(plane.to(cd), (g, right))
        for tau, v in enumerate(f):
            if v != 0.0:
                term = padded[..., tau : tau + n] * v
                out = term if out is None else out + term
    span_l, span_r = g, right
    out = torch.cat([head.to(cd), out[..., span_l : n - span_r], tail.to(cd)], dim=-1)
    return out.to(planes[0].dtype)


def _interior(c: torch.Tensor, span_l: int, span_r: int) -> torch.Tensor:
    """c with its first span_l and last span_r samples zeroed."""
    n = c.shape[-1]
    idx = torch.arange(n, device=c.device)
    return c * ((idx >= span_l) & (idx < n - span_r))


def symmetric_adjoint_plain(c, levels, filters, ops, span_l: int = 0,
                            span_r: int = 0) -> tuple[torch.Tensor, ...]:
    """Plain version of :func:`symmetric_adjoint`, the transpose of the body
    of :func:`symmetric_synthesis_plain`:
    ``grad_p[q] = sum_tau f'_p[tau] c[q - tau + G]``, c zero outside its
    interior [span_l, n - span_r), summed in float64."""
    dense, g, _ = _dense_plane_filters(filters, ops)
    cd = torch.float64
    n = c.shape[-1]
    pad = max(len(f) for f in dense) + g
    padded = torch.nn.functional.pad(_interior(c, span_l, span_r).to(cd), (pad, pad))
    grads = []
    for f in dense:
        acc = torch.zeros_like(padded[..., :n])
        for tau, v in enumerate(f):
            if v != 0.0:
                start = pad - tau + g
                acc = acc + padded[..., start : start + n] * v
        grads.append(acc.to(c.dtype))
    return tuple(grads)


def _shrink(d: torch.Tensor, t: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "soft":  # d - clamp(d, -t, t) == sign(d) max(|d| - t, 0)
        return d - torch.minimum(torch.maximum(d, -t), t)
    if mode == "hard":
        return torch.where(d.abs() > t, d, torch.zeros_like(d))
    return d


def denoise_plain(x, thresholds, levels, filters_dec, filters_rec, periodic, mode,
                  halo=None):
    """Plain version of :func:`denoise`: analysis (of ``[halo | x]`` with a
    zero edge, sliced back to N, given a halo), per-(signal, level) threshold
    of the unrounded detail planes, synthesis on N samples."""
    if halo is not None:
        _refuse_periodic_halo(periodic)
        planes = _external_cascade(x, halo, levels, filters_dec)
    else:
        planes = _analysis_cascade(x, levels, filters_dec, periodic)
    th = thresholds.to(planes[0].dtype)
    shrunk = [
        _shrink(planes[j], th[:, j : j + 1], mode) for j in range(levels)
    ] + [planes[levels]]
    return _synthesis_cascade(shrunk, levels, filters_rec, periodic).to(x.dtype)


# --- kernel launches ---------------------------------------------------------------


def _fitting_tile(bytes_of_tile, preferred: int) -> int | None:
    """The preferred tile, halved until the block fits shared memory (None
    below 128)."""
    tile = preferred
    while tile >= 128:
        if bytes_of_tile(tile) <= SHARED_LIMIT:
            return tile
        tile //= 2
    return None


def _too_large(taps: int, levels: int) -> InvalidArgumentError:
    return InvalidArgumentError(
        ErrorCode.VAL_TOO_LARGE,
        "The cascade halo does not fit the kernel's shared memory",
        context={"taps": taps, "levels": levels},
        suggestions=("Use fewer levels or backend='torch'",),
    )


def _tile(bytes_fn, taps: int, levels: int, preferred: int) -> int:
    """The preferred tile, halved until the block fits shared memory."""
    tile = _fitting_tile(lambda t: bytes_fn(taps, levels, t), preferred)
    if tile is not None:
        return tile
    raise _too_large(taps, levels)


def _check_operand(t: torch.Tensor, what: str, device=None) -> None:
    if t.device.type != "cuda":
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"{what} must be a CUDA tensor for the kernel, got {t.device}",
        )
    if device is not None and t.device != device:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"{what} is on {t.device}, expected {device}",
        )
    if t.dim() != 2 or not t.is_contiguous():
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"{what} must be a contiguous [batch, n] tensor",
            context={"shape": tuple(t.shape), "contiguous": t.is_contiguous()},
        )


def _check_dtype(t: torch.Tensor, what: str) -> int:
    code = _DTYPE_CODES.get(t.dtype)
    if code is None:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"{what} must be float32 or bfloat16 for the kernel, got {t.dtype}",
        )
    return code


def _refuse_periodic_halo(periodic: bool) -> None:
    if periodic:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            "an external halo is the row's edge; it does not combine with a "
            "periodic boundary",
            suggestions=("Pass periodic=False with halo=",),
        )


def _check_halo_count(halo, levels: int) -> None:
    """A right halo is one entry per plane."""
    if len(halo) != levels + 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"expected one right halo per plane ({levels + 1}), got {len(halo)}",
        )


def _halo_width(halos, like: torch.Tensor) -> int:
    """Check CUDA right halos against the first plane, all of one width;
    returns that width."""
    widths = {_check_halo(h, like) for h in halos}
    if len(widths) != 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            "every plane's right halo must have the same width",
            context={"widths": sorted(widths)},
        )
    return widths.pop()


def _check_halo(halo: torch.Tensor, x: torch.Tensor) -> int:
    """Check a CUDA halo against x: a contiguous [batch, H] tensor, H >= 1,
    on x's device and of x's dtype; returns H."""
    _check_operand(halo, "halo", x.device)
    if halo.dtype != x.dtype or halo.shape[0] != x.shape[0] or halo.shape[1] < 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"halo must be a [{x.shape[0]}, H >= 1] tensor of x's dtype {x.dtype}",
            context={"shape": tuple(halo.shape), "dtype": halo.dtype},
        )
    return halo.shape[1]


def _check_levels(levels: int) -> None:
    if not 1 <= levels <= 10:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL, f"levels must be in [1, 10], got {levels}"
        )


@functools.lru_cache(maxsize=64)
@kept
def _device_taps(taps: tuple, device_index: int,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.tensor(taps, dtype=dtype, device=f"cuda:{device_index}")


def _raise_on_error(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed with CUDA error {err}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def analysis(x, levels, filters, periodic, head=None, halo=None
             ) -> tuple[torch.Tensor, ...]:
    """[B, N] -> (d_1, ..., d_J, a_J); periodic or zero boundary, any N.

    ``head``, a float32 ``[J+1, B, H]`` tensor with H <= N, splices each
    plane's first H outputs in the kernel.  ``halo``, ``[B, H]`` of x's
    dtype, is the external left edge (``periodic`` must be False): the
    kernel's ``external`` edge."""
    if x.device.type == "cpu":
        return analysis_plain(x, levels, filters, periodic, head, halo)
    if halo is not None:
        _refuse_periodic_halo(periodic)
    edge = _boundary(periodic) if halo is None else "external"
    return launch_analysis(x, levels, filters, edge, "modwt_analysis", head=head,
                           halo=halo)


def launch_analysis(x, levels, filters, edge, counter, head=None, halo=None):
    """Launch the analysis kernel on a CUDA ``x`` with left edge ``edge``
    (:data:`EDGES`) at the library's tile for :data:`ANALYSIS_TILE`, adding one to
    ``LAUNCHES[counter]`` (the external edge's to
    ``LAUNCHES["modwt_analysis_external"]``); the mirror edge takes
    N >= :func:`mirror_reach`, the external edge (and only it) a ``[B, H]``
    ``halo`` of x's dtype."""
    _check_operand(x, "x")
    code = _check_dtype(x, "x")
    _check_levels(levels)
    if edge not in EDGES or (edge == "external") != (halo is not None):
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"edge {edge!r}: the external edge, and only it, takes a halo",
            suggestions=(f"Use one of {tuple(EDGES)}",),
        )
    halo_len = 0 if halo is None else _check_halo(halo, x)
    taps = len(filters[0])
    mirror = edge == "mirror"
    if mirror and x.shape[1] < mirror_reach(taps, levels):
        raise InvalidArgumentError(
            ErrorCode.VAL_TOO_SHORT,
            "The mirror edge serves signals of at least (L-1) 2^(J-1) samples",
            context={"n": x.shape[1], "taps": taps, "levels": levels},
            suggestions=("Use the plain symmetric cascade for shorter signals",),
        )
    head_samples = 0
    if head is not None:
        if (head.device != x.device or head.dtype != torch.float32
                or not head.is_contiguous() or head.dim() != 3
                or head.shape[:2] != (levels + 1, x.shape[0])
                or not 0 < head.shape[2] <= x.shape[1]):
            raise InvalidArgumentError(
                ErrorCode.VAL_INVALID_SHAPE,
                "head must be a contiguous float32 [levels + 1, batch, H] tensor "
                "on x's device, 0 < H <= n",
                context={"shape": tuple(head.shape), "dtype": head.dtype},
            )
        head_samples = head.shape[2]
    lib = library()
    b, n = x.shape
    tile = lib.vw_modwt_analysis_tile(taps, levels, n, ANALYSIS_TILE, EDGES[edge])
    if not tile:
        raise _too_large(taps, levels)
    outs = [torch.empty_like(x) for _ in range(levels + 1)]
    out_ptrs = (ctypes.c_void_p * (levels + 1))(*[o.data_ptr() for o in outs])
    tap_t = _device_taps(tuple(filters[0]) + tuple(filters[1]), x.device.index)
    with torch.cuda.device(x.device):
        err = lib.vw_modwt_analysis(
            x.data_ptr(), out_ptrs, tap_t.data_ptr(),
            None if head is None else head.data_ptr(), head_samples,
            None if halo is None else halo.data_ptr(), halo_len, b, n, levels,
            taps, tile, EDGES[edge], code, _stream(x.device),
        )
    _raise_on_error(err, counter)
    LAUNCHES["modwt_analysis_external" if halo is not None else counter] += 1
    return tuple(outs)


def _check_planes(planes) -> int:
    """Check that the planes are CUDA [B, N] tensors of one shape and dtype;
    returns the dtype code."""
    first = planes[0]
    _check_operand(first, "plane 0")
    code = _check_dtype(first, "plane 0")
    for i, p in enumerate(planes):
        _check_operand(p, f"plane {i}", first.device)
        if p.dtype != first.dtype or p.shape != first.shape:
            raise InvalidArgumentError(
                ErrorCode.VAL_INVALID_SHAPE,
                "all planes must share shape and dtype",
                context={"plane": i, "shape": tuple(p.shape), "dtype": p.dtype},
            )
    return code


def synthesis(planes, levels, filters, periodic, halo=None) -> torch.Tensor:
    """(d_1, ..., d_J, a_J), each [B, N] -> [B, N]; periodic or zero.
    ``halo``, J+1 ``[B, H]`` tensors of the planes' dtype, is the external
    right edge (``periodic`` must be False)."""
    if planes[0].device.type == "cpu":
        return synthesis_plain(planes, levels, filters, periodic, halo)
    return launch_synthesis(planes, levels, filters, periodic, "modwt_synthesis", halo)


def launch_synthesis(planes, levels, filters, periodic, counter, halo=None):
    """Launch the synthesis kernel on CUDA planes, adding one to
    ``LAUNCHES[counter]``; ``halo``, one ``[B, H]`` tensor per plane, is the
    external right edge (its launches count under
    ``LAUNCHES["modwt_synthesis_external"]``)."""
    if len(planes) != levels + 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"expected {levels + 1} planes, got {len(planes)}",
        )
    first = planes[0]
    code = _check_planes(planes)
    _check_levels(levels)
    halo_len = 0
    if halo is not None:
        _check_halo_count(halo, levels)
        _refuse_periodic_halo(periodic)
        halo_len = _halo_width(halo, first)
    taps = len(filters[0])
    lib = library()
    b, n = first.shape
    tile = lib.vw_modwt_synthesis_tile(taps, levels, n, SYNTHESIS_TILE)
    if not tile:
        raise _too_large(taps, levels)
    out = torch.empty_like(first)
    in_ptrs = (ctypes.c_void_p * (levels + 1))(*[p.data_ptr() for p in planes])
    halo_ptrs = (None if halo is None else
                 (ctypes.c_void_p * (levels + 1))(*[h.data_ptr() for h in halo]))
    tap_t = _device_taps(tuple(filters[0]) + tuple(filters[1]), first.device.index)
    with torch.cuda.device(first.device):
        err = lib.vw_modwt_synthesis(
            in_ptrs, halo_ptrs, halo_len, out.data_ptr(), tap_t.data_ptr(), b, n,
            levels, taps, tile, int(periodic), code, _stream(first.device),
        )
    _raise_on_error(err, counter)
    LAUNCHES["modwt_synthesis_external" if halo is not None else counter] += 1
    return out


def denoise(x, thresholds, levels, filters_dec, filters_rec, periodic, mode,
            halo=None):
    """[B, N] x and [B, J] float32 thresholds -> [B, N]: analysis, soft/hard
    threshold per (signal, level) (``mode='none'``: the round trip),
    synthesis; periodic or zero.  ``halo``, ``[B, H]`` of x's dtype, is the
    stream mode (``periodic`` must be False): the raw samples left of each
    row feed the analysis, and the synthesis stays block-local."""
    if mode not in _MODES:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"Unknown threshold mode {mode!r}",
            suggestions=("Use 'none', 'soft' or 'hard'",),
        )
    if halo is not None:
        _refuse_periodic_halo(periodic)
    if x.device.type == "cpu":
        return denoise_plain(
            x, thresholds, levels, filters_dec, filters_rec, periodic, mode, halo
        )
    _check_operand(x, "x")
    code = _check_dtype(x, "x")
    halo_len = 0 if halo is None else _check_halo(halo, x)
    _check_operand(thresholds, "thresholds", x.device)
    if thresholds.dtype != torch.float32 or thresholds.shape != (x.shape[0], levels):
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            "thresholds must be float32 of shape [batch, levels]",
            context={"shape": tuple(thresholds.shape), "dtype": thresholds.dtype},
        )
    _check_levels(levels)
    taps = len(filters_dec[0])
    if len(filters_rec[0]) != taps:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            "analysis and synthesis filters must have the same length",
        )
    _tile(denoise_shared_bytes, taps, levels, DENOISE_TILE)  # the gate: raises where none fits
    lib = library()
    b, n = x.shape
    tile = lib.vw_modwt_denoise_tile(taps, levels, n, DENOISE_LAUNCH_TILE)
    if not tile:
        raise _too_large(taps, levels)
    out = torch.empty_like(x)
    tap_t = _device_taps(
        tuple(filters_dec[0]) + tuple(filters_dec[1])
        + tuple(filters_rec[0]) + tuple(filters_rec[1]),
        x.device.index,
    )
    with torch.cuda.device(x.device):
        err = lib.vw_modwt_denoise(
            x.data_ptr(), out.data_ptr(), thresholds.data_ptr(), tap_t.data_ptr(),
            None if halo is None else halo.data_ptr(), halo_len, b, n, levels, taps,
            tile, int(periodic), _MODES[mode], code, _stream(x.device),
        )
    _raise_on_error(err, "modwt_denoise")
    LAUNCHES["modwt_denoise_stream" if halo is not None else "modwt_denoise"] += 1
    return out


# --- the symmetric tier ------------------------------------------------------------


def _symmetric_launch_tile(taps: int, ops: tuple, adjoint: bool) -> int:
    tile = symmetric_tile(taps, ops, adjoint)
    if tile is None:
        raise InvalidArgumentError(
            ErrorCode.VAL_TOO_LARGE,
            "The symmetric windows do not fit the kernel's shared memory",
            context={"taps": taps, "levels": len(ops)},
            suggestions=("Use fewer levels or backend='torch'",),
        )
    return tile


def _check_symmetric(levels: int, filters, ops) -> int:
    _check_levels(levels)
    if len(ops) != levels or len(filters[0]) != len(filters[1]):
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            "ops must have one entry per level and the filters one length",
            context={"levels": levels, "ops": len(ops)},
        )
    return len(filters[0])


def symmetric_synthesis(planes, head, tail, levels, filters, ops) -> torch.Tensor:
    """(d_1, ..., d_J, a_J), each [B, N] -> [B, N]: the alignment-shifted
    symmetric inverse body on zero-extended planes, with the first span_l
    outputs from ``head`` ([B, span_l]) and the last span_r from ``tail``
    ([B, span_r]), both float32 (:func:`symmetric_spans`)."""
    if planes[0].device.type == "cpu":
        return symmetric_synthesis_plain(planes, head, tail, levels, filters, ops)
    if len(planes) != levels + 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"expected {levels + 1} planes, got {len(planes)}",
        )
    first = planes[0]
    code = _check_planes(planes)
    taps = _check_symmetric(levels, filters, ops)
    span_l, span_r = symmetric_spans(taps, tuple(ops))
    b, n = first.shape
    for t, span, what in ((head, span_l, "head"), (tail, span_r, "tail")):
        if (t.device != first.device or t.dtype != torch.float32
                or not t.is_contiguous() or t.shape != (b, span)):
            raise InvalidArgumentError(
                ErrorCode.VAL_INVALID_SHAPE,
                f"{what} must be a contiguous float32 [{b}, {span}] tensor on the "
                "planes' device",
                context={"shape": tuple(t.shape), "dtype": t.dtype},
            )
    if span_l + span_r > n:
        raise InvalidArgumentError(
            ErrorCode.VAL_TOO_SHORT,
            "the head and tail splices overlap",
            context={"span_l": span_l, "span_r": span_r, "n": n},
        )
    _symmetric_launch_tile(taps, tuple(ops), False)  # the gate: raises where none fits
    lib = library()
    tile = lib.vw_modwt_symmetric_synthesis_tile(taps, levels, n, SYMMETRIC_LAUNCH_TILE)
    if not tile:
        raise _too_large(taps, levels)
    plan, width = symmetric_plan(taps, tuple(ops), tile, False)
    out = torch.empty_like(first)
    in_ptrs = (ctypes.c_void_p * (levels + 1))(*[p.data_ptr() for p in planes])
    tap_t = _device_taps(tuple(filters[0]) + tuple(filters[1]), first.device.index)
    plan_t = _device_taps(plan, first.device.index, torch.int32)
    with torch.cuda.device(first.device):
        err = lib.vw_modwt_symmetric_synthesis(
            in_ptrs, out.data_ptr(), head.data_ptr(), tail.data_ptr(), tap_t.data_ptr(),
            plan_t.data_ptr(), b, n, levels, taps, tile, width, span_l, span_r, 0,
            code, _stream(first.device),
        )
    _raise_on_error(err, "modwt_symmetric_synthesis")
    LAUNCHES["modwt_symmetric_synthesis"] += 1
    return out


def symmetric_adjoint(c, levels, filters, ops, span_l: int = 0,
                      span_r: int = 0) -> tuple[torch.Tensor, ...]:
    """[B, N] -> J+1 planes: the transpose of :func:`symmetric_synthesis`'s
    body (no splice), the gradient of the body with respect to the planes;
    ``c`` is read as zero outside its interior [span_l, n - span_r), the
    outputs the body gives (the kernel reads it so, with no mask pass)."""
    if c.device.type == "cpu":
        return symmetric_adjoint_plain(c, levels, filters, ops, span_l, span_r)
    _check_operand(c, "c")
    code = _check_dtype(c, "c")
    taps = _check_symmetric(levels, filters, ops)
    b, n = c.shape
    if span_l < 0 or span_r < 0 or span_l + span_r > n:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            "the interior spans must be non-negative and fit the row",
            context={"span_l": span_l, "span_r": span_r, "n": n},
        )
    _symmetric_launch_tile(taps, tuple(ops), True)  # the gate: raises where none fits
    lib = library()
    tile = lib.vw_modwt_symmetric_adjoint_tile(taps, levels, n, SYMMETRIC_ADJOINT_LAUNCH_TILE)
    if not tile:
        raise _too_large(taps, levels)
    plan, width = symmetric_plan(taps, tuple(ops), tile, True)
    outs = [torch.empty_like(c) for _ in range(levels + 1)]
    out_ptrs = (ctypes.c_void_p * (levels + 1))(*[o.data_ptr() for o in outs])
    tap_t = _device_taps(tuple(filters[0]) + tuple(filters[1]), c.device.index)
    plan_t = _device_taps(plan, c.device.index, torch.int32)
    with torch.cuda.device(c.device):
        err = lib.vw_modwt_symmetric_synthesis(
            out_ptrs, c.data_ptr(), None, None, tap_t.data_ptr(), plan_t.data_ptr(),
            b, n, levels, taps, tile, width, span_l, span_r, 1, code, _stream(c.device),
        )
    _raise_on_error(err, "modwt_symmetric_adjoint")
    LAUNCHES["modwt_symmetric_adjoint"] += 1
    return tuple(outs)


# --- the exact tier -------------------------------------------------------------


def _refuse_grad(*tensors) -> None:
    """The exact tier has no gradient (the JAX package defines none): an
    input that requires grad under grad mode raises on every device."""
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    ):
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            "The exact tier has no gradient: its (hi, lo) planes are not "
            "differentiable",
            suggestions=("Run it under torch.no_grad() on a detached input, or "
                         "differentiate through the float32 tier",),
        )


def exact_launches(bytes_fn, taps: int, levels: int, first_level: int = 1):
    """Split the levels first_level .. first_level + levels - 1 into kernel
    launches ``[(first, count, tile, direct), ...]``, fine to coarse.  Each
    launch takes as many levels as fit one block's shared memory at a tile
    of at least 128; the next continues from its approximation pair, which
    adds at most 2^-48 relative.  A level whose halo alone does not fit runs
    ``direct``: one level, its inputs read from device memory."""
    plan = []
    j, end = first_level, first_level + levels
    while j < end:
        for count in range(end - j, 0, -1):
            tile = _fitting_tile(lambda t: bytes_fn(taps, count, t, j), EXACT_TILE)
            if tile is not None:
                plan.append((j, count, tile, False))
                break
        else:
            count = 1
            plan.append((j, count, EXACT_TILE, True))
        j += count
    return plan


def _check_exact_levels(levels: int, first_level: int) -> None:
    if levels < 1 or first_level < 1 or first_level + levels - 1 > 10:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL,
            "the exact kernels serve levels 1 to 10",
            context={"first_level": first_level, "levels": levels},
        )


def _check_pair(hi: torch.Tensor, lo: torch.Tensor | None, what: str, like=None) -> None:
    like = hi if like is None else like
    for t, word in ((hi, "hi"), (lo, "lo")):
        if t is None:
            continue
        _check_operand(t, f"{what} {word}", like.device)
        if t.dtype != torch.float32 or t.shape != like.shape:
            raise InvalidArgumentError(
                ErrorCode.VAL_INVALID_SHAPE,
                f"{what} {word} must be float32 of shape {tuple(like.shape)}",
                context={"shape": tuple(t.shape), "dtype": t.dtype},
            )


def _one_window(plan) -> bool:
    """Whether an exact launch plan is one window launch: only then does a
    halo go to the kernel's load rule (a later launch of a split plan would
    read an approximation pair the neighbour never sent)."""
    return len(plan) == 1 and not plan[0][3]


def exact_analysis(x, x_lo, levels, filters, periodic, first_level=1, halo=None):
    """[B, N] float32 x (with an optional lo word ``x_lo``) -> ``levels + 1``
    float32 (hi, lo) pairs (d_first .. d_last, a_last), computed in fp64;
    periodic or zero boundary, any N.  The cascade starts at ``first_level``
    (stride 2^(first_level-1)).

    ``halo``, ``[B, H]`` float32 raw samples just left of each row (lo word
    zero), is the external left edge (``periodic`` must be False).  A plan
    of one window launch reads it through the kernel's load rule; a split
    plan (several launches, or ``direct``) runs on ``[halo | x]``, the halo
    cut to the span, with zero edges, and slices each plane back to N."""
    _refuse_grad(x, x_lo, halo)
    if x.device.type == "cpu":
        return exact_analysis_plain(x, x_lo, levels, filters, periodic, first_level, halo)
    _check_pair(x, x_lo, "x")
    _check_exact_levels(levels, first_level)
    taps = len(filters[0])
    plan = exact_launches(exact_analysis_shared_bytes, taps, levels, first_level)
    halo_len = 0
    if halo is not None:
        _refuse_periodic_halo(periodic)
        halo_len = _check_halo(halo, x)
        if not _one_window(plan):
            span = composite_halo_samples(taps, levels) << (first_level - 1)
            h = min(halo_len, span)
            ext_lo = None if x_lo is None else torch.cat([torch.zeros_like(halo[:, :h]), x_lo], -1)
            pairs = exact_analysis(torch.cat([halo[:, halo_len - h:], x], -1), ext_lo, levels,
                                   filters, False, first_level)
            return tuple((hi[:, h:].contiguous(), lo[:, h:].contiguous()) for hi, lo in pairs)
    lib = library()
    tap_t = _device_taps(tuple(filters[0]) + tuple(filters[1]), x.device.index,
                         torch.float64)
    b, n = x.shape
    pairs = []
    cur_hi, cur_lo = x, x_lo
    for first, count, tile, direct in plan:
        outs = [torch.empty_like(x) for _ in range(2 * (count + 1))]
        out_ptrs = (ctypes.c_void_p * len(outs))(*[o.data_ptr() for o in outs])
        with torch.cuda.device(x.device):
            err = lib.vw_modwt_exact_analysis(
                cur_hi.data_ptr(), None if cur_lo is None else cur_lo.data_ptr(),
                None if halo is None else halo.data_ptr(), halo_len,
                out_ptrs, tap_t.data_ptr(), b, n, first, count, taps,
                tile if direct else EXACT_ANALYSIS_LAUNCH_TILE, int(periodic), int(direct),
                _stream(x.device),
            )
        _raise_on_error(err, "modwt_exact_analysis")
        LAUNCHES["modwt_exact_analysis_halo" if halo is not None
                 else "modwt_exact_analysis"] += 1
        pairs += [(outs[2 * i], outs[2 * i + 1]) for i in range(count)]
        cur_hi, cur_lo = outs[2 * count], outs[2 * count + 1]
    return tuple(pairs) + ((cur_hi, cur_lo),)


def exact_synthesis(pairs, levels, filters, periodic, first_level=1, halo=None):
    """``levels + 1`` float32 (hi, lo) pairs, each [B, N] -> the (hi, lo)
    reconstruction, computed in fp64; periodic or zero.

    ``halo``, one ``(hi, lo)`` pair of ``[B, H]`` float32 samples per plane,
    just right of its end, is the external right edge (``periodic`` must be
    False): the load rule for a plan of one window launch, ``[plane | halo]``
    with zero edges sliced to N for a split plan, as in
    :func:`exact_analysis`."""
    _refuse_grad(*(t for pair in pairs for t in pair),
                 *(t for pair in (halo or ()) for t in pair))
    if pairs[0][0].device.type == "cpu":
        return exact_synthesis_plain(pairs, levels, filters, periodic, first_level, halo)
    if len(pairs) != levels + 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"expected {levels + 1} plane pairs, got {len(pairs)}",
        )
    first_hi = pairs[0][0]
    for i, (hi, lo) in enumerate(pairs):
        _check_pair(hi, lo, f"pair {i}", first_hi)
    _check_exact_levels(levels, first_level)
    taps = len(filters[0])
    plan = exact_launches(exact_synthesis_shared_bytes, taps, levels, first_level)
    halo_len, halo_ptrs = 0, None
    if halo is not None:
        _refuse_periodic_halo(periodic)
        _check_halo_count(halo, levels)
        halo_len = _halo_width([t for pair in halo for t in pair], first_hi)
        if not _one_window(plan):
            span = composite_halo_samples(taps, levels) << (first_level - 1)
            h = min(halo_len, span)
            n = first_hi.shape[1]
            ext = tuple((torch.cat([hi, h_hi[:, :h]], -1), torch.cat([lo, h_lo[:, :h]], -1))
                        for (hi, lo), (h_hi, h_lo) in zip(pairs, halo))
            out_hi, out_lo = exact_synthesis(ext, levels, filters, False, first_level)
            return out_hi[:, :n].contiguous(), out_lo[:, :n].contiguous()
        halo_ptrs = (ctypes.c_void_p * (2 * (levels + 1)))(
            *[t.data_ptr() for pair in halo for t in pair])
    lib = library()
    tap_t = _device_taps(tuple(filters[0]) + tuple(filters[1]), first_hi.device.index,
                         torch.float64)
    b, n = first_hi.shape
    cur = pairs[levels]
    for first, count, tile, direct in reversed(plan):
        start = first - first_level
        ins = [t for pair in (*pairs[start : start + count], cur) for t in pair]
        in_ptrs = (ctypes.c_void_p * len(ins))(*[t.data_ptr() for t in ins])
        out_hi, out_lo = torch.empty_like(first_hi), torch.empty_like(first_hi)
        with torch.cuda.device(first_hi.device):
            err = lib.vw_modwt_exact_synthesis(
                in_ptrs, halo_ptrs, halo_len, out_hi.data_ptr(), out_lo.data_ptr(),
                tap_t.data_ptr(), b, n, first, count, taps,
                tile if direct else EXACT_SYNTHESIS_LAUNCH_TILE, int(periodic),
                int(direct), _stream(first_hi.device),
            )
        _raise_on_error(err, "modwt_exact_synthesis")
        LAUNCHES["modwt_exact_synthesis_halo" if halo is not None
                 else "modwt_exact_synthesis"] += 1
        cur = (out_hi, out_lo)
    return cur
