"""The 2-D MODWT kernel tier: one launch per level, both axes in one block.

Counterpart of ``vectorwave_tpu/kernels/modwt2_pallas.py``.  The TPU
kernels ``_modwt2_analysis_call`` and ``_modwt2_synthesis_call`` apply
composite per-level filters for a group of shallow levels in one pass (W as
banded lane matmuls, H as left matmuls) and run the deep levels as a
"cascade tier", one à trous stage per call.  Both forms give the separable
2-D à trous pyramid of ``transforms/twodim.py``'s plain path; here every
level is one stage, run by a hand-written CUDA kernel for Hopper:

=========================  ==========================  ==========================
wrapper                    CUDA source                 TPU kernel it replaces
=========================  ==========================  ==========================
:func:`analysis2_level`    ``modwt2_analysis.cu``      ``_modwt2_analysis_call``
:func:`synthesis2_level`   ``modwt2_synthesis.cu``     ``_modwt2_synthesis_call``
=========================  ==========================  ==========================

Level j filters at spacing ``s = 2^(j-1)`` along both axes.  Analysis reads
backward, ``out[t] = sum_l f[l] in[t - s l]``; synthesis reads
``in[t + sign s l + offset]`` with one ``(sign, offset)`` per filter, which
is ``(+1, 0)`` for periodic and zero edges and the alignment-shifted pair of
``_inv_axis`` for the symmetric inverse (:func:`synthesis_ops`).  The edge
(periodic, zero or half-point symmetric) is applied per axis where a block
loads its window, so a span above the image size and any H, W are served.

Band names: the first letter is the filter along H, the second along W, so
``lh`` is low along H and high along W (``MODWT2Result(ll=a[0], lh=d[0],
hl=a[1], hh=d[1])`` in ``twodim.modwt2``).

A wrapper given a CPU tensor runs its plain version, given a CUDA tensor it
launches its kernel or raises; each launch adds one to its entry of
``modwt_composite.LAUNCHES``.  The kernels compute in fp32 and take float32
only (as the TPU tier does).  They have no gradient, because the JAX 2-D
tier defines none: a CUDA input that requires grad raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..errors import ErrorCode, InvalidArgumentError
from ..ops.convolve import atrous_analysis_pair, atrous_convolve, effective_length
from ._build import library
from .modwt_composite import (
    LAUNCHES,
    SHARED_LIMIT,
    _device_taps,
    _raise_on_error,
    _reach,
    _stream,
)
from .modwt_fused import _kernel_boundary, _kernel_filters

#: Edge modes and their codes in the CUDA sources (``kEdge*``).
EDGES = {"periodic": 0, "zero": 1, "symmetric": 2}
#: Block tiles ``(rows, columns)`` of the fallback, in order of
#: preference: a block owns ``rows`` output rows of one residue class mod
#: the spacing and ``columns`` adjacent columns; where no tile of
#: :data:`PLAN_TILES` leaves two blocks to an SM, the first of these whose
#: block fits shared memory is taken.
TILES = ((16, 128), (8, 128), (8, 64), (4, 64), (4, 32), (2, 32), (1, 32))
#: The planners' tiles: per level each direction takes the one that reads
#: its input the fewest times, ``(rows + L - 1) * width / (rows * columns)``,
#: among those whose block leaves room for three blocks on an SM, else two
#: (the synthesis), or for two (the analysis).
PLAN_TILES = ((4, 512), (8, 256), (8, 512), (16, 128), (16, 256), (32, 64), (32, 128))
#: Outputs a thread owns in the W pass (``kW``), and the H-pass items (of 4
#: class rows, ``kMaxItems`` a thread) a synthesis tile may have.
W_BLOCK, SYNTHESIS_ITEMS = 4, 1024
#: Shared memory a block may take for three (two) to fit an SM: a third (a
#: half) of the SM's 228 KB less the 1 KB the card reserves for each block.
THREE_BLOCKS_SHARED, TWO_BLOCKS_SHARED = 233472 // 3 - 1024, 233472 // 2 - 1024
#: Periodic and zero synthesis ops: forward reads, no offset, both filters.
FORWARD_OPS = (1, 0, 1, 0)


# --- the per-level plan (numpy) ---------------------------------------------------


def synthesis_ops(w, levels: int, edge: str) -> tuple[tuple[int, int, int, int], ...]:
    """Per level, ``(lo_sign, lo_offset, hi_sign, hi_offset)`` of the
    synthesis ops along each axis: level j reads ``in[t + sign 2^(j-1) l +
    offset]``.  Forward reads for periodic and zero edges; the symmetric
    alignment of ``twodim._inv_axis`` (``_symmetric_alignment`` and
    ``_tau_j``) for symmetric ones."""
    if edge == "symmetric":
        from .modwt_symmetric import symmetric_level_ops

        return symmetric_level_ops(w, levels)
    return (FORWARD_OPS,) * levels


def analysis_window(taps: int, spacing: int, tile: tuple[int, int]) -> tuple[int, int]:
    """``(rows, width)`` of an analysis block's input window: ``rows`` of one
    residue class and ``width`` adjacent columns (tile + the W reach)."""
    th, tw = tile
    return th + taps - 1, tw + spacing * (taps - 1)


def synthesis_window(taps: int, spacing: int, ops, tile: tuple[int, int]) -> tuple[int, int, int]:
    """``(rows, width, first)`` of a synthesis block's plane window: the
    window's first column is ``first`` from the tile's (``wlo`` in the CUDA
    source)."""
    th, tw = tile
    lo_s, lo_o, hi_s, hi_o = ops
    a = _reach(lo_s, lo_o, spacing, taps)
    d = _reach(hi_s, hi_o, spacing, taps)
    first, last = min(a[0], d[0]), max(a[1], d[1])
    return th + taps - 1, tw + last - first, first


class LevelPlan(NamedTuple):
    """One level launch's layout: the tile, how many plane windows the block
    holds at once (the synthesis: 2, the next one's copies in flight while
    the current one is filtered; 1, copy, then filter; the analysis reads
    one plane), the window's and the W-pass sums' row pitch in words, and
    the outputs a thread owns in the W pass (``kW``: 4 of one column class
    where the tile is a multiple of 4 spacings wide, else 1)."""

    tile: tuple[int, int]
    stages: int
    pitch: int
    row_pitch: int
    block: int


def _plan(width: int, spacing: int, tile, stages: int, padded: bool) -> LevelPlan:
    """The plan for one tile whose window is ``width`` columns: padded, the
    pitches are rounded up so that a warp's 8 strips by 4 rows of W-pass
    reads fall on 32 banks (``min(spacing, 8)`` words mod 32) and, where
    that is a multiple of 4, the window rows start on 16 bytes; unpadded,
    they are the widths."""
    tw = tile[1]
    block = W_BLOCK if tw % (W_BLOCK * spacing) == 0 else 1
    if not padded:
        return LevelPlan(tile, stages, width, tw, block)
    mod = min(spacing, 8) if block > 1 else 8
    base = width if mod % 4 else -(-width // 4) * 4
    return LevelPlan(tile, stages, base + (mod - base) % 32, tw + (mod - tw) % 32, block)


def _best_plan(plans, window, nbytes, serves, limits) -> LevelPlan | None:
    """Of ``plans``, the one whose tile reads its input the fewest times,
    ``rows * width / (th * tw)`` from ``window(tile)``, among those that
    ``serve`` and whose block takes at most the first of ``limits`` bytes of
    shared memory, else the next."""
    for limit in limits:
        best = None
        for plan in plans:
            size = nbytes(plan)
            if not serves(plan) or size > limit:
                continue
            rows, width = window(plan.tile)
            key = (rows * width / (plan.tile[0] * plan.tile[1]), size)
            if best is None or key < best[0]:
                best = (key, plan)
        if best is not None:
            return best[1]
    return None


def analysis_shared_bytes(taps: int, spacing: int, plan: LevelPlan) -> int:
    """Shared memory of one analysis block: the taps in forward-read order
    (each filter padded to a multiple of 4), the input window and the W
    pass's low and high sums."""
    rows, _ = analysis_window(taps, spacing, plan.tile)
    taps4 = -(-taps // 4) * 4
    return 4 * (2 * taps4 + rows * (plan.pitch + 2 * plan.row_pitch))


def _serves_analysis(plan: LevelPlan) -> bool:
    return plan.tile[1] % (8 * plan.block) == 0


@functools.lru_cache(maxsize=512)
def analysis_plan(taps: int, spacing: int) -> LevelPlan | None:
    """The analysis launch's plan: of :data:`PLAN_TILES`, padded, the tile
    that reads x the fewest times among those that leave room for two
    blocks on an SM (measured on an H100 at db4 levels 1-6: as fast as the
    three-block tiles at levels 1-4, faster at 5 and 6, where (16, 256)
    beats (8, 256)); else the first of :data:`TILES` whose block fits shared
    memory, padded or unpadded (never more than the earlier layout with its
    index tables took, so every level it served is served)."""
    def window(tile):
        return analysis_window(taps, spacing, tile)

    def plan_for(tile, padded):
        return _plan(window(tile)[1], spacing, tile, 1, padded)

    def nbytes(plan):
        return analysis_shared_bytes(taps, spacing, plan)

    plan = _best_plan([plan_for(t, True) for t in PLAN_TILES], window, nbytes,
                      _serves_analysis, (TWO_BLOCKS_SHARED,))
    if plan is not None:
        return plan
    for tile in TILES:
        for plan in (plan_for(tile, True), plan_for(tile, False)):
            if _serves_analysis(plan) and nbytes(plan) <= SHARED_LIMIT:
                return plan
    return None


def analysis_tile(taps: int, spacing: int) -> tuple[int, int] | None:
    """The tile of :func:`analysis_plan`, or None where no plan fits."""
    plan = analysis_plan(taps, spacing)
    return None if plan is None else plan.tile


def plan_shared_bytes(taps: int, spacing: int, ops, plan: LevelPlan) -> int:
    """Shared memory of one synthesis block: the taps in forward-read order
    (each filter padded to a multiple of 4), ``stages`` plane windows and the
    W-pass sums."""
    rows, _, _ = synthesis_window(taps, spacing, ops, plan.tile)
    taps4 = -(-taps // 4) * 4
    return 4 * (2 * taps4 + rows * (plan.stages * plan.pitch + plan.row_pitch))


def _serves(plan: LevelPlan) -> bool:
    th, tw = plan.tile
    return tw % (8 * plan.block) == 0 and -(-th // 4) * tw <= SYNTHESIS_ITEMS


@functools.lru_cache(maxsize=512)
def synthesis_plan(taps: int, spacing: int, ops) -> LevelPlan | None:
    """The synthesis launch's plan: of :data:`PLAN_TILES`, two stages, the
    tile that reads each plane the fewest times among those that leave room
    for three blocks on an SM, else two (measured on an H100: at db4 level
    6, (8, 256) three to an SM beats (16, 256) two to an SM, which reads
    less); else the first of :data:`TILES` that fits
    one block's shared memory, two stages padded or one unpadded (never
    more than the earlier one-plane layout took, so every level it served
    is served)."""
    ops = tuple(int(v) for v in ops)

    def window(tile):
        return synthesis_window(taps, spacing, ops, tile)[:2]

    def plan_for(tile, stages, padded):
        return _plan(window(tile)[1], spacing, tile, stages, padded)

    def nbytes(plan):
        return plan_shared_bytes(taps, spacing, ops, plan)

    plan = _best_plan([plan_for(t, 2, True) for t in PLAN_TILES], window, nbytes, _serves,
                      (THREE_BLOCKS_SHARED, TWO_BLOCKS_SHARED))
    if plan is not None:
        return plan
    for tile in TILES:
        for plan in (plan_for(tile, 2, True), plan_for(tile, 1, False)):
            if _serves(plan) and nbytes(plan) <= SHARED_LIMIT:
                return plan
    return None


def synthesis_tile(taps: int, spacing: int, ops) -> tuple[int, int] | None:
    """The tile of :func:`synthesis_plan`, or None where no plan fits."""
    plan = synthesis_plan(taps, spacing, ops)
    return None if plan is None else plan.tile


def grid_blocks(batch: int, h: int, w: int, spacing: int, tile) -> tuple[int, int, int]:
    """``(blocks, chunks, column tiles)`` of one launch: per image, per
    residue class of rows mod the spacing, ``chunks`` runs of tile rows of
    the class, each cut into column tiles."""
    th, tw = tile
    rows_per_class = -(-h // spacing)
    chunks = -(-rows_per_class // th)
    wtiles = -(-w // tw)
    return batch * spacing * chunks * wtiles, chunks, wtiles


# --- plain versions ---------------------------------------------------------------


def _swap(t: torch.Tensor) -> torch.Tensor:
    return t.transpose(-1, -2)


def _h_pair(x, lo, hi, spacing, edge):
    a, d = atrous_analysis_pair(_swap(x), lo, hi, spacing=spacing, boundary=edge)
    return _swap(a), _swap(d)


def analysis2_level_plain(x, filters, spacing: int, edge: str):
    """Plain version of :func:`analysis2_level`, its definition: the analysis
    pair along W, then along H (``twodim._analysis2_level``).  Returns
    ``(ll, lh, hl, hh)``."""
    lo, hi = filters
    a_w, d_w = atrous_analysis_pair(x, lo, hi, spacing=spacing, boundary=edge)
    ll, hl = _h_pair(a_w, lo, hi, spacing, edge)
    lh, hh = _h_pair(d_w, lo, hi, spacing, edge)
    return ll, lh, hl, hh


def _inv_last(a, d, filters, spacing, ops, edge):
    lo, hi = filters
    lo_s, lo_o, hi_s, hi_o = ops
    return (atrous_convolve(a, lo, spacing=spacing, boundary=edge, sign=lo_s, offset=lo_o)
            + atrous_convolve(d, hi, spacing=spacing, boundary=edge, sign=hi_s,
                              offset=hi_o))


def synthesis2_level_plain(ll, lh, hl, hh, filters, spacing: int, ops, edge: str):
    """Plain version of :func:`synthesis2_level`: the inverse along H on
    ``(ll, hl)`` and on ``(lh, hh)``, then along W
    (``twodim.imodwt2_multilevel``'s per-level step)."""
    col_a = _swap(_inv_last(_swap(ll), _swap(hl), filters, spacing, ops, edge))
    col_d = _swap(_inv_last(_swap(lh), _swap(hh), filters, spacing, ops, edge))
    return _inv_last(col_a, col_d, filters, spacing, ops, edge)


# --- the gate ----------------------------------------------------------------------


def kernel_refusal(x: torch.Tensor, w, levels: int, boundary: str) -> str | None:
    """Why the 2-D kernels cannot serve this call, or None when they can:
    float32 ``[..., H, W]`` input, a periodic, zero or symmetric edge,
    1 <= levels <= 10 with the level-J filter within min(H, W)
    (``_check_level_fits``), and every level's windows within one block's
    shared memory in both directions."""
    if x.dtype != torch.float32:
        return f"the 2-D kernels take float32, got {x.dtype}"
    try:
        edge = _kernel_boundary(boundary, "the 2-D kernel tier")
    except InvalidArgumentError:
        return f"no 2-D kernel edge mode for boundary {boundary!r}"
    if x.dim() < 2 or not 1 <= levels <= 10:
        return f"levels must be in [1, 10] on [..., H, W] input, got {levels}"
    if effective_length(w.filter_length, levels) > min(x.shape[-2], x.shape[-1]):
        return "the level-J filter is longer than the image"
    taps = w.filter_length
    for j, ops in enumerate(synthesis_ops(w, levels, edge), start=1):
        s = 1 << (j - 1)
        if analysis_tile(taps, s) is None or synthesis_tile(taps, s, ops) is None:
            return f"level {j}'s windows do not fit one block's shared memory"
    return None


def modwt2_kernel_eligible(x: torch.Tensor, w, levels: int, boundary: str) -> bool:
    """Whether ``auto`` routes this call to the 2-D kernel tier: a CUDA
    tensor on a Hopper card, under backend ``auto`` or ``kernel``, that
    :func:`kernel_refusal` admits.  The counterpart of
    ``modwt2_pallas_eligible``, without its Pallas layout gates (H and W
    multiples of 256, at most four 128-row halo blocks)."""
    from ..config import get_backend
    from .modwt_fused import kernel_available

    backend = get_backend()
    if backend == "torch":
        return False
    if backend == "auto" and (x.device.type != "cuda" or not kernel_available()):
        return False
    return kernel_refusal(x, w, levels, boundary) is None


def _edge(boundary: str) -> str:
    return _kernel_boundary(boundary, "the 2-D kernel tier")


# --- kernel launches ---------------------------------------------------------------


def _check_image(t: torch.Tensor, what: str, like: torch.Tensor | None = None) -> None:
    if t.device.type != "cuda":
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"{what} must be a CUDA tensor for the kernel, got {t.device}",
        )
    ref = t if like is None else like
    if (t.dim() != 3 or not t.is_contiguous() or t.dtype != torch.float32
            or t.device != ref.device or t.shape != ref.shape):
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"{what} must be a contiguous float32 [batch, H, W] tensor"
            + ("" if like is None else " shaped and placed like the first plane"),
            context={"shape": tuple(t.shape), "dtype": t.dtype,
                     "contiguous": t.is_contiguous()},
        )


def _refuse_tile(what: str, taps: int, spacing: int) -> InvalidArgumentError:
    return InvalidArgumentError(
        ErrorCode.VAL_TOO_LARGE,
        f"The {what} windows do not fit the 2-D kernel's shared memory",
        context={"taps": taps, "spacing": spacing},
        suggestions=("Use fewer levels or backend='torch'",),
    )


def analysis2_level(x: torch.Tensor, filters, spacing: int, edge: str):
    """One level of the 2-D analysis: ``[B, H, W]`` ``LL_{j-1}`` (x at
    j = 1) -> ``(ll, lh, hl, hh)`` at spacing ``2^(j-1)``."""
    edge = _edge(edge)
    if x.device.type == "cpu":
        return analysis2_level_plain(x, filters, spacing, edge)
    _check_image(x, "x")
    taps = len(filters[0])
    plan = analysis_plan(taps, spacing)
    if plan is None:
        raise _refuse_tile("analysis", taps, spacing)
    b, h, w = x.shape
    lib = library()
    outs = [torch.empty_like(x) for _ in range(4)]  # ll, lh, hl, hh
    tap_t = _device_taps(tuple(filters[0]) + tuple(filters[1]), x.device.index)
    with torch.cuda.device(x.device):
        err = lib.vw_modwt2_analysis_level(
            x.data_ptr(), *(o.data_ptr() for o in outs), tap_t.data_ptr(), b, h, w,
            taps, spacing, EDGES[edge], *plan.tile, plan.pitch, plan.row_pitch, plan.block,
            _stream(x.device),
        )
    _raise_on_error(err, "modwt2_analysis")
    LAUNCHES["modwt2_analysis"] += 1
    return tuple(outs)


def synthesis2_level(ll, lh, hl, hh, filters, spacing: int, ops, edge: str) -> torch.Tensor:
    """One level of the 2-D synthesis: ``LL_j``, ``LH_j``, ``HL_j``, ``HH_j``
    (each ``[B, H, W]``) -> ``LL_{j-1}``, with the per-filter ``ops`` of
    :func:`synthesis_ops` along both axes."""
    edge = _edge(edge)
    if ll.device.type == "cpu":
        return synthesis2_level_plain(ll, lh, hl, hh, filters, spacing, ops, edge)
    _check_image(ll, "ll")
    for t, what in ((lh, "lh"), (hl, "hl"), (hh, "hh")):
        _check_image(t, what, ll)
    taps = len(filters[0])
    ops = tuple(int(v) for v in ops)
    plan = synthesis_plan(taps, spacing, ops)
    if plan is None:
        raise _refuse_tile("synthesis", taps, spacing)
    b, h, w = ll.shape
    lib = library()
    out = torch.empty_like(ll)
    tap_t = _device_taps(tuple(filters[0]) + tuple(filters[1]), ll.device.index)
    with torch.cuda.device(ll.device):
        err = lib.vw_modwt2_synthesis_level(
            ll.data_ptr(), lh.data_ptr(), hl.data_ptr(), hh.data_ptr(), out.data_ptr(),
            tap_t.data_ptr(), b, h, w, taps, spacing, *ops, EDGES[edge], *plan.tile,
            plan.stages, plan.pitch, plan.row_pitch, plan.block, _stream(ll.device),
        )
    _raise_on_error(err, "modwt2_synthesis")
    LAUNCHES["modwt2_synthesis"] += 1
    return out


# --- the multi-level drivers -------------------------------------------------------


def _refuse_unservable(tensors, w, levels: int, boundary: str, entry: str) -> None:
    """On CUDA tensors the kernel tier serves the call or raises: an input
    the kernels cannot take (judged on the first tensor), or one that
    requires grad (the 2-D tier has no gradient on the card, as in the JAX
    package)."""
    x = tensors[0]
    if x.device.type != "cuda":
        return
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"{entry}: the 2-D kernel tier has no gradient on the card",
            suggestions=("Pass backend='torch' to differentiate through the plain "
                         "cascade, or run under torch.no_grad()",),
        )
    why = kernel_refusal(x, w, levels, boundary)
    if why is not None:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"{entry}: the 2-D kernels cannot serve this call: {why}",
            context={"shape": tuple(x.shape), "dtype": x.dtype, "levels": levels},
            suggestions=("Pass backend='torch' for the plain cascade",),
        )


def _flat(t: torch.Tensor) -> torch.Tensor:
    return t.reshape((-1,) + tuple(t.shape[-2:])).contiguous()


def modwt2_multilevel_kernel(x: torch.Tensor, w, levels: int, boundary: str):
    """``[..., H, W]`` -> ``(((lh, hl, hh) per level), ll_J)``: one
    :func:`analysis2_level` per level on the previous LL.  The counterpart of
    ``modwt2_multilevel_pallas``."""
    edge = _edge(boundary)
    _refuse_unservable((x,), w, levels, boundary, "modwt2_multilevel")
    lead, hw = x.shape[:-2], tuple(x.shape[-2:])
    filters = _kernel_filters(w, synthesis=False)
    cur = _flat(x)
    details = []
    for j in range(1, levels + 1):
        cur, lh, hl, hh = analysis2_level(cur, filters, 1 << (j - 1), edge)
        details.append(tuple(p.reshape(lead + hw) for p in (lh, hl, hh)))
    return tuple(details), cur.reshape(lead + hw)


def imodwt2_multilevel_kernel(details, approx: torch.Tensor, w, boundary: str):
    """Inverse of :func:`modwt2_multilevel_kernel`, coarsest level first:
    one :func:`synthesis2_level` per level.  The counterpart of
    ``imodwt2_multilevel_pallas`` (and of the symmetric fast inverse)."""
    edge = _edge(boundary)
    levels = len(details)
    _refuse_unservable((approx, *(p for trip in details for p in trip)), w, levels,
                       boundary, "imodwt2_multilevel")
    lead, hw = approx.shape[:-2], tuple(approx.shape[-2:])
    filters = _kernel_filters(w, synthesis=True)
    all_ops = synthesis_ops(w, levels, edge)
    cur = _flat(approx)
    for j in range(levels, 0, -1):
        lh, hl, hh = (_flat(p) for p in details[j - 1])
        cur = synthesis2_level(cur, lh, hl, hh, filters, 1 << (j - 1), all_ops[j - 1], edge)
    return cur.reshape(lead + hw)
