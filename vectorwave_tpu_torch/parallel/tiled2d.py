"""2-D MODWT tiled across a mesh along the ROW (H) axis with halo exchange.

Counterpart of ``vectorwave_tpu/parallel/tiled2d.py``: an image batch is
split along H over a mesh axis; the W axis stays whole per shard, so the W
pass is local and only the H pass needs neighbour rows.  The H pass reads
backward (analysis) or forward (synthesis) at most the cumulative span
``(L0-1)(2^J - 1)`` rows away, so ONE slab exchange per transform suffices:

* analysis: ``span`` rows from the upper ring neighbour, the whole local
  cascade on ``[halo | shard]`` with the GLOBAL boundary along W and ZERO
  along H, each level cropped to the shard's rows;
* synthesis: the adjoint, ``span`` rows from the lower neighbour appended
  below, cropped to the leading shard rows.

PERIODIC keeps the ring's wrap link, ZERO drops it.  SYMMETRIC mirrors the
global image head and foot, which span shards at depth, and a periodic span
of at least H wraps more than once: both gather the image's H (the
single-device transform on the mesh's first device; across ranks each rank
gathers its images' rows, the JAX package's ``all_gather`` of H, and keeps
its own).  The shard functions are plain PyTorch, as the JAX package's are
jnp; all shards on one device run as one call (:mod:`.tiled`).  On a mesh
that spans ranks each rank passes the rows of H its cells hold (and its
images, with ``batch_axis``) and gets the same block of every plane back;
the slabs that cross ranks travel over ``torch.distributed``
(:mod:`.exchange`).
"""

from __future__ import annotations

import math

import torch

from ..ops.convolve import atrous_analysis_pair, atrous_convolve
from ..transforms.modwt import _resolve_discrete
from ..transforms.multilevel import _check_level_fits
from ..transforms.twodim import (
    MultiLevelMODWT2Result,
    _check_2d,
    imodwt2_multilevel,
    modwt2_multilevel,
)
from .mesh import Mesh
from .tiled import _gather_halo, _gather_halos, _ring_perms, _tiles

_INV_SQRT2 = 1.0 / math.sqrt(2.0)

__all__ = ["modwt2_multilevel_tiled", "imodwt2_multilevel_tiled"]


def _h_pair_zero(x, low, high, spacing):
    """Analysis pair along H with zero boundary (slab-local)."""
    a, d = atrous_analysis_pair(x.transpose(-1, -2), low, high, spacing=spacing,
                                boundary="zero")
    return a.transpose(-1, -2), d.transpose(-1, -2)


def _inv_axis(a, d, low, high, spacing, boundary):
    """Per-level synthesis along the LAST axis (periodic or zero)."""
    return (atrous_convolve(a, low, spacing=spacing, boundary=boundary, sign=+1)
            + atrous_convolve(d, high, spacing=spacing, boundary=boundary, sign=+1))


def modwt2_multilevel_tiled(
    x: torch.Tensor,
    wavelet,
    *,
    levels: int,
    mesh: Mesh,
    axis: str = "rows",
    boundary: str = "periodic",
    batch_axis: str | None = None,
) -> MultiLevelMODWT2Result:
    """J-level 2-D MODWT of images split along H (axis -2).

    Matches the single-device :func:`..transforms.twodim.modwt2_multilevel`
    to machine precision for periodic, zero and symmetric boundaries; one
    ``span``-row slab exchange per transform (symmetric: the gathered image).
    """
    _check_2d(x, "modwt2_multilevel_tiled")
    w = _resolve_discrete(wavelet)
    boundary_l = boundary.lower()
    tiles = _tiles(mesh, axis, batch_axis, tuple(x.shape), -2)
    h = tiles.n
    _check_level_fits(w, levels, min(h, x.shape[-1]))
    low = w.dec_lo * _INV_SQRT2
    high = w.dec_hi * _INV_SQRT2
    span = (w.filter_length - 1) * ((1 << levels) - 1)
    wrap = boundary_l.startswith("per")
    w_boundary = "periodic" if wrap else "zero"
    shape = tuple(x.shape)

    x3 = x.reshape(tiles.rows, x.shape[-2], x.shape[-1]).to(tiles.home)
    if boundary_l.startswith("sym") or (wrap and span >= h):
        if tiles.ring.whole:
            return modwt2_multilevel(x.to(tiles.home), w, levels=levels, boundary=boundary_l)
        full = modwt2_multilevel(tiles.gather_axis(x3), w, levels=levels, boundary=boundary_l)
        details = tuple(tuple(tiles.own(p).reshape(shape) for p in trip)
                        for trip in full.details)
        return MultiLevelMODWT2Result(details, tiles.own(full.approx).reshape(shape))

    from_left, _ = _ring_perms(axis, mesh, wrap)
    eff = min(span, h)
    halos = _gather_halo(tiles.shards(x3), eff, from_left, "left", tiles.ring)
    n_loc = tiles.n_loc

    def cascade(rows, hal):
        cur = torch.cat([hal[0], rows[0]], dim=-2)
        outs = []
        for level in range(1, levels + 1):
            spacing = 1 << (level - 1)
            a_w, d_w = atrous_analysis_pair(cur, low, high, spacing=spacing,
                                            boundary=w_boundary)
            ll, hl = _h_pair_zero(a_w, low, high, spacing)
            lh, hh = _h_pair_zero(d_w, low, high, spacing)
            outs += [lh[..., -n_loc:, :], hl[..., -n_loc:, :], hh[..., -n_loc:, :]]
            cur = ll
        return (*outs, cur[..., -n_loc:, :])

    planes = [p.reshape(shape) for p in tiles.compute((x3,), (halos,), cascade)]
    details = tuple(tuple(planes[3 * j: 3 * j + 3]) for j in range(levels))
    return MultiLevelMODWT2Result(details, planes[-1])


def imodwt2_multilevel_tiled(
    result: MultiLevelMODWT2Result,
    wavelet,
    *,
    mesh: Mesh,
    axis: str = "rows",
    boundary: str = "periodic",
    batch_axis: str | None = None,
) -> torch.Tensor:
    """Inverse of :func:`modwt2_multilevel_tiled` (synthesis reads forward:
    the slab comes from the LOWER ring neighbour and is appended below)."""
    w = _resolve_discrete(wavelet)
    boundary_l = boundary.lower()
    levels = result.levels
    shape = tuple(result.approx.shape)
    tiles = _tiles(mesh, axis, batch_axis, shape, -2)
    h = tiles.n
    low = w.rec_lo * _INV_SQRT2
    high = w.rec_hi * _INV_SQRT2
    span = (w.filter_length - 1) * ((1 << levels) - 1)
    wrap = boundary_l.startswith("per")
    w_boundary = "periodic" if wrap else "zero"

    if boundary_l.startswith("sym") or (wrap and span >= h):
        # see the analysis gather-path note on multi-wrap periodic spans
        home = tiles.home
        if tiles.ring.whole:
            return imodwt2_multilevel(MultiLevelMODWT2Result(
                tuple(tuple(p.to(home) for p in trip) for trip in result.details),
                result.approx.to(home)), w, boundary=boundary_l)

        def whole(p):
            return tiles.gather_axis(p.reshape(tiles.rows, shape[-2], shape[-1]).to(home))

        full = imodwt2_multilevel(MultiLevelMODWT2Result(
            tuple(tuple(whole(p) for p in trip) for trip in result.details),
            whole(result.approx)), w, boundary=boundary_l)
        return tiles.own(full).reshape(shape)

    _, from_right = _ring_perms(axis, mesh, wrap)
    planes = [p.reshape(tiles.rows, shape[-2], shape[-1]).to(tiles.home)
              for p in (*(q for trip in result.details for q in trip), result.approx)]
    eff = min(span, h)
    halos = _gather_halos(tuple(tiles.shards(p) for p in planes), eff, from_right, "right",
                          tiles.ring)
    n_loc = tiles.n_loc

    def cascade(rows, hal):
        ext = [torch.cat([r, g], dim=-2) for r, g in zip(rows, hal)]
        cur = ext[-1]
        for level in range(levels, 0, -1):
            lh, hl, hh = ext[3 * (level - 1): 3 * level]
            spacing = 1 << (level - 1)

            def inv_h(a, d, spacing=spacing):
                return _inv_axis(a.transpose(-1, -2), d.transpose(-1, -2), low, high,
                                 spacing, "zero").transpose(-1, -2)

            col_a = inv_h(cur, hl)
            col_d = inv_h(lh, hh)
            cur = _inv_axis(col_a, col_d, low, high, spacing, w_boundary)
        return (cur[..., :n_loc, :],)

    (out,) = tiles.compute(tuple(planes), halos, cascade)
    return out.reshape(shape)
