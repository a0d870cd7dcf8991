"""Long-signal MODWT tiled across a mesh with halo exchange.

Counterpart of ``vectorwave_tpu/parallel/tiled.py``.  A length-N signal is
split along its last axis into T shards over a mesh axis; each level (or
once, for the cumulative halo) a shard receives the filter-support halo of
its ring neighbours, then runs the same local à trous convolution as the
single-device path.  PERIODIC uses the ring's wrap link, ZERO drops it
(a missing source is zero, which IS the zero extension), SYMMETRIC mirrors
the edge shards' own data; halos wider than one shard are gathered hop by
hop, and the symmetric levels whose halo outgrows a shard gather the whole
signal (the JAX package's ``all_gather``).

The shards are the ``[B, T, n_loc]`` view of the signal, and the exchange
is slicing, a roll along the shard axis (:func:`.exchange.ppermute`, the
counterpart of ``jax.lax.ppermute``) and ``torch.cat``; ``Tensor.to`` takes
each device its shards and halos where the mesh spans several devices.  All
shards on one device are computed together: one call, one kernel launch on
the kernel route, for their ``[B·T, n_loc]`` rows with a ``[B·T, H]`` halo,
the counterpart of ``shard_map``.  In one process the results come back as
ordinary global tensors on the device of the mesh's first shard.

On a mesh that spans the ranks of a ``torch.distributed`` world
(:mod:`.mesh`) each rank passes the block of the input that its cells hold,
``[B_local, T_local n_loc]``, computes its own shards and gets back its
block of every output; the halos whose source is another rank's shard
travel over ``torch.distributed`` (:mod:`.exchange`), and where the JAX
package gathers the whole axis (the symmetric levels whose halo outgrows a
shard, the exact tier's multi-wrap periodic span) each rank gathers its
rows' whole axis, runs the single-device op and keeps its own columns.

Routes (``backend``): ``'torch'`` (alias ``'jnp'``) is the plain cascade
for every boundary; ``'kernel'`` (alias ``'pallas'``) serves periodic and
zero with ONE cumulative halo of ``(L0-1)(2^J-1)`` samples each way, one
external-edge analysis launch and one external-halo synthesis launch
(``kernels.modwt_composite``); ``'auto'`` takes the kernel route on
Hopper cards for periodic and zero float32/bfloat16 signals whose windows
fit shared memory, and the plain route elsewhere, as JAX does off the TPU.
The periodic halo wraps around the ring as often as the span needs, so a
span longer than the whole signal stays exact (the JAX kernel route caps it
at N and loses the second wrap).

The exact tier (:func:`modwt_multilevel_tiled_exact`) runs the fp64
double-float kernels shard-locally with the same exchange: a raw float32
left halo for the analysis, a (hi, lo) right halo per plane for the
synthesis; a periodic span of at least N gathers the whole signal.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import _BACKEND_ALIASES
from ..errors import ErrorCode, InvalidArgumentError
from ..ops.convolve import atrous_analysis_pair, atrous_convolve, effective_length
from ..transforms.modwt import _resolve_discrete
from ..transforms.multilevel import (
    MultiLevelMODWTResult,
    _check_level_fits,
    _symmetric_alignment,
    _tau_j,
)
from . import exchange
from .mesh import Mesh, local_index, rank_box

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


# --- the shard exchange ----------------------------------------------------------------


def _ring_perms(axis: str, mesh: Mesh, wrap: bool):
    """(from_left, from_right): ``(source, destination)`` shard pairs of a
    shift by one along ``axis``; without ``wrap`` the link across the ends
    is dropped."""
    size = mesh.axis_size(axis)
    from_left = [(i, (i + 1) % size) for i in range(size)]
    from_right = [((i + 1) % size, i) for i in range(size)]
    if not wrap:
        from_left = [(a, b) for a, b in from_left if b != 0]
        from_right = [(a, b) for a, b in from_right if b != size - 1]
    return from_left, from_right


def _ppermute(blocks: torch.Tensor, perm) -> torch.Tensor:
    """The exchange within this process, the counterpart of
    ``jax.lax.ppermute``: :func:`.exchange.roll`."""
    return exchange.roll(blocks, perm)


def _hop(blocks: torch.Tensor, perm, ring: exchange.Ring | None) -> torch.Tensor:
    """One step round the ring: :func:`_ppermute` where this process holds
    the whole axis, else :func:`.exchange.ppermute` across ranks."""
    if ring is None or ring.whole:
        return _ppermute(blocks, perm)
    return exchange.ppermute(blocks, perm, ring)


def _gather_halo(shards: torch.Tensor, halo_len: int, perm, side: str,
                 ring: exchange.Ring | None = None) -> torch.Tensor:
    """Fetch ``halo_len`` samples adjacent to each shard of ``shards``
    (``[B, T, n_loc, ...]``: T shards along dim 1, their samples along dim
    2) from its ring neighbours, hop by hop for halos wider than one shard.
    For the shallow case only the needed ``halo_len`` samples move; a wide
    halo moves whole shards a hop; on a ring with the wrap link a halo
    longer than the signal keeps wrapping.  ``ring`` is this rank's place
    on the axis (:attr:`_Tiles.ring`; None: the whole axis, in this
    process).  Returns ``[B, T, halo_len, ...]``."""
    return _gather_halos((shards,), halo_len, perm, side, ring)[0]


def _gather_halos(shards: tuple, halo_len: int, perm, side: str,
                  ring: exchange.Ring | None = None) -> tuple:
    """:func:`_gather_halo` for several tensors of one shape at once (the
    planes of a synthesis): what they send is stacked along dim 0 and goes
    round the ring in one exchange, the counterpart of the JAX package's
    one ``ppermute`` of the stacked planes.  Returns one ``[B, T, halo_len,
    ...]`` halo per input, each a contiguous slice of one tensor."""
    b, n_loc = shards[0].shape[0], shards[0].shape[2]

    def stacked(views):
        return views[0] if len(views) == 1 else torch.cat(views)

    if halo_len <= n_loc:
        start = n_loc - halo_len if side == "left" else 0
        out = _hop(stacked([s.narrow(2, start, halo_len) for s in shards]), perm, ring)
        return out.split(b)
    hops = -(-halo_len // n_loc)
    blocks = []
    carried = stacked(list(shards))
    for _ in range(hops):
        carried = _hop(carried, perm, ring)
        blocks.append(carried)
    if side == "left":  # blocks[0] = left neighbour, blocks[1] = left-left, ...
        ext = torch.cat(blocks[::-1], dim=2)
        out = ext.narrow(2, ext.shape[2] - halo_len, halo_len)
    else:
        out = torch.cat(blocks, dim=2).narrow(2, 0, halo_len)
    return out.contiguous().split(b)


def _mirror_tail(x: torch.Tensor, length: int) -> torch.Tensor:
    """Half-point mirror of the HEAD of x, as a left extension of length
    ``length`` (global symmetric-boundary parity for the first shard)."""
    n = x.shape[-1]
    reps = -(-length // n)
    tiles = []
    flip = True
    for _ in range(reps):
        tiles.append(torch.flip(x, dims=(-1,)) if flip else x)
        flip = not flip
    return torch.cat(tiles[::-1], dim=-1)[..., -length:]


def _with_shard(halos: torch.Tensor, index: int, block: torch.Tensor) -> torch.Tensor:
    """``halos`` (``[B, T, H]``) with shard ``index``'s halo replaced by
    ``block`` (``[B, H]``): the global edge's own mirror."""
    parts = [halos.narrow(1, 0, index), block.unsqueeze(1),
             halos.narrow(1, index + 1, halos.shape[1] - index - 1)]
    return torch.cat(parts, dim=1)


class _Tiles(NamedTuple):
    """How this rank's ``[B, N, *rest]`` block lies on the mesh: P groups of
    B/P rows (over ``batch_axis``) times T shards of ``n_loc`` along dim 1
    (over ``axis``).  ``cells[p][t]`` is the device of shard (p, t); mesh
    axes other than those two hold replicas, and the first replica computes.
    In one process the block is the global tensor; across ranks it is the
    rank's box of the grid (:attr:`ring` places it).  The block's tensors
    live on :attr:`home`, where the halos are exchanged on the ``[B, T,
    n_loc, *rest]`` view (:meth:`shards`)."""

    cells: list
    rows: int
    n_loc: int
    ring: exchange.Ring

    @property
    def P(self) -> int:  # noqa: N802
        return len(self.cells)

    @property
    def T(self) -> int:  # noqa: N802
        return len(self.cells[0])

    @property
    def home(self) -> torch.device:
        return self.cells[0][0]

    @property
    def n(self) -> int:
        """The global length of the split axis."""
        return self.n_loc * self.ring.size

    @property
    def head(self) -> bool:
        """Whether this rank holds the global first shard."""
        return self.ring.first == 0

    @property
    def tail(self) -> bool:
        """Whether this rank holds the global last shard."""
        return self.ring.first + self.ring.count == self.ring.size

    def shards(self, g: torch.Tensor) -> torch.Tensor:
        """A ``[B, T n_loc, *rest]`` block as ``[B, T, n_loc, *rest]``."""
        return g.reshape(self.rows, self.T, self.n_loc, *g.shape[2:])

    def gather_axis(self, g: torch.Tensor) -> torch.Tensor:
        """The whole split axis of this rank's rows, ``[B, N, *rest]``: the
        block itself in one process, else every rank's shards of its rows
        (the JAX package's tiled ``all_gather``)."""
        if self.ring.whole:
            return g
        return exchange.all_gather(self.shards(g), self.ring).reshape(
            self.rows, self.n, *g.shape[2:])

    def own(self, g: torch.Tensor) -> torch.Tensor:
        """This rank's columns of a ``[B, N, *rest]`` tensor of the whole
        axis (:meth:`gather_axis`'s inverse)."""
        if self.ring.whole:
            return g
        return g.narrow(1, self.ring.first * self.n_loc, self.T * self.n_loc)

    def compute(self, globals_: tuple, halos: tuple, fn: Callable) -> tuple:
        """Shard-local ``fn(rows, halos)`` once per device, for all of its
        shards together: ``rows`` one ``[R, n_loc, *rest]`` tensor per
        block input, ``halos`` one ``[R, H, *rest]`` tensor per
        ``[B, T, H, *rest]`` halo input; ``fn`` returns ``[R, n_loc, *rest]``
        outputs, which come back as blocks on :attr:`home`."""
        b, t, n_loc = self.rows, self.T, self.n_loc
        rest = tuple(globals_[0].shape[2:])
        if all(d == self.home for row in self.cells for d in row):
            # one device: the (row, shard) order is a reshape of the blocks,
            # so no contiguous shard is copied in or out
            outs = fn(tuple(g.reshape(b * t, n_loc, *rest).contiguous() for g in globals_),
                      tuple(h.reshape(b * t, -1, *rest).contiguous() for h in halos))
            return tuple(o.reshape(b, t * n_loc, *rest) for o in outs)
        bp = b // self.P
        stacked = [self.shards(g) for g in globals_]
        groups: dict = {}
        for p in range(self.P):
            for q in range(t):
                groups.setdefault(self.cells[p][q], []).append((p, q))
        results = [[None] * t for _ in range(self.P)]
        for dev, cells in groups.items():
            def gather(v):
                return torch.cat([v[p * bp:(p + 1) * bp, q] for p, q in cells]).to(dev)

            outs = fn(tuple(map(gather, stacked)), tuple(map(gather, halos)))
            for i, (p, q) in enumerate(cells):
                results[p][q] = [o.narrow(0, i * bp, bp).to(self.home) for o in outs]
        return tuple(
            torch.cat([torch.cat([results[p][q][k] for q in range(t)], dim=1)
                       for p in range(self.P)])
            for k in range(len(results[0][0])))


def _tiles(mesh: Mesh, axis: str, batch_axis: str | None, shape, dim: int, *,
           world: bool = True) -> _Tiles:
    """The tiling of this rank's block of ``shape``, split along ``dim``
    (negative) over ``axis`` and along its first dimension over
    ``batch_axis``: ``_tile_spec``'s layout.  The dimensions before ``dim``
    are the rows.  ``world=False`` serves a layout whose split axis never
    crosses ranks (the multihost facades), which needs no process group."""
    mesh.axis_size(axis)  # an axis the mesh lacks raises
    lead = len(shape) + dim  # dimensions before the split one
    if batch_axis is not None:
        if lead < 1:
            raise InvalidArgumentError(
                ErrorCode.VAL_INVALID_SHAPE,
                "batch_axis sharding needs a leading batch dimension",
                suggestions=("Add a batch axis or drop batch_axis",),
            )
        if batch_axis == axis:
            raise InvalidArgumentError(
                ErrorCode.DIST_BAD_MESH,
                f"batch_axis and axis are both {axis!r}",
            )
    box = rank_box(mesh, (batch_axis, axis), world=world)
    groups, shards = (box.ranges if batch_axis is not None else (range(1), box.ranges[0]))
    n = shape[dim]
    if n % len(shards) != 0:
        raise InvalidArgumentError(
            ErrorCode.DIST_TILE_TOO_SMALL,
            f"Length {n} of the split axis must divide evenly across {len(shards)} shards",
            suggestions=("Pad the signal to a multiple of the mesh axis size",),
        )
    if batch_axis is not None and shape[0] % len(groups) != 0:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"batch {shape[0]} not divisible by {len(groups)} shards of {batch_axis!r}",
            suggestions=("Pad the batch to a multiple of the mesh axis size",),
        )
    names = mesh.axis_names

    def device(p, t):
        idx = [0] * len(names)
        idx[names.index(axis)] = t
        if batch_axis is not None:
            idx[names.index(batch_axis)] = p
        return mesh.devices[tuple(idx)]

    rows = math.prod(shape[:lead])
    owners = box.owners if batch_axis is not None else box.owners[None]
    ring = exchange.Ring(mesh.axis_size(axis), shards.start, len(shards), tuple(groups),
                         rows // len(groups), owners, mesh.rank)
    return _Tiles([[device(p, t) for t in shards] for p in groups], rows, n // len(shards),
                  ring)


def _flat(x: torch.Tensor, tiles: _Tiles) -> torch.Tensor:
    """``[..., N]`` as the ``[B, N]`` rows of the tiling, on its home device."""
    return x.reshape(tiles.rows, x.shape[-1]).to(tiles.home)


def _resolve_tiled_backend(backend: str, boundary_l: str, tiles: _Tiles, dtype,
                           taps: int, levels: int) -> str:
    """``'kernel'`` or ``'torch'``.  ``'auto'`` takes the kernel route for
    periodic/zero float32 or bfloat16 signals on a mesh of Hopper cards
    whose windows fit shared memory (the JAX package takes its kernel on the
    TPU only); symmetric boundaries and everything else keep the plain
    cascade.  ``'kernel'`` with a symmetric boundary raises."""
    from ..kernels.modwt_composite import kernels_fit
    from ..kernels.modwt_fused import kernel_available

    name = _BACKEND_ALIASES.get(backend, backend)
    kernel_ok = boundary_l.startswith(("per", "zero"))
    if name == "auto":
        on_cards = all(d.type == "cuda" for row in tiles.cells for d in row)
        fits = dtype in (torch.float32, torch.bfloat16) and kernels_fit(taps, levels)
        return "kernel" if (kernel_ok and on_cards and fits and kernel_available()) else "torch"
    if name not in ("torch", "kernel"):
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"Unknown tiled backend {backend!r}",
            suggestions=("Use 'auto', 'torch' or 'kernel' ('jnp', 'pallas' alias them)",),
        )
    if name == "kernel" and not kernel_ok:
        raise InvalidArgumentError(
            ErrorCode.CFG_UNSUPPORTED_BOUNDARY,
            "The tiled kernel backend serves periodic/zero boundaries",
            suggestions=("Use backend='torch' for symmetric tiling",),
        )
    return name


# --- the transforms -------------------------------------------------------------------


def modwt_multilevel_tiled(
    x: torch.Tensor,
    wavelet,
    *,
    levels: int,
    mesh: Mesh,
    axis: str = "signal",
    boundary: str = "periodic",
    batch_axis: str | None = None,
    backend: str = "auto",
    precision: str | None = None,
) -> MultiLevelMODWTResult:
    """Multi-level MODWT of a signal split along its LAST axis over
    ``mesh[axis]``.

    Machine-precision parity with the single-device ``modwt_multilevel``
    for every boundary mode.  ``batch_axis`` optionally splits the FIRST
    axis over a second mesh axis (the batch over hosts, :mod:`.multihost`);
    halos only ever cross ``axis``.  On the kernel route (module docstring)
    the whole local cascade is one external-edge launch per device, fed one
    cumulative halo of ``(L0-1)(2^J-1)`` samples.  ``precision`` names a
    tier of the kernel tier, as in the JAX signature: it is validated on
    every route and changes nothing, since every tier runs the fp32 kernel.
    On a mesh that spans ranks ``x`` is this rank's block
    (:func:`.mesh.local_index`) and so is each plane of the result.
    """
    return _analysis(x, wavelet, levels, mesh, axis, boundary, batch_axis, backend, precision)


def _analysis(x, wavelet, levels, mesh, axis, boundary, batch_axis, backend, precision, *,
              world: bool = True) -> MultiLevelMODWTResult:
    """:func:`modwt_multilevel_tiled`; ``world`` as :func:`_tiles` takes it."""
    from ..kernels.modwt_fused import _check_precision

    _check_precision(precision)
    w = _resolve_discrete(wavelet)
    boundary_l = boundary.lower()
    tiles = _tiles(mesh, axis, batch_axis, tuple(x.shape), -1, world=world)
    n = x.shape[-1]
    _check_level_fits(w, levels, tiles.n)
    wrap = boundary_l.startswith("per")
    from_left, _ = _ring_perms(axis, mesh, wrap)
    resolved = _resolve_tiled_backend(backend, boundary_l, tiles, x.dtype,
                                      w.filter_length, levels)
    lead = tuple(x.shape[:-1])
    x2 = _flat(x, tiles)
    low = w.dec_lo * _INV_SQRT2
    high = w.dec_hi * _INV_SQRT2

    def unflat(planes):
        planes = tuple(p.reshape(lead + (n,)) for p in planes)
        return MultiLevelMODWTResult(planes[:levels], planes[levels])

    if not boundary_l.startswith("sym"):
        # ONE cumulative raw-x halo of (L0-1)(2^J-1) samples, then the whole
        # local cascade zero-extended on [halo | x]; the periodic wrap and
        # the global zero edge both ride the hop chain
        span = (w.filter_length - 1) * ((1 << levels) - 1)
        halos = _gather_halo(tiles.shards(x2), span, from_left, "left", tiles.ring)
        if resolved == "kernel":
            from ..kernels import modwt_composite as mc
            from ..kernels.modwt_fused import _kernel_filters

            filters = _kernel_filters(w, synthesis=False)
            return unflat(tiles.compute((x2,), (halos,), lambda rows, hal: mc.analysis(
                rows[0], levels, filters, False, halo=hal[0])))

        def cascade(rows, hal):
            cur = torch.cat([hal[0], rows[0]], dim=-1)
            details = []
            for level in range(1, levels + 1):
                cur, detail = atrous_analysis_pair(cur, low, high, spacing=1 << (level - 1),
                                                   boundary="zero")
                details.append(detail[..., span:])
            return (*details, cur[..., span:])

        return unflat(tiles.compute((x2,), (halos,), cascade))

    cur = x2
    details = []
    for level in range(1, levels + 1):
        spacing = 1 << (level - 1)
        halo_len = effective_length(w.filter_length, level) - 1
        if halo_len > tiles.n_loc:
            # deep-halo symmetric: the mirror of the global head spans several
            # shards, so the shards are gathered and the single-device op runs
            # on the whole signal (cheap by definition in that regime); across
            # ranks each rank gathers its rows and keeps its own columns
            a, d = atrous_analysis_pair(tiles.gather_axis(cur), low, high, spacing=spacing,
                                        boundary="symmetric")
            cur = tiles.own(a)
            details.append(tiles.own(d))
            continue
        shards = tiles.shards(cur)
        halos = _gather_halo(shards, halo_len, from_left, "left", tiles.ring)
        if tiles.head:
            halos = _with_shard(halos, 0, _mirror_tail(shards[:, 0], halo_len))

        def level_pair(rows, hal, spacing=spacing, halo_len=halo_len):
            a, d = atrous_analysis_pair(torch.cat([hal[0], rows[0]], dim=-1), low, high,
                                        spacing=spacing, boundary="zero")
            return a[..., halo_len:], d[..., halo_len:]

        cur, detail = tiles.compute((cur,), (halos,), level_pair)
        details.append(detail)
    return unflat((*details, cur))


def imodwt_multilevel_tiled(
    result: MultiLevelMODWTResult,
    wavelet,
    *,
    mesh: Mesh,
    axis: str = "signal",
    boundary: str = "periodic",
    batch_axis: str | None = None,
    backend: str = "auto",
    precision: str | None = None,
) -> torch.Tensor:
    """Inverse of :func:`modwt_multilevel_tiled`, all three boundary modes.

    PERIODIC/ZERO synthesis uses the adjoint ``(t + 2^(j-1) l)`` indexing, so
    halos come from the RIGHT ring neighbours (per level on the plain route,
    one cumulative halo per plane and one synthesis launch per device on the
    kernel route).  SYMMETRIC's alignment-shifted inverse reads
    ``t + sign*2^(j-1)*l + offset`` with per-level tau offsets, so it needs
    TWO-SIDED halos; the global mirror only affects the first and last
    shard, whose halos are rebuilt from their own edge data.  When a halo
    exceeds the shard width the level gathers the whole signal.  On a mesh
    that spans ranks the planes are this rank's blocks, and so is the
    result.
    """
    return _synthesis(result, wavelet, mesh, axis, boundary, batch_axis, backend, precision)


def _synthesis(result, wavelet, mesh, axis, boundary, batch_axis, backend, precision, *,
               world: bool = True) -> torch.Tensor:
    """:func:`imodwt_multilevel_tiled`; ``world`` as :func:`_tiles` takes it."""
    from ..kernels.modwt_fused import _check_precision

    _check_precision(precision)
    w = _resolve_discrete(wavelet)
    boundary_l = boundary.lower()
    levels = result.levels
    approx = result.approx
    tiles = _tiles(mesh, axis, batch_axis, tuple(approx.shape), -1, world=world)
    wrap = boundary_l.startswith("per")
    resolved = _resolve_tiled_backend(backend, boundary_l, tiles, approx.dtype,
                                      w.filter_length, levels)
    from_left, from_right = _ring_perms(axis, mesh, wrap)
    lead, n = tuple(approx.shape[:-1]), approx.shape[-1]
    planes = [_flat(p, tiles) for p in (*result.details, approx)]
    low = w.rec_lo * _INV_SQRT2
    high = w.rec_hi * _INV_SQRT2
    ring = tiles.ring

    if resolved == "kernel":
        from ..kernels import modwt_composite as mc
        from ..kernels.modwt_fused import _kernel_filters

        filters = _kernel_filters(w, synthesis=True)
        span = (w.filter_length - 1) * ((1 << levels) - 1)
        halos = _gather_halos(tuple(tiles.shards(p) for p in planes), span, from_right,
                              "right", ring)
        (out,) = tiles.compute(tuple(planes), halos, lambda rows, hal: (mc.synthesis(
            rows, levels, filters, False, halo=hal),))
        return out.reshape(lead + (n,))

    def two_sided_conv(plane, filt, spacing, sign, offset):
        """One symmetric synthesis branch: gather two-sided halos, mirror-fix
        the global edges, convolve with the tau-offset indexing."""
        deltas = [offset + sign * spacing * k for k in range(len(filt))]
        lh = max(0, -min(deltas))
        rh = max(0, max(deltas))
        if lh > tiles.n_loc or rh > tiles.n_loc:
            return tiles.own(atrous_convolve(tiles.gather_axis(plane), filt, spacing=spacing,
                                             boundary="symmetric", sign=sign, offset=offset))
        shards = tiles.shards(plane)
        halos = []
        if lh:
            # global head mirror: position -p-1 (p in 1..lh) -> plane[p-1]
            left = _gather_halo(shards, lh, from_left, "left", ring)
            if tiles.head:
                left = _with_shard(left, 0, torch.flip(shards[:, 0, :lh], dims=(-1,)))
            halos.append(left)
        if rh:
            # global tail mirror: position N+q -> plane[n_loc-1-q]
            right = _gather_halo(shards, rh, from_right, "right", ring)
            if tiles.tail:
                right = _with_shard(right, tiles.T - 1,
                                    torch.flip(shards[:, -1, -rh:], dims=(-1,)))
            halos.append(right)

        def conv(rows, hal):
            pieces = ([hal[0]] if lh else []) + [rows[0]] + ([hal[-1]] if rh else [])
            out = atrous_convolve(torch.cat(pieces, dim=-1), filt, spacing=spacing,
                                  boundary="zero", sign=sign, offset=offset)
            return (out[..., lh: lh + tiles.n_loc],)

        return tiles.compute((plane,), tuple(halos), conv)[0]

    cur = planes[levels]
    for level in range(levels, 0, -1):
        spacing = 1 << (level - 1)
        detail = planes[level - 1]
        if boundary_l.startswith("sym"):
            dec = _symmetric_alignment(w, level)
            tau_h = _tau_j(w.rec_lo.shape[0], level) + dec.delta_approx
            tau_g = _tau_j(w.rec_hi.shape[0], level) + dec.delta_detail
            cur = two_sided_conv(
                cur, low, spacing, +1 if dec.approx_plus else -1,
                -tau_h if dec.approx_plus else tau_h,
            ) + two_sided_conv(
                detail, high, spacing, +1 if dec.detail_plus else -1,
                -tau_g if dec.detail_plus else tau_g,
            )
            continue
        halo_len = effective_length(w.filter_length, level) - 1
        halos = _gather_halos((tiles.shards(cur), tiles.shards(detail)), halo_len,
                              from_right, "right", ring)

        def level_synthesis(rows, hal, spacing=spacing):
            ext_c = torch.cat([rows[0], hal[0]], dim=-1)
            ext_d = torch.cat([rows[1], hal[1]], dim=-1)
            rec = atrous_convolve(ext_c, low, spacing=spacing, boundary="zero", sign=+1) \
                + atrous_convolve(ext_d, high, spacing=spacing, boundary="zero", sign=+1)
            return (rec[..., : tiles.n_loc],)

        (cur,) = tiles.compute((cur, detail), halos, level_synthesis)
    return cur.reshape(lead + (n,))


def tiled_roundtrip_check(
    mesh: Mesh,
    *,
    axis: str = "signal",
    wavelet: str = "db4",
    levels: int = 3,
    n: int = 1024,
    dtype=torch.float32,
    seed: int = 0,
) -> float:
    """Round-trip a random signal through the tiled transform on the mesh's
    first device of this rank; returns the max abs error against the input.
    On a mesh that spans ranks each rank round-trips its block of the one
    seeded signal, and the result is the largest error over all ranks (one
    ``all_reduce``)."""
    home = mesh.local_devices[0]
    x = torch.as_tensor(np.random.default_rng(seed).standard_normal(n), dtype=dtype,
                        device=home)[local_index(mesh, (n,), axis=axis)]
    res = modwt_multilevel_tiled(x, wavelet, levels=levels, mesh=mesh, axis=axis,
                                 boundary="periodic")
    xr = imodwt_multilevel_tiled(res, wavelet, mesh=mesh, axis=axis, boundary="periodic")
    err = (xr - x).abs().max()
    if not mesh.is_local:
        err = exchange.all_reduce_max(err)
    return float(err)


# ---------------------------------------------------------------------------
# EXACT (<=1e-10) sharded tier: the fp64 double-float kernels of
# kernels/modwt_exact.py run shard-locally, with the halo exchanged over the
# ring like the fast tier's: the analysis halo is RAW float32 input (exact
# by construction), the synthesis halo is each plane's (hi, lo) head, so the
# sharded round trip keeps the single-device parity contract (<=1e-10).
# ---------------------------------------------------------------------------


def modwt_multilevel_tiled_exact(
    x: torch.Tensor,
    wavelet,
    *,
    levels: int,
    mesh: Mesh,
    axis: str = "signal",
    boundary: str = "periodic",
    batch_axis: str | None = None,
    profile: str = "balanced",
):
    """Sharded exact analysis: ``(details pairs tuple, approx pair)``, each
    plane a float32 ``(hi, lo)`` pair shaped like the input (across ranks,
    like this rank's block).  ``profile`` is validated and changes nothing
    (``kernels.modwt_exact``)."""
    from ..kernels.modwt_exact import _resolve_profile, analysis_exact
    from ..kernels.modwt_fused import _kernel_filters

    _resolve_profile(profile)
    w = _resolve_discrete(wavelet)
    boundary_l = boundary.lower()
    if not boundary_l.startswith(("per", "zero")):
        raise InvalidArgumentError(
            ErrorCode.CFG_UNSUPPORTED_BOUNDARY,
            "Exact tiled analysis supports periodic/zero boundaries",
        )
    wrap = boundary_l.startswith("per")
    tiles = _tiles(mesh, axis, batch_axis, tuple(x.shape), -1)
    filters = _kernel_filters(w, synthesis=False)
    span = (w.filter_length - 1) * ((1 << levels) - 1)
    from_left, _ = _ring_perms(axis, mesh, wrap)
    lead, n = tuple(x.shape[:-1]), x.shape[-1]
    x2 = _flat(x, tiles).to(torch.float32)
    if wrap and span >= tiles.n:
        # the periodic extension wraps more than once: gather the whole
        # signal and run the single-device exact transform (cheap by
        # definition in that regime); across ranks each keeps its columns
        flat = tuple(tiles.own(t) for pair in analysis_exact(
            tiles.gather_axis(x2), levels, filters, True, profile=profile) for t in pair)
    else:
        halos = _gather_halo(tiles.shards(x2), min(span, tiles.n), from_left, "left",
                             tiles.ring)
        flat = tiles.compute((x2,), (halos,), lambda rows, hal: tuple(
            t for pair in analysis_exact(rows[0], levels, filters, False, halo=hal[0],
                                         profile=profile) for t in pair))
    pairs = tuple((flat[2 * i].reshape(lead + (n,)), flat[2 * i + 1].reshape(lead + (n,)))
                  for i in range(levels + 1))
    return pairs[:levels], pairs[levels]


def imodwt_multilevel_tiled_exact(
    details,
    approx,
    wavelet,
    *,
    mesh: Mesh,
    axis: str = "signal",
    boundary: str = "periodic",
    batch_axis: str | None = None,
    profile: str = "balanced",
):
    """Sharded exact synthesis from double-float plane pairs: returns the
    reconstructed ``(hi, lo)`` pair (combine in float64 to evaluate; across
    ranks, this rank's block).  A boundary other than periodic takes zero
    edges, as in JAX."""
    from ..kernels.modwt_exact import _resolve_profile, synthesis_exact
    from ..kernels.modwt_fused import _kernel_filters

    _resolve_profile(profile)
    w = _resolve_discrete(wavelet)
    wrap = boundary.lower().startswith("per")
    levels = len(details)
    tiles = _tiles(mesh, axis, batch_axis, tuple(approx[0].shape), -1)
    filters = _kernel_filters(w, synthesis=True)
    span = (w.filter_length - 1) * ((1 << levels) - 1)
    _, from_right = _ring_perms(axis, mesh, wrap)
    lead, n = tuple(approx[0].shape[:-1]), approx[0].shape[-1]
    flat = [_flat(t, tiles).to(torch.float32) for pair in (*details, approx) for t in pair]

    def pairs_of(ts):
        return tuple((ts[2 * i], ts[2 * i + 1]) for i in range(levels + 1))

    if wrap and span >= tiles.n:
        # multi-wrap periodic extension: gather every plane pair and run the
        # single-device exact synthesis
        hi, lo = map(tiles.own, synthesis_exact(pairs_of([tiles.gather_axis(t) for t in flat]),
                                                levels, filters, True, profile=profile))
    else:
        halos = _gather_halos(tuple(tiles.shards(t) for t in flat), min(span, tiles.n),
                              from_right, "right", tiles.ring)
        hi, lo = tiles.compute(tuple(flat), halos, lambda rows, hal: synthesis_exact(
            pairs_of(rows), levels, filters, False, halo=pairs_of(hal), profile=profile))
    return hi.reshape(lead + (n,)), lo.reshape(lead + (n,))
