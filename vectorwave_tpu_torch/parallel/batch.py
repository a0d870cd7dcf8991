"""Batch (data-parallel) sharded transforms.

Counterpart of ``vectorwave_tpu/parallel/batch.py``: the MODWT is
independent per signal, so batch parallelism is a split leading axis and
each shard's transform runs locally with no communication.  In one process
the shards of one device run as one call (one kernel launch on a Hopper
card, :meth:`.tiled._Tiles.compute` with no halo); the results are gathered
on the mesh's first device.  On a mesh that spans ranks each rank passes the
rows its cells hold and gets its rows back, with no message; a 1-D signal
split over the ranks is transformed as one signal, over the tiled route.
"""

from __future__ import annotations

import torch

from ..errors import ErrorCode, InvalidArgumentError
from ..transforms.multilevel import MultiLevelMODWTResult, modwt_multilevel
from .mesh import Mesh, rank_box
from .tiled import _tiles, modwt_multilevel_tiled


def _batch_tiles(x: torch.Tensor, mesh: Mesh, axis: str):
    """The tiling of ``x[None]``: its leading (batch) axis split over
    ``mesh[axis]``, as a signal axis is by :mod:`.tiled`."""
    count = len(rank_box(mesh, (axis,)).ranges[0])
    if x.dim() < 1 or x.shape[0] % count != 0:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"leading axis of shape {tuple(x.shape)} not divisible by the {count} "
            f"shards of {axis!r}",
            suggestions=("Pad the batch to a multiple of the mesh axis size",),
        )
    return _tiles(mesh, axis, None, (1, *x.shape), -x.dim())


def shard_batch(x: torch.Tensor, mesh: Mesh, *, axis: str = "data") -> tuple:
    """Split ``x``'s leading axis over ``mesh[axis]``: one tensor per shard,
    on its device (the port has no sharded array type).  On a mesh that
    spans ranks ``x`` is this rank's rows and the shards are its cells'."""
    tiles = _batch_tiles(x, mesh, axis)
    return tuple(chunk.to(dev) for chunk, dev in zip(torch.chunk(x, tiles.T), tiles.cells[0]))


def modwt_multilevel_sharded_batch(
    x: torch.Tensor,
    wavelet,
    *,
    levels: int,
    mesh: Mesh,
    axis: str = "data",
    boundary: str = "periodic",
) -> MultiLevelMODWTResult:
    """Batch MODWT with the batch axis split over the mesh.

    Each device's rows go through :func:`modwt_multilevel` as one call.
    Routing follows the MESH's devices: a CUDA device routes as
    ``modwt_multilevel`` does (the kernel tier where eligible), any other
    device takes the plain cascade.  On a mesh that spans ranks ``x`` is this
    rank's rows (a 1-D ``x``, its samples of one signal) and so is the
    result.
    """
    tiles = _batch_tiles(x, mesh, axis)

    def transform(rows, _):
        res = modwt_multilevel(rows[0], wavelet, levels=levels, boundary=boundary,
                               backend=None if rows[0].device.type == "cuda" else "torch")
        return (*res.details, res.approx)

    if x.dim() < 2:  # one signal split over the devices: its transform is global
        if not tiles.ring.whole:  # across ranks: the tiled route over the axis
            return modwt_multilevel_tiled(x, wavelet, levels=levels, mesh=mesh, axis=axis,
                                          boundary=boundary)
        planes = transform((x.to(tiles.home),), ())
        return MultiLevelMODWTResult(planes[:levels], planes[levels])

    planes = [p[0] for p in tiles.compute((x[None].to(tiles.home),), (), transform)]
    return MultiLevelMODWTResult(tuple(planes[:levels]), planes[levels])
