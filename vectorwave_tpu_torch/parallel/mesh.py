"""Device meshes: named axes over a grid of torch devices.

Counterpart of ``vectorwave_tpu/parallel/mesh.py``.  The axes keep the JAX
package's meaning:

* ``data``   — batch sharding;
* ``signal`` — long-signal tiling with halo exchange (:mod:`.tiled`).

A mesh is a grid of ``torch.device`` objects, and a device may repeat:
``[torch.device("cpu")] * 8`` is eight shards on one CPU (the counterpart
of the JAX tests' forced host device count), ``[torch.device("cuda")] * 4``
four shards on one card.  The shards of one device are computed together
(:mod:`.tiled`); shards on different devices exchange their halos with
``Tensor.to``.

Each cell belongs to a process, the counterpart of JAX's
``device.process_index``.  In one process every cell is this process's
(rank 0).  In a ``torch.distributed`` world of several ranks,
:func:`make_mesh` and :func:`.multihost.make_multihost_mesh` gather every
rank's device list once and lay the lists out in rank order (JAX's
``jax.devices()`` order): this rank's cells are ``torch.device`` entries,
every other rank's are :class:`RemoteDevice` entries, which name that rank
and its device and are never computed on here.

Such a mesh follows the counterpart of a global ``jax.Array`` built from
process-local data: each rank passes the block of the global input that its
own cells hold under the facade's layout and gets back the block of the
output that its cells hold (``addressable_shards``).  :func:`local_index`
gives that block's place in the global tensor.  A rank's cells must form one
box of the grid of the axes the facade splits, and a mesh that spans ranks
has no replica axis (the facade splits every axis); both are decided
from the mesh alone, so every rank raises the same fault before any message
is sent.  Halos that cross ranks travel over ``torch.distributed``
(:mod:`.exchange`); in one process nothing changes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..errors import ErrorCode, InvalidArgumentError


@dataclass(frozen=True)
class RemoteDevice:
    """A mesh cell of another rank: that rank's device, which this process
    never computes on (``rank 1``'s ``cuda:0`` is not this rank's)."""

    rank: int
    device: torch.device


class Mesh:
    """Named axes over an ndarray of ``torch.device`` (a device may repeat);
    other ranks' cells are :class:`RemoteDevice` entries, and ``rank`` is
    this process's rank (0 in one process)."""

    def __init__(self, devices, axis_names, *, rank: int = 0):
        given = np.asarray(devices, dtype=object)
        grid = np.empty(given.shape, dtype=object)
        owners = np.full(given.shape, rank, dtype=int)
        for idx in np.ndindex(grid.shape):
            cell = given[idx]
            if isinstance(cell, RemoteDevice):
                grid[idx], owners[idx] = cell, cell.rank
            else:
                grid[idx] = torch.device(cell)
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise InvalidArgumentError(
                ErrorCode.DIST_BAD_MESH,
                f"A mesh of shape {grid.shape} needs {grid.ndim} distinct axis names, "
                f"got {axis_names}",
            )
        self.devices = grid
        self.axis_names = axis_names
        self.rank = rank
        #: the rank that owns each cell, shaped like :attr:`devices`
        self.process_index = owners
        #: how many ranks own cells of the mesh (1 in one process)
        self.process_count = len(np.unique(owners))

    @property
    def shape(self) -> dict[str, int]:
        """``{axis: size}``, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_size(self, axis: str) -> int:
        """Size of ``axis``; an axis the mesh lacks raises."""
        if axis not in self.axis_names:
            raise InvalidArgumentError(
                ErrorCode.DIST_BAD_MESH,
                f"The mesh has no axis {axis!r}",
                context={"axes": self.axis_names},
                suggestions=(f"Use one of {self.axis_names}",),
            )
        return self.shape[axis]

    @property
    def is_local(self) -> bool:
        """Whether every cell is this rank's (a one-process mesh)."""
        return bool((self.process_index == self.rank).all())

    @property
    def local_devices(self) -> list[torch.device]:
        """This rank's cells, in grid order."""
        return [c for c in self.devices.flat if not isinstance(c, RemoteDevice)]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.devices.flatten().tolist()})"


def _world() -> tuple[int, int] | None:
    """``(rank, world size)`` of an initialised ``torch.distributed`` world
    of several ranks, else None."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() < 2:
        return None
    return dist.get_rank(), dist.get_world_size()


def _gather_rows(devices, default, rank: int, size: int) -> list:
    """Every rank's device names, in rank order, from ONE
    ``all_gather_object``: this rank contributes ``devices`` (or
    ``default()``).  Every check reads what was gathered, so the ranks raise
    together and none waits in a collective."""
    import torch.distributed as dist

    try:
        row = default() if devices is None else [torch.device(d) for d in devices]
        mine = [str(d) for d in row]
    except (RuntimeError, TypeError, AssertionError) as exc:  # no card; a bad name
        mine = f"{type(exc).__name__}: {exc}"
    gathered: list = [None] * size
    dist.all_gather_object(gathered, mine)
    faults = {r: g for r, g in enumerate(gathered) if isinstance(g, str)}
    if faults:
        raise InvalidArgumentError(
            ErrorCode.DIST_BAD_MESH,
            f"Ranks {sorted(faults)} could not name their devices: {faults}",
            suggestions=("Pass devices= on every rank, or give each rank its card "
                         "with torch.cuda.set_device",),
        )
    counts = {r: len(g) for r, g in enumerate(gathered)}
    if len(set(counts.values())) != 1 or counts[rank] == 0:
        raise InvalidArgumentError(
            ErrorCode.DIST_BAD_MESH,
            f"Uneven devices per rank: {counts}",
            suggestions=("Pass an explicit, balanced device list on every rank",),
        )
    return gathered


def _cells(rows: list, rank: int) -> list:
    """The gathered rows as mesh cells, in rank order: this rank's as
    ``torch.device``, the others' as :class:`RemoteDevice`."""
    return [torch.device(name) if r == rank else RemoteDevice(r, torch.device(name))
            for r, names in enumerate(rows) for name in names]


def visible_devices() -> list[torch.device]:
    """The CUDA devices this process sees, one per card."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    shape: dict[str, int] | None = None,
    *,
    devices=None,
) -> Mesh:
    """Create a mesh from ``{axis: size}``.  With no shape, all devices go on
    a single ``data`` axis.  The default devices are the visible CUDA
    devices; virtual shards are asked for explicitly, for example
    ``devices=[torch.device("cuda")] * 4``.

    In a ``torch.distributed`` world of several ranks ``devices`` is this
    rank's own list (by default its visible cards): the ranks exchange their
    lists once, with ``all_gather_object``, and the mesh lays them out in
    rank order, as ``jax.devices()`` orders the processes' devices.  Uneven
    lists raise on every rank."""
    world = _world()
    rank = 0
    if world is not None:
        rank = world[0]
        devices = _cells(_gather_rows(devices, visible_devices, *world), rank)
    else:
        devices = visible_devices() if devices is None else [torch.device(d) for d in devices]
    if not devices:
        raise InvalidArgumentError(
            ErrorCode.DIST_BAD_MESH,
            "No CUDA device is visible to build a mesh on",
            suggestions=("Pass devices=, e.g. [torch.device('cpu')] * 8",),
        )
    if shape is None:
        shape = {"data": len(devices)}
    sizes = list(shape.values())
    total = math.prod(sizes)
    if total > len(devices) or min(sizes, default=0) < 1:
        raise InvalidArgumentError(
            ErrorCode.DIST_BAD_MESH,
            f"Mesh shape {shape} needs {total} devices, have {len(devices)}",
            suggestions=("Reduce mesh axis sizes",),
        )
    grid = np.empty(total, dtype=object)
    grid[:] = devices[:total]
    return Mesh(grid.reshape(sizes), axis_names=tuple(shape.keys()), rank=rank)


def default_mesh() -> Mesh:
    """1-D data mesh over every visible device (in a world of several ranks,
    every rank's, as :func:`make_mesh` gathers them)."""
    return make_mesh(None)


# --- this rank's block ----------------------------------------------------------------


class Box(NamedTuple):
    """This rank's cells in the grid of the split axes: ``ranges[k]`` is the
    ``range`` of indices it holds along ``axes[k]``, ``owners`` the rank of
    every cell of the grid (the first replica's, in one process)."""

    axes: tuple
    ranges: tuple
    owners: np.ndarray


def _box(mesh: Mesh, axes: tuple) -> Box:
    """This rank's box in the grid of ``axes``; a rank whose cells do not
    form one box raises, on every rank alike."""
    for a in axes:
        mesh.axis_size(a)  # an axis the mesh lacks raises
    owners = mesh.process_index
    keep = [mesh.axis_names.index(a) for a in axes]
    others = [i for i in range(owners.ndim) if i not in keep]
    ranges = {}
    for r in np.unique(owners):
        cells = {tuple(idx[i] for i in keep) for idx in zip(*np.nonzero(owners == r))}
        spans = [sorted({c[k] for c in cells}) for k in range(len(keep))]
        box = [range(s[0], s[-1] + 1) for s in spans]
        if len(cells) != math.prod(len(b) for b in box) or any(
                len(s) != len(b) for s, b in zip(spans, box)):
            raise InvalidArgumentError(
                ErrorCode.DIST_BAD_MESH,
                f"The cells of rank {int(r)} form no box of the {axes} grid of mesh "
                f"{mesh.shape}",
                context={"rank": mesh.rank, "process_index": owners.tolist()},
                suggestions=("Order each rank's devices so that its cells are one block "
                             "of the grid",),
            )
        ranges[int(r)] = tuple(box)
    if mesh.rank not in ranges:
        raise InvalidArgumentError(
            ErrorCode.DIST_BAD_MESH,
            f"Rank {mesh.rank} holds no cell of mesh {mesh.shape}",
            suggestions=("Build the mesh from every rank's devices",),
        )
    first = owners.transpose(keep + others).reshape(
        tuple(owners.shape[i] for i in keep) + (-1,))[..., 0]
    return Box(tuple(axes), ranges[mesh.rank], first)


def _check_world(mesh: Mesh) -> None:
    """A mesh that spans ranks is used inside the ``torch.distributed``
    world it was built in: initialised, this process its ``rank``, and
    every rank of the world holding cells."""
    import torch.distributed as dist

    ranks = sorted(int(r) for r in np.unique(mesh.process_index))
    live = dist.is_available() and dist.is_initialized()
    if not live or dist.get_rank() != mesh.rank or ranks != list(range(dist.get_world_size())):
        raise InvalidArgumentError(
            ErrorCode.DIST_BAD_MESH,
            f"The mesh holds the cells of ranks {ranks}, and this process is not rank "
            f"{mesh.rank} of an initialised torch.distributed world of those ranks",
            context={"rank": mesh.rank, "shape": mesh.shape},
            suggestions=(
                "Build the mesh with make_mesh or make_multihost_mesh inside the world",
                "Or pass this rank's cells alone, a one-process mesh: "
                "Mesh(mesh.local_devices, ('signal',))",
            ),
        )


def rank_box(mesh: Mesh, axes: tuple, *, world: bool = True) -> Box:
    """This rank's box for a facade that splits ``axes`` (None entries
    dropped).  In one process it is the whole grid.  A mesh that spans ranks
    must be used in its world (unless ``world`` is False: a layout that
    never crosses ranks), must hold no axis that the facade does not split
    (its replicas would be computed on several ranks, or left idle) and must
    give each rank one box."""
    axes = tuple(a for a in axes if a is not None)
    if mesh.is_local:
        return Box(axes, tuple(range(mesh.axis_size(a)) for a in axes),
                   np.full(tuple(mesh.axis_size(a) for a in axes), mesh.rank))
    if world:
        _check_world(mesh)
    replicas = [a for a in mesh.axis_names if a not in axes]
    if replicas:
        raise InvalidArgumentError(
            ErrorCode.DIST_BAD_MESH,
            f"The mesh spans ranks, and the facade splits {axes} only: its axes "
            f"{replicas} would hold replicas, which cannot span ranks",
            context={"rank": mesh.rank, "shape": mesh.shape},
            suggestions=(
                "Split the batch over that axis with batch_axis=, or build the mesh of "
                "the split axes alone",
                "Or pass this rank's cells alone, a one-process mesh: "
                "Mesh(mesh.local_devices, ('signal',))",
            ),
        )
    return _box(mesh, axes)


def local_index(mesh: Mesh, shape, *, axis: str, batch_axis: str | None = None,
                dim: int = -1) -> tuple:
    """The slices that place this rank's block in a global tensor of
    ``shape`` whose dimension ``dim`` is split over ``mesh[axis]`` and, with
    ``batch_axis``, its first dimension over ``mesh[batch_axis]`` (the
    facades' layout): ``global[local_index(...)]`` is the block this rank
    passes, and ``global[local_index(...)] = block`` puts an output back.
    In one process every slice is whole."""
    shape = tuple(shape)
    dim = dim % len(shape)
    index = [slice(None)] * len(shape)
    if mesh.is_local:
        return tuple(index)
    box = _box(mesh, (batch_axis, axis) if batch_axis is not None else (axis,))
    for d, a, r in zip((0, dim) if batch_axis is not None else (dim,), box.axes, box.ranges):
        size = mesh.axis_size(a)
        if shape[d] % size != 0:
            raise InvalidArgumentError(
                ErrorCode.VAL_INVALID_SHAPE,
                f"dimension {d} of {shape} is not divisible by the {size} shards of {a!r}",
            )
        step = shape[d] // size
        index[d] = slice(r.start * step, r.stop * step)
    return tuple(index)
