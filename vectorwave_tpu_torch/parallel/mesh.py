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
(rank 0).  A mesh that spans the ranks of a ``torch.distributed`` world
(:func:`.multihost.make_multihost_mesh`, one row a rank) holds this rank's
cells as ``torch.device`` and every other rank's as a
:class:`RemoteDevice`, which names that rank and its device and is never
computed on here.  Only the multihost facades take such a mesh: each rank
runs its own row, and nothing crosses ranks during a transform.  The other
facades compute every cell in one process and raise on it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

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
    def local_devices(self) -> list[torch.device]:
        """This rank's cells, in grid order."""
        return [c for c in self.devices.flat if not isinstance(c, RemoteDevice)]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.devices.flatten().tolist()})"


def _check_one_process(mesh: Mesh) -> None:
    """Raise unless ``mesh`` lies in this process: every facade but the
    multihost pair computes each cell itself."""
    if mesh.process_count > 1:
        raise InvalidArgumentError(
            ErrorCode.DIST_BAD_MESH,
            f"The mesh spans {mesh.process_count} ranks, and this facade computes "
            "every cell in one process",
            context={"rank": mesh.rank, "shape": mesh.shape},
            suggestions=(
                "Pass this rank's row: make_mesh({'chip': len(mesh.local_devices)}, "
                "devices=mesh.local_devices)",
                "Or use modwt_multilevel_multihost / imodwt_multilevel_multihost",
            ),
        )


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
    ``devices=[torch.device("cuda")] * 4``."""
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
    return Mesh(grid.reshape(sizes), axis_names=tuple(shape.keys()))


def default_mesh() -> Mesh:
    """1-D data mesh over every visible device."""
    return make_mesh(None)
