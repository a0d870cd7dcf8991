"""Device meshes: named axes over a grid of torch devices.

Counterpart of ``vectorwave_tpu/parallel/mesh.py``.  The axes keep the JAX
package's meaning:

* ``data``   — batch sharding;
* ``signal`` — long-signal tiling with halo exchange (:mod:`.tiled`).

The port runs a whole mesh inside one process.  A mesh is a grid of
``torch.device`` objects, and a device may repeat: ``[torch.device("cpu")] *
8`` is eight shards on one CPU (the counterpart of the JAX tests' forced
host device count), ``[torch.device("cuda")] * 4`` four shards on one card.
The shards of one device are computed together (:mod:`.tiled`); shards on
different devices exchange their halos with ``Tensor.to``.  A transport
with one process per card (``torch.distributed``, NCCL point-to-point
halos) is later work; :class:`Mesh` keeps the axis names and the device
grid that such a transport would group by process.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..errors import ErrorCode, InvalidArgumentError


class Mesh:
    """Named axes over an ndarray of ``torch.device`` (a device may repeat)."""

    def __init__(self, devices, axis_names):
        given = np.asarray(devices, dtype=object)
        grid = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device(given[idx])
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise InvalidArgumentError(
                ErrorCode.DIST_BAD_MESH,
                f"A mesh of shape {grid.shape} needs {grid.ndim} distinct axis names, "
                f"got {axis_names}",
            )
        self.devices = grid
        self.axis_names = axis_names

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

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.devices.flatten().tolist()})"


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
