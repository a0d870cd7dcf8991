"""Host x chip meshes and the hierarchical transform facade.

Counterpart of ``vectorwave_tpu/parallel/multihost.py``.  The layout rule
it encodes: axes whose exchanges run per transform level (the signal
tiling's halos) map to the fast link between the cards of one host, and the
axis crossing hosts carries only work that needs no exchange during the
transform, the batch.

* :func:`make_multihost_mesh` builds a ``("host", "chip")`` mesh.  In a
  ``torch.distributed`` world of several ranks (one process a host, as JAX
  groups the rows by ``device.process_index``) each rank contributes one
  row, in rank order: the ``devices`` it passes, by default its current
  card.  The ranks exchange their rows once, with ``all_gather_object``,
  and every rank raises on the same faults.  In one process (no process
  group, or a world of one) the device list is split contiguously into
  hosts.
* :func:`modwt_multilevel_multihost` / :func:`imodwt_multilevel_multihost`
  split the batch over ``"host"`` and tile the signal over ``"chip"``.  In
  a world of several ranks each rank passes its own batch rows and gets its
  own rows back (the counterpart of the global array's addressable
  shards); it tiles them over its own row, so no ``torch.distributed``
  call runs during a transform.
* :func:`communication_report` is the analytic communication model: the
  bytes each chip receives per transform.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..errors import ErrorCode, InvalidArgumentError
from ..transforms.modwt import _resolve_discrete
from ..transforms.multilevel import MultiLevelMODWTResult
from .mesh import Mesh, RemoteDevice, visible_devices
from .tiled import imodwt_multilevel_tiled, modwt_multilevel_tiled

HOST_AXIS = "host"
CHIP_AXIS = "chip"


def _world() -> tuple[int, int] | None:
    """``(rank, world size)`` of an initialised ``torch.distributed`` world
    of several ranks, else None."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() < 2:
        return None
    return dist.get_rank(), dist.get_world_size()


def make_multihost_mesh(
    n_hosts: int | None = None,
    chips_per_host: int | None = None,
    *,
    devices=None,
) -> Mesh:
    """Build a ``("host", "chip")`` mesh aligned with process boundaries.

    In a ``torch.distributed`` world of several ranks the rows are the
    ranks, in rank order, and this rank's row is ``devices`` (default: its
    current card, one chip a rank, since under ``torchrun`` every rank sees
    every card).  Uneven rows, an ``n_hosts`` other than the world size or
    a ``chips_per_host`` other than the row's length raise on every rank.
    In one process the device list (the visible CUDA devices by default) is
    split contiguously into ``n_hosts`` rows of ``chips_per_host`` devices.
    """
    world = _world()
    if world is not None:
        return _rows_by_rank(n_hosts, chips_per_host, devices, *world)
    devices = visible_devices() if devices is None else [torch.device(d) for d in devices]
    if n_hosts is None:
        n_hosts = 1
    if chips_per_host is None:
        chips_per_host = len(devices) // n_hosts
    need = n_hosts * chips_per_host
    if need > len(devices) or chips_per_host < 1 or n_hosts < 1:
        raise InvalidArgumentError(
            ErrorCode.DIST_BAD_MESH,
            f"Mesh {n_hosts}x{chips_per_host} needs {need} devices, have {len(devices)}",
            suggestions=("Reduce n_hosts or chips_per_host",),
        )
    rows = [devices[h * chips_per_host:(h + 1) * chips_per_host] for h in range(n_hosts)]
    return Mesh(rows, axis_names=(HOST_AXIS, CHIP_AXIS))


def _rows_by_rank(n_hosts, chips_per_host, devices, rank: int, size: int) -> Mesh:
    """The multi-process mesh, one row a rank.  Every rank takes part in the
    one ``all_gather_object`` before any check, and every check reads what
    was gathered, so the ranks raise together and none waits in a
    collective."""
    import torch.distributed as dist

    try:
        row = ([torch.device("cuda", torch.cuda.current_device())] if devices is None
               else [torch.device(d) for d in devices])
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
    if n_hosts is not None and n_hosts != size:
        raise InvalidArgumentError(
            ErrorCode.DIST_BAD_MESH,
            f"n_hosts={n_hosts} but {size} ranks are attached",
            suggestions=("Omit n_hosts to use the world size",),
        )
    if chips_per_host is not None and chips_per_host != counts[rank]:
        raise InvalidArgumentError(
            ErrorCode.DIST_BAD_MESH,
            f"chips_per_host={chips_per_host} but each rank's row holds {counts[rank]} "
            "devices",
            suggestions=("Omit chips_per_host, or pass that many devices= on every rank",),
        )
    grid = np.empty((size, counts[rank]), dtype=object)
    for r, names in enumerate(gathered):
        for c, name in enumerate(names):
            grid[r, c] = torch.device(name) if r == rank else RemoteDevice(r, torch.device(name))
    return Mesh(grid, axis_names=(HOST_AXIS, CHIP_AXIS), rank=rank)


def _place(x, mesh: Mesh) -> torch.Tensor:
    """Check a ``[batch, N]`` block for the host x chip layout: the batch
    splits over hosts, the signal over chips.  In one process ``x`` is the
    whole batch, a multiple of the host count; across ranks it is this
    rank's rows (the global batch is its rows times the world size), moved
    to the row's first device."""
    x = torch.as_tensor(x)
    if x.dim() != 2:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"multihost facade expects [batch, n], got shape {tuple(x.shape)}",
            suggestions=("Reshape leading axes into one batch axis",),
        )
    if mesh.process_count > 1:
        return x.to(mesh.local_devices[0])
    n_hosts = mesh.axis_size(HOST_AXIS)
    if x.shape[0] % n_hosts != 0:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"batch {x.shape[0]} not divisible by {n_hosts} hosts",
            suggestions=("Pad the batch to a multiple of the host count",),
        )
    return x


def _layout(mesh: Mesh) -> dict:
    """The tiled engine's mesh and axes for a multihost call: across ranks
    this rank's row alone (its rows tiled over ``"chip"``, no batch axis),
    in one process the whole mesh with the batch over ``"host"``."""
    if mesh.process_count > 1:
        return {"mesh": Mesh(mesh.local_devices, axis_names=(CHIP_AXIS,)),
                "axis": CHIP_AXIS, "batch_axis": None}
    return {"mesh": mesh, "axis": CHIP_AXIS, "batch_axis": HOST_AXIS}


def modwt_multilevel_multihost(
    x,
    wavelet,
    *,
    levels: int,
    mesh: Mesh,
    boundary: str = "periodic",
    backend: str = "auto",
    precision: str | None = None,
) -> MultiLevelMODWTResult:
    """Multi-level MODWT of a ``[batch, N]`` block over a host x chip mesh:
    the batch over ``"host"`` (no exchange during the transform), the signal
    tiled over ``"chip"`` with halo exchange (:func:`.tiled.modwt_multilevel_tiled`,
    whose kernel route makes one analysis launch per device).  Across ranks
    ``x`` is this rank's rows, and so is the result."""
    return modwt_multilevel_tiled(
        _place(x, mesh), wavelet, levels=levels, boundary=boundary, backend=backend,
        precision=precision, **_layout(mesh),
    )


def imodwt_multilevel_multihost(
    result: MultiLevelMODWTResult,
    wavelet,
    *,
    mesh: Mesh,
    boundary: str = "periodic",
    backend: str = "auto",
    precision: str | None = None,
) -> torch.Tensor:
    """Inverse of :func:`modwt_multilevel_multihost` (across ranks, of this
    rank's rows)."""
    return imodwt_multilevel_tiled(
        result, wavelet, boundary=boundary, backend=backend, precision=precision,
        **_layout(mesh),
    )


class CommunicationReport(NamedTuple):
    """Analytic per-transform communication volume for the multihost layout."""

    ici_bytes_per_chip: int  # halo traffic received per chip
    dcn_bytes_per_host: int  # 0 by construction during the transform
    per_level_halo_samples: tuple[int, ...]
    ici_fraction_of_compute_bytes: float  # comm / local memory traffic


def communication_report(
    mesh: Mesh,
    wavelet,
    *,
    levels: int,
    n: int,
    batch: int,
    dtype_bytes: int = 4,
    direction: str = "forward",
) -> CommunicationReport:
    """Exact bytes each chip receives per transform under the multihost
    layout.

    Forward analysis gathers a LEFT halo of ``(L0-1)*2^(j-1)`` samples per
    level; the symmetric inverse needs two-sided halos, counted as 2x.  The
    batch-over-host axis exchanges nothing.  The kernel route exchanges the
    SAME total bytes in one cumulative message per direction
    (``sum_j (L0-1) 2^(j-1) = (L0-1)(2^J - 1)``), so the model covers both
    routes; only the message count differs (1 vs J).  The symmetric
    deep-halo regime (a halo wider than a shard) gathers the whole signal,
    whose traffic this model does not count.  The field names keep the JAX
    package's: ``ici`` is the link within a host, ``dcn`` the one between
    hosts.  ``batch`` is the global batch: across ranks, one rank's rows
    times the world size (the mesh's host count).
    """
    w = _resolve_discrete(wavelet)
    l0 = len(w.dec_lo)
    chips = mesh.axis_size(CHIP_AXIS)
    hosts = mesh.axis_size(HOST_AXIS)
    if batch % hosts != 0:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"batch {batch} not divisible by {hosts} hosts (the transform "
            f"itself rejects such a batch)",
            suggestions=("Pad the batch to a multiple of the host count",),
        )
    local_batch = batch // hosts
    halos = tuple((l0 - 1) * 2 ** (j - 1) for j in range(1, levels + 1))
    sides = 2 if direction == "inverse_symmetric" else 1
    ici = sum(halos) * sides * local_batch * dtype_bytes if chips > 1 else 0
    # local memory traffic for the same work: read x once + write levels+1 planes
    local_n = n // chips
    compute_bytes = local_batch * local_n * (levels + 2) * dtype_bytes
    frac = ici / compute_bytes if compute_bytes else math.inf
    return CommunicationReport(int(ici), 0, halos, float(frac))
