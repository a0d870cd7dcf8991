"""Host x chip meshes and the hierarchical transform facade.

Counterpart of ``vectorwave_tpu/parallel/multihost.py``.  The layout rule
it encodes: axes whose exchanges run per transform level (the signal
tiling's halos) map to the fast link between the cards of one host, and the
axis crossing hosts carries only work that needs no exchange during the
transform, the batch.

* :func:`make_multihost_mesh` builds a ``("host", "chip")`` mesh.  In one
  process the device list is split contiguously into hosts; grouping the
  rows by process (one rank per card, ``torch.distributed``) waits for the
  multi-process transport.
* :func:`modwt_multilevel_multihost` / :func:`imodwt_multilevel_multihost`
  split the batch over ``"host"`` and tile the signal over ``"chip"``.
* :func:`communication_report` is the analytic communication model: the
  bytes each chip receives per transform.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..errors import ErrorCode, InvalidArgumentError
from ..transforms.modwt import _resolve_discrete
from ..transforms.multilevel import MultiLevelMODWTResult
from .mesh import Mesh, visible_devices
from .tiled import imodwt_multilevel_tiled, modwt_multilevel_tiled

HOST_AXIS = "host"
CHIP_AXIS = "chip"


def make_multihost_mesh(
    n_hosts: int | None = None,
    chips_per_host: int | None = None,
    *,
    devices=None,
) -> Mesh:
    """Build a ``("host", "chip")`` mesh by splitting the device list (the
    visible CUDA devices by default) contiguously into ``n_hosts`` rows of
    ``chips_per_host`` devices."""
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


def _place(x, mesh: Mesh) -> torch.Tensor:
    """Check a ``[batch, N]`` block for the host x chip layout: the batch
    splits over hosts, the signal over chips."""
    x = torch.as_tensor(x)
    if x.dim() != 2:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"multihost facade expects [batch, n], got shape {tuple(x.shape)}",
            suggestions=("Reshape leading axes into one batch axis",),
        )
    n_hosts = mesh.axis_size(HOST_AXIS)
    if x.shape[0] % n_hosts != 0:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"batch {x.shape[0]} not divisible by {n_hosts} hosts",
            suggestions=("Pad the batch to a multiple of the host count",),
        )
    return x


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
    whose kernel route makes one analysis launch per device)."""
    return modwt_multilevel_tiled(
        _place(x, mesh), wavelet, levels=levels, mesh=mesh, axis=CHIP_AXIS,
        boundary=boundary, batch_axis=HOST_AXIS, backend=backend, precision=precision,
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
    """Inverse of :func:`modwt_multilevel_multihost`."""
    return imodwt_multilevel_tiled(
        result, wavelet, mesh=mesh, axis=CHIP_AXIS, boundary=boundary,
        batch_axis=HOST_AXIS, backend=backend, precision=precision,
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
    hosts.
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
