"""Sharded and tiled transforms over a mesh of torch devices.

Counterpart of ``vectorwave_tpu/parallel``: batch sharding
(:mod:`.batch`), long-signal tiling with halo exchange (:mod:`.tiled`, with
its exact tier), 2-D row tiling (:mod:`.tiled2d`), the host x chip layout
(:mod:`.multihost`) and the tiled CWT with two-sided support halos
(:mod:`.cwt_tiled`), over a mesh of one process's devices or of every rank
of a ``torch.distributed`` world (:mod:`.mesh`): each rank passes the block
of the input its cells hold (:func:`local_index`) and gets its block of the
output back, the halos that cross ranks travelling over
``torch.distributed`` (:mod:`.exchange`).
"""

from .mesh import Mesh, default_mesh, local_index, make_mesh
from .batch import shard_batch, modwt_multilevel_sharded_batch
from .tiled import (
    imodwt_multilevel_tiled,
    imodwt_multilevel_tiled_exact,
    modwt_multilevel_tiled,
    modwt_multilevel_tiled_exact,
    tiled_roundtrip_check,
)
from .tiled2d import imodwt2_multilevel_tiled, modwt2_multilevel_tiled
from .cwt_tiled import cwt_tiled, cwt_tiled_2d
from .multihost import (
    CommunicationReport,
    communication_report,
    imodwt_multilevel_multihost,
    make_multihost_mesh,
    modwt_multilevel_multihost,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "default_mesh",
    "local_index",
    "shard_batch",
    "modwt_multilevel_sharded_batch",
    "modwt_multilevel_tiled",
    "imodwt_multilevel_tiled",
    "modwt2_multilevel_tiled",
    "imodwt2_multilevel_tiled",
    "modwt_multilevel_tiled_exact",
    "imodwt_multilevel_tiled_exact",
    "tiled_roundtrip_check",
    "cwt_tiled",
    "cwt_tiled_2d",
    "make_multihost_mesh",
    "modwt_multilevel_multihost",
    "imodwt_multilevel_multihost",
    "communication_report",
    "CommunicationReport",
]
