"""The shard exchange along one mesh axis, within a rank and across ranks.

The counterpart of ``jax.lax.ppermute`` and of the tiled
``jax.lax.all_gather`` inside ``shard_map``, which the JAX package calls
for its halos (``vectorwave_tpu/parallel/tiled.py:92, 97, 321, 382, 634,
726``) and its whole-axis gathers (``tiled.py:235, 456, 614, 706``;
``tiled2d.py:132, 214``).  No JAX file corresponds to this module: over a
mesh that spans processes those calls cross processes inside XLA.

A rank holds the shards of its own box of the mesh (:class:`Ring`), as
``[B, T_local, ...]`` blocks: its row groups along the batch, its
``T_local`` consecutive shards along the axis.

* :func:`ppermute` shifts the shards one step round the ring.  A shard
  whose source is on this rank gets it by a roll of the block (in one
  process, or wherever a rank holds the whole axis, the exchange is that
  roll alone); a shard whose source is on another rank gets it through
  ``torch.distributed.batch_isend_irecv``: one call for the exchange, one
  ``isend`` and one ``irecv`` per neighbour rank and direction, every plane
  and row group stacked into one message.  A missing source (the zero
  boundary's dropped wrap link) gives zeros and sends no message.
* :func:`all_gather` gives each rank the whole axis of its rows, in one
  call, where the JAX package gathers the axis.

Every message is tagged by its direction, so that two ranks that are each
other's left and right neighbour never confuse two messages.  Transport:
NCCL sends CUDA tensors as they are; Gloo's point-to-point calls take CPU
tensors, so a CUDA block is staged through pinned host memory (the stream
synchronised before the sends) and copied back to its card; any other
backend raises.  An exchange that fails raises on the rank where it fails.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..errors import ErrorCode, InvalidArgumentError

#: message tags: the direction a halo travels along the axis, and the gather
TAG_RIGHT, TAG_LEFT, TAG_GATHER = 1, 2, 3

#: what this process's exchanges sent across ranks: ``batch_isend_irecv``
#: calls, messages and bytes (:func:`reset_traffic` zeroes them)
TRAFFIC = {"calls": 0, "messages": 0, "bytes": 0}


def reset_traffic() -> None:
    for k in TRAFFIC:
        TRAFFIC[k] = 0


class Ring(NamedTuple):
    """This rank's place on the ring of one mesh axis: ``size`` shards, of
    which it holds ``count`` from ``first`` on, for each of its row groups
    ``groups`` (global indices along the batch axis, ``(0,)`` without one)
    of ``rows`` rows each; ``owners[p, t]`` is the rank holding shard ``t``
    of row group ``p``."""

    size: int
    first: int
    count: int
    groups: tuple
    rows: int
    owners: np.ndarray
    rank: int

    @property
    def whole(self) -> bool:
        """Whether this rank holds the whole axis: every exchange is local."""
        return self.count == self.size

    def holds(self, t: int) -> bool:
        return self.first <= t < self.first + self.count


def roll(blocks: torch.Tensor, perm) -> torch.Tensor:
    """Shard ``d`` receives block ``s`` for each ``(s, d)`` in ``perm``; a
    shard with no source receives zeros.  ``blocks`` is ``[B, T, ...]``, the
    whole axis's T shards along dim 1; ``perm`` is a ring shift, so the
    exchange is one roll, written as a ``torch.cat`` of the two halves (one
    copy, from a strided view too)."""
    if not perm:
        return torch.zeros_like(blocks)
    size = blocks.shape[1]
    (shift,) = {(d - s) % size for s, d in perm}
    if shift == 0:  # one shard, its own neighbour
        return blocks
    out = torch.cat([blocks.narrow(1, size - shift, shift),
                     blocks.narrow(1, 0, size - shift)], dim=1)
    for missing in set(range(size)) - {d for _, d in perm}:
        out.narrow(1, missing, 1).zero_()
    return out


def _direction(perm, size: int) -> int:
    """The tag of a ring shift: its first pair names the direction (``(0,
    1)`` for the shift from the left, ``(1, 0)`` from the right)."""
    s, d = perm[0]
    return TAG_RIGHT if d == s + 1 or (size > 2 and s == size - 1 and d == 0) else TAG_LEFT


def _grouped(blocks: torch.Tensor, ring: Ring) -> torch.Tensor:
    """``[K*B, T_local, ...]`` (K planes stacked along dim 0) as ``[K,
    groups, rows a group, T_local, ...]``."""
    return blocks.reshape(-1, len(ring.groups), ring.rows, *blocks.shape[1:])


def ppermute(blocks: torch.Tensor, perm, ring: Ring) -> torch.Tensor:
    """:func:`roll` of this rank's ``[K*B, T_local, ...]`` shards by the
    ring shift ``perm`` (``(source, destination)`` pairs of global shard
    indices), the sources on other ranks received over
    ``torch.distributed``."""
    if ring.whole:
        return roll(blocks, perm)
    tag = _direction(perm, ring.size) if perm else TAG_RIGHT
    source = {d: s for s, d in perm}
    dest = {s: d for s, d in perm}
    view = _grouped(blocks, ring)
    out = torch.zeros_like(view)
    sends: dict = {}
    wanted: dict = {}
    for i, p in enumerate(ring.groups):
        for j in range(ring.count):
            d, s = dest.get(ring.first + j), source.get(ring.first + j)
            if d is not None and not ring.holds(d):
                sends.setdefault((int(ring.owners[p, d]), tag), []).append(view[:, i, :, j])
            if s is not None and ring.holds(s):
                out[:, i, :, j] = view[:, i, :, s - ring.first]
            elif s is not None:
                wanted.setdefault((int(ring.owners[p, s]), tag), []).append((i, j))
    got = _post(sends, {k: len(v) for k, v in wanted.items()}, view[:, 0, :, 0])
    for key, cells in wanted.items():
        for (i, j), piece in zip(cells, got[key]):
            out[:, i, :, j] = piece
    return out.reshape(blocks.shape)


def all_gather(blocks: torch.Tensor, ring: Ring) -> torch.Tensor:
    """The whole axis of this rank's rows: ``[K*B, T_local, ...]`` ->
    ``[K*B, T, ...]``, every other rank's shards of the same row groups
    received in one call."""
    if ring.whole:
        return blocks
    view = _grouped(blocks, ring)
    sends: dict = {}
    wanted: dict = {}
    for i, p in enumerate(ring.groups):
        peers = sorted({int(r) for r in ring.owners[p]} - {ring.rank})
        for r in peers:
            sends.setdefault((r, TAG_GATHER), []).extend(
                view[:, i, :, j] for j in range(ring.count))
        for t in range(ring.size):
            if not ring.holds(t):
                wanted.setdefault((int(ring.owners[p, t]), TAG_GATHER), []).append((i, t))
    got = _post(sends, {k: len(v) for k, v in wanted.items()}, view[:, 0, :, 0])
    out = view.new_empty(view.shape[:3] + (ring.size,) + view.shape[4:])
    out.narrow(3, ring.first, ring.count).copy_(view)
    for key, cells in wanted.items():
        for (i, t), piece in zip(cells, got[key]):
            out[:, i, :, t] = piece
    return out.reshape((blocks.shape[0], ring.size) + tuple(blocks.shape[2:]))


def _transport(device: torch.device) -> bool:
    """Whether a tensor on ``device`` is staged through host memory: NCCL
    takes CUDA tensors, Gloo CPU tensors; anything else raises."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise InvalidArgumentError(
            ErrorCode.DIST_BAD_MESH,
            "A halo crosses ranks, and no torch.distributed world is initialised",
            suggestions=("Build the mesh with make_mesh inside its world",),
        )
    backend = str(dist.get_backend()).lower()
    if device.type == "cuda" and "nccl" in backend:
        return False
    if "gloo" in backend:
        return device.type == "cuda"
    raise InvalidArgumentError(
        ErrorCode.DIST_BAD_MESH,
        f"The exchange runs over NCCL (CUDA tensors) or Gloo, not {backend!r} with "
        f"{device.type} tensors",
        suggestions=("Initialise the world with backend='gloo' or 'nccl'",),
    )


def _post(sends: dict, wanted: dict, like: torch.Tensor) -> dict:
    """One ``batch_isend_irecv`` of every message: ``sends`` maps ``(peer,
    tag)`` to the pieces sent there (stacked into one tensor), ``wanted`` to
    the number of pieces expected from there, each shaped like ``like``.
    Returns ``{(peer, tag): [pieces]}`` on ``like``'s device."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d

    if not sends and not wanted:
        return {}
    staged = _transport(like.device)
    host = torch.device("cpu")
    ops, outgoing = [], []
    for peer, tag in sorted(sends):
        msg = torch.stack(sends[peer, tag])
        if staged:
            pinned = torch.empty(msg.shape, dtype=msg.dtype, device=host, pin_memory=True)
            pinned.copy_(msg, non_blocking=True)
            msg = pinned
        outgoing.append(msg)
        ops.append(dist.P2POp(c10d.isend, msg, peer, tag=tag))
    if staged and outgoing:
        torch.cuda.current_stream(like.device).synchronize()
    incoming = {}
    for peer, tag in sorted(wanted):
        shape = (wanted[peer, tag],) + tuple(like.shape)
        buf = (torch.empty(shape, dtype=like.dtype, device=host, pin_memory=True) if staged
               else torch.empty(shape, dtype=like.dtype, device=like.device))
        incoming[peer, tag] = buf
        ops.append(dist.P2POp(c10d.irecv, buf, peer, tag=tag))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    TRAFFIC["calls"] += 1
    TRAFFIC["messages"] += len(outgoing)
    TRAFFIC["bytes"] += sum(m.numel() * m.element_size() for m in outgoing)
    return {key: list((buf.to(like.device) if staged else buf).unbind(0))
            for key, buf in incoming.items()}


def all_reduce_max(value: torch.Tensor) -> torch.Tensor:
    """The largest of every rank's scalar ``value``, in one ``all_reduce``
    (through host memory on Gloo, as the exchange stages its blocks)."""
    import torch.distributed as dist

    staged = _transport(value.device)
    flat = value.detach().reshape(1).to("cpu" if staged else value.device, copy=True)
    dist.all_reduce(flat, op=dist.ReduceOp.MAX)
    return flat[0]
