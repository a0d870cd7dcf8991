"""2-D wavelet packets: quadtree decomposition and Coifman-Wickerhauser basis.

Counterpart of ``vectorwave_tpu/transforms/packets2d.py``.  Every subband,
not just the pyramid's LL spine, is split recursively, and a best-basis
dynamic program picks the minimal-cost tiling of the frequency plane.

* The node axis is a leading batch axis: depth ``j`` holds ``4^j`` nodes as
  one ``[..., 4^j, H/2^j, W/2^j]`` tensor, and one :func:`..twodim.dwt2`
  call splits every node at once.
* Best-basis selection compares cost tables pulled to the host in one
  transfer; reconstruction from a chosen basis is a function of the tree
  and that basis.  :func:`best_basis_denoise2` keeps the whole program on
  the input's device: the dynamic program runs there over the per-level
  cost vectors and the basis becomes per-level used masks.

The quadtree runs on the plain decimated ops (:mod:`..ops.dwt`), as the JAX
package's does: no kernel route serves it.

Node order is natural (Paley) per axis: the children of node ``i`` are
``4i + k`` with ``k`` = 0:``ll``, 1:``lh``, 2:``hl``, 3:``hh`` (first letter
the filter along H, second along W, as in :mod:`.twodim`).  Only the
decimated quadtree is provided (use :func:`..twodim.modwt2_multilevel` for
shift-invariant 2-D analysis).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..errors import ErrorCode, InvalidArgumentError
from .modwt import _resolve_discrete
from .packets import _EPS, _device_best_basis_masks, _node_costs, _validate_depth, frequency_order
from .twodim import DWT2Result, _check_2d, dwt2, idwt2


class WaveletPacket2DTree(NamedTuple):
    """Quadtree of packet planes: ``levels[j]`` is ``[..., 4^j, H/2^j, W/2^j]``.

    ``levels[0]`` is the input image as the single root node ``[..., 1, H, W]``.
    """

    levels: tuple[torch.Tensor, ...]

    @property
    def depth(self) -> int:
        return len(self.levels) - 1

    def node(self, level: int, index: int) -> torch.Tensor:
        """Plane of node ``(level, index)``, shape ``[..., H_j, W_j]``."""
        return self.levels[level][..., index, :, :]

    @property
    def leaves(self) -> torch.Tensor:
        """Deepest level, natural order: ``[..., 4^J, H_J, W_J]``."""
        return self.levels[-1]

    def energy_map(self, level: int | None = None) -> torch.Tensor:
        """Per-node energies ``[..., 4^level]`` (defaults to the leaf level)."""
        lvl = self.depth if level is None else level
        return (self.levels[lvl] ** 2).sum(dim=(-1, -2))


def wpt2(
    x: torch.Tensor,
    wavelet,
    levels: int,
    *,
    boundary: str = "periodic",
) -> WaveletPacket2DTree:
    """Decimated 2-D packet decomposition to depth ``levels``.

    Requires ``H`` and ``W`` divisible by ``2^levels``.  Boundaries follow
    :func:`..twodim.dwt2`: periodic (exact reconstruction) or zero.
    """
    _validate_depth(levels)
    w = _resolve_discrete(wavelet)
    _check_2d(x, "wpt2")
    h_dim, w_dim = x.shape[-2], x.shape[-1]
    div = 1 << levels
    if h_dim % div or w_dim % div:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"wpt2 depth {levels} requires dims divisible by {div}, got {h_dim}x{w_dim}",
            suggestions=("Pad the image or lower the depth",),
        )
    nodes = x[..., None, :, :]
    tree = [nodes]
    for _ in range(levels):
        res = dwt2(nodes, w, boundary=boundary)
        m = nodes.shape[-3]
        # [..., M, 4, h, w] -> the children (4i + k) of node i contiguous
        nodes = torch.stack([res.ll, res.lh, res.hl, res.hh], dim=-3).reshape(
            nodes.shape[:-3] + (4 * m,) + res.ll.shape[-2:]
        )
        tree.append(nodes)
    return WaveletPacket2DTree(tuple(tree))


def _iwpt2_quad(nodes: torch.Tensor, w, boundary: str) -> torch.Tensor:
    """One synthesis stage: ``[..., 4M, h, w]`` children -> ``[..., M, 2h, 2w]``."""
    m = nodes.shape[-3] // 4
    quads = nodes.reshape(nodes.shape[:-3] + (m, 4) + nodes.shape[-2:])
    return idwt2(
        DWT2Result(quads[..., 0, :, :], quads[..., 1, :, :], quads[..., 2, :, :],
                   quads[..., 3, :, :]),
        w,
        boundary=boundary,
    )


def iwpt2(
    tree: WaveletPacket2DTree | torch.Tensor,
    wavelet,
    *,
    boundary: str = "periodic",
) -> torch.Tensor:
    """Invert a packet quadtree from its leaves ``[..., 4^J, H/2^J, W/2^J]``."""
    w = _resolve_discrete(wavelet)
    nodes = tree.leaves if isinstance(tree, WaveletPacket2DTree) else tree
    while nodes.shape[-3] > 1:
        nodes = _iwpt2_quad(nodes, w, boundary)
    return nodes[..., 0, :, :]


# ---------------------------------------------------------------------------
# Frequency geometry
# ---------------------------------------------------------------------------


def _axis_natural(index: int, level: int) -> tuple[int, int]:
    """Split a quadtree index into its per-axis (H, W) natural 1-D indices."""
    h_nat = w_nat = 0
    for d in range(level):
        digit = (index >> (2 * (level - 1 - d))) & 3
        h_nat = (h_nat << 1) | (digit >> 1)
        w_nat = (w_nat << 1) | (digit & 1)
    return h_nat, w_nat


def packet_frequency_bands2(level: int, sampling_rate: float = 1.0) -> np.ndarray:
    """``[4^level, 2, 2]`` frequency rectangles per natural-order node.

    ``bands[idx][0]`` is the (low, high) band along H, ``bands[idx][1]``
    along W, each axis ordered by the 1-D sequency (Gray-code) rule of
    :func:`.packets.frequency_order`, since the separable quadtree is the
    tensor product of two 1-D packet trees.
    """
    if level < 0:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL, f"level must be >= 0, got {level}"
        )
    inv = np.argsort(frequency_order(level))  # natural -> frequency position
    width = sampling_rate / 2.0 / (1 << level)
    bands = np.empty((1 << (2 * level), 2, 2))
    for idx in range(bands.shape[0]):
        h_nat, w_nat = _axis_natural(idx, level)
        for axis, nat in ((0, h_nat), (1, w_nat)):
            pos = int(inv[nat])
            bands[idx, axis] = (pos * width, (pos + 1) * width)
    return bands


# ---------------------------------------------------------------------------
# Best basis (quadtree Coifman-Wickerhauser)
# ---------------------------------------------------------------------------


def _level_costs(lvl: torch.Tensor, cost, threshold, root_energy) -> torch.Tensor:
    """``[4^j]`` additive costs of one level's nodes, summed over the batch
    axes; a callable ``cost`` is called on each ``[h, w]`` plane."""
    if callable(cost):
        planes = lvl.reshape((-1,) + tuple(lvl.shape[-2:]))
        per_plane = torch.stack([torch.as_tensor(cost(p), device=lvl.device) for p in planes])
        return per_plane.reshape(-1, lvl.shape[-3]).sum(dim=0)
    node_cost = _node_costs(lvl, cost, threshold, root_energy)
    return node_cost.reshape(-1, lvl.shape[-3]).sum(dim=0)


def _cost_table2(
    tree: WaveletPacket2DTree, cost: str | Callable, threshold: float
) -> list[np.ndarray]:
    """Additive cost per node, summed over batch axes, pulled to the host in
    one transfer."""
    root_energy = None if callable(cost) else (tree.levels[0] ** 2).sum() + _EPS
    vectors = [_level_costs(lvl, cost, threshold, root_energy) for lvl in tree.levels]
    flat = torch.cat([v.to(torch.float64) for v in vectors]).cpu().numpy()
    return np.split(flat, np.cumsum([v.shape[0] for v in vectors])[:-1])


def best_basis2(
    tree: WaveletPacket2DTree,
    cost: str | Callable = "shannon",
    *,
    threshold: float = 1.0,
) -> tuple[tuple[int, int], ...]:
    """Minimal-cost admissible quadtree basis as ``((level, index), ...)``.

    Same bottom-up dynamic program as the 1-D :func:`.packets.best_basis`,
    with four children per node: keep a node whole iff its own cost is at
    most the best total cost of its four subtrees.  A callable ``cost`` maps
    one node's ``[h, w]`` plane (a tensor) to a scalar.
    """
    tables = _cost_table2(tree, cost, threshold)
    depth = tree.depth
    best_cost = tables[depth].astype(np.float64).copy()
    choice: list[np.ndarray] = [None] * (depth + 1)  # type: ignore[list-item]
    choice[depth] = np.ones(1 << (2 * depth), dtype=bool)
    for j in range(depth - 1, -1, -1):
        own = tables[j].astype(np.float64)
        children = best_cost.reshape(-1, 4).sum(axis=1)
        keep = own <= children
        choice[j] = keep
        best_cost = np.where(keep, own, children)
    basis: list[tuple[int, int]] = []

    def _collect(level: int, idx: int) -> None:
        if choice[level][idx]:
            basis.append((level, idx))
        else:
            for k in range(4):
                _collect(level + 1, 4 * idx + k)

    _collect(0, 0)
    return tuple(basis)


def basis_coefficients2(
    tree: WaveletPacket2DTree, basis: Sequence[tuple[int, int]]
) -> list[torch.Tensor]:
    """Planes of the chosen basis nodes, in ``basis`` order."""
    return [tree.node(level, idx) for level, idx in basis]


def reconstruct_basis2(
    tree: WaveletPacket2DTree,
    basis: Sequence[tuple[int, int]],
    wavelet,
    *,
    boundary: str = "periodic",
    transform_nodes: Callable | None = None,
) -> torch.Tensor:
    """Reconstruct the image from an admissible quadtree basis selection.

    ``transform_nodes(level, index, plane) -> plane`` optionally edits each
    basis node before synthesis (thresholding, band suppression, ...).
    """
    w = _resolve_discrete(wavelet)
    _validate_basis2(basis, tree.depth)
    chosen = {}
    for level, idx in basis:
        plane = tree.node(level, idx)
        if transform_nodes is not None:
            plane = transform_nodes(level, idx, plane)
        chosen[(level, idx)] = plane

    def _synth(level: int, idx: int) -> torch.Tensor:
        if (level, idx) in chosen:
            return chosen[(level, idx)]
        quad = torch.stack([_synth(level + 1, 4 * idx + k) for k in range(4)], dim=-3)
        return _iwpt2_quad(quad, w, boundary)[..., 0, :, :]

    return _synth(0, 0)


def best_basis_denoise2(
    x: torch.Tensor,
    wavelet,
    levels: int,
    *,
    threshold,
    cost: str = "shannon",
    cost_threshold: float = 1.0,
    mode: str = "soft",
    boundary: str = "periodic",
) -> torch.Tensor:
    """Best-basis packet denoise with no transfer to the host.

    The quadtree's per-level cost vectors feed the Coifman-Wickerhauser
    program on the input's device; the chosen basis becomes per-level used
    masks (a node is used iff it is kept and no ancestor is kept), and the
    reconstruction is the full masked bottom-up synthesis of the
    thresholded node planes, so unused nodes contribute zero.  Equal to
    :func:`best_basis2` followed by :func:`reconstruct_basis2` with the
    threshold applied to every basis node.  ``cost_threshold`` is taken in
    float32, as the JAX package takes it.
    """
    from ..ops.thresholds import apply_threshold

    w = _resolve_discrete(wavelet)
    tree = wpt2(x, w, levels, boundary=boundary)
    cth = torch.tensor(cost_threshold, dtype=torch.float32, device=x.device)
    thr = torch.as_tensor(threshold, dtype=x.dtype, device=x.device)
    root_energy = (tree.levels[0] ** 2).sum() + _EPS
    costs = [_level_costs(lvl, cost, cth, root_energy) for lvl in tree.levels]
    used = _device_best_basis_masks(costs, levels, 4)

    def t_masked(j):
        m = used[j].to(x.dtype)[:, None, None]
        return apply_threshold(tree.levels[j], thr, mode) * m

    val = t_masked(levels)
    for j in range(levels - 1, -1, -1):
        val = _iwpt2_quad(val, w, boundary) + t_masked(j)
    return val[..., 0, :, :]


def _validate_basis2(basis: Sequence[tuple[int, int]], depth: int) -> None:
    """An admissible quadtree basis tiles the unit square in dyadic squares."""
    if not basis:
        raise InvalidArgumentError(ErrorCode.CFG_INVALID_CONFIG, "empty packet basis")
    max_level = 0
    for level, idx in basis:
        if not (0 <= level <= depth) or not (0 <= idx < (1 << (2 * level))):
            raise InvalidArgumentError(
                ErrorCode.CFG_INVALID_CONFIG,
                f"node ({level}, {idx}) outside the quadtree (depth {depth})",
            )
        max_level = max(max_level, level)
    side = 1 << max_level
    cover = np.zeros((side, side), dtype=np.int32)
    for level, idx in basis:
        h_nat, w_nat = _axis_natural(idx, level)
        scale = 1 << (max_level - level)
        cover[h_nat * scale : (h_nat + 1) * scale, w_nat * scale : (w_nat + 1) * scale] += 1
    if (cover != 1).any():
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            "basis nodes overlap or leave gaps: not an admissible quadtree packet basis",
        )
