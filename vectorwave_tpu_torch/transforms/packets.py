"""Wavelet packet transforms: decimated WPT and undecimated MODWPT.

Counterpart of ``vectorwave_tpu/transforms/packets.py``: the full binary
filter-bank tree over both the approximation and the detail branches, with
Coifman-Wickerhauser best-basis selection and frequency (sequency) ordering
of the leaves.

* A packet level is one batched op: the node axis is another leading batch
  axis, so depth ``j`` is two à trous (or decimated) convolutions over a
  ``[..., 2^(j-1), N]`` tensor.
* The tree is a NamedTuple of per-depth tensors.
* Best-basis selection compares node costs, so it runs on the host, on a
  cost table pulled from the device in one transfer; reconstruction from a
  chosen basis is a function of the tree and that static basis.

The MODWPT follows Percival and Walden's convention (filters scaled by
1/sqrt(2) per stage, à trous spacing ``2^(j-1)`` at depth ``j``), so every
stage is a tight frame: node energies at each depth sum to the signal energy
(periodic boundary, orthogonal wavelets), and synthesis is the exact adjoint.

The MODWPT has three routes, chosen by :func:`~vectorwave_tpu_torch.config.get_backend`:

* the whole tree as one launch of the filter-bank kernel
  (:mod:`..kernels.modwt_bank`): every node of every level is x filtered by
  its composed à trous filter, up to depth :data:`TREE_MAX_DEPTH`;
* one à trous pair per level through the same kernel, the 2^(j-1) nodes of
  a level riding the batch axis;
* the plain ``atrous_analysis_pair`` cascade.

``kernel`` takes the first that serves the call (on a CPU tensor the bank's
plain version) and raises on a CUDA tensor the kernel cannot take; ``torch``
takes the cascade; ``auto`` takes, on a float32 or bfloat16 CUDA tensor on a
Hopper card, the bank route that measured fastest there
(:data:`AUTO_TREE_MAX_WORK`), and the cascade otherwise.  Symmetric
boundaries and float64 always take the cascade.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..config import get_backend
from ..errors import ErrorCode, InvalidArgumentError
from ..kernels import modwt_bank
from ..ops.convolve import atrous_analysis_pair, atrous_convolve
from ..ops.dwt import _bior_parities, convolve_downsample, upsample_convolve
from .modwt import _resolve_discrete, _validate_signal

_INV_SQRT2 = 1.0 / math.sqrt(2.0)

#: Deepest tree that one bank launch holds: its 2^(J+1) - 2 planes must be
#: at most ``modwt_bank.MAX_PLANES``.
TREE_MAX_DEPTH = 5
#: The most work, in FMAs (samples times the analysis tree's non-zero taps),
#: that ``auto`` sends through one whole-tree launch each way; beyond it,
#: one bank pair per level.  The dense tree costs sum_j 2^j ((L-1)(2^j-1)+1)
#: FMAs a sample, bound by operations, against sum_j 2^j L for the pairs,
#: bound by bytes but J launches and the host work between them.  On an H100
#: the whole tree measured faster up to the sym8 depth-4 tree at 64 x 16384
#: (2^20 samples, 4680 taps) and the depth-2 tree at 128 x 65536, the pairs
#: from the depth-5 tree at 64 x 16384 and the depth-3 tree at 128 x 65536
#: (PERF.md, section 6).
AUTO_TREE_MAX_WORK = (1 << 20) * 4680


class WaveletPacketTree(NamedTuple):
    """Full packet tree: ``levels[j]`` holds the ``2^j`` depth-``j`` nodes.

    Decimated (``wpt``): ``levels[j]`` is ``[..., 2^j, N / 2^j]``.
    Undecimated (``modwpt``): ``levels[j]`` is ``[..., 2^j, N]``.
    ``levels[0]`` is the input signal as the single root node
    (``[..., 1, N]``).  Nodes are in natural (Paley) order: the children of
    node ``i`` are ``2i`` (lowpass branch) and ``2i+1`` (highpass branch);
    use :func:`frequency_order` for spectrally ascending leaves.
    """

    levels: tuple[torch.Tensor, ...]

    @property
    def depth(self) -> int:
        return len(self.levels) - 1

    @property
    def is_decimated(self) -> bool:
        return self.depth >= 1 and (
            self.levels[1].shape[-1] != self.levels[0].shape[-1]
        )

    def node(self, level: int, index: int) -> torch.Tensor:
        """Coefficients of node ``(level, index)``, shape ``[..., N_level]``."""
        return self.levels[level][..., index, :]

    @property
    def leaves(self) -> torch.Tensor:
        """Deepest-level nodes, natural order: ``[..., 2^J, N_J]``."""
        return self.levels[-1]

    def energy_map(self, level: int | None = None) -> torch.Tensor:
        """Per-node energies ``[..., 2^level]`` (defaults to the leaf level)."""
        lvl = self.depth if level is None else level
        return (self.levels[lvl] ** 2).sum(dim=-1)


def _validate_depth(levels: int) -> None:
    if levels < 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL,
            f"packet depth must be >= 1, got {levels}",
        )


def _interleave(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Children (2i, 2i+1) of node i: ``[..., M, n]`` pairs -> ``[..., 2M, n]``."""
    return torch.stack([lo, hi], dim=-2).reshape(
        lo.shape[:-2] + (2 * lo.shape[-2], lo.shape[-1])
    )


# ---------------------------------------------------------------------------
# Decimated WPT
# ---------------------------------------------------------------------------


def wpt(
    x: torch.Tensor,
    wavelet,
    levels: int,
    *,
    boundary: str = "periodic",
) -> WaveletPacketTree:
    """Decimated wavelet packet decomposition to depth ``levels``.

    Each depth applies ``dwt`` to every node (approx and detail alike);
    requires ``N`` divisible by ``2^levels``.  Boundaries: periodic (exact
    perfect reconstruction) or zero.  Plain PyTorch, as in the JAX package.
    """
    _validate_depth(levels)
    w = _resolve_discrete(wavelet)
    _validate_signal(x, min_length=2)
    n = x.shape[-1]
    if n % (1 << levels):
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"WPT depth {levels} requires length divisible by {1 << levels}, "
            f"got {n}",
            suggestions=("Pad the signal or lower the depth",),
        )
    p_h, p_g = _bior_parities(w)
    nodes = x[..., None, :]
    tree = [nodes]
    for _ in range(levels):
        lo = convolve_downsample(nodes, w.dec_lo, boundary=boundary, offset=p_h)
        hi = convolve_downsample(nodes, w.dec_hi, boundary=boundary, offset=p_g)
        nodes = _interleave(lo, hi)
        tree.append(nodes)
    return WaveletPacketTree(tuple(tree))


def _iwpt_pair(nodes: torch.Tensor, w, boundary: str) -> torch.Tensor:
    """One synthesis stage: ``[..., 2M, n]`` children -> ``[..., M, 2n]``."""
    p_h, p_g = _bior_parities(w)
    pairs = nodes.reshape(nodes.shape[:-2] + (nodes.shape[-2] // 2, 2, nodes.shape[-1]))
    lo = pairs[..., 0, :]
    hi = pairs[..., 1, :]
    n_out = 2 * nodes.shape[-1]
    return upsample_convolve(
        lo, w.rec_lo, n_out, boundary=boundary, offset=p_h
    ) + upsample_convolve(hi, w.rec_hi, n_out, boundary=boundary, offset=p_g)


def iwpt(
    tree: WaveletPacketTree | torch.Tensor,
    wavelet,
    *,
    boundary: str = "periodic",
) -> torch.Tensor:
    """Invert a decimated packet tree from its leaves ``[..., 2^J, N/2^J]``."""
    w = _resolve_discrete(wavelet)
    nodes = tree.leaves if isinstance(tree, WaveletPacketTree) else tree
    while nodes.shape[-2] > 1:
        nodes = _iwpt_pair(nodes, w, boundary)
    return nodes[..., 0, :]


# ---------------------------------------------------------------------------
# Undecimated MODWPT
# ---------------------------------------------------------------------------


def _upsample(f, spacing: int) -> np.ndarray:
    """``f`` with ``spacing - 1`` zeros between its taps (à trous), float64."""
    arr = np.zeros(spacing * (len(f) - 1) + 1, dtype=np.float64)
    arr[::spacing] = np.asarray(f, dtype=np.float64)
    return arr


def _upsampled_taps(f: np.ndarray, spacing: int) -> tuple[float, ...]:
    return tuple(_upsample(f, spacing).tolist())


def _bank_route(flat: torch.Tensor, boundary: str, dtypes=(torch.float32, torch.bfloat16)):
    """``'kernel'`` or ``'auto'`` if the configured backend sends this call to
    the filter bank, else None (the plain cascade).  ``torch`` never does,
    nor does a boundary other than periodic or zero, nor a dtype outside
    ``dtypes`` (float64 keeps the cascade); ``kernel`` does otherwise (a CPU
    tensor runs the bank's plain version), ``auto`` for a CUDA tensor on a
    card the kernels are built for."""
    from ..kernels.modwt_fused import kernel_available

    backend = get_backend()
    if (backend == "torch" or flat.dtype not in dtypes
            or not boundary.lower().startswith(("per", "zero"))):
        return None
    if backend == "auto" and not (flat.device.type == "cuda" and kernel_available()):
        return None
    return backend


def _bank_serves(flat: torch.Tensor, dense, route: str) -> bool:
    """Whether the bank takes these taps on this route: ``kernel`` sends a
    CPU tensor to the plain version, which serves any taps; on the card the
    window must fit (``auto`` then falls through, ``kernel`` falls through
    to its next route and at the last lets the kernel wrapper raise)."""
    return (route == "kernel" and flat.device.type == "cpu") or modwt_bank.bank_fits(dense)


def _compose_tree(f0: np.ndarray, f1: np.ndarray, levels: int):
    """Composed à trous filters of a packet tree whose low and high branch
    filters are ``f0`` and ``f1``: ``out[j-1][idx]`` = dense taps of node
    ``(j, idx)``."""
    per_level: list[list[np.ndarray]] = []
    prev = [np.array([1.0])]
    for j in range(1, levels + 1):
        s = 1 << (j - 1)
        u0, u1 = _upsample(f0, s), _upsample(f1, s)
        cur = []
        for parent in prev:
            cur.append(np.convolve(parent, u0))
            cur.append(np.convolve(parent, u1))
        per_level.append(cur)
        prev = cur
    return per_level


def _packet_plane_filters(w, levels: int, dec: bool = True):
    """Composed à trous filters for every node of every level (natural
    order): ``out[j-1][idx]`` = dense taps of node ``(j, idx)``, the
    product of the per-stage branch filters, upsampled by ``2^(s-1)`` at
    stage ``s`` (children of node ``i`` are ``2i`` low / ``2i+1`` high)."""
    f0 = np.asarray(w.dec_lo if dec else w.rec_lo, np.float64) * _INV_SQRT2
    f1 = np.asarray(w.dec_hi if dec else w.rec_hi, np.float64) * _INV_SQRT2
    return _compose_tree(f0, f1, levels)


@functools.lru_cache(maxsize=32)
def _tree_dense_cached(f0: bytes, f1: bytes, levels: int, leaves_only: bool):
    per_level = _compose_tree(np.frombuffer(f0, np.float64), np.frombuffer(f1, np.float64),
                              levels)
    taps = per_level[-1] if leaves_only else [t for lvl in per_level for t in lvl]
    return tuple(tuple(t.tolist()) for t in taps)


def _tree_dense(w, levels: int, dec: bool):
    """The whole tree's dense taps (analysis: every node of every level;
    synthesis: the leaves), the same tuple on every call so that the bank's
    tap tables are built once."""
    lo, hi = (w.dec_lo, w.dec_hi) if dec else (w.rec_lo, w.rec_hi)
    return _tree_dense_cached(
        (np.asarray(lo, np.float64) * _INV_SQRT2).tobytes(),
        (np.asarray(hi, np.float64) * _INV_SQRT2).tobytes(), levels, not dec,
    )


def _use_tree(levels: int, route: str, samples: int, w) -> bool:
    """``kernel`` takes the whole tree to :data:`TREE_MAX_DEPTH`; ``auto``
    up to the measured work."""
    if levels > TREE_MAX_DEPTH:
        return False
    if route == "kernel":
        return True
    taps = modwt_bank.bank_taps(_tree_dense(w, levels, dec=True)).nonzeros
    return samples * taps <= AUTO_TREE_MAX_WORK


def _tree_bank(like: torch.Tensor, samples: int, w, levels: int, boundary: str, dec: bool):
    """The whole tree's dense taps where one bank call takes the tree (the
    route of ``like``'s dtype and device, the depth and the work of
    ``samples`` samples, a bank that fits), else None."""
    route = _bank_route(like, boundary)
    if route is None or not _use_tree(levels, route, samples, w):
        return None
    dense = _tree_dense(w, levels, dec)
    return dense if _bank_serves(like, dense, route) else None


def _modwpt_tree_kernel(x2: torch.Tensor, w, levels: int, boundary: str):
    """The whole packet tree as one bank call: every node of every level is
    a composed à trous filter applied directly to x.  Returns per-level
    output lists, or None when this route does not serve the call."""
    dense = _tree_bank(x2, x2.numel(), w, levels, boundary, dec=True)
    if dense is None:
        return None
    outs = modwt_bank.bank_analysis(x2, dense, boundary.lower().startswith("per"))
    levels_out = []
    off = 0
    for j in range(1, levels + 1):
        cnt = 1 << j
        levels_out.append(list(outs[off : off + cnt]))
        off += cnt
    return levels_out


@functools.lru_cache(maxsize=128)
def _pair_dense_cached(low: bytes, high: bytes, spacing: int):
    return (_upsampled_taps(np.frombuffer(low, np.float64), spacing),
            _upsampled_taps(np.frombuffer(high, np.float64), spacing))


def _pair_dense(low, high, spacing: int):
    return _pair_dense_cached(
        np.ascontiguousarray(low, np.float64).tobytes(),
        np.ascontiguousarray(high, np.float64).tobytes(), spacing,
    )


def _pair_bank(flat: torch.Tensor, low, high, spacing: int, boundary: str):
    """The dense taps of one à trous pair where the bank takes it (``kernel``
    always, ``auto`` where the bank fits), else None."""
    route = _bank_route(flat, boundary)
    if route is None:
        return None
    dense = _pair_dense(low, high, spacing)
    if route == "auto" and not _bank_serves(flat, dense, route):
        return None
    return dense


def _pair_analysis_kernel(flat, low, high, spacing: int, boundary: str):
    """One batched à trous analysis pair [B, N] -> (lo, hi) through the
    bank kernel (the two upsampled filters as its planes; a packet level is
    2^(j-1) independent pairs riding the batch axis).  Returns None when the
    bank does not serve the call."""
    dense = _pair_bank(flat, low, high, spacing, boundary)
    if dense is None:
        return None
    outs = modwt_bank.bank_analysis(flat, dense, boundary.lower().startswith("per"))
    return outs[0], outs[1]


def _pair_synthesis_kernel(lo, hi, low, high, spacing: int, boundary: str):
    """Adjoint stage: lo*low + hi*high with forward reads, through the bank."""
    dense = _pair_bank(lo, low, high, spacing, boundary)
    if dense is None:
        return None
    return modwt_bank.bank_synthesis((lo, hi), dense, boundary.lower().startswith("per"))


def modwpt(
    x: torch.Tensor,
    wavelet,
    levels: int,
    *,
    boundary: str = "periodic",
) -> WaveletPacketTree:
    """Undecimated (maximal-overlap) packet decomposition to depth ``levels``.

    Every node keeps length ``N``; depth ``j`` filters with à trous spacing
    ``2^(j-1)`` and per-stage 1/sqrt(2) scaling, so depth-``j`` node energies
    sum to the signal energy (periodic, orthogonal wavelets).
    """
    _validate_depth(levels)
    w = _resolve_discrete(wavelet)
    _validate_signal(x, min_length=2)
    low = w.dec_lo * _INV_SQRT2
    high = w.dec_hi * _INV_SQRT2
    n = x.shape[-1]
    lead = x.shape[:-1]
    whole = _modwpt_tree_kernel(x.reshape(-1, n).contiguous(), w, levels, boundary)
    if whole is not None:
        tree = [x[..., None, :]]
        for j, planes in enumerate(whole, start=1):
            tree.append(torch.stack(planes, dim=-2).reshape(lead + (1 << j, n)))
        return WaveletPacketTree(tuple(tree))
    nodes = x[..., None, :]
    tree = [nodes]
    for j in range(1, levels + 1):
        spacing = 1 << (j - 1)
        flat = nodes.reshape(-1, n).contiguous()
        pair = _pair_analysis_kernel(flat, low, high, spacing, boundary)
        if pair is not None:
            lo = pair[0].reshape(nodes.shape)
            hi = pair[1].reshape(nodes.shape)
        else:
            lo, hi = atrous_analysis_pair(
                nodes, low, high, spacing=spacing, boundary=boundary
            )
        nodes = _interleave(lo, hi)
        tree.append(nodes)
    return WaveletPacketTree(tuple(tree))


def _imodwpt_pair(
    nodes: torch.Tensor, w, spacing: int, boundary: str
) -> torch.Tensor:
    """One adjoint synthesis stage at the given à trous spacing."""
    low = w.rec_lo * _INV_SQRT2
    high = w.rec_hi * _INV_SQRT2
    pairs = nodes.reshape(nodes.shape[:-2] + (nodes.shape[-2] // 2, 2, nodes.shape[-1]))
    n = nodes.shape[-1]
    lo2 = pairs[..., 0, :].reshape(-1, n).contiguous()
    hi2 = pairs[..., 1, :].reshape(-1, n).contiguous()
    rec = _pair_synthesis_kernel(lo2, hi2, low, high, spacing, boundary)
    if rec is not None:
        return rec.reshape(pairs.shape[:-2] + (n,))
    rec_lo = atrous_convolve(
        pairs[..., 0, :], low, spacing=spacing, boundary=boundary, sign=+1
    )
    rec_hi = atrous_convolve(
        pairs[..., 1, :], high, spacing=spacing, boundary=boundary, sign=+1
    )
    return rec_lo + rec_hi


def imodwpt(
    tree: WaveletPacketTree | torch.Tensor,
    wavelet,
    *,
    boundary: str = "periodic",
) -> torch.Tensor:
    """Invert an undecimated packet tree from its leaves ``[..., 2^J, N]``."""
    w = _resolve_discrete(wavelet)
    nodes = tree.leaves if isinstance(tree, WaveletPacketTree) else tree
    depth = int(round(math.log2(nodes.shape[-2])))
    if (1 << depth) != nodes.shape[-2]:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"leaf node count must be a power of two, got {nodes.shape[-2]}",
        )
    n = nodes.shape[-1]
    lead = nodes.shape[:-2]
    dense = _tree_bank(nodes, n * math.prod(lead), w, depth, boundary, dec=False)
    if dense is not None:
        leaves2 = [nodes[..., i, :].reshape(-1, n).contiguous() for i in range(1 << depth)]
        whole = modwt_bank.bank_synthesis(tuple(leaves2), dense,
                                          boundary.lower().startswith("per"))
        return whole.reshape(lead + (n,))
    for j in range(depth, 0, -1):
        nodes = _imodwpt_pair(nodes, w, 1 << (j - 1), boundary)
    return nodes[..., 0, :]


# ---------------------------------------------------------------------------
# Frequency (sequency) ordering
# ---------------------------------------------------------------------------


def frequency_order(level: int) -> np.ndarray:
    """Natural-order indices arranged by ascending passband frequency.

    ``tree.levels[level][..., frequency_order(level), :]`` is spectrally
    ascending.  Recursion: a parent sitting at an even frequency position
    passes its band through un-mirrored (lowpass child first); at an odd
    position decimation/aliasing mirrors the band, so the children swap:
    the Gray-code permutation of the Paley order.
    """
    order = [0]
    for _ in range(level):
        nxt: list[int] = []
        for pos, natural in enumerate(order):
            if pos % 2 == 0:
                nxt.extend((2 * natural, 2 * natural + 1))
            else:
                nxt.extend((2 * natural + 1, 2 * natural))
        order = nxt
    return np.asarray(order, dtype=np.int64)


def packet_frequency_bands(
    level: int, sampling_rate: float = 1.0
) -> np.ndarray:
    """``[2^level, 2]`` (low, high) frequency edges per natural-order node."""
    n_nodes = 1 << level
    width = sampling_rate / 2.0 / n_nodes
    bands = np.empty((n_nodes, 2))
    for freq_pos, natural in enumerate(frequency_order(level)):
        bands[natural] = (freq_pos * width, (freq_pos + 1) * width)
    return bands


# ---------------------------------------------------------------------------
# Best basis (Coifman-Wickerhauser)
# ---------------------------------------------------------------------------

_EPS = 1e-30


def _node_costs(lvl: torch.Tensor, cost: str, threshold, root_energy,
                axes=(-1, -2)) -> torch.Tensor:
    """Additive node costs on the device, summed over ``axes`` (the last one
    for a 1-D tree's ``[..., nodes, N]``, the last two for a 2-D tree);
    ``threshold`` and ``root_energy`` may be tensors."""
    p = lvl**2 / root_energy
    if cost == "shannon":
        return -(p * torch.log(p + _EPS)).sum(dim=axes)
    if cost == "log_energy":
        return torch.log(p + _EPS).sum(dim=axes)
    if cost == "threshold":
        return (lvl.abs() > threshold).sum(dim=axes).to(torch.float32)
    if cost == "risk":
        return torch.minimum(lvl**2, torch.as_tensor(threshold**2, dtype=lvl.dtype,
                                                     device=lvl.device)).sum(dim=axes)
    if cost == "l1":
        return lvl.abs().sum(dim=axes)
    raise InvalidArgumentError(
        ErrorCode.CFG_INVALID_CONFIG, f"unknown cost {cost!r}",
        suggestions=("Use shannon, log_energy, threshold, risk, l1, "
                     "or a callable node -> scalar",),
    )


def _device_best_basis_masks(costs, depth: int, arity: int):
    """Coifman-Wickerhauser dynamic program on the device over per-level
    ``[arity^j]`` cost vectors -> per-level used masks (a node is used iff it
    is kept and no ancestor is kept): a bottom-up sweep without a host sync.
    ``arity`` is 2 for the 1-D tree and 4 for the 2-D quadtree.  The
    comparison runs in float64, as the host program of :func:`best_basis`."""
    costs = [c.to(torch.float64) for c in costs]
    best = costs[depth]
    keeps: list = [None] * depth
    for j in range(depth - 1, -1, -1):
        children = best.reshape(-1, arity).sum(dim=1)
        keep = costs[j] <= children
        keeps[j] = keep
        best = torch.where(keep, costs[j], children)
    anc = torch.zeros(1, dtype=torch.bool, device=best.device)
    used: list = [None] * (depth + 1)
    for j in range(depth):
        used[j] = keeps[j] & ~anc
        anc = torch.repeat_interleave(anc | keeps[j], arity)
    used[depth] = ~anc
    return used


def _cost_table(
    tree: WaveletPacketTree, cost: str | Callable, threshold: float
) -> list[np.ndarray]:
    """Additive information cost per node, summed over batch axes, pulled to
    the host in one transfer."""
    if callable(cost):
        vectors = []
        for lvl in tree.levels:
            rows = lvl.reshape(-1, lvl.shape[-1])
            per_node = torch.stack([torch.as_tensor(cost(r)) for r in rows])
            vectors.append(per_node.reshape(-1, lvl.shape[-2]).sum(dim=0))
    else:
        root_energy = (tree.levels[0] ** 2).sum() + _EPS
        vectors = []
        for lvl in tree.levels:
            node_cost = _node_costs(lvl, cost, threshold, root_energy, axes=(-1,))
            vectors.append(node_cost.reshape(-1, lvl.shape[-2]).sum(dim=0))
    flat = torch.cat([v.to(torch.float64) for v in vectors]).cpu().numpy()
    return np.split(flat, np.cumsum([v.shape[0] for v in vectors])[:-1])


def best_basis(
    tree: WaveletPacketTree,
    cost: str | Callable = "shannon",
    *,
    threshold: float = 1.0,
) -> tuple[tuple[int, int], ...]:
    """Minimal-cost admissible basis as ``((level, natural_index), ...)``.

    Bottom-up dynamic program: a node is kept whole if its own cost is at
    most the best total cost of its two subtrees, else it is split.  Costs
    are additive over nodes ("shannon" = -sum p log p with p the per-sample
    energy fraction of the root energy; "log_energy"; "threshold" = count of
    samples above ``threshold``; "risk" = sum min(c^2, threshold^2); "l1";
    or any callable mapping a node's coefficient vector to a scalar).
    Batched inputs are selected jointly (costs summed over batch axes).
    """
    tables = _cost_table(tree, cost, threshold)
    depth = tree.depth
    best_cost = tables[depth].astype(np.float64).copy()
    choice: list[np.ndarray] = [None] * (depth + 1)  # type: ignore[list-item]
    choice[depth] = np.ones(1 << depth, dtype=bool)  # leaves: keep
    for j in range(depth - 1, -1, -1):
        own = tables[j].astype(np.float64)
        children = best_cost.reshape(-1, 2).sum(axis=1)
        keep = own <= children
        choice[j] = keep
        best_cost = np.where(keep, own, children)
    basis: list[tuple[int, int]] = []

    def _collect(level: int, idx: int) -> None:
        if choice[level][idx]:
            basis.append((level, idx))
        else:
            _collect(level + 1, 2 * idx)
            _collect(level + 1, 2 * idx + 1)

    _collect(0, 0)
    return tuple(basis)


def basis_coefficients(
    tree: WaveletPacketTree, basis: Sequence[tuple[int, int]]
) -> list[torch.Tensor]:
    """Coefficient vectors of the chosen basis nodes, in ``basis`` order."""
    return [tree.node(level, idx) for level, idx in basis]


def reconstruct_basis(
    tree: WaveletPacketTree,
    basis: Sequence[tuple[int, int]],
    wavelet,
    *,
    boundary: str = "periodic",
    transform_nodes: Callable | None = None,
) -> torch.Tensor:
    """Reconstruct the signal from an admissible basis selection.

    ``transform_nodes(level, index, coeffs) -> coeffs`` optionally edits each
    basis node before synthesis (thresholding, band suppression, ...).
    """
    w = _resolve_discrete(wavelet)
    _validate_basis(basis, tree.depth)
    chosen = dict()
    for level, idx in basis:
        coeffs = tree.node(level, idx)
        if transform_nodes is not None:
            coeffs = transform_nodes(level, idx, coeffs)
        chosen[(level, idx)] = coeffs
    decimated = tree.is_decimated

    def _synth(level: int, idx: int) -> torch.Tensor:
        if (level, idx) in chosen:
            return chosen[(level, idx)]
        lo = _synth(level + 1, 2 * idx)
        hi = _synth(level + 1, 2 * idx + 1)
        pair = torch.stack([lo, hi], dim=-2)
        if decimated:
            return _iwpt_pair(pair, w, boundary)[..., 0, :]
        return _imodwpt_pair(pair, w, 1 << level, boundary)[..., 0, :]

    return _synth(0, 0)


def _validate_basis(basis: Sequence[tuple[int, int]], depth: int) -> None:
    """An admissible basis covers [0, 1) exactly once in dyadic intervals."""
    intervals = []
    for level, idx in basis:
        if not (0 <= level <= depth) or not (0 <= idx < (1 << level)):
            raise InvalidArgumentError(
                ErrorCode.CFG_INVALID_CONFIG,
                f"node ({level}, {idx}) outside the tree (depth {depth})",
            )
        width = 1.0 / (1 << level)
        intervals.append((idx * width, (idx + 1) * width))
    intervals.sort()
    pos = 0.0
    for lo, hi in intervals:
        if abs(lo - pos) > 1e-12:
            raise InvalidArgumentError(
                ErrorCode.CFG_INVALID_CONFIG,
                "basis nodes overlap or leave gaps: not an admissible "
                "packet basis",
            )
        pos = hi
    if abs(pos - 1.0) > 1e-12:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            "basis does not cover the whole tree",
        )
