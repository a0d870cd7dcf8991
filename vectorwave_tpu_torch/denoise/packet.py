"""Best-basis wavelet packet denoising.

Counterpart of ``vectorwave_tpu/denoise/packet.py``: pick a
Coifman-Wickerhauser basis of an undecimated packet tree, shrink each basis
node with the standard threshold selectors (universal / SURE / minimax /
BayesShrink), reconstruct.  Against the plain MODWT denoiser this adapts the
frequency tiling to the signal: narrowband structure in a high band gets its
own node instead of sharing a whole detail level with the noise.

Noise model: per-stage 1/sqrt(2) filter scaling makes white noise of std
``sigma`` contribute ``sigma / sqrt(2^j)`` to every depth-``j`` packet node.
``sigma`` itself is estimated as the noise floor across the deepest-level
nodes, the median of per-node MADs rescaled by ``sqrt(2^J)``, which stays
honest when narrowband signal occupies some bands.  The DC-path node
``(j, 0)`` passes through untouched (the approximation, as in the MODWT
denoiser).

With a named cost everything stays on the input's device: the
Coifman-Wickerhauser program runs there over the per-level cost vectors and
the chosen basis becomes per-level used masks feeding a masked bottom-up
synthesis, with no transfer to the host.  A callable cost takes
:func:`~vectorwave_tpu_torch.transforms.packets.best_basis` on the host.
:func:`denoise_packet2` does the same over the decimated 2-D quadtree
(:mod:`..transforms.packets2d`).
"""

from __future__ import annotations

import math

import torch

from ..ops.thresholds import apply_threshold, mad_sigma, select_threshold
from ..transforms.modwt import _resolve_discrete
from ..transforms.packets import (
    _EPS,
    _device_best_basis_masks,
    _imodwpt_pair,
    _node_costs,
    best_basis,
    modwpt,
    reconstruct_basis,
)
from ..transforms.packets2d import _iwpt2_quad, _level_costs, best_basis2, reconstruct_basis2, wpt2


def _median_last(v: torch.Tensor) -> torch.Tensor:
    """Median along the last axis, kept as a singleton, the two middle values
    of an even count averaged."""
    n = v.shape[-1]
    ordered = torch.sort(v, dim=-1).values
    if n % 2 == 0:
        return (ordered[..., n // 2 - 1 : n // 2] + ordered[..., n // 2 : n // 2 + 1]) / 2
    return ordered[..., n // 2 : n // 2 + 1]


def _noise_floor_sigma(tree) -> torch.Tensor:
    """Median of depth-rescaled per-node MADs at the deepest level,
    ``[..., 1]`` (broadcastable against node coefficients)."""
    depth = tree.depth
    mads = mad_sigma(tree.levels[depth])[..., 0]  # [..., 2^J]
    return _median_last(mads) * math.sqrt(2.0**depth)


def denoise_packet(
    x: torch.Tensor,
    wavelet,
    levels: int = 4,
    *,
    cost="threshold",
    method: str = "universal",
    mode: str = "soft",
    boundary: str = "periodic",
) -> torch.Tensor:
    """Denoise via best-basis packet thresholding.

    ``cost`` picks the basis-selection criterion; the default "threshold"
    counts coefficients above the deepest level's noise-scaled universal
    threshold (a sparsity-relative-to-noise measure: the entropy costs tend
    to keep the root on noisy inputs, which would make the denoiser a
    no-op).
    """
    w = _resolve_discrete(wavelet)
    tree = modwpt(x, w, levels, boundary=boundary)
    sigma = _noise_floor_sigma(tree)
    if callable(cost):
        basis = best_basis(tree, cost=cost)
        return _reconstruct_shrunk_1d(tree, basis, w, sigma, method, mode, boundary)
    thr = sigma.mean() * math.sqrt(2.0 * math.log(float(x.shape[-1]))) / math.sqrt(
        2.0**levels)
    root_energy = (tree.levels[0] ** 2).sum() + _EPS
    costs = [
        _node_costs(lvl, cost, thr, root_energy, axes=(-1,)).reshape(
            -1, lvl.shape[-2]).sum(dim=0)
        for lvl in tree.levels
    ]
    used = _device_best_basis_masks(costs, levels, 2)

    def shrunk(j):
        lvl = tree.levels[j]  # [..., 2^j, N]
        level_sigma = sigma[..., None] / math.sqrt(2.0**j)
        threshold = select_threshold(lvl, level_sigma, method)
        s = apply_threshold(lvl, threshold, mode)
        # DC path (node 0 of any level): pure approximation, passes through
        s = torch.cat([lvl[..., :1, :], s[..., 1:, :]], dim=-2)
        return s * used[j].to(x.dtype)[:, None]

    val = shrunk(levels)
    for j in range(levels, 0, -1):
        val = _imodwpt_pair(val, w, 1 << (j - 1), boundary)
        val = val + shrunk(j - 1)
    return val[..., 0, :]


def _reconstruct_shrunk_1d(tree, basis, w, sigma, method, mode, boundary):
    def shrink(level: int, idx: int, coeffs: torch.Tensor) -> torch.Tensor:
        if idx == 0:  # DC path: pure approximation, pass through
            return coeffs
        level_sigma = sigma / math.sqrt(2.0**level)
        threshold = select_threshold(coeffs, level_sigma, method)
        return apply_threshold(coeffs, threshold, mode)

    return reconstruct_basis(tree, basis, w, boundary=boundary, transform_nodes=shrink)


def denoise_packet2(
    x: torch.Tensor,
    wavelet,
    levels: int = 3,
    *,
    cost="risk",
    method: str = "universal",
    mode: str = "hard",
    boundary: str = "periodic",
) -> torch.Tensor:
    """2-D best-basis packet denoising over the decimated quadtree.

    Default shrinkage is hard: the basis concentrates texture into few
    large coefficients, and soft's constant bias shaves exactly those.  The
    default basis cost is the threshold-risk proxy ``sum min(c^2, t^2)``
    (the count-above-threshold cost is degenerate for decimated denoising:
    a weak texture spread below ``t`` at the root counts near zero, so the
    program would hide the signal in the noise).

    The quadtree is orthonormal for orthogonal wavelets, so white noise of
    std ``sigma`` keeps std ``sigma`` in every node at every depth: no level
    rescaling.  ``sigma`` is the noise floor across the deepest-level nodes
    (the median of per-node MADs, two middle values of an even count
    averaged); the universal threshold uses ``N = H*W``.  The DC-path node
    ``(j, 0)`` passes through.  A named cost keeps the whole program on the
    input's device (masked bottom-up synthesis); a callable cost takes
    :func:`~vectorwave_tpu_torch.transforms.packets2d.best_basis2` on the
    host.
    """
    w = _resolve_discrete(wavelet)
    n_total = x.shape[-1] * x.shape[-2]
    tree = wpt2(x, w, levels, boundary=boundary)
    leaves = tree.leaves
    flat = leaves.reshape(leaves.shape[:-2] + (-1,))
    sigma = _median_last(mad_sigma(flat)[..., 0])
    if callable(cost):
        basis = best_basis2(tree, cost=cost)
        return _reconstruct_shrunk_2d(tree, basis, w, sigma, n_total, method, mode, boundary)
    thr = sigma.mean() * math.sqrt(2.0 * math.log(float(n_total)))
    root_energy = (tree.levels[0] ** 2).sum() + _EPS
    costs = [_level_costs(lvl, cost, thr, root_energy) for lvl in tree.levels]
    used = _device_best_basis_masks(costs, levels, 4)

    def shrunk(j):
        lvl = tree.levels[j]  # [..., 4^j, h, w]
        vec = lvl.reshape(lvl.shape[:-2] + (-1,))
        if method.lower() == "universal":
            threshold = (sigma * math.sqrt(2.0 * math.log(n_total)))[..., None]
        else:
            threshold = select_threshold(vec, sigma[..., None], method)
        s = apply_threshold(vec, threshold, mode).reshape(lvl.shape)
        # DC path (node 0 of any level) passes through
        s = torch.cat([lvl[..., :1, :, :], s[..., 1:, :, :]], dim=-3)
        return s * used[j].to(x.dtype)[:, None, None]

    val = shrunk(levels)
    for j in range(levels, 0, -1):
        val = _iwpt2_quad(val, w, boundary)
        val = val + shrunk(j - 1)
    return val[..., 0, :, :]


def _reconstruct_shrunk_2d(tree, basis, w, sigma, n_total, method, mode, boundary):
    def shrink(level: int, idx: int, plane: torch.Tensor) -> torch.Tensor:
        if idx == 0:  # DC path: pure approximation, pass through
            return plane
        vec = plane.reshape(plane.shape[:-2] + (-1,))
        if method.lower() == "universal":
            threshold = sigma * math.sqrt(2.0 * math.log(n_total))
        else:
            threshold = select_threshold(vec, sigma, method)
        return apply_threshold(vec, threshold, mode).reshape(plane.shape)

    return reconstruct_basis2(tree, basis, w, boundary=boundary, transform_nodes=shrink)
