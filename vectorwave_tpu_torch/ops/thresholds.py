"""Thresholding and noise-estimation primitives in plain PyTorch.

Counterpart of ``vectorwave_tpu/ops/thresholds.py``: soft/hard shrinkage,
the MAD noise estimate, the universal, SURE, minimax, Bayes and FDR
threshold rules and NeighBlock block shrinkage, all vectorized along the
last axis.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..errors import ErrorCode, InvalidArgumentError

#: MAD -> sigma scale for Gaussian noise
MAD_SCALE = 0.6745

#: Cai-Silverman block-shrinkage risk constant (the root of L - log L = 3)
BLOCK_LAMBDA = 4.50524


def soft_threshold(coeffs: torch.Tensor, threshold) -> torch.Tensor:
    """Soft thresholding: sign(c) * max(|c| - t, 0)."""
    return torch.sign(coeffs) * torch.clamp(coeffs.abs() - threshold, min=0.0)


def hard_threshold(coeffs: torch.Tensor, threshold) -> torch.Tensor:
    """Hard thresholding: c * 1[|c| > t]."""
    return torch.where(coeffs.abs() > threshold, coeffs, torch.zeros_like(coeffs))


def apply_threshold(coeffs: torch.Tensor, threshold, mode: str = "soft") -> torch.Tensor:
    mode_l = mode.lower()
    if mode_l == "soft":
        return soft_threshold(coeffs, threshold)
    if mode_l == "hard":
        return hard_threshold(coeffs, threshold)
    raise InvalidArgumentError(
        ErrorCode.CFG_INVALID_CONFIG,
        f"Unknown threshold type: {mode!r}",
        suggestions=("Use 'soft' or 'hard'",),
    )


class _MedianMagnitude(torch.autograd.Function):
    """The median of ``|v|`` with the JAX package's derivative: for each
    middle order statistic the subgradient is shared equally by every
    position whose float32 magnitude equals it, and the middle statistics
    are averaged.  Each statistic's share is rounded to float32 before it
    is cast back to ``v``'s dtype, as the JAX rule's float32 tangent
    rounds it.  The backward is tensor ops on constants of ``v``, so a
    second derivative is zero, as JAX's is."""

    @staticmethod
    def forward(ctx, v):
        n = v.shape[-1]
        ordered = torch.sort(v.abs().to(torch.float32), dim=-1).values
        vals = ordered[..., (n - 1) // 2 : n // 2 + 1]  # the middle one or two
        ctx.save_for_backward(v, vals)
        mid = vals if vals.shape[-1] == 1 else (vals[..., :1] + vals[..., 1:]) / 2
        return mid.to(v.dtype)

    @staticmethod
    def backward(ctx, grad):
        v, vals = ctx.saved_tensors
        mag = v.abs().to(torch.float32)
        sign = torch.sign(v)
        share = grad / vals.shape[-1]
        total = 0
        for r in range(vals.shape[-1]):
            mask = (mag == vals[..., r : r + 1]).to(torch.float32)
            weight = mask / mask.sum(dim=-1, keepdim=True).clamp(min=1.0)
            total = total + (weight * sign * share).to(torch.float32).to(v.dtype)
        return total


def median_magnitude(v: torch.Tensor) -> torch.Tensor:
    """Median of ``|v|`` along the last axis, with a trailing singleton axis.

    The JAX package's semantics, for every input dtype: ``|v|`` is taken in
    float32, the two middle order statistics of an even count are averaged
    in float32, and the result is cast back to ``v``'s dtype.  (``torch.median``
    would return the lower middle value instead.)  Its gradient is the JAX
    package's custom derivative: each middle order statistic's subgradient
    is averaged over every position that attains it, so ties share it.
    """
    return _MedianMagnitude.apply(v)


def mad_sigma(detail: torch.Tensor) -> torch.Tensor:
    """Noise sigma via the median absolute deviation of detail coefficients:
    median(|d|) / 0.6745, per signal along the last axis, keeping a trailing
    singleton axis so it broadcasts against ``[..., N]`` coefficients."""
    return median_magnitude(detail) / MAD_SCALE


def universal_threshold(n: int, sigma) -> torch.Tensor:
    """VisuShrink: sigma * sqrt(2 ln N)."""
    return torch.as_tensor(sigma) * math.sqrt(2.0 * math.log(float(n)))


def sure_threshold(coeffs: torch.Tensor, sigma) -> torch.Tensor:
    """SURE threshold: minimize Stein's unbiased risk over candidate
    thresholds, capped at universal.

    With s = sorted(|c|), the risk at t = s[k] is
    ``(-n sigma^2 + sum_{i<=k} s_i^2 + sum_{i>k} [sigma^2 + (s_i - s_k)^2]) / n``,
    computed for all k via prefix sums.
    """
    n = coeffs.shape[-1]
    sigma = torch.as_tensor(sigma, device=coeffs.device)
    s = torch.sort(coeffs.abs(), dim=-1).values
    s2 = s * s
    cum_s2 = torch.cumsum(s2, dim=-1)
    cum_s = torch.cumsum(s, dim=-1)
    above_s2 = cum_s2[..., -1:] - cum_s2  # sum_{i>k} s_i^2
    above_s = cum_s[..., -1:] - cum_s  # sum_{i>k} s_i
    count_above = (n - 1 - torch.arange(n, device=coeffs.device)).to(coeffs.dtype)
    sigma2 = sigma * sigma
    risk = (
        -n * sigma2
        + cum_s2
        + count_above * sigma2
        + above_s2
        - 2.0 * s * above_s
        + count_above * s2
    ) / n
    best = torch.gather(s, -1, torch.argmin(risk, dim=-1, keepdim=True))
    return torch.minimum(best, universal_threshold(n, sigma))


def minimax_threshold(n: int, sigma) -> torch.Tensor:
    """Minimax piecewise approximation."""
    sigma = torch.as_tensor(sigma)
    if n <= 32:
        return torch.zeros_like(sigma)
    log_n = math.log(float(n))
    if n <= 64:
        return sigma * 0.3936 + 0.1829 * sigma * log_n
    return sigma * (0.4745 + 0.1148 * log_n)


def bayes_threshold(coeffs: torch.Tensor, sigma, eps: float = 1e-10) -> torch.Tensor:
    """BayesShrink: T = sigma^2 / sigma_x, sigma_x^2 = max(0, var(c) - sigma^2)."""
    sigma = torch.as_tensor(sigma, device=coeffs.device)
    sigma2 = sigma * sigma
    variance = torch.var(coeffs, dim=-1, keepdim=True, correction=0)
    sigma_x = torch.sqrt(torch.clamp(variance - sigma2, min=0.0) + eps)
    return sigma2 / sigma_x


def fdr_threshold(coeffs: torch.Tensor, sigma, q: float = 0.05) -> torch.Tensor:
    """False-discovery-rate threshold (Abramovich-Benjamini): the largest k
    with two-sided p-value ``p_(k) <= q k / n`` over the descending |c|; if
    nothing is significant every coefficient is killed (``max |c|``)."""
    n = coeffs.shape[-1]
    sigma = torch.as_tensor(sigma, device=coeffs.device)
    s = torch.flip(torch.sort(coeffs.abs(), dim=-1).values, dims=(-1,))
    pvals = torch.special.erfc(s / (sigma * math.sqrt(2.0) + 1e-30))
    crit = q * torch.arange(1, n + 1, dtype=coeffs.dtype, device=coeffs.device) / n
    ok = pvals <= crit
    found = ok.any(dim=-1, keepdim=True)
    last = n - 1 - torch.argmax(torch.flip(ok, dims=(-1,)).to(torch.int8), dim=-1,
                                keepdim=True)
    t_found = torch.gather(s, -1, last)
    return torch.where(found, t_found, s[..., :1])


def block_shrink(
    coeffs: torch.Tensor,
    sigma,
    *,
    block_size: int | None = None,
    lam: float = BLOCK_LAMBDA,
) -> torch.Tensor:
    """NeighBlock James-Stein block shrinkage (Cai-Silverman 2001).

    Coefficients are shrunk in blocks of ``L0 = floor(log n / 2)`` using the
    energy ``S_b`` of an extended window (``L1 = floor(L0/2)`` extra
    samples each side),

        c_b <- c_b * max(0, 1 - lam * L * sigma^2 / S_b),

    so a strong neighbour rescues a weak coefficient inside a feature and
    isolated noise blocks are zeroed wholesale.  Windows are clamped at the
    edges (``L`` is the actual window length per block).  The window
    energies are differences of one prefix sum along the last axis, as in
    the JAX package: in float32 they cancel on long rows (the difference of
    two sums of order n), so a float32 shrink strays from a float64 one by
    about 1e-5 of the largest coefficient at n = 1024 and 2e-5 at 4096, as
    the JAX package's float32 shrink does.
    """
    n = coeffs.shape[-1]
    if block_size is None:
        block_size = max(1, int(math.log(max(n, 2)) / 2.0))
    l0 = max(1, int(block_size))
    l1 = max(1, l0 // 2)
    nb = -(-n // l0)
    starts = np.clip(np.arange(nb) * l0 - l1, 0, n)
    ends = np.clip(np.arange(nb) * l0 + l0 + l1, 0, n)
    c2 = coeffs * coeffs
    csum = torch.cat([coeffs.new_zeros(coeffs.shape[:-1] + (1,)), torch.cumsum(c2, dim=-1)],
                     dim=-1)
    dev = coeffs.device
    energy = (csum[..., torch.from_numpy(ends).to(dev)]
              - csum[..., torch.from_numpy(starts).to(dev)])  # [..., nb]
    win_len = torch.from_numpy(ends - starts).to(device=dev, dtype=coeffs.dtype)
    sigma = torch.as_tensor(sigma, device=dev)
    factor = torch.clamp(1.0 - lam * win_len * sigma * sigma / (energy + 1e-30), min=0.0)
    idx_map = np.minimum(np.arange(n) // l0, nb - 1)
    return coeffs * factor[..., torch.from_numpy(idx_map).to(dev)]


def select_threshold(coeffs: torch.Tensor, sigma, method: str):
    """Dispatch on the threshold-selection method.  ``sigma`` has a trailing
    singleton axis (from :func:`mad_sigma`); the returned threshold
    broadcasts against ``coeffs``."""
    method_l = method.lower()
    n = int(coeffs.shape[-1])
    if method_l == "universal":
        return universal_threshold(n, sigma)
    if method_l == "sure":
        return sure_threshold(coeffs, sigma)
    if method_l == "minimax":
        return minimax_threshold(n, sigma)
    if method_l in ("bayes", "bayesshrink"):
        return bayes_threshold(coeffs, sigma)
    if method_l == "fdr":
        return fdr_threshold(coeffs, sigma)
    raise InvalidArgumentError(
        ErrorCode.CFG_INVALID_CONFIG,
        f"Unknown threshold method: {method!r}",
        suggestions=("Use 'universal', 'sure', 'minimax', 'bayes' or 'fdr'",),
    )
