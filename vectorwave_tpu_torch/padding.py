"""Signal padding strategies.

Counterpart of ``vectorwave_tpu/padding.py``: one functional entry point,
:func:`pad_signal`, with a strategy name, and :func:`adaptive_strategy`,
which picks a strategy from the signal's smoothness, trend and periodicity.
Plain PyTorch over the last axis; the index-map strategies build their
gather index with ``numpy.pad`` of ``arange(n)``, so they follow numpy's
(and so the JAX package's) edge rules exactly.  Alignment is ``right``,
``left`` or ``symmetric``.
"""

from __future__ import annotations

import numpy as np
import torch

from .errors import ErrorCode, InvalidArgumentError

STRATEGIES = (
    "zero",
    "constant",
    "periodic",
    "symmetric",
    "reflect",
    "antisymmetric",
    "linear_extrapolation",
    "polynomial_extrapolation",
    "statistical",
    "composite",
    "adaptive",
)

#: Strategies that repeat samples of the signal, as numpy.pad modes.
_INDEX_MODES = {
    "constant": "edge",  # repeat the edge values
    "periodic": "wrap",
    "symmetric": "symmetric",  # half-point mirror, edge repeated
    "reflect": "reflect",  # whole-point mirror, edge not repeated
}


def _extend(x: torch.Tensor, left: int, right: int, strategy: str, options) -> torch.Tensor:
    """x extended by ``left``/``right`` samples on each side."""
    n = x.shape[-1]
    if strategy == "zero":
        return torch.nn.functional.pad(x, (left, right))
    if strategy in _INDEX_MODES:
        idx = np.pad(np.arange(n), (left, right), mode=_INDEX_MODES[strategy])
        return x[..., torch.as_tensor(idx, device=x.device)]
    if strategy == "antisymmetric":
        # half-point antisymmetry about each edge value
        idx_l = torch.arange(left - 1, -1, -1, device=x.device)
        idx_r = torch.arange(n - 1, n - 1 - right, -1, device=x.device)
        left_part = 2 * x[..., :1] - x[..., idx_l]
        right_part = 2 * x[..., -1:] - x[..., idx_r]
        return torch.cat([left_part, x, right_part], dim=-1)
    if strategy == "linear_extrapolation":
        # continue the slope of the last (first) two samples
        slope_r = x[..., -1:] - x[..., -2:-1]
        slope_l = x[..., 1:2] - x[..., :1]
        kr = torch.arange(1, right + 1, dtype=x.dtype, device=x.device)
        kl = torch.arange(left, 0, -1, dtype=x.dtype, device=x.device)
        return torch.cat([x[..., :1] - slope_l * kl, x, x[..., -1:] + slope_r * kr],
                         dim=-1)
    if strategy == "polynomial_extrapolation":
        order = int(options.get("order", 3))
        window = min(int(options.get("window", max(2 * (order + 1), 8))), n)
        vand = np.vander(np.arange(window, dtype=np.float64), order + 1, increasing=True)

        def const(a):
            return torch.as_tensor(a, dtype=x.dtype, device=x.device)

        pinv = const(np.linalg.pinv(vand))

        def powers(count):
            return const(np.vander(np.arange(window, window + count, dtype=np.float64),
                                   order + 1, increasing=True))

        coef_r = torch.einsum("ij,...j->...i", pinv, x[..., -window:])
        coef_l = torch.einsum("ij,...j->...i", pinv, torch.flip(x[..., :window], dims=(-1,)))
        right_part = torch.einsum("kj,...j->...k", powers(right), coef_r)
        left_part = torch.flip(torch.einsum("kj,...j->...k", powers(left), coef_l),
                               dims=(-1,))
        return torch.cat([left_part, x, right_part], dim=-1)
    if strategy == "statistical":
        method = options.get("method", "mean")
        if method == "mean":
            fill = x.mean(dim=-1, keepdim=True)
        elif method == "median":  # the mean of the two middle values of an even count
            fill = torch.quantile(x, 0.5, dim=-1, keepdim=True)
        else:
            raise InvalidArgumentError(
                ErrorCode.CFG_INVALID_CONFIG,
                f"Unknown statistical padding method: {method!r}",
                suggestions=("Use 'mean' or 'median'",),
            )
        return torch.cat([fill.expand(x.shape[:-1] + (left,)), x,
                          fill.expand(x.shape[:-1] + (right,))], dim=-1)
    if strategy == "composite":
        # a different strategy on each side
        with_left = _extend(x, left, 0, options.get("left", "symmetric"), options)
        with_right = _extend(x, 0, right, options.get("right", "symmetric"), options)
        return torch.cat([with_left[..., :left], with_right], dim=-1)
    raise InvalidArgumentError(
        ErrorCode.CFG_INVALID_CONFIG,
        f"Unknown padding strategy: {strategy!r}",
        suggestions=(f"Use one of {STRATEGIES}",),
    )


def adaptive_strategy(x) -> str:
    """Pick a padding strategy from the signal's characteristics: strong
    periodicity (autocorrelation that recovers after decorrelating),
    a linear trend, smoothness, else ``symmetric``.  Runs on the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    n = len(x)
    if n < 8:
        return "symmetric"
    centered = x - x.mean()
    denom = float(np.dot(centered, centered)) + 1e-30
    max_lag = min(n // 2, 256)
    ac = np.correlate(centered, centered, mode="full")[n - 1 : n - 1 + max_lag] / denom
    below = np.nonzero(ac < 0.2)[0]
    periodicity = float(ac[below[0] :].max()) if below.size else 0.0
    t = np.arange(n)
    slope, intercept = np.polyfit(t, x, 1)
    resid = x - (slope * t + intercept)
    r2 = 1.0 - float(np.dot(resid, resid)) / denom if denom > 0 else 0.0
    diff = np.diff(x)
    roughness = float(np.dot(diff, diff)) / denom
    if periodicity > 0.8:
        return "periodic"
    if r2 > 0.85:
        return "linear_extrapolation"
    if roughness < 0.05:
        return "polynomial_extrapolation"
    return "symmetric"


def pad_signal(
    x: torch.Tensor,
    target_length: int,
    strategy: str = "symmetric",
    *,
    align: str = "right",
    **options,
) -> torch.Tensor:
    """Pad ``x`` (last axis) to ``target_length`` using ``strategy``.

    ``align`` places the original samples: ``right`` pads after the signal,
    ``left`` before, ``symmetric`` splits the padding.
    """
    n = x.shape[-1]
    if target_length < n:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"Target length {target_length} must be >= signal length {n}",
        )
    pad_total = target_length - n
    if pad_total == 0:
        return x
    strategy_l = strategy.lower()
    if strategy_l == "adaptive":
        strategy_l = adaptive_strategy(x)
    align_l = align.lower()
    if align_l == "right":
        left, right = 0, pad_total
    elif align_l == "left":
        left, right = pad_total, 0
    elif align_l == "symmetric":
        left = pad_total // 2
        right = pad_total - left
    else:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"Unknown padding alignment: {align!r}",
            suggestions=("Use 'right', 'left' or 'symmetric'",),
        )
    return _extend(x, left, right, strategy_l, options)
