"""O(1)-per-tick incremental financial metrics.

Counterpart of ``vectorwave_tpu/finance/incremental.py``, after the
reference's streaming analyzers (``IncrementalFinancialAnalyzer`` and
``SimpleStreamingAnalyzer``): the state is an explicit NamedTuple of 0-d
tensors and the update a pure function of (state, price), called tick at a
time.  :func:`analyze_ticks_incremental` runs a whole stream as a Python
loop of these updates on the device of its prices, about 50 small tensor
operations a tick; the JAX package runs the same update inside one
``lax.scan``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..convert import _device
from ..ops.constants import kept


class IncrementalState(NamedTuple):
    """EWMA/rolling carry for the streaming metrics."""

    count: torch.Tensor
    last_price: torch.Tensor
    mean_return: torch.Tensor  # EWMA of returns
    var_return: torch.Tensor  # EWMA variance of returns
    ewma_vol_fast: torch.Tensor
    ewma_vol_slow: torch.Tensor
    peak_price: torch.Tensor
    max_drawdown: torch.Tensor


class IncrementalMetrics(NamedTuple):
    ret: torch.Tensor
    volatility: torch.Tensor
    sharpe: torch.Tensor
    drawdown: torch.Tensor
    max_drawdown: torch.Tensor
    vol_ratio: torch.Tensor  # fast/slow volatility regime indicator


def incremental_init(dtype=torch.float32, *, device="cuda") -> IncrementalState:
    """The empty state on ``device`` (default: the card; ``device="cpu"``
    for the CPU)."""
    zero = torch.zeros((), dtype=dtype, device=_device(device))
    return IncrementalState(*([zero] * len(IncrementalState._fields)))


def incremental_update(
    state: IncrementalState,
    price,
    *,
    alpha_mean: float = 0.05,
    alpha_fast: float = 0.2,
    alpha_slow: float = 0.02,
) -> tuple[IncrementalState, IncrementalMetrics]:
    """One tick -> (new_state, metrics); O(1) work
    (IncrementalFinancialAnalyzer's EWMA scheme)."""
    price = torch.as_tensor(price, dtype=state.last_price.dtype, device=state.last_price.device)
    first = state.count == 0
    ret = torch.where(first, 0.0, torch.log(torch.clamp_min(price, 1e-30)
                                            / torch.clamp_min(state.last_price, 1e-30)))
    mean = torch.where(first, 0.0, (1 - alpha_mean) * state.mean_return + alpha_mean * ret)
    var = torch.where(
        first, 0.0, (1 - alpha_mean) * state.var_return + alpha_mean * (ret - mean) ** 2
    )
    vol_fast = torch.where(
        first, 0.0, (1 - alpha_fast) * state.ewma_vol_fast + alpha_fast * ret.abs()
    )
    vol_slow = torch.where(
        first, 0.0, (1 - alpha_slow) * state.ewma_vol_slow + alpha_slow * ret.abs()
    )
    peak = torch.maximum(state.peak_price, price)
    drawdown = (peak - price) / torch.clamp_min(peak, 1e-30)
    max_dd = torch.maximum(state.max_drawdown, drawdown)
    std = torch.sqrt(torch.clamp_min(var, 1e-30))
    metrics = IncrementalMetrics(
        ret=ret,
        volatility=std,
        sharpe=mean / std,
        drawdown=drawdown,
        max_drawdown=max_dd,
        vol_ratio=vol_fast / torch.clamp_min(vol_slow, 1e-30),
    )
    new_state = IncrementalState(
        count=state.count + 1,
        last_price=price,
        mean_return=mean,
        var_return=var,
        ewma_vol_fast=vol_fast,
        ewma_vol_slow=vol_slow,
        peak_price=peak,
        max_drawdown=max_dd,
    )
    return new_state, metrics


# ---------------------------------------------------------------------------
# Per-tick incremental WAVELET analyzer (IncrementalFinancialAnalyzer: EMAs
# 12/26/50, volatility, drawdown, Paul-CWT crash detection, regime and risk
# tracking).  The wavelet state advances every tick in O(K): the level-1
# Haar MODWT detail in closed form, and the Paul crash correlation over a
# K-tick return window carried in the state.
# ---------------------------------------------------------------------------


class IncrementalWaveletState(NamedTuple):
    """Carry for the wavelet-augmented tick analyzer."""

    base: IncrementalState
    ret_window: torch.Tensor  # [K] most recent log returns (oldest first)
    ema12: torch.Tensor
    ema26: torch.Tensor
    ema50: torch.Tensor
    wavelet_vol: torch.Tensor  # EWMA of squared Haar detail
    max_crash_score: torch.Tensor


class IncrementalWaveletMetrics(NamedTuple):
    base: IncrementalMetrics
    haar_detail: torch.Tensor  # level-1 MODWT detail at the newest tick
    wavelet_vol: torch.Tensor
    crash_score: torch.Tensor  # Paul-kernel asymmetry of the return window
    crash_detected: torch.Tensor  # bool
    macd: torch.Tensor  # ema12 - ema26
    regime_code: torch.Tensor  # 0 bull/calm, 1 bull/vol, 2 bear/calm, 3 bear/vol
    risk_level: torch.Tensor  # [0, 1]


@functools.lru_cache(maxsize=32)
def _paul_crash_kernel(k: int, order: int = 4) -> np.ndarray:
    """Real part of a Paul wavelet sampled causally over the last k ticks
    (the crash detector's asymmetric kernel), unit norm."""
    from ..wavelets.registry import wavelet as _wavelet

    w = _wavelet(f"paul{order}")
    t = np.linspace(-3.5, 0.0, k)  # causal: newest tick at t=0
    vals = np.real(np.asarray([w.psi(float(ti)) for ti in t]))
    norm = np.sqrt(np.sum(vals**2))
    return vals / max(norm, 1e-30)


@functools.lru_cache(maxsize=32)
@kept
def _kernel_tensor(k: int, order: int, dtype: torch.dtype, device: torch.device):
    return torch.as_tensor(_paul_crash_kernel(k, order), dtype=dtype, device=device)


def incremental_wavelet_init(
    *, window: int = 32, paul_order: int = 4, dtype=torch.float32, device="cuda"
) -> IncrementalWaveletState:
    """The empty wavelet state on ``device`` (default: the card;
    ``device="cpu"`` for the CPU)."""
    dev = _device(device)
    zero = torch.zeros((), dtype=dtype, device=dev)
    return IncrementalWaveletState(
        base=incremental_init(dtype=dtype, device=dev),
        ret_window=torch.zeros((window,), dtype=dtype, device=dev),
        ema12=zero,
        ema26=zero,
        ema50=zero,
        wavelet_vol=zero,
        max_crash_score=zero,
    )


def incremental_wavelet_update(
    state: IncrementalWaveletState,
    price,
    *,
    paul_order: int = 4,
    crash_threshold: float = 3.0,
    alpha_wavelet: float = 0.06,
) -> tuple[IncrementalWaveletState, IncrementalWaveletMetrics]:
    """One tick -> (state, metrics), a pure function.

    ``haar_detail`` is the closed-form level-1 MODWT detail ``(p_t -
    p_{t-1}) / 2``; ``crash_score`` correlates the K-tick return window
    with a causal Paul-wavelet kernel, normalized by the EWMA volatility, so
    one-sided drops score high while symmetric swings cancel.
    """
    k = state.ret_window.shape[-1]
    kernel = _kernel_tensor(k, paul_order, state.ret_window.dtype, state.ret_window.device)
    prev_price = state.base.last_price
    new_base, base_metrics = incremental_update(state.base, price)
    price = new_base.last_price
    first = state.base.count == 0

    haar_detail = torch.where(first, 0.0, (price - prev_price) * 0.5)
    wavelet_vol = torch.where(
        first, 0.0, (1 - alpha_wavelet) * state.wavelet_vol + alpha_wavelet * haar_detail**2
    )
    ret_window = torch.cat([state.ret_window[1:], base_metrics.ret[None]], dim=-1)
    sigma = torch.clamp_min(base_metrics.volatility, 1e-12)
    crash_score = -(ret_window @ kernel) / sigma  # drops (neg returns) -> +
    crash_detected = torch.logical_and(crash_score > crash_threshold, state.base.count >= k)
    ema12 = torch.where(first, price, state.ema12 + (2.0 / 13) * (price - state.ema12))
    ema26 = torch.where(first, price, state.ema26 + (2.0 / 27) * (price - state.ema26))
    ema50 = torch.where(first, price, state.ema50 + (2.0 / 51) * (price - state.ema50))
    bearish = ema12 < ema50
    volatile = base_metrics.vol_ratio > 1.5
    regime_code = bearish.to(torch.int32) * 2 + volatile.to(torch.int32)
    risk = torch.clamp(
        0.3 * torch.tanh(crash_score / crash_threshold)
        + 0.3 * torch.tanh(base_metrics.vol_ratio - 1.0)
        + 0.2 * bearish.to(price.dtype)
        + 0.2 * torch.tanh(10.0 * base_metrics.drawdown),
        0.0,
        1.0,
    )
    new_state = IncrementalWaveletState(
        base=new_base,
        ret_window=ret_window,
        ema12=ema12,
        ema26=ema26,
        ema50=ema50,
        wavelet_vol=wavelet_vol,
        max_crash_score=torch.maximum(state.max_crash_score, crash_score),
    )
    metrics = IncrementalWaveletMetrics(
        base=base_metrics,
        haar_detail=haar_detail,
        wavelet_vol=wavelet_vol,
        crash_score=crash_score,
        crash_detected=crash_detected,
        macd=ema12 - ema26,
        regime_code=regime_code,
        risk_level=risk,
    )
    return new_state, metrics


def _stack(items: list):
    """Per-tick metric records -> one record of ``[T]`` tensors."""
    first = items[0]
    if isinstance(first, tuple):
        return type(first)(*(_stack([it[i] for it in items]) for i in range(len(first))))
    return torch.stack(items)


def analyze_ticks_incremental(
    prices,
    *,
    window: int = 32,
    paul_order: int = 4,
    crash_threshold: float = 3.0,
    device="cuda",
) -> IncrementalWaveletMetrics:
    """A whole tick stream through :func:`incremental_wavelet_update`
    (processBatch analogue); per-tick metric tensors ``[T]``.  A tensor of
    prices runs on its device; host prices become the default dtype on
    ``device`` (default: the card)."""
    if not isinstance(prices, torch.Tensor):
        prices = torch.as_tensor(np.asarray(prices, dtype=np.float64),
                                 dtype=torch.get_default_dtype(), device=_device(device))
    state = incremental_wavelet_init(window=window, paul_order=paul_order,
                                     dtype=prices.dtype, device=prices.device)
    metrics = []
    for p in prices:
        state, m = incremental_wavelet_update(state, p, paul_order=paul_order,
                                              crash_threshold=crash_threshold)
        metrics.append(m)
    return _stack(metrics)
