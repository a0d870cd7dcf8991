"""Financial wavelet analysis.

Counterpart of ``vectorwave_tpu/finance/analyzer.py``, after the
reference's two financial analyzers: the Sharpe ratio and its
wavelet-denoised form, crash asymmetry, and the CWT-based crash detection,
volatility classification and clustering, market cycles, regime and anomaly
detection, trading signals and wavelet indicators, returned as records.

The transforms (``cwt``, ``denoise_multilevel``, ``modwt_multilevel``) run
on the card; the record assembly (clusters, event lists) is host numpy, as
in the JAX package.  Price series given as arrays become tensors of the
default dtype (``torch.get_default_dtype()``, the counterpart of JAX's
default float) on ``device`` (default: the card; pass ``device="cpu"`` for
the CPU); a tensor stays on its own device.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import NamedTuple

import numpy as np
import torch

from ..convert import _device
from ..denoise.denoiser import denoise_multilevel
from ..ops.convolve import host_complex
from ..transforms.cwt import cwt, scale_to_frequency, scales_log
from ..transforms.multilevel import max_levels, modwt_multilevel


@dataclasses.dataclass(frozen=True)
class FinancialConfig:
    """Thresholds + rates (financial/FinancialConfig.java:25-40,
    FinancialAnalysisConfig.java)."""

    risk_free_rate: float = 0.0
    crash_asymmetry_threshold: float = 0.65
    volatility_low_threshold: float = 0.5
    volatility_high_threshold: float = 2.0
    regime_trend_threshold: float = 0.4
    anomaly_threshold: float = 3.0


def _input_device(values, device) -> torch.device:
    """A tensor's own device, else ``device`` (raising for a missing card)."""
    return values.device if isinstance(values, torch.Tensor) else _device(device)


def _to_device(values, dev: torch.device) -> torch.Tensor:
    """A tensor as it is; host values as the default dtype on ``dev``."""
    if isinstance(values, torch.Tensor):
        return values
    return torch.as_tensor(np.asarray(values, dtype=np.float64),
                           dtype=torch.get_default_dtype(), device=dev)


def _host(values) -> np.ndarray:
    """Prices or returns as a float64 host array."""
    return host_complex(values) if isinstance(values, torch.Tensor) else np.asarray(
        values, dtype=np.float64)


# --------------------------------------------------------------------------
# Sharpe ratios (financial/FinancialWaveletAnalyzer.java:82-160)
# --------------------------------------------------------------------------


def sharpe_ratio(returns, risk_free_rate: float = 0.0, *, device="cuda") -> torch.Tensor:
    """(mean - rf) / std (ddof 1) over the last axis."""
    returns = _to_device(returns, _input_device(returns, device))
    excess = returns.mean(dim=-1) - risk_free_rate
    std = returns.std(dim=-1)
    return excess / torch.where(std > 0, std, math.inf)


def wavelet_sharpe_ratio(
    returns,
    risk_free_rate: float = 0.0,
    *,
    wavelet: str = "db4",
    levels: int | None = None,
    device="cuda",
) -> torch.Tensor:
    """Sharpe of wavelet-denoised returns
    (``calculateWaveletSharpeRatio`` :151-160)."""
    returns = _to_device(returns, _input_device(returns, device))
    n = returns.shape[-1]
    if levels is None:
        levels = max(1, min(4, max_levels(n, wavelet)))
    denoised = denoise_multilevel(returns, wavelet, levels=levels)
    return sharpe_ratio(denoised, risk_free_rate)


def crash_asymmetry(prices, *, wavelet: str = "haar", device="cuda") -> torch.Tensor:
    """Down-vs-up movement energy asymmetry in the fine detail band
    (``FinancialAnalyzer.analyzeCrashAsymmetry`` :52-92): crashes are fast
    drawdowns, so negative-movement detail energy dominating is the
    signature.  With the Haar detail, ``detail[t] = (p[t] - p[t-1]) / 2``.
    """
    prices = _to_device(prices, _input_device(prices, device))
    # symmetric boundary: the periodic wrap-around would fabricate one huge
    # (last-to-first) jump that swamps the energy ratio
    res = modwt_multilevel(prices, wavelet, levels=1, boundary="symmetric")
    detail = res.details[0]
    neg = torch.where(detail < 0, detail**2, 0.0).sum(dim=-1)
    pos = torch.where(detail > 0, detail**2, 0.0).sum(dim=-1)
    return neg / (neg + pos + 1e-30)


# --------------------------------------------------------------------------
# CWT-based market analysis (cwt/finance/FinancialWaveletAnalyzer.java)
# --------------------------------------------------------------------------


class CrashDetectionResult(NamedTuple):
    crash_points: tuple[int, ...]
    severity: np.ndarray
    max_severity: float
    crash_probabilities: dict[int, float]


class VolatilityLevel(enum.Enum):
    LOW = "low"
    MEDIUM = "medium"
    HIGH = "high"
    EXTREME = "extreme"


class VolatilityCluster(NamedTuple):
    start_index: int
    end_index: int
    level: VolatilityLevel
    average_volatility: float


class VolatilityAnalysisResult(NamedTuple):
    volatility_clusters: tuple[VolatilityCluster, ...]
    instantaneous_volatility: np.ndarray
    average_volatility: float
    max_volatility: float


class MarketCycle(NamedTuple):
    period: float
    frequency: float
    strength: float
    phase: float


class CyclicalAnalysisResult(NamedTuple):
    dominant_cycles: tuple[MarketCycle, ...]
    spectral_density: np.ndarray
    periodogram: dict[float, float]


class MarketRegime(enum.Enum):
    TRENDING_UP = "trending_up"
    TRENDING_DOWN = "trending_down"
    RANGING = "ranging"
    VOLATILE = "volatile"


class AnomalyType(enum.Enum):
    PRICE_SPIKE = "price_spike"
    VOLUME_SPIKE = "volume_spike"
    VOLUME_PRICE_DIVERGENCE = "volume_price_divergence"
    UNUSUAL_PATTERN = "unusual_pattern"


class MarketAnomaly(NamedTuple):
    time_index: int
    type: AnomalyType
    severity: float
    description: str


class MarketAnalysisResult(NamedTuple):
    regime_changes: tuple[int, ...]
    anomalies: tuple[MarketAnomaly, ...]
    current_risk_level: float
    max_drawdown: float
    regime_map: dict[int, MarketRegime]


class SignalType(enum.Enum):
    BUY = "buy"
    SELL = "sell"
    HOLD = "hold"


class TradingSignal(NamedTuple):
    time_index: int
    type: SignalType
    confidence: float
    rationale: str


class TradingSignalResult(NamedTuple):
    signals: tuple[TradingSignal, ...]
    sharpe_ratio: float
    win_rate: float


class WaveletIndicators(NamedTuple):
    trend_strength: np.ndarray
    momentum: np.ndarray
    volatility_index: np.ndarray
    support_resistance: np.ndarray


def _returns(prices: np.ndarray) -> np.ndarray:
    prices = np.asarray(prices, dtype=np.float64)
    return np.diff(np.log(np.maximum(prices, 1e-12)))


def detect_market_crashes(
    prices,
    sampling_rate: float = 1.0,
    *,
    config: FinancialConfig = FinancialConfig(),
    paul_order: int = 4,
    device="cuda",
) -> CrashDetectionResult:
    """Crash detection via the Paul wavelet's time-asymmetry
    (``detectMarketCrashes``; the asymmetric analytic kernel responds
    strongly to sharp drawdowns)."""
    dev = _input_device(prices, device)
    rets = _returns(_host(prices))
    n = len(rets)
    scales = scales_log(2.0, max(8.0, n / 16.0), 16)
    coeffs = host_complex(cwt(_to_device(rets, dev), scales, f"paul{paul_order}").coeffs)
    # crash severity: magnitude of fine-scale response where returns are negative
    fine = np.abs(coeffs[: len(scales) // 2]).mean(axis=0)
    severity = fine * (rets < 0)
    scale_ref = np.median(fine) + 1e-30
    severity = severity / scale_ref
    threshold = 1.0 / max(config.crash_asymmetry_threshold, 1e-6)
    points = [int(i) for i in np.nonzero(severity > threshold)[0]]
    probs = {i: float(1.0 - math.exp(-severity[i] / threshold)) for i in points}
    return CrashDetectionResult(
        crash_points=tuple(points),
        severity=severity,
        max_severity=float(severity.max(initial=0.0)),
        crash_probabilities=probs,
    )


def analyze_volatility(
    prices,
    sampling_rate: float = 1.0,
    *,
    config: FinancialConfig = FinancialConfig(),
    device="cuda",
) -> VolatilityAnalysisResult:
    """Instantaneous volatility from fine-scale CWT power + cluster
    segmentation (``analyzeVolatility``, VolatilityLevel/VolatilityCluster)."""
    dev = _input_device(prices, device)
    rets = _returns(_host(prices))
    n = len(rets)
    scales = scales_log(2.0, max(8.0, n / 16.0), 12)
    power = host_complex(cwt(_to_device(rets, dev), scales, "mexh").power())
    inst = np.sqrt(power.mean(axis=0))
    avg = float(inst.mean())
    std = float(inst.std()) + 1e-30

    def classify(v: float) -> VolatilityLevel:
        z = (v - avg) / std
        if z < -0.5:
            return VolatilityLevel.LOW
        if z < 0.75:
            return VolatilityLevel.MEDIUM
        if z < 2.0:
            return VolatilityLevel.HIGH
        return VolatilityLevel.EXTREME

    clusters: list[VolatilityCluster] = []
    start = 0
    current = classify(inst[0])
    for i in range(1, n + 1):
        level = classify(inst[i]) if i < n else None
        if level != current:
            clusters.append(
                VolatilityCluster(start, i - 1, current, float(inst[start:i].mean()))
            )
            start, current = i, level
    return VolatilityAnalysisResult(
        volatility_clusters=tuple(clusters),
        instantaneous_volatility=inst,
        average_volatility=avg,
        max_volatility=float(inst.max()),
    )


def analyze_cyclical_patterns(
    prices,
    sampling_rate: float = 1.0,
    *,
    max_cycles: int = 5,
    device="cuda",
) -> CyclicalAnalysisResult:
    """Dominant market cycles from the CWT global spectrum
    (``analyzeCyclicalPatterns`` :315)."""
    dev = _input_device(prices, device)
    rets = _returns(_host(prices))
    n = len(rets)
    scales = scales_log(4.0, max(16.0, n / 2.0), 48)
    res = cwt(_to_device(rets, dev), scales, "morl", analytic=True)
    power = host_complex(res.power()).mean(axis=-1)  # global spectrum per scale
    phase = host_complex(res.phase())
    freqs = np.asarray(scale_to_frequency(np.asarray(scales), "morl", dt=1.0 / sampling_rate))
    periodogram = {float(1.0 / f): float(p) for f, p in zip(freqs, power)}
    # local maxima of the global spectrum
    peaks = [
        i
        for i in range(1, len(power) - 1)
        if power[i] > power[i - 1] and power[i] > power[i + 1]
    ]
    peaks.sort(key=lambda i: -power[i])
    total = float(power.sum()) + 1e-30
    cycles = tuple(
        MarketCycle(
            period=float(1.0 / freqs[i]),
            frequency=float(freqs[i]),
            strength=float(power[i] / total),
            phase=float(phase[i, -1]),
        )
        for i in peaks[:max_cycles]
    )
    return CyclicalAnalysisResult(cycles, power, periodogram)


def _max_drawdown(prices: np.ndarray) -> float:
    peaks = np.maximum.accumulate(prices)
    drawdowns = (peaks - prices) / np.maximum(peaks, 1e-30)
    return float(drawdowns.max(initial=0.0))


def analyze_market(
    prices,
    sampling_rate: float = 1.0,
    *,
    config: FinancialConfig = FinancialConfig(),
    window: int = 32,
    device="cuda",
) -> MarketAnalysisResult:
    """Combined regime / anomaly / risk view (``analyzeMarket`` :377-470)."""
    dev = _input_device(prices, device)
    prices = _host(prices)
    rets = _returns(prices)
    n = len(rets)
    vol = analyze_volatility(prices, sampling_rate, config=config, device=dev)
    inst = vol.instantaneous_volatility
    # regime per window: trend via smooth slope, volatility via inst
    smooth = host_complex(denoise_multilevel(
        _to_device(prices, dev), "db4", levels=max(1, min(3, max_levels(len(prices), "db4")))))
    regime_map: dict[int, MarketRegime] = {}
    regime_changes: list[int] = []
    previous = None
    vol_hi = inst.mean() + inst.std()
    for start in range(0, n, window):
        end = min(start + window, n)
        seg_slope = (smooth[end] - smooth[start]) / max(end - start, 1)
        seg_vol = inst[start:end].mean()
        scale = np.abs(np.diff(smooth)).mean() + 1e-30
        if seg_vol > vol_hi:
            regime = MarketRegime.VOLATILE
        elif seg_slope > config.regime_trend_threshold * scale:
            regime = MarketRegime.TRENDING_UP
        elif seg_slope < -config.regime_trend_threshold * scale:
            regime = MarketRegime.TRENDING_DOWN
        else:
            regime = MarketRegime.RANGING
        regime_map[start] = regime
        if previous is not None and regime != previous:
            regime_changes.append(start)
        previous = regime
    # anomalies: returns beyond anomaly_threshold sigmas
    sigma = rets.std() + 1e-30
    anomalies = tuple(
        MarketAnomaly(
            int(i),
            AnomalyType.PRICE_SPIKE,
            float(abs(rets[i]) / sigma),
            f"return {rets[i]:+.4f} exceeds {config.anomaly_threshold} sigma",
        )
        for i in np.nonzero(np.abs(rets) > config.anomaly_threshold * sigma)[0]
    )
    risk = float(inst[-max(1, window // 2) :].mean() / (inst.mean() + 1e-30))
    return MarketAnalysisResult(
        regime_changes=tuple(regime_changes),
        anomalies=anomalies,
        current_risk_level=risk,
        max_drawdown=_max_drawdown(prices),
        regime_map=regime_map,
    )


def generate_trading_signals(
    prices,
    sampling_rate: float = 1.0,
    *,
    config: FinancialConfig = FinancialConfig(),
    device="cuda",
) -> TradingSignalResult:
    """Heuristic BUY/SELL/HOLD stream from crash + volatility + momentum
    context (``generateTradingSignals`` :474-536)."""
    dev = _input_device(prices, device)
    prices = _host(prices)
    rets = _returns(prices)
    crashes = detect_market_crashes(prices, sampling_rate, config=config, device=dev)
    vol = analyze_volatility(prices, sampling_rate, config=config, device=dev)
    indicators = calculate_wavelet_indicators(prices, sampling_rate, device=dev)
    momentum = indicators.momentum
    signals: list[TradingSignal] = []
    crash_set = set(crashes.crash_points)
    vol_hi = vol.average_volatility + 1.5 * (vol.instantaneous_volatility.std() + 1e-30)
    for i in range(len(rets)):
        if i in crash_set:
            signals.append(
                TradingSignal(i, SignalType.SELL, min(1.0, crashes.severity[i] / 3.0),
                              "crash signature detected")
            )
        elif vol.instantaneous_volatility[i] > vol_hi:
            signals.append(
                TradingSignal(i, SignalType.HOLD, 0.5, "extreme volatility"))
        elif i > 0 and momentum[i] > 0 and momentum[i - 1] <= 0:
            signals.append(
                TradingSignal(i, SignalType.BUY, min(1.0, abs(momentum[i]) * 10),
                              "momentum turned positive")
            )
        elif i > 0 and momentum[i] < 0 and momentum[i - 1] >= 0:
            signals.append(
                TradingSignal(i, SignalType.SELL, min(1.0, abs(momentum[i]) * 10),
                              "momentum turned negative")
            )
    # evaluate: position follows last buy/sell
    position = 0.0
    pnl = []
    sig_by_t = {s.time_index: s for s in signals}
    for i in range(len(rets)):
        if i in sig_by_t:
            s = sig_by_t[i]
            position = 1.0 if s.type is SignalType.BUY else (0.0 if s.type is SignalType.HOLD else -1.0)
        pnl.append(position * rets[i])
    pnl_arr = np.asarray(pnl)
    sr = float(sharpe_ratio(_to_device(pnl_arr, dev))) if pnl_arr.std() > 0 else 0.0
    wins = (pnl_arr > 0).sum()
    trades = (pnl_arr != 0).sum()
    return TradingSignalResult(
        signals=tuple(signals),
        sharpe_ratio=sr,
        win_rate=float(wins / trades) if trades else 0.0,
    )


def calculate_wavelet_indicators(
    prices,
    sampling_rate: float = 1.0,
    *,
    device="cuda",
) -> WaveletIndicators:
    """Indicator series from the MODWT band split
    (``calculateWaveletIndicators`` :538-595)."""
    dev = _input_device(prices, device)
    prices_np = _host(prices)
    n = len(prices_np)
    levels = max(2, min(5, max_levels(n, "sym8")))
    res = modwt_multilevel(_to_device(prices_np, dev), "sym8", levels=levels)
    details = [host_complex(d) for d in res.details]
    approx = host_complex(res.approx)
    total_power = sum(d**2 for d in details) + approx**2 + 1e-30
    trend_strength = approx**2 / total_power
    momentum = np.gradient(approx)
    volatility_index = np.sqrt(sum(d**2 for d in details[: max(1, levels // 2)]))
    # support/resistance: distance of price to the smoothed envelope
    support_resistance = prices_np - approx
    return WaveletIndicators(
        trend_strength=trend_strength,
        momentum=momentum,
        volatility_index=volatility_index,
        support_resistance=support_resistance,
    )
