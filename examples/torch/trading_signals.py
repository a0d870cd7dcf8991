"""Algorithmic trading signals from wavelet decompositions on the PyTorch
port.

Counterpart of ``examples/trading_signals.py`` (the reference's
AlgorithmicTradingSignals): multi-scale trend/momentum signal generation,
wavelet technical indicators, and a toy walk-forward evaluation.

    python examples/torch/trading_signals.py          # on the card
    python examples/torch/trading_signals.py --cpu    # on the CPU
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np
import torch

from vectorwave_tpu_torch.finance.analyzer import (
    FinancialConfig,
    calculate_wavelet_indicators,
    generate_trading_signals,
)

N = 2048


def simulate_prices(rng: np.random.Generator) -> np.ndarray:
    drift = np.concatenate([
        np.full(N // 2, 0.0004),   # bull leg
        np.full(N // 4, -0.0008),  # correction
        np.full(N - N // 2 - N // 4, 0.0002),
    ])
    returns = drift + rng.normal(0, 0.01, N)
    return 100.0 * np.exp(np.cumsum(returns))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    dev = torch.device("cpu" if parser.parse_args(argv).cpu else "cuda")
    torch.empty(0, device=dev)  # without a card and without --cpu this raises

    rng = np.random.default_rng(11)
    prices = simulate_prices(rng)

    cfg = FinancialConfig()
    result = generate_trading_signals(prices, config=cfg, device=dev)
    by_type: dict[str, int] = {}
    for s in result.signals:
        by_type[s.type.name] = by_type.get(s.type.name, 0) + 1
    print(f"signals generated: {len(result.signals)}  {by_type}")
    for s in result.signals[:5]:
        print(f"  t={s.time_index:5d}  {s.type.name:<5}  "
              f"confidence={s.confidence:.2f}  {s.rationale}")

    # Built-in walk-forward evaluation: position follows the signal stream.
    print(f"strategy Sharpe: {result.sharpe_ratio:+.3f}   "
          f"win rate: {result.win_rate:.1%}")

    # Indicator SERIES from the MODWT band split (one value per tick).
    ind = calculate_wavelet_indicators(prices, device=dev)
    print(f"trend strength (last):    {ind.trend_strength[-1]:+.3f}")
    print(f"momentum (last):          {ind.momentum[-1]:+.4f}")
    print(f"volatility index (mean):  {ind.volatility_index.mean():.4f}")
    print(f"support/resistance gap:   {ind.support_resistance[-1]:+.3f}")


if __name__ == "__main__":
    main()
