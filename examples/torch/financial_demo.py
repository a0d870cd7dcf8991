"""Financial wavelet analysis walkthrough on the PyTorch port.

Counterpart of ``examples/financial_demo.py`` (the reference's finance
demos).  The JAX example runs its per-tick metrics under ``lax.scan``;
here they are a Python loop over ``incremental_update``.

    python examples/torch/financial_demo.py          # on the card
    python examples/torch/financial_demo.py --cpu    # on the CPU
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np
import torch

from vectorwave_tpu_torch import finance


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    dev = torch.device("cpu" if parser.parse_args(argv).cpu else "cuda")
    torch.empty(0, device=dev)  # without a card and without --cpu this raises

    rng = np.random.default_rng(7)
    n = 1024
    rets = rng.normal(0.0004, 0.01, n)
    rets[700] = -0.11  # engineered crash
    rets[701] = -0.05
    prices = 100.0 * np.exp(np.cumsum(rets))

    returns = torch.as_tensor(rets, dtype=torch.float32, device=dev)
    sr = float(finance.sharpe_ratio(returns))
    wsr = float(finance.wavelet_sharpe_ratio(returns))
    print(f"Sharpe: {sr:.4f}   wavelet-denoised Sharpe: {wsr:.4f}")

    crashes = finance.detect_market_crashes(prices, device=dev)
    near = [p for p in crashes.crash_points if 690 <= p <= 710]
    print(f"crash flagged near t=700: {near} (max severity {crashes.max_severity:.1f})")

    vol = finance.analyze_volatility(prices, device=dev)
    print(f"volatility clusters: {len(vol.volatility_clusters)}, "
          f"avg {vol.average_volatility:.4f}, max {vol.max_volatility:.4f}")

    market = finance.analyze_market(prices, device=dev)
    print(f"max drawdown: {market.max_drawdown:.1%}, "
          f"risk level: {market.current_risk_level:.2f}, "
          f"anomalies: {len(market.anomalies)}")

    signals = finance.generate_trading_signals(prices, device=dev)
    kinds = {}
    for s in signals.signals:
        kinds[s.type.value] = kinds.get(s.type.value, 0) + 1
    print(f"signals: {kinds}, strategy Sharpe {signals.sharpe_ratio:.3f}, "
          f"win rate {signals.win_rate:.1%}")

    # O(1)-per-tick streaming metrics, a tick at a time
    state = finance.incremental_init(torch.float32, device=dev)
    for p in torch.as_tensor(prices, dtype=torch.float32, device=dev):
        state, metrics = finance.incremental_update(state, p)
    print(f"incremental: final drawdown {float(state.max_drawdown):.1%}, "
          f"vol ratio tail {float(metrics.vol_ratio):.2f}")


if __name__ == "__main__":
    main()
