"""Multi-asset portfolio risk analysis with batched wavelet transforms on
the PyTorch port.

Counterpart of ``examples/portfolio_risk.py`` (the reference's
PortfolioRiskAnalyzer): per-asset wavelet volatility decomposition,
scale-wise cross-asset correlation, and drawdown/crash screening, batched
over the asset axis in one call instead of a thread pool.

    python examples/torch/portfolio_risk.py          # on the card
    python examples/torch/portfolio_risk.py --cpu    # on the CPU
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np
import torch

from vectorwave_tpu_torch import finance
from vectorwave_tpu_torch.transforms.multilevel import modwt_multilevel

ASSETS = ["EQUITY", "BONDS", "GOLD", "CRYPTO"]
N = 2048
LEVELS = 5


def simulate_portfolio(rng: np.random.Generator) -> np.ndarray:
    """Correlated returns: a common market factor plus idiosyncratic noise."""
    market = rng.normal(0.0003, 0.008, N)
    betas = np.array([1.0, -0.25, 0.1, 1.8])
    vols = np.array([0.006, 0.003, 0.008, 0.03])
    idio = rng.normal(0.0, 1.0, (len(ASSETS), N)) * vols[:, None]
    rets = betas[:, None] * market[None, :] + idio
    rets[0, 1500:1504] -= 0.04  # equity drawdown event
    rets[3, 1500:1510] -= 0.06  # crypto follows, amplified
    return rets


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    dev = torch.device("cpu" if parser.parse_args(argv).cpu else "cuda")
    torch.empty(0, device=dev)  # without a card and without --cpu this raises

    rng = np.random.default_rng(11)
    rets = simulate_portfolio(rng)
    prices = 100.0 * np.exp(np.cumsum(rets, axis=1))

    # One batched 5-level MODWT over all assets: leading axes are batch axes.
    res = modwt_multilevel(torch.as_tensor(rets, dtype=torch.float32, device=dev), "db4",
                           levels=LEVELS)
    details = torch.stack(res.details)          # [levels, assets, N]

    # Scale-wise volatility profile per asset (std of each detail band).
    band_vol = details.std(dim=-1, unbiased=False).T.cpu().numpy()  # [assets, levels]
    print("per-scale volatility (rows=assets, cols=levels 1..%d):" % LEVELS)
    for name, row in zip(ASSETS, band_vol):
        print(f"  {name:<7}" + "".join(f" {v:.5f}" for v in row))

    # Scale-wise correlation with the equity factor: short scales decouple,
    # long scales show the common market factor.
    host = details.cpu().numpy()
    eq = host[:, 0, :]
    print("correlation vs EQUITY by scale:")
    for j in range(LEVELS):
        cors = []
        for a in range(1, len(ASSETS)):
            c = np.corrcoef(eq[j], host[j, a])[0, 1]
            cors.append(f"{ASSETS[a]}={c:+.2f}")
        print(f"  level {j + 1}: " + "  ".join(cors))

    # Portfolio-level screening with the finance toolkit.
    weights = np.array([0.4, 0.3, 0.2, 0.1])
    port_prices = prices.T @ weights
    market = finance.analyze_market(port_prices, device=dev)
    print(f"portfolio max drawdown: {market.max_drawdown:.1%}, "
          f"risk level {market.current_risk_level:.2f}")

    crashes = finance.detect_market_crashes(port_prices, device=dev)
    print(f"crash points: {crashes.crash_points[:5]} "
          f"(max severity {crashes.max_severity:.1f})")

    # Risk decomposition: share of portfolio variance carried per scale.
    port_details = torch.einsum(
        "jan,a->jn", details, torch.as_tensor(weights, dtype=torch.float32, device=dev))
    var_by_scale = port_details.var(dim=-1, unbiased=False).cpu().numpy()
    share = var_by_scale / var_by_scale.sum()
    print("variance share by scale: " +
          "  ".join(f"L{j + 1}={s:.1%}" for j, s in enumerate(share)))


if __name__ == "__main__":
    main()
