"""Real-time market monitoring on the PyTorch port: sliding-window transform
and per-tick metrics.

Counterpart of ``examples/realtime_market_monitor.py`` (the reference's
RealTimeMarketMonitor and StreamingFinancialDemo): ticks arrive one at a
time, a sliding-window MODWT keeps an overlap of L-1 samples so every
window equals the whole-signal transform, and an O(1)-per-tick incremental
wavelet state tracks crash energy and denoised Sharpe without
re-transforming history.  The JAX example scans the ticks with
``lax.scan``; the port's ``analyze_ticks_incremental`` loops over them.

    python examples/torch/realtime_market_monitor.py          # on the card
    python examples/torch/realtime_market_monitor.py --cpu    # on the CPU
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np
import torch

from vectorwave_tpu_torch.finance.incremental import (
    analyze_ticks_incremental,
    incremental_wavelet_init,
    incremental_wavelet_update,
)
from vectorwave_tpu_torch.streaming.sliding import SlidingStreamingTransform


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    dev = torch.device("cpu" if parser.parse_args(argv).cpu else "cuda")
    torch.empty(0, device=dev)  # without a card and without --cpu this raises

    rng = np.random.default_rng(3)
    n = 4096
    rets = rng.normal(0.0002, 0.006, n)
    rets[3000:3003] = (-0.08, -0.04, -0.02)  # flash crash mid-stream
    prices = 100.0 * np.exp(np.cumsum(rets))

    # --- sliding-window transform: per-tick feed, overlap = L-1 ---------
    mon = SlidingStreamingTransform("db4", buffer_size=256, levels=3, device=dev)
    alerts = []
    for t, p in enumerate(prices):
        out = mon.process_sample(np.float32(np.log(p)))
        if out is None:
            continue
        spike = float(out.details[0][-mon.step :].abs().max())
        if spike > 0.02:
            alerts.append((t, spike))
    stats = mon.statistics
    print(f"sliding monitor: {stats['samples_processed']} ticks, "
          f"{stats['windows_emitted']} windows, step={mon.step}")
    # Each emitted window's fresh span is the last `step` ticks; the crash at
    # tick 3000 surfaces in the first window whose span covers it.
    hits = [t for t, _ in alerts if t - mon.step <= 3000 <= t]
    print(f"alert windows covering the crash: {hits} "
          f"(spike {max(s for _, s in alerts):.3f} vs quiet ~0.007)")

    # --- O(1)-per-tick incremental wavelet metrics (a loop over ticks) ----
    metrics = analyze_ticks_incremental(prices, device=dev)
    score = metrics.crash_score.cpu().numpy()
    peak = int(np.argmax(score))
    flagged = np.flatnonzero(metrics.crash_detected.cpu().numpy())
    print(f"incremental crash-score peak at tick {peak} "
          f"(event injected at 3000), value {score[peak]:.2f}; "
          f"{flagged.size} ticks flagged")
    print(f"final state: regime code {int(metrics.regime_code[-1])}, "
          f"risk level {float(metrics.risk_level[-1]):.2f}, "
          f"rolling Sharpe {float(metrics.base.sharpe[-1]):.3f}")

    # --- the same state machine, driven tick-by-tick (live-loop shape) --
    st = incremental_wavelet_init(device=dev)
    for p in prices[:16]:
        st, m = incremental_wavelet_update(st, np.float32(p))
    print(f"after 16 live ticks: haar detail {float(m.haar_detail):+.5f}, "
          f"wavelet vol {float(m.wavelet_vol):.5f}")


if __name__ == "__main__":
    main()
