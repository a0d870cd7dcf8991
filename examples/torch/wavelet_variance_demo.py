"""Wavelet variance ANOVA on the PyTorch port: which time scales carry a
series' variance?

Counterpart of ``examples/wavelet_variance_demo.py``: the
Percival-Walden scale-by-scale variance decomposition with chi-squared
confidence intervals, the cross-series covariance/correlation split, the
streaming estimator, long memory and a variance break test.

    python examples/torch/wavelet_variance_demo.py          # on the card
    python examples/torch/wavelet_variance_demo.py --cpu    # on the CPU
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np
import torch

import vectorwave_tpu_torch as vw
from vectorwave_tpu_torch.streaming import modwt_stream_block, streaming_init


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    dev = torch.device("cpu" if parser.parse_args(argv).cpu else "cuda")
    torch.empty(0, device=dev)  # without a card and without --cpu this raises

    def tensor(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    rng = np.random.default_rng(11)
    n = 2**14
    t = np.arange(n)

    # fast noise + a slow cycle: variance should split across scales
    slow = 1.5 * np.sin(2 * np.pi * t / 512)
    x = tensor(slow + 0.8 * rng.standard_normal(n))

    r = vw.wavelet_variance(x, "db4", 8, confidence=0.95)
    print("level  scale  variance   95% CI            edof")
    for j in range(r.n_levels):
        print(f"  {j + 1}    {int(r.scales[j]):4d}  "
              f"{float(r.variance[j]):.4f}   "
              f"[{float(r.ci_low[j]):.4f}, {float(r.ci_high[j]):.4f}]  "
              f"{int(r.edof[j])}")
    peak = int(r.variance.argmax()) + 1
    print(f"dominant scale: level {peak} (tau ~ {int(r.scales[peak - 1])} samples; "
          f"the 512-sample cycle lives at levels 8-9)")

    # white noise halves its variance per level: nu_j^2 = sigma^2 / 2^j
    wn = tensor(rng.standard_normal(n))
    rw = vw.wavelet_variance(wn, "db4", 6)
    ratios = rw.variance.cpu().numpy() * 2.0 ** np.arange(1, 7)
    print(f"\nwhite-noise check (nu_j^2 * 2^j / sigma^2 ~ 1): "
          f"{np.round(ratios, 2)}")

    # cross-series: two assets sharing the slow factor, independent noise
    y = tensor(slow + 0.8 * rng.standard_normal(n))
    rho, scales = vw.wavelet_correlation(x, y, "db4", 8)
    print("\nper-scale correlation (shared slow factor):")
    for j, (s, p) in enumerate(zip(scales, rho.cpu().numpy()), start=1):
        bar = "#" * int(max(p, 0) * 30)
        print(f"  level {j} (tau {int(s):4d}): {p:+.2f} {bar}")
    print("short scales ~ 0 (independent noise), long scales -> 1 (shared cycle)")

    # streaming: fold arriving blocks into an O(J) accumulator; the result
    # EQUALS the whole-signal estimator (boundary-free coefficients only)
    st = streaming_init("db4", 6, device=dev)
    acc = vw.variance_stream_init("db4", 6, device=dev)
    for i in range(0, n, 1024):
        st, res = modwt_stream_block(st, wn[i : i + 1024], "db4", boundary="zero")
        acc = vw.variance_stream_update(acc, res.details, "db4")
    streamed = vw.variance_stream_result(acc)
    drift = float((streamed.variance - rw.variance).abs().max())
    print(f"\nstreamed-vs-batch wavelet variance max |diff|: {drift:.2e}")

    # long memory: Hurst exponent (white noise -> 0.5) + variance break test
    h = vw.hurst_exponent(wn, "db4", 8)
    print(f"Hurst of white noise: {float(h.hurst):.3f} "
          f"(+/- {float(h.stderr):.3f}, truth 0.5)")
    broke = wn.clone()
    broke[n // 2 :] *= 2.5
    tst = vw.variance_change_test(broke, "db4", level=1)
    print(f"variance break: stat {float(tst.statistic):.2f} vs crit "
          f"{tst.critical_value:.2f} -> reject={bool(tst.reject)}, "
          f"located at t~{int(tst.location)} (injected at {n // 2})")


if __name__ == "__main__":
    main()
