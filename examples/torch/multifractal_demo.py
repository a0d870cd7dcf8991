"""Multifractal analysis on the PyTorch port: telling monofractal from
multifractal data.

Counterpart of ``examples/multifractal_demo.py``: the singularity
spectrum of processes with known answers, fractional Brownian motion
(monofractal, one regularity exponent), a log-normal Mandelbrot cascade
(multifractal, a spread of exponents), and a synthetic volatility-clustered
return series (multifractal-like, the classic stylized fact of financial
returns).

    python examples/torch/multifractal_demo.py          # on the card
    python examples/torch/multifractal_demo.py --cpu    # on the CPU
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np
import torch

import vectorwave_tpu_torch as vw


def fbm(n, hurst, seed):
    rng = np.random.default_rng(seed)
    k = np.arange(n)
    gamma = 0.5 * (
        np.abs(k - 1) ** (2 * hurst)
        - 2 * np.abs(k) ** (2 * hurst)
        + np.abs(k + 1) ** (2 * hurst)
    )
    row = np.concatenate([gamma, gamma[1:-1][::-1]])
    lam = np.maximum(np.fft.fft(row).real, 0)
    z = rng.standard_normal(len(row)) + 1j * rng.standard_normal(len(row))
    fgn = np.real(np.fft.fft(np.sqrt(lam / (2 * len(row))) * z))[:n]
    return np.cumsum(fgn)


def cascade(n_levels, seed, sigma=0.3):
    rng = np.random.default_rng(seed)
    m = np.ones(1)
    for _ in range(n_levels):
        w = np.exp(rng.normal(-sigma**2 / 2, sigma, 2 * len(m)))
        m = np.repeat(m, 2) * w
    return np.cumsum(m)


def garch_like(n, seed):
    """Volatility clustering: sigma_t follows a slow log-normal cascade."""
    rng = np.random.default_rng(seed)
    vol = np.exp(0.8 * np.sin(np.linspace(0, 40, n)) * 0 + np.interp(
        np.arange(n), np.arange(0, n, 64), rng.normal(0, 0.8, (n + 63) // 64)
    ))
    return np.cumsum(vol * rng.standard_normal(n))


def report(name, x, dev):
    res = vw.multifractal_spectrum(
        torch.as_tensor(np.stack([x]).astype(np.float32), device=dev), "db3", min_level=3
    )
    c1 = float(res.c1[0])
    c2 = float(res.c2[0])
    width = float(res.spectrum_width()[0])
    verdict = "MULTIFRACTAL" if c2 < -0.03 or width > 0.4 else "monofractal"
    print(f"{name:28s} c1={c1:+.3f}  c2={c2:+.4f}  width={width:.3f}  -> {verdict}")
    return res


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    dev = torch.device("cpu" if parser.parse_args(argv).cpu else "cuda")
    torch.empty(0, device=dev)  # without a card and without --cpu this raises

    print(f"{'process':28s} {'c1':>9} {'c2':>10} {'width':>11}")
    report("fBm H=0.35", fbm(2**15, 0.35, 1), dev)
    report("fBm H=0.7", fbm(2**15, 0.7, 2), dev)
    res = report("log-normal cascade", cascade(15, 3), dev)
    report("volatility-clustered walk", garch_like(2**15, 4), dev)

    qs = np.asarray(res.qs)
    h = res.h[0].cpu().numpy()
    D = res.D[0].cpu().numpy()
    print("\ncascade singularity spectrum (h -> D):")
    for k in range(0, len(qs), 2):
        bar = "#" * max(0, int(28 * max(D[k], 0)))
        print(f"  q={qs[k]:+4.1f}  h={h[k]:.3f}  D={D[k]:+.2f} {bar}")


if __name__ == "__main__":
    main()
