"""Synchrosqueezing on the PyTorch port: sharpen a scalogram and pull
individual modes out.

Counterpart of ``examples/synchrosqueezing_demo.py`` (Daubechies-Lu-Wu
SST).  A two-component signal whose modes sit 0.6 octave apart smears
across neighbouring CWT scales; reassigning each coefficient to its
instantaneous frequency collapses the energy onto two near-lines that can
be inverted separately.

    python examples/torch/synchrosqueezing_demo.py          # on the card
    python examples/torch/synchrosqueezing_demo.py --cpu    # on the CPU
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np
import torch

import vectorwave_tpu_torch as vw
from vectorwave_tpu_torch.transforms.cwt import cwt, scales_log


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    dev = torch.device("cpu" if parser.parse_args(argv).cpu else "cuda")
    torch.empty(0, device=dev)  # without a card and without --cpu this raises

    n = 2048
    t = np.arange(n)
    f1, f2 = 0.04, 0.06
    x = torch.as_tensor(np.sin(2 * np.pi * f1 * t) + 0.8 * np.sin(2 * np.pi * f2 * t),
                        dtype=torch.float32, device=dev)
    scales = scales_log(2, 64, 48)

    res = vw.synchrosqueeze(x, scales, "morl")
    p_sst = res.power().cpu().numpy().mean(axis=-1)
    p_cwt = (cwt(x, scales, "morl", analytic=True).coeffs.abs() ** 2).cpu().numpy().mean(axis=-1)

    def top4(p):
        return float(np.sort(p)[::-1][:4].sum() / p.sum())

    print(f"energy in top-4 rows: CWT {top4(p_cwt):.2f} -> SST {top4(p_sst):.2f}")
    freqs = np.asarray(res.freqs)
    peaks = sorted(freqs[np.argsort(p_sst)[::-1][:2]])
    print(f"SST peaks at {peaks[0]:.4f}, {peaks[1]:.4f} cycles/sample "
          f"(true: {f1}, {f2})")

    # invert everything, then each mode separately
    xr = vw.isst(res, "morl")
    interior = slice(256, -256)
    print(f"full inversion max err (interior): "
          f"{float((xr - x)[interior].abs().max()):.3f}")

    def full(f):
        return torch.full((n,), f, dtype=torch.float32, device=dev)

    m1 = vw.extract_mode(res, full(f1), "morl", bandwidth_octaves=0.4).cpu().numpy()
    m2 = vw.extract_mode(res, full(f2), "morl", bandwidth_octaves=0.4).cpu().numpy()
    tone1, tone2 = np.sin(2 * np.pi * f1 * t), 0.8 * np.sin(2 * np.pi * f2 * t)
    c1 = np.corrcoef(m1[interior], tone1[interior])[0, 1]
    c2 = np.corrcoef(m2[interior], tone2[interior])[0, 1]
    print(f"mode correlations with their own tones: {c1:.3f}, {c2:.3f}")

    # a chirp's dominant squeezed bin tracks its instantaneous frequency
    chirp = torch.as_tensor(np.sin(2 * np.pi * (0.01 * t + 2e-5 * t**2)),
                            dtype=torch.float32, device=dev)
    rc = vw.synchrosqueeze(chirp, scales, "morl")
    dom = vw.dominant_frequencies(rc).cpu().numpy()[interior]
    true_if = (0.01 + 4e-5 * t)[interior]
    print(f"chirp IF tracking: median rel err "
          f"{float(np.median(np.abs(dom - true_if) / true_if)):.3f}")


if __name__ == "__main__":
    main()
