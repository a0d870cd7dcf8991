"""Empirical wavelet transform on the PyTorch port: adaptive mode
decomposition.

Counterpart of ``examples/ewt_demo.py``: a mixture whose component
frequencies are unknown a priori is separated by segmenting the spectrum
where this signal's peaks sit, then a tight-frame Meyer bank extracts one
mode per segment.  A nonstationary case (a frequency-hopping tone) shows
the analytic modes' instantaneous frequency tracking the hop.

    python examples/torch/ewt_demo.py          # on the card
    python examples/torch/ewt_demo.py --cpu    # on the CPU
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np
import torch

import vectorwave_tpu_torch as vw


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    dev = torch.device("cpu" if parser.parse_args(argv).cpu else "cuda")
    torch.empty(0, device=dev)  # without a card and without --cpu this raises

    rng = np.random.default_rng(0)
    n = 4096
    t = np.arange(n)

    # --- stationary mixture -------------------------------------------------
    x = (np.sin(2 * np.pi * 0.021 * t)
         + 0.8 * np.sin(2 * np.pi * 0.13 * t)
         + 0.5 * np.sin(2 * np.pi * 0.34 * t)
         + 0.05 * rng.standard_normal(n)).astype(np.float32)
    bounds = vw.ewt_boundaries(x, 3)
    print(f"detected boundaries: {[round(b, 3) for b in bounds]} cycles/sample")
    modes = vw.ewt(torch.as_tensor(x, device=dev), bounds)
    modes_np = modes.cpu().numpy()
    for b in range(3):
        f = np.fft.rfftfreq(n)[np.argmax(np.abs(np.fft.rfft(modes_np[b])))]
        print(f"  mode {b}: dominant frequency {f:.3f}, "
              f"energy share {np.sum(modes_np[b]**2) / np.sum(x**2):.2f}")
    xr = vw.iewt(modes, bounds).cpu().numpy()
    print(f"reconstruction error: {np.abs(xr - x).max():.2e}")

    # --- nonstationary: frequency hop tracked by the analytic mode ----------
    hop = np.where(t < n // 2, 0.08, 0.12)
    y = (np.sin(2 * np.pi * np.cumsum(hop))
         + 0.4 * np.sin(2 * np.pi * 0.3 * t)).astype(np.float32)
    b2 = vw.ewt_boundaries(y, 2)
    analytic = vw.ewt_hilbert(torch.as_tensor(y, device=dev), b2).cpu().numpy()
    phase = np.unwrap(np.angle(analytic[0]))
    inst_f = np.diff(phase) / (2 * np.pi)
    first = np.median(inst_f[200 : n // 2 - 200])
    second = np.median(inst_f[n // 2 + 200 : -200])
    print(f"\nfrequency hop: instantaneous f = {first:.3f} -> {second:.3f} "
          f"(true 0.080 -> 0.120)")


if __name__ == "__main__":
    main()
