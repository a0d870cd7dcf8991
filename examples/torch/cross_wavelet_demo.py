"""Cross-wavelet analysis on the PyTorch port: coherence, lead/lag phase,
ridges.

Counterpart of ``examples/cross_wavelet_demo.py``: the analyses the
reference's ComplexCWTResult says its coefficients enable (phase
synchronization, instantaneous frequency, ridge extraction, wavelet
coherence).

    python examples/torch/cross_wavelet_demo.py          # on the card
    python examples/torch/cross_wavelet_demo.py --cpu    # on the CPU
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

    def tensor(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    rng = np.random.default_rng(2)
    n = 2048
    t = np.arange(n)
    scales = scales_log(2, 64, 32)

    # y follows x with a quarter-cycle lag at a 20-sample period
    f0 = 0.05
    x = tensor(np.sin(2 * np.pi * f0 * t) + 0.4 * rng.standard_normal(n))
    y = tensor(np.sin(2 * np.pi * f0 * (t - 5)) + 0.4 * rng.standard_normal(n))

    wxy = vw.cross_wavelet(x, y, scales, "morl")
    si = int(wxy.magnitude().mean(dim=-1).argmax())
    lag_phase = float(np.median(np.angle(wxy.coeffs[si, 256:-256].cpu().numpy())))
    lag_samples = lag_phase / (2 * np.pi * f0)
    print(f"cross-wavelet dominant scale: {wxy.scales[si]:.1f} "
          f"(period ~ {1 / f0:.0f} samples)")
    print(f"relative phase there: {lag_phase:+.2f} rad -> "
          f"x leads y by ~{lag_samples:.1f} samples (true lag: 5)")

    coh = vw.wavelet_coherence(x, y, scales, "morl")
    indep = tensor(rng.standard_normal(n))
    coh_i = vw.wavelet_coherence(x, indep, scales, "morl")
    print(f"\ncoherence at the shared tone: "
          f"{float(coh.mean_coherence()[si]):.2f} (locked pair) vs "
          f"{float(coh_i.mean_coherence()[si]):.2f} (independent noise)")

    plv = vw.phase_synchronization(x, y, scales, "morl")
    print(f"phase-locking value: {float(plv[si]):.3f}")

    # instantaneous frequency + Viterbi ridge on a chirp
    chirp = tensor(np.sin(2 * np.pi * (0.01 * t + 2e-5 * t**2)))
    r = cwt(chirp, scales, "morl", analytic=True)
    ridge = vw.extract_ridge(r, smoothness=2.0)
    inst = vw.instantaneous_frequency(r).cpu().numpy()
    f_start = float(inst[int(ridge.indices[100]), 100])
    f_end = float(inst[int(ridge.indices[-100]), n - 100])
    print(f"\nchirp ridge: scale {float(ridge.scales[0]):.1f} -> "
          f"{float(ridge.scales[-1]):.1f}; instantaneous frequency "
          f"{f_start:.3f} -> {f_end:.3f} cycles/sample "
          f"(true: {0.01 + 2 * 2e-5 * 100:.3f} -> {0.01 + 2 * 2e-5 * (n - 100):.3f})")


if __name__ == "__main__":
    main()
