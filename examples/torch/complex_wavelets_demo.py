"""Complex continuous wavelets on the PyTorch port: phase, instantaneous
frequency, ridges.

Counterpart of ``examples/complex_wavelets_demo.py`` (the reference's
ComplexGaussianFixDemo and the analyzeComplex CWT path): complex Gaussian
(cgau) and Morlet transforms carry phase, so a chirp's instantaneous
frequency can be read off the transform ridge.

    python examples/torch/complex_wavelets_demo.py          # on the card
    python examples/torch/complex_wavelets_demo.py --cpu    # on the CPU
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np
import torch

from vectorwave_tpu_torch.transforms.cwt import cwt, scale_to_frequency, scales_log
from vectorwave_tpu_torch.wavelets.registry import wavelet

N = 2048


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    dev = torch.device("cpu" if parser.parse_args(argv).cpu else "cuda")
    torch.empty(0, device=dev)  # without a card and without --cpu this raises

    # Linear chirp: frequency sweeps 0.01 -> 0.08 cycles/sample.
    t = np.arange(N)
    f0, f1 = 0.01, 0.08
    phase = 2 * np.pi * (f0 * t + (f1 - f0) * t**2 / (2 * N))
    x = torch.as_tensor(np.sin(phase), dtype=torch.float32, device=dev)
    true_freq = f0 + (f1 - f0) * t / N

    # cgau filters are intrinsically complex: the result carries phase.
    w = wavelet("cgau4")
    print(f"{w.name}: complex-valued={w.is_complex}, center freq "
          f"{w.center_frequency:.3f}")

    scales = scales_log(4.0, 64.0, 48)
    res = cwt(x, scales, "cgau4", boundary="zero")
    assert res.coeffs.is_complex()

    # Ridge = argmax |W(scale, t)| per time; map scale -> frequency.
    mag = res.magnitude().cpu().numpy()
    ridge = mag.argmax(axis=0)
    freqs = np.array([scale_to_frequency(s, "cgau4") for s in scales])
    est = freqs[ridge]
    sl = slice(N // 8, -N // 8)  # ignore cone-of-influence edges
    err = np.median(np.abs(est[sl] - true_freq[sl]) / true_freq[sl])
    print(f"chirp ridge tracking, median relative error: {err:.1%}")

    # Real wavelets gain phase through the analytic (Hilbert) path.
    res_m = cwt(x, scales, "morl", analytic=True)
    dphi = np.unwrap(res_m.phase().cpu().numpy(), axis=1)
    inst = np.take_along_axis(
        np.diff(dphi, axis=1) / (2 * np.pi), ridge[None, :-1], axis=0
    )[0]
    sl2 = slice(N // 8, N - N // 8 - 1)
    err_m = np.median(np.abs(inst[sl2] - true_freq[sl2]) / true_freq[sl2])
    print(f"analytic-Morlet instantaneous frequency, median error: {err_m:.1%}")


if __name__ == "__main__":
    main()
