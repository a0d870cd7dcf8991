"""Matching pursuit on the PyTorch port: a sparse, interpretable story of a
composite signal.

Counterpart of ``examples/matching_pursuit_demo.py``: a signal with a
slow oscillation, a sharp transient and a high-frequency burst is
summarized in a handful of (scale, shift, amplitude) atoms; the greedy
decomposition localizes each event where a global spectrum cannot.

    python examples/torch/matching_pursuit_demo.py          # on the card
    python examples/torch/matching_pursuit_demo.py --cpu    # on the CPU
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

    rng = np.random.default_rng(13)
    n = 1024
    t = np.arange(n)

    slow = 1.2 * np.sin(2 * np.pi * t / 256)
    transient = 2.5 * np.exp(-0.5 * ((t - 300) / 4.0) ** 2)
    burst = np.where(
        (t > 650) & (t < 750), np.sin(2 * np.pi * t / 16), 0.0
    ) * np.hanning(100).sum() / 50
    x = torch.as_tensor(slow + transient + burst + 0.05 * rng.standard_normal(n),
                        dtype=torch.float32, device=dev)

    scales = (2.0, 4.0, 8.0, 16.0, 32.0, 64.0)
    res = vw.matching_pursuit(x, scales, "mexh", steps=24)

    total = float((x**2).sum())
    print("step | scale | shift | coeff  | residual energy")
    kept = 0
    for k in range(24):
        e = float(res.energies[k]) / total
        if k < 8:
            print(
                f" {k:3d} | {float(res.atom_scales()[k]):5.1f} |"
                f" {int(res.shifts[k]):5d} | {float(res.coeffs[k]):+6.2f} |"
                f" {e:6.1%}"
            )
        kept = k
        if e < 0.02:
            break
    print(f"... {kept + 1} atoms capture"
          f" {1 - float(res.energies[kept]) / total:.1%} of the energy")

    # Events localize: the transient at t=300 should be among the first picks
    early_shifts = [int(s) for s in res.shifts[:6]]
    print("first-6 atom shifts:", early_shifts)
    assert any(abs(s - 300) < 12 for s in early_shifts), "transient not found"

    # approx + residual == x always
    err = float((res.approx + res.residual - x).abs().max())
    print(f"split invariant max|err|: {err:.2e}")


if __name__ == "__main__":
    main()
