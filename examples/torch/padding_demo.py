"""Padding strategies and adaptive selection on the PyTorch port.

Counterpart of ``examples/padding_demo.py`` (the reference's
AdaptivePaddingDemo; 12 strategies in wavelet/padding/).

    python examples/torch/padding_demo.py          # on the card
    python examples/torch/padding_demo.py --cpu    # on the CPU
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

    print(f"strategies: {', '.join(vw.PADDING_STRATEGIES)}")

    rng = np.random.default_rng(0)
    t = np.arange(300)

    # the adaptive chooser inspects smoothness/trend/periodicity
    cases = {
        "pure tone": np.sin(2 * np.pi * t / 25.0),
        "linear trend": 0.02 * t + 0.05 * rng.standard_normal(len(t)),
        "white noise": rng.standard_normal(len(t)),
    }
    for name, sig in cases.items():
        choice = vw.adaptive_strategy(sig)
        print(f"  adaptive choice for {name}: {choice}")

    # pad to a pow2 length with a few strategies and compare edge behavior
    x = np.sin(2 * np.pi * t / 40.0) + 0.1
    xt = torch.as_tensor(x, dtype=torch.float32, device=dev)
    for strategy in ("zero", "symmetric", "periodic", "linear_extrapolation"):
        padded = vw.pad_signal(xt, 512, strategy=strategy).cpu().numpy()
        print(
            f"  {strategy:22s}: len {len(padded)}, "
            f"edge continuity |x[299]-pad[300]| = "
            f"{abs(float(padded[300]) - x[-1]):.3f}"
        )


if __name__ == "__main__":
    main()
