"""Wavelet denoising, batch and streaming, on the PyTorch port.

Counterpart of ``examples/denoising_demo.py`` (the reference's denoising
demos).  At 4096 samples the sigma-only rules take the fused denoise
kernel on the card.

    python examples/torch/denoising_demo.py          # on the card
    python examples/torch/denoising_demo.py --cpu    # on the CPU
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np
import torch

import vectorwave_tpu_torch as vw
from vectorwave_tpu_torch.streaming import StreamingDenoiser


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    dev = torch.device("cpu" if parser.parse_args(argv).cpu else "cuda")
    torch.empty(0, device=dev)  # without a card and without --cpu this raises

    rng = np.random.default_rng(1)
    t = np.arange(4096)
    clean = np.sin(2 * np.pi * t / 128) + 0.5 * np.sin(2 * np.pi * t / 32)
    noisy = clean + rng.normal(0, 0.8, len(t))
    x = torch.as_tensor(noisy, dtype=torch.float32, device=dev)

    def snr(den):
        return 10 * np.log10(np.var(clean) / np.mean((den - clean) ** 2))

    print(f"input SNR: {snr(noisy):5.1f} dB")
    for method in ("universal", "sure", "minimax", "bayes"):
        den = vw.denoise_multilevel(x, "sym8", levels=5, method=method)
        print(f"  {method:9s}: {snr(den.cpu().numpy()):5.1f} dB")

    # streaming: 256-sample blocks with running MAD noise tracking
    denoiser = StreamingDenoiser("db4", implementation="quality", device=dev)
    blocks = [denoiser.denoise(noisy[i : i + 256].astype(np.float32))
              for i in range(0, len(t), 256)]
    streamed = torch.cat(blocks).cpu().numpy()
    print(f"  streaming: {snr(streamed):5.1f} dB  ({denoiser.statistics})")


if __name__ == "__main__":
    main()
