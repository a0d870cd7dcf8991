"""ForWaRD deconvolution on the PyTorch port: recover signals and images
from blur and noise.

Counterpart of ``examples/deconvolution_demo.py``: the naive Fourier
inverse explodes (noise divided by tiny |H|), plain denoising cannot undo
the blur, and ForWaRD (a thresholded-periodogram Wiener step, then exact
colored-noise wavelet shrinkage) recovers both.  It runs in float32, as
the JAX example does (without x64, ``jnp.asarray`` of float64 data is
float32).

    python examples/torch/deconvolution_demo.py          # on the card
    python examples/torch/deconvolution_demo.py --cpu    # on the CPU
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np
import torch

import vectorwave_tpu_torch as vw


def rmse(a, b) -> float:
    return float(np.sqrt(np.mean((a - b) ** 2)))


def one_dimensional(rng: np.random.Generator, dev) -> None:
    n = 2048
    t = np.arange(n)
    clean = np.sin(2 * np.pi * t / 128) + 0.6 * np.sin(2 * np.pi * t / 23)

    taps = np.arange(33) - 16
    kernel = np.exp(-0.5 * (taps / 4.0) ** 2)
    kernel = np.fft.ifftshift(kernel / kernel.sum())  # peak at index 0
    blurred = np.fft.ifft(np.fft.fft(clean) * np.fft.fft(kernel, n=n)).real
    noisy = blurred + 0.05 * rng.standard_normal(n)

    naive = np.fft.ifft(np.fft.fft(noisy) / np.fft.fft(kernel, n=n)).real
    res = vw.deconvolve(torch.as_tensor(noisy, dtype=torch.float32, device=dev),
                        kernel, "sym8")

    print("1-D Gaussian blur (sigma_blur=4 samples) + noise 0.05")
    print(f"  blurred+noisy rmse : {rmse(noisy, clean):7.4f}")
    print(f"  naive inverse rmse : {rmse(naive, clean):7.4f}  <- noise blowup")
    print(f"  ForWaRD rmse       : {rmse(res.signal.cpu().numpy(), clean):7.4f}")
    print(f"  estimated sigma    : {float(res.sigma.mean()):7.4f} (true 0.05)")


def two_dimensional(rng: np.random.Generator, dev) -> None:
    h = w = 64
    yy, xx = np.mgrid[0:h, 0:w]
    clean = np.sin(2 * np.pi * yy / 16) + 0.7 * np.cos(2 * np.pi * xx / 10)
    clean[h // 2 :, :] += 1.2

    g = np.exp(-0.5 * ((np.arange(11) - 5) / 1.8) ** 2)
    psf = np.outer(g, g)
    psf /= psf.sum()
    pad = np.zeros((h, w))
    pad[:11, :11] = psf
    pad = np.roll(pad, (-5, -5), axis=(0, 1))  # peak at (0, 0)
    blurred = np.fft.ifft2(np.fft.fft2(clean) * np.fft.fft2(pad)).real
    noisy = blurred + 0.05 * rng.standard_normal((h, w))

    res = vw.deconvolve2(torch.as_tensor(noisy, dtype=torch.float32, device=dev),
                         pad, "sym4", levels=3)
    print("\n2-D Gaussian PSF deblurring (64x64)")
    print(f"  blurred+noisy rmse : {rmse(noisy, clean):7.4f}")
    print(f"  Wiener step rmse   : {rmse(res.wiener.cpu().numpy(), clean):7.4f}")
    print(f"  ForWaRD rmse       : {rmse(res.signal.cpu().numpy(), clean):7.4f}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    dev = torch.device("cpu" if parser.parse_args(argv).cpu else "cuda")
    torch.empty(0, device=dev)  # without a card and without --cpu this raises

    rng = np.random.default_rng(5)
    one_dimensional(rng, dev)
    two_dimensional(rng, dev)


if __name__ == "__main__":
    main()
