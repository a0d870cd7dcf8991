"""2-D wavelet processing on the PyTorch port: subband analysis and image
denoising.

Counterpart of ``examples/image_processing_2d.py``: decompose a synthetic
image into oriented subbands, round-trip it, denoise it, and take it apart
into additive per-scale images.  On the card the 2-D MODWT levels run the
hand-written 2-D analysis and synthesis kernels where the image fits them.

    python examples/torch/image_processing_2d.py          # on the card
    python examples/torch/image_processing_2d.py --cpu    # on the CPU
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np
import torch

import vectorwave_tpu_torch as vw

H = W = 128


def synthetic_image(rng: np.random.Generator) -> np.ndarray:
    yy, xx = np.mgrid[0:H, 0:W]
    img = np.sin(2 * np.pi * yy / 24) + np.cos(2 * np.pi * xx / 16)
    img[H // 2 :, :] += 1.5   # horizontal edge
    img[:, W // 2 :] += 0.75  # vertical edge
    return img


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    dev = torch.device("cpu" if parser.parse_args(argv).cpu else "cuda")
    torch.empty(0, device=dev)  # without a card and without --cpu this raises

    rng = np.random.default_rng(4)
    clean = synthetic_image(rng)
    noisy = clean + 0.4 * rng.standard_normal((H, W))
    x = torch.as_tensor(noisy, dtype=torch.float32, device=dev)

    # Subband energies: hl sees horizontal edges (high along rows), lh
    # vertical ones, hh diagonals.
    res = vw.modwt2(x, "haar")
    for name, band in zip(("ll", "lh", "hl", "hh"), res):
        print(f"{name} energy: {float((band**2).sum()):10.1f}")

    # Multi-level + exact reconstruction (periodic).
    ml = vw.modwt2_multilevel(x, "sym4", levels=3)
    back = vw.imodwt2_multilevel(ml, "sym4")
    print(f"3-level round trip max err: {float((back - x).abs().max()):.2e}")

    # Denoise: per-level, per-subband thresholds (finest hh estimates noise).
    den = vw.denoise2(x, "sym4", levels=3, method="universal").cpu().numpy()
    rmse_noisy = float(np.sqrt(np.mean((noisy - clean) ** 2)))
    rmse_den = float(np.sqrt(np.mean((den - clean) ** 2)))
    print(f"denoise2 RMSE: {rmse_noisy:.3f} -> {rmse_den:.3f}")

    # 2-D SWT facade + multi-resolution analysis: additive per-scale
    # images that sum back to the input (periodic).
    bands = vw.mra2(x, "db4", levels=3)
    total = sum(bands)
    print(f"mra2: {len(bands)} bands, additivity err "
          f"{float((total - x).abs().max()):.2e}")

    # Decimated pyramid: L-shaped coefficient layout, exact reconstruction.
    details, ll = vw.wavedec2(x, "db2", levels=3)
    print(f"wavedec2: ll {tuple(ll.shape)}, finest detail {tuple(details[0][0].shape)}")
    rec = vw.waverec2(details, ll, "db2")
    print(f"wavedec2 round trip max err: {float((rec - x).abs().max()):.2e}")


if __name__ == "__main__":
    main()
