"""Lossless compression pipeline and packet texture basis on the PyTorch
port.

Counterpart of ``examples/compression_lifting_demo.py``.  Two capabilities
no convolution DWT offers, end to end:

1. the reversible integer 5/3 lifting transform (JPEG2000 lossless mode):
   decompose 8-bit samples to an integer pyramid, measure the entropy drop
   that a lossless entropy coder would realise, reconstruct bit-exactly;
2. the 2-D packet quadtree with best-basis selection: an oscillatory
   texture concentrates into a handful of high-frequency packet nodes the
   plain pyramid (which only ever splits LL) cannot isolate.

The float 9/7 lifting runs in float64, as the JAX example asks (it gets
float32 there, since it runs without x64).

    python examples/torch/compression_lifting_demo.py          # on the card
    python examples/torch/compression_lifting_demo.py --cpu    # on the CPU
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np
import torch

import vectorwave_tpu_torch as vw


def entropy_bits(values: np.ndarray) -> float:
    """Empirical zeroth-order entropy (bits/sample) of an integer array."""
    _, counts = np.unique(values, return_counts=True)
    p = counts / counts.sum()
    return float(-(p * np.log2(p)).sum())


def lossless_pipeline(rng: np.random.Generator, dev) -> None:
    # Smooth 8-bit "sensor" signal: slow drift + texture + quantization.
    n = 4096
    t = np.arange(n)
    analog = 96 + 48 * np.sin(2 * np.pi * t / 900) + 8 * np.sin(2 * np.pi * t / 37)
    samples = np.clip(np.round(analog + rng.normal(0, 1.5, n)), 0, 255)
    x = torch.as_tensor(samples, dtype=torch.int32, device=dev)

    tree = vw.lifting_wavedec_int(x, "legall53", levels=5)
    rec = vw.lifting_waverec_int(tree, "legall53")
    assert bool((rec == x).all()), "lossless round trip broken"

    coeff_stream = np.concatenate(
        [tree.approx.cpu().numpy()] + [d.cpu().numpy() for d in tree.details]
    )
    print("reversible 5/3 lifting (JPEG2000 lossless mode)")
    print(f"  raw entropy      : {entropy_bits(samples):5.2f} bits/sample")
    print(f"  transform entropy: {entropy_bits(coeff_stream):5.2f} bits/sample")
    print("  round trip       : bit-exact")

    # Float 9/7 path: same API, machine-precision PR, normalised branches.
    res = vw.lifting_dwt(x.to(torch.float64), "cdf97")
    back = vw.lifting_idwt(res.approx, res.detail, "cdf97")
    print(f"  cdf97 float PR   : max|err| = {float((back - x).abs().max()):.2e}")


def texture_basis(rng: np.random.Generator, dev) -> None:
    h = w = 64
    yy, xx = np.mgrid[0:h, 0:w]
    texture = np.sin(2 * np.pi * (21 * xx + 5 * yy) / w)  # high-freq weave
    img = torch.as_tensor(texture + 0.05 * rng.standard_normal((h, w)),
                          dtype=torch.float32, device=dev)

    tree = vw.wpt2(img, "db4", 3)
    basis = vw.best_basis2(tree, "shannon")
    rec = vw.reconstruct_basis2(tree, basis, "db4")
    err = float((rec - img).abs().max())

    # How concentrated is the representation?  Compare the best basis's
    # node count and dominant-node energy share against the leaf basis.
    energies = sorted(
        (float((c**2).sum()) for c in vw.basis_coefficients2(tree, basis)),
        reverse=True,
    )
    total = sum(energies)
    print("\n2-D packet best basis on an oscillatory texture")
    print(f"  nodes in basis    : {len(basis)} (leaf basis would use 64)")
    print(f"  top-4 energy share: {sum(energies[:4]) / total:6.1%}")
    print(f"  reconstruction err: {err:.2e}")
    deepest = max(level for level, _ in basis)
    print(f"  deepest split     : level {deepest}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    dev = torch.device("cpu" if parser.parse_args(argv).cpu else "cuda")
    torch.empty(0, device=dev)  # without a card and without --cpu this raises

    rng = np.random.default_rng(11)
    lossless_pipeline(rng, dev)
    texture_basis(rng, dev)


if __name__ == "__main__":
    main()
