"""Choosing a wavelet on the PyTorch port: registry queries, compatibility,
energy compaction.

Counterpart of ``examples/wavelet_selection_guide.py`` (the reference's
WaveletSelectionGuideDemo and TransformCompatibilityDemo): walk the
registry by family, check which transforms each wavelet supports, and
compare candidates on a concrete signal by energy compaction and
denoising quality.

    python examples/torch/wavelet_selection_guide.py          # on the card
    python examples/torch/wavelet_selection_guide.py --cpu    # on the CPU
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np
import torch

from vectorwave_tpu_torch.denoise.denoiser import denoise_multilevel
from vectorwave_tpu_torch.transforms.multilevel import modwt_multilevel
from vectorwave_tpu_torch.wavelets.base import TransformType
from vectorwave_tpu_torch.wavelets.registry import (
    available_wavelets,
    is_compatible,
    recommended_transform,
    supported_transforms,
    wavelet,
    wavelets_in_family,
)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    dev = torch.device("cpu" if parser.parse_args(argv).cpu else "cuda")
    torch.empty(0, device=dev)  # without a card and without --cpu this raises

    names = available_wavelets()
    print(f"registry: {len(names)} wavelets")
    for family in ("haar", "db", "sym", "coif", "bior", "dmey"):
        members = wavelets_in_family(family)
        print(f"  {family:<5} {len(members):>3} members, e.g. {members[:3]}")

    # Transform compatibility: discrete families do MODWT/SWT, continuous
    # families do CWT only (registry mirrors the reference's compat matrix).
    print("\ncompatibility:")
    for name in ("db4", "bior2.2", "morl"):
        kinds = [t.name for t in supported_transforms(name)]
        rec = recommended_transform(name).name
        print(f"  {name:<8} supports {kinds}, recommended {rec}")
    assert is_compatible("db4", TransformType.MODWT)
    assert not is_compatible("morl", TransformType.MODWT)

    # Pick by property: vanishing moments vs support length trade-off.
    print("\nproperty table (discrete candidates):")
    for name in ("haar", "db2", "db4", "db8", "sym8", "coif3"):
        w = wavelet(name)
        print(f"  {name:<6} filter length {len(w.dec_lo):>2}, "
              f"vanishing moments ~{len(w.dec_lo) // 2}")

    # Concrete selection: energy compaction on a piecewise-smooth signal.
    # Fewer large coefficients = better basis for compression/denoising.
    rng = np.random.default_rng(5)
    t = np.linspace(0, 1, 4096)
    clean = np.sin(8 * np.pi * t) + 0.5 * np.sign(np.sin(3 * np.pi * t))
    noisy = clean + rng.normal(0, 0.25, t.size)

    print("\nenergy compaction (share of energy in top 5% of detail coeffs)"
          " and denoise RMSE:")
    x = torch.as_tensor(noisy, dtype=torch.float32, device=dev)
    for name in ("haar", "db4", "sym8", "coif3"):
        res = modwt_multilevel(x, name, levels=5)
        coeffs = torch.cat(list(res.details))
        mags = coeffs.abs().sort(descending=True).values
        k = int(0.05 * mags.numel())
        compaction = float((mags[:k] ** 2).sum() / (mags**2).sum())
        den = denoise_multilevel(x, name, levels=5).cpu().numpy()
        rmse = float(np.sqrt(np.mean((den - clean) ** 2)))
        print(f"  {name:<6} compaction {compaction:.3f}   denoise RMSE {rmse:.4f}")

    print("\nrules of thumb: haar for edges/steps, db4-db8 general purpose, "
          "sym8 when phase matters, coif for near-symmetric smooth signals, "
          "bior for exact linear phase, morl/mexh for CWT time-frequency maps.")


if __name__ == "__main__":
    main()
