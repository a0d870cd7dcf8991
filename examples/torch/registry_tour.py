"""Wavelet registry tour on the PyTorch port: families, generation quality,
compatibility.

Counterpart of ``examples/registry_tour.py`` (the reference's registry and
family demos).  Every filter is generated from its defining equations
(spectral factorization, Newton refinement, CDF splits, Fourier sampling),
not read from tables.

    python examples/torch/registry_tour.py          # on the card
    python examples/torch/registry_tour.py --cpu    # on the CPU
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np
import torch

import vectorwave_tpu_torch as vw
from vectorwave_tpu_torch.wavelets.base import orthogonal_wavelet


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    dev = torch.device("cpu" if parser.parse_args(argv).cpu else "cuda")
    torch.empty(0, device=dev)  # without a card and without --cpu this raises

    names = vw.available_wavelets()
    print(f"registered wavelets: {len(names)}")
    for family in ("db", "sym", "coif", "bior", "rbio"):
        members = vw.wavelets_in_family(family)
        print(f"  {family}: {len(members)} members")

    # every discrete family satisfies perfect-reconstruction invariants
    worst = ("", 0.0)
    checked = 0
    for name in ("haar", "db8", "db20", "sym12", "coif5", "bior4.4", "dmey"):
        w = vw.wavelet(name)
        ok = w.validate_perfect_reconstruction()
        h = w.dec_lo
        err = abs(float(np.sum(h)) - np.sqrt(2.0))
        checked += 1
        if err > worst[1]:
            worst = (name, err)
        assert ok, name
    print(f"PR validation passed for {checked} families; "
          f"worst sum(h)-sqrt(2): {worst[0]} at {worst[1]:.2e}")

    # transform-compatibility matrix (WaveletRegistry.getSupportedTransforms)
    for name in ("db4", "morl", "bior2.2"):
        kinds = vw.supported_transforms(name)
        rec = vw.recommended_transform(name)
        print(f"  {name}: supports {sorted(k.name for k in kinds)}, "
              f"recommended {rec.name}")
    assert not vw.is_compatible("morl", vw.TransformType.MODWT)

    # register a custom wavelet and use it immediately
    taps = np.asarray(vw.wavelet("db2").dec_lo)  # reuse db2 taps for the demo
    vw.register_wavelet(
        "mydb2", lambda: orthogonal_wavelet("mydb2", "custom", taps, 2)
    )
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(256),
                        dtype=torch.float32, device=dev)
    res = vw.modwt(x, "mydb2")
    ref = vw.modwt(x, "db2")
    deviation = float((res.detail - ref.detail).abs().max())
    print(f"custom-registered wavelet matches its source family: {deviation:.1e}")


if __name__ == "__main__":
    main()
