"""Transform-compatibility API on the PyTorch port: which wavelets work with
which transforms.

Counterpart of ``examples/transform_compatibility_demo.py`` (the
reference's TransformCompatibilityDemo.java): query a wavelet's supported
transforms, find wavelets for a transform, verify before use, get a
recommendation, and print the family-level compatibility matrix.  The
registry lives on the host; the device only decides where the example
may run.

    python examples/torch/transform_compatibility_demo.py          # on the card
    python examples/torch/transform_compatibility_demo.py --cpu    # on the CPU
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import torch

import vectorwave_tpu_torch as vw
from vectorwave_tpu_torch import TransformType


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    dev = torch.device("cpu" if parser.parse_args(argv).cpu else "cuda")
    torch.empty(0, device=dev)  # without a card and without --cpu this raises

    # --- 1. what does a specific wavelet support? --------------------------
    for name in ("db4", "morl"):
        kinds = ", ".join(t.name for t in vw.supported_transforms(name))
        print(f"{name}: supports {kinds}")

    # --- 2. find wavelets compatible with a transform ----------------------
    cwt_ready = [w for w in vw.available_wavelets() if vw.is_compatible(w, TransformType.CWT)]
    modwt_ready = [w for w in vw.available_wavelets() if vw.is_compatible(w, TransformType.MODWT)]
    print(f"\nCWT-compatible wavelets: {len(cwt_ready)} (e.g. {', '.join(cwt_ready[:6])} ...)")
    print(f"MODWT-compatible wavelets: {len(modwt_ready)} (e.g. {', '.join(modwt_ready[:6])} ...)")

    # --- 3. verify before use ----------------------------------------------
    checks = [("haar", TransformType.MODWT), ("morl", TransformType.MODWT),
              ("sym8", TransformType.SWT), ("mexh", TransformType.CWT)]
    print()
    for name, transform in checks:
        ok = vw.is_compatible(name, transform)
        print(f"{'OK ' if ok else 'NO '} {name} + {transform.name}")

    # --- 4. recommendations -------------------------------------------------
    print()
    for name in ("db4", "bior4.4", "morl", "dmey"):
        print(f"recommended transform for {name}: {vw.recommended_transform(name).name}")

    # --- 5. family-level compatibility matrix -------------------------------
    families = ("haar", "db", "sym", "coif", "bior", "dmey", "morl", "mexh", "paul")
    transforms = (TransformType.MODWT, TransformType.SWT, TransformType.CWT)
    header = "family".ljust(8) + "".join(t.name.ljust(8) for t in transforms)
    print("\n" + header)
    for fam in families:
        members = vw.wavelets_in_family(fam) or [fam]
        row = fam.ljust(8)
        for t in transforms:
            row += ("yes" if vw.is_compatible(members[0], t) else "-").ljust(8)
        print(row)


if __name__ == "__main__":
    main()
