"""SWT workflows on the PyTorch port: transform, thresholding, level
extraction, MRA.

Counterpart of ``examples/swt_demo.py`` (the reference's SWTDemo and
SWTBestPracticesDemo): the shift-invariant transform as a denoising and
analysis tool, with the best-practice rules: universal threshold for quick
cleanup, per-level thresholds for control, MRA when you need additive
components.

    python examples/torch/swt_demo.py          # on the card
    python examples/torch/swt_demo.py --cpu    # on the CPU
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np
import torch

from vectorwave_tpu_torch.transforms.swt import (
    apply_universal_threshold,
    extract_level,
    iswt,
    mra,
    swt,
    swt_denoise,
    threshold_level,
)

N, LEVELS = 1024, 4


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    dev = torch.device("cpu" if parser.parse_args(argv).cpu else "cuda")
    torch.empty(0, device=dev)  # without a card and without --cpu this raises

    rng = np.random.default_rng(3)
    t = np.arange(N) / N
    clean = np.sin(2 * np.pi * 5 * t) + 0.5 * np.sin(2 * np.pi * 40 * t)
    noisy = clean + rng.normal(0.0, 0.35, N)
    x = torch.as_tensor(noisy, dtype=torch.float32, device=dev)
    clean = torch.as_tensor(clean, dtype=torch.float32, device=dev)

    # 1. Round trip: SWT is shift-invariant and perfectly invertible.
    res = swt(x, "db4", levels=LEVELS)
    xr = iswt(res, "db4")
    print(f"round-trip max error: {float((xr - x).abs().max()):.2e}")

    # 2. Quick cleanup: one universal threshold across all levels.
    den = iswt(apply_universal_threshold(res, mode="soft"), "db4")
    rmse = float((den - clean).pow(2).mean().sqrt())
    print(f"universal-threshold denoise RMSE vs clean: {rmse:.4f}")

    # 3. Fine control: threshold only the two finest (noisiest) levels.
    shaped = res
    for lvl in (1, 2):
        shaped = threshold_level(shaped, lvl, 0.8, mode="hard")
    print(f"selective-threshold RMSE: "
          f"{float((iswt(shaped, 'db4') - clean).pow(2).mean().sqrt()):.4f}")

    # 4. One-call facade (the reference's denoise(signal, wavelet, levels)).
    one_call = swt_denoise(x, "db4", levels=LEVELS, mode="soft")
    print(f"swt_denoise RMSE: {float((one_call - clean).pow(2).mean().sqrt()):.4f}")

    # 5. Analysis: isolate one scale band / additive MRA components.
    d2 = extract_level(x, "db4", LEVELS, 2)
    comps = mra(x, "db4", levels=LEVELS)
    recon = sum(comps)
    print(f"level-2 band energy: {float(d2.pow(2).sum()):.2f}")
    print(f"MRA components: {len(comps)}, additive residual "
          f"{float((recon - x).abs().max()):.2e}")


if __name__ == "__main__":
    main()
