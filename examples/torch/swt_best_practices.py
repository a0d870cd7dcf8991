"""SWT best practices on the PyTorch port: shift invariance, level choice,
thresholding, MRA.

Counterpart of ``examples/swt_best_practices.py`` (the reference's
SWTBestPracticesDemo.java), condensed to the decisions that matter and
verified numerically instead of asserted in prose.

    python examples/torch/swt_best_practices.py          # on the card
    python examples/torch/swt_best_practices.py --cpu    # on the CPU
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np
import torch

import vectorwave_tpu_torch as vw
from vectorwave_tpu_torch import extract_level, mra, swt, swt_denoise


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    dev = torch.device("cpu" if parser.parse_args(argv).cpu else "cuda")
    torch.empty(0, device=dev)  # without a card and without --cpu this raises

    def tensor(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    def host(t):
        return t.cpu().numpy()

    rng = np.random.default_rng(0)
    n = 1024
    t = np.arange(n)
    clean = np.sin(2 * np.pi * t / 64) + 0.5 * (t > 512)
    noisy = clean + 0.3 * rng.standard_normal(n)

    # 1. Shift invariance, the reason to prefer SWT over decimated DWT.
    #    Denoise x and a 1-shifted copy; SWT outputs differ by exactly that
    #    shift, decimated DWT outputs do not.
    den0 = host(swt_denoise(tensor(noisy), "sym8", levels=4))
    den1 = host(swt_denoise(tensor(np.roll(noisy, 1)), "sym8", levels=4))
    swt_drift = float(np.max(np.abs(np.roll(den0, 1) - den1)))

    def dwt_denoise(sig):
        dec = vw.wavedec(tensor(sig), "sym8", levels=4)
        thr = [vw.hard_threshold(d, 0.3) for d in dec.details]
        return host(vw.waverec(dec._replace(details=tuple(thr)), "sym8"))

    dwt_drift = float(
        np.max(np.abs(np.roll(dwt_denoise(noisy), 1) - dwt_denoise(np.roll(noisy, 1))))
    )
    print("1. Shift invariance (max deviation under a 1-sample shift):")
    print(f"   SWT {swt_drift:.2e} (invariant)   decimated DWT {dwt_drift:.2e}")

    # 2. Level choice: once the decomposition reaches the scale where your
    #    structure lives, deeper levels start thresholding the structure
    #    itself: RMSE degrades, runtime grows.
    for levels in (3, 5, 7):
        den = host(swt_denoise(tensor(noisy), "sym8", levels=levels))
        rmse = float(np.sqrt(np.mean((den - clean) ** 2)))
        print(f"2. levels={levels}: denoise RMSE {rmse:.4f}")

    # 3. Per-level thresholding beats one global threshold when noise is
    #    colored; universal threshold with level-dependent sigma is default.
    res = swt(tensor(noisy), "sym8", levels=4)
    sigmas = [float(np.median(np.abs(host(d))) / 0.6745) for d in res.details]
    print("3. per-level sigma estimates:", [f"{s:.3f}" for s in sigmas])

    # 4. MRA: additive decomposition for inspection; components sum back
    #    to the signal exactly.
    components = mra(tensor(noisy), "sym8", levels=4)
    recon = np.sum([host(c) for c in components], axis=0)
    print(f"4. MRA components: {len(components)}, "
          f"additivity error {np.max(np.abs(recon - host(tensor(noisy)))):.2e}")

    # 5. Single-level inspection without assembling the full MRA.
    lvl3 = host(extract_level(tensor(noisy), "sym8", 4, 3))
    print(f"5. level-3 detail energy {np.sum(lvl3**2):.2f} "
          f"(step change concentrates here)")


if __name__ == "__main__":
    main()
