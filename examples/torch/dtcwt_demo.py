"""Dual-tree complex wavelet transform on the PyTorch port: shift-invariant
envelopes (1-D) and oriented subbands (2-D).

Counterpart of ``examples/dtcwt_demo.py``: the two properties that
motivate the DTCWT over the plain DWT, coefficient magnitudes that track
features under shifts, and six directionally selective complex subbands
for images.  On the card the 1-D dual tree runs the filter-bank kernels.

    python examples/torch/dtcwt_demo.py          # on the card
    python examples/torch/dtcwt_demo.py --cpu    # on the CPU
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np
import torch

import vectorwave_tpu_torch as vw
from vectorwave_tpu_torch.ops.dwt import wavedec
from vectorwave_tpu_torch.transforms.dtcwt import coefficient_delay


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    dev = torch.device("cpu" if parser.parse_args(argv).cpu else "cuda")
    torch.empty(0, device=dev)  # without a card and without --cpu this raises

    def tensor(a):
        return torch.as_tensor(a.astype(np.float32), device=dev)

    # --- 1-D: envelope stability under shifts -------------------------------
    t = np.arange(1024)
    burst = np.exp(-0.5 * ((t - 512) / 40.0) ** 2) * np.cos(2 * np.pi * 0.05 * t)
    res = vw.dtcwt(tensor(burst), levels=5)
    energies = [float(z.abs().pow(2).sum()) for z in res.highpasses]
    j = int(np.argmax(energies)) + 1
    print(f"burst concentrates at level {j} "
          f"({energies[j-1] / sum(energies):.0%} of detail energy)")

    def peak_mag(x, lvl):
        r = vw.dtcwt(tensor(x), levels=5)
        return float(r.highpasses[lvl - 1].abs().max())

    def peak_dwt(x, lvl):
        d = wavedec(tensor(x), "sym8", levels=5)
        return float(d.details[lvl - 1].abs().max())

    mags = [peak_mag(np.roll(burst, s), j) for s in range(8)]
    mags_d = [peak_dwt(np.roll(burst, s), j) for s in range(8)]
    print(f"peak |coeff| over 8 shifts: DTCWT varies "
          f"{max(mags)/min(mags)-1:.1%}, DWT varies {max(mags_d)/min(mags_d)-1:.1%}")

    xr = vw.idtcwt(res)
    print(f"reconstruction error: {float((xr - tensor(burst)).abs().max()):.2e}")

    # --- 2-D: orientation analysis ------------------------------------------
    n = 128
    yy, xx = np.mgrid[0:n, 0:n]
    # two textures: +15 deg stripes left, -75 deg stripes right
    th1, th2 = np.deg2rad(15), np.deg2rad(-75)
    img = np.where(
        xx < n // 2,
        np.cos(2 * np.pi * 0.09 * (np.cos(th1) * xx + np.sin(th1) * yy)),
        np.cos(2 * np.pi * 0.09 * (np.cos(th2) * xx + np.sin(th2) * yy)),
    ).astype(np.float32)
    res2 = vw.dtcwt2(tensor(img), levels=3)
    names = ("-15", "+15", "-75", "+75", "+45", "-45")
    oe = res2.orientation_energy(3).cpu().numpy()
    print("orientation energy (level 3):",
          {nm: round(float(e / oe.sum()), 2) for nm, e in zip(names, oe)})
    # localize each texture from its band's magnitude (roll off the
    # accumulated filter delay so the coefficient grid aligns spatially)
    shift = round(coefficient_delay(3))
    mag = np.roll(
        res2.highpasses[2].abs().cpu().numpy(), (shift, shift), axis=(-2, -1)
    )  # [6, 16, 16]
    left_band, right_band = 1, 2  # +15 and -75
    left_frac = mag[left_band, :, :8].sum() / mag[left_band].sum()
    right_frac = mag[right_band, :, 8:].sum() / mag[right_band].sum()
    print(f"+15 band energy in left half: {left_frac:.0%}; "
          f"-75 band energy in right half: {right_frac:.0%}")
    rec = vw.idtcwt2(res2).cpu().numpy()
    print(f"2-D reconstruction error: {np.abs(rec - img).max():.2e}")


if __name__ == "__main__":
    main()
