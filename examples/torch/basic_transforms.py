"""Basic MODWT / SWT / CWT usage on the PyTorch port.

Counterpart of ``examples/basic_transforms.py`` (the reference's
vectorwave-examples Main.java walkthrough).  The port does not trace, so
the JAX example's jitted pipeline runs eagerly here and says so.

    python examples/torch/basic_transforms.py          # on the card
    python examples/torch/basic_transforms.py --cpu    # on the CPU
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np
import torch

import vectorwave_tpu_torch as vw


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    dev = torch.device("cpu" if parser.parse_args(argv).cpu else "cuda")
    torch.empty(0, device=dev)  # without a card and without --cpu this raises

    rng = np.random.default_rng(0)
    t = np.arange(2048)
    signal = np.sin(2 * np.pi * t / 64) + 0.3 * rng.standard_normal(len(t))
    x = torch.as_tensor(signal, dtype=torch.float32, device=dev)

    # --- single-level MODWT: shift-invariant, any length -------------------
    res = vw.modwt(x, "db4")
    xr = vw.imodwt(res, "db4")
    print(f"single-level round-trip error: {float((x - xr).abs().max()):.2e}")

    # --- multi-level decomposition with energy summary ---------------------
    levels = vw.max_levels(len(t), "db4")
    multi = vw.modwt_multilevel(x, "db4", levels=min(levels, 6))
    dist = multi.relative_energy_distribution().cpu().numpy()
    for j, frac in enumerate(dist[:-1], start=1):
        print(f"  level {j} detail energy: {frac:6.1%}")
    print(f"  approximation energy:  {dist[-1]:6.1%}")

    # --- SWT band extraction ----------------------------------------------
    band = vw.extract_level(x, "sym8", 4, target_level=2)
    print(f"level-2 band energy: {float((band**2).sum()):.2f}")

    # --- CWT scalogram -----------------------------------------------------
    scales = vw.scales_log(2, 128, 32)
    cwt_res = vw.cwt(x, scales, "morl")
    ridge = scales[int(cwt_res.magnitude().mean(dim=-1).argmax())]
    fc = vw.wavelet("morl").center_frequency
    print(f"dominant CWT scale {ridge:.1f} -> period {ridge / fc:.1f} samples "
          f"(true period 64)")

    # --- the same pipeline, run eagerly (the port does not trace) ----------
    def pipeline(x):
        res = vw.modwt_multilevel(x, "db4", levels=5)
        return vw.imodwt_multilevel(res, "db4")

    print(f"eager round-trip error: {float((pipeline(x) - x).abs().max()):.2e}")


if __name__ == "__main__":
    main()
