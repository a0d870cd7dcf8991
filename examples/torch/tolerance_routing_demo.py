"""Tolerance-routed precision tiers on the PyTorch port.

Counterpart of ``examples/tolerance_routing_demo.py``: ``tolerance=``
asks for a round-trip error budget and the router picks the cheapest
tier that meets it; the tightest budget returns the exact tier's
double-float planes (on the card, the fp64 exact kernel pair).

    python examples/torch/tolerance_routing_demo.py          # on the card
    python examples/torch/tolerance_routing_demo.py --cpu    # on the CPU
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
    x = torch.as_tensor(rng.standard_normal((4, 4096)), dtype=torch.float32, device=dev)

    for tol in (1e-2, 1e-5, 1e-10):
        tier = vw.resolve_tolerance(tol)
        res = vw.modwt_multilevel(x, "db4", levels=5, tolerance=tol)
        xr = vw.imodwt_multilevel(res, "db4")
        err = xr.double() - x.double()
        rmse = float(err.pow(2).mean().sqrt())
        kind = type(res).__name__
        print(f"tolerance {tol:g}: tier={tier:8s} result={kind:22s} "
              f"round-trip rmse {rmse:.2e}")
        assert rmse <= tol, (tol, rmse)

    # exact-tier coefficients: combine hi + lo in float64
    res = vw.modwt_multilevel(x, "db4", levels=5, tolerance=1e-10)
    d1 = res.details[0].double() + res.details_lo[0].double()
    print(f"exact-tier level-1 detail carries ~48 bits: "
          f"|d1| max {float(d1.abs().max()):.6f}")


if __name__ == "__main__":
    main()
