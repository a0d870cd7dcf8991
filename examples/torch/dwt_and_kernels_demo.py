"""Decimated DWT and the kernel tier's precision ladder on the PyTorch port.

Counterpart of ``examples/dwt_and_kernels_demo.py``: the decimated
pyramid (coefficients halve per level), biorthogonal perfect
reconstruction, and the fused precision tiers of the multi-level MODWT,
which on the card run the hand-written cascade kernels.  Where the JAX
example names its backend (``pallas`` on a TPU, ``jnp`` elsewhere), this
one names the device and whether the CUDA kernels serve it.

    python examples/torch/dwt_and_kernels_demo.py          # on the card
    python examples/torch/dwt_and_kernels_demo.py --cpu    # on the CPU
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
    x = torch.as_tensor(rng.standard_normal(1024), dtype=torch.float32, device=dev)

    # --- decimated pyramid: coefficients halve per level -------------------
    dec = vw.wavedec(x, "db4", levels=4)
    shapes = [tuple(d.shape) for d in dec.details] + [tuple(dec.approx.shape)]
    print(f"wavedec shapes (d1..d4, a4): {shapes}")
    xr = vw.waverec(dec, "db4")
    print(f"pyramid round-trip error: {float((x - xr).abs().max()):.2e}")

    # biorthogonal pairs reconstruct exactly too (parity-calibrated offsets)
    res = vw.dwt(x, "bior4.4")
    xr_b = vw.idwt(res.approx, res.detail, "bior4.4")
    print(f"bior4.4 PR error: {float((x - xr_b).abs().max()):.2e}")

    # DWT coefficients relate to MODWT by subsampling x sqrt(2) scaling at
    # matching phase; both transforms agree on signal energy split
    e_dwt = float((res.approx**2).sum() + (res.detail**2).sum())
    print(f"orthogonal-energy check (db4): {abs(e_dwt / float((x**2).sum()) - 1):.2e}")

    # --- fused kernel precision ladder -------------------------------------
    # On the card the cascade kernels serve modwt_multilevel automatically;
    # pick the precision tier globally or per call:
    backend = (f"{torch.cuda.get_device_name(dev)}, CUDA kernels "
               f"{vw.kernel_available()}" if dev.type == "cuda" else "cpu, plain torch")
    print(f"default fused precision: {vw.get_fused_precision()}")
    for precision in ("float32", "bf16_3x"):
        vw.set_fused_precision(precision)
        res_ml = vw.modwt_multilevel(x, "db4", levels=4)
        xr_ml = vw.imodwt_multilevel(res_ml, "db4")
        print(
            f"  {precision:8s}: round-trip max err "
            f"{float((x - xr_ml).abs().max()):.2e} "
            f"(backend: {backend})"
        )
    vw.set_fused_precision("bf16_3x")


if __name__ == "__main__":
    main()
