"""Sparse recovery on the PyTorch port: inpainting, iterative denoising,
compressed sensing.

Counterpart of ``examples/sparse_recovery_demo.py``.  Three inverse
problems solved by the same engine, FISTA over the MODWT tight frame
(``vectorwave_tpu_torch.optimize``), on the device:

1. inpaint: restore 40% missing samples of a smooth signal,
2. bpdn: iterative L1 denoising that out-cleans the one-shot threshold,
3. sparse_recover: rebuild a wavelet-sparse signal from 2x undersampled
   random projections (compressed sensing).

The JAX example flattens the coefficient pytree with ``jax.tree_util``;
here the result's planes are listed and rebuilt directly.

    python examples/torch/sparse_recovery_demo.py          # on the card
    python examples/torch/sparse_recovery_demo.py --cpu    # on the CPU
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

    def tensor(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    rng = np.random.default_rng(0)
    n = 512
    t = np.linspace(0, 1, n, endpoint=False)
    clean = np.sin(2 * np.pi * 5 * t) + 0.5 * np.sin(2 * np.pi * 13 * t + 0.7)

    # --- 1. inpainting ------------------------------------------------------
    mask = (rng.random(n) > 0.4).astype(np.float32)  # 1 = observed
    y = tensor(clean * mask)
    filled = vw.inpaint(y, tensor(mask), "db8", steps=200).cpu().numpy()
    miss = mask == 0
    rel = np.sqrt(np.mean((filled[miss] - clean[miss]) ** 2)) / np.std(clean)
    print(f"inpaint: {int(miss.sum())}/{n} samples missing, "
          f"relative RMSE on the gaps = {rel:.3f}")

    # --- 2. iterative denoising (BPDN) vs one-shot threshold ----------------
    noisy = clean + 0.3 * np.random.default_rng(0).standard_normal(n)
    yn = tensor(noisy)
    mse_in = np.mean((noisy - clean) ** 2)
    one_shot = vw.denoise(yn, "db8").cpu().numpy()
    res = vw.bpdn(yn, "db8", steps=100)
    for label, est in [("one-shot", one_shot), ("bpdn", res.signal.cpu().numpy())]:
        gain = 10 * np.log10(mse_in / np.mean((est - clean) ** 2))
        print(f"denoise [{label:8s}]: SNR gain {gain:+.2f} dB")

    # --- 3. compressed sensing ----------------------------------------------
    # Build a signal that is genuinely sparse in the db4 MODWT frame...
    zero_c = vw.modwt_multilevel(tensor(np.zeros(n)), "db4", levels=4)
    planes = [*zero_c.details, zero_c.approx]
    sparse = []
    for k in range(len(planes)):
        v = np.zeros(n, np.float32)
        if k < 2:
            v[rng.choice(n, 3, replace=False)] = 2.0 * rng.standard_normal(3)
        sparse.append(tensor(v))
    x_true = vw.imodwt_multilevel(zero_c._replace(details=tuple(sparse[:-1]),
                                                  approx=sparse[-1]), "db4")

    # ...measure it with m = n/2 Gaussian projections, and recover.
    m = n // 2
    a_mat = tensor(rng.standard_normal((m, n)).astype(np.float32) / np.sqrt(m))

    def forward(x):
        return a_mat @ x

    rec = vw.sparse_recover(forward(x_true), forward, "db4",
                            signal_shape=(n,), lam=1e-4, lam_init=1.0,
                            steps=400, levels=4)
    rel = float(torch.linalg.norm(rec.signal - x_true) / torch.linalg.norm(x_true))
    print(f"compressed sensing: {m} measurements for {n} samples, "
          f"relative error = {rel:.3f}")


if __name__ == "__main__":
    main()
