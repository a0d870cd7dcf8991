"""One-pass fused denoise on the PyTorch port: the coefficient planes never
reach device memory.

Counterpart of ``examples/fused_denoise_demo.py``.  ``denoise_multilevel``
with a sigma-only rule (universal/minimax) runs analysis, a per-level
soft/hard threshold and synthesis in one launch of the fused denoise
kernel on the card; the noise floor is the MAD of the finest detail.
Gradients run end to end (``torch.autograd`` through the kernel's
gradient, the cascade pair), so the denoiser can sit inside a training
loss.

    python examples/torch/fused_denoise_demo.py          # on the card
    python examples/torch/fused_denoise_demo.py --cpu    # on the CPU
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

    rng = np.random.default_rng(7)
    t = np.arange(8192)
    clean = np.sin(2 * np.pi * t / 256) + 0.4 * np.sin(2 * np.pi * t / 48)
    noisy = (clean + rng.normal(0, 0.6, len(t))).astype(np.float32)
    x = torch.as_tensor(noisy, device=dev)

    # the router picks the fused kernel on the card; force the kernel tier
    # so the demo takes the same path everywhere (on the CPU, its plain
    # version)
    vw.set_backend("kernel")
    try:
        den = vw.denoise_multilevel(x, "db4", levels=5, method="universal",
                                    mode="soft")
        snr_in = 10 * np.log10(np.var(clean) / np.var(noisy - clean))
        snr_out = 10 * np.log10(
            np.var(clean) / np.mean((den.cpu().numpy() - clean) ** 2)
        )
        print(f"fused one-pass denoise: {snr_in:5.1f} dB -> {snr_out:5.1f} dB")

        # differentiable: gradient of a denoised-output loss w.r.t. input
        def loss(y):
            return vw.denoise_multilevel(y, "db4", levels=5, method="universal",
                                         mode="soft").pow(2).mean()

        xg = x.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(loss(xg), xg)
        print(f"grad through the fused kernel: shape {tuple(g.shape)}, "
              f"|g| max {float(g.abs().max()):.3e}")
    finally:
        vw.set_backend("auto")

    # batch throughput shape: every signal denoised in one kernel sweep
    xb = torch.as_tensor(rng.standard_normal((16, 8192)), dtype=torch.float32, device=dev)
    den_b = vw.denoise_multilevel(xb, "db4", levels=5, method="minimax", mode="hard")
    print(f"batched 16x8192 minimax-hard: output {tuple(den_b.shape)}, "
          f"finite={bool(torch.isfinite(den_b).all())}")


if __name__ == "__main__":
    main()
