"""Parallel denoising on the PyTorch port: a batch at once, then sharded.

Counterpart of ``examples/parallel_denoising.py`` (the reference's
ParallelDenoisingDemo): the batch axis is the parallelism.  One call
denoises every signal (on the card, one fused kernel launch for the
batch), and the same call runs per shard of a mesh for more devices.

    python examples/torch/parallel_denoising.py          # on the card
    python examples/torch/parallel_denoising.py --cpu    # on the CPU
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np
import torch

from vectorwave_tpu_torch.denoise.denoiser import denoise_multilevel
from vectorwave_tpu_torch.parallel import make_mesh, shard_batch
from vectorwave_tpu_torch.parallel.mesh import visible_devices

BATCH, N, LEVELS = 16, 4096, 5


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    dev = torch.device("cpu" if parser.parse_args(argv).cpu else "cuda")
    rng = np.random.default_rng(5)
    t = np.arange(N) / N
    clean = np.stack([
        np.sin(2 * np.pi * (3 + b) * t) + 0.4 * np.sign(np.sin(2 * np.pi * 11 * t))
        for b in range(BATCH)
    ])
    noisy = clean + rng.normal(0.0, 0.3, (BATCH, N))
    x = torch.as_tensor(noisy, dtype=torch.float32, device=dev)
    clean = torch.as_tensor(clean, dtype=torch.float32, device=dev)

    def rmse(v):
        return float((v - clean).pow(2).mean().sqrt())

    # One call denoises the whole batch (leading axes are batch).
    den = denoise_multilevel(x, "sym8", levels=LEVELS, method="universal", mode="soft")
    print(f"batch {BATCH}x{N}: RMSE {rmse(x):.4f} -> {rmse(den):.4f}")

    # Per-signal methods still batch: SURE chooses its own threshold per
    # signal, no Python loop.
    sure = denoise_multilevel(x, "sym8", levels=LEVELS, method="sure")
    print(f"SURE per-signal RMSE: {rmse(sure):.4f}")

    # Scale out: split the batch over a mesh (every card, or 4 virtual
    # shards of one device) and run the same call on each shard.
    cards = visible_devices() if dev.type == "cuda" else []
    devices = cards if len(cards) > 1 else [dev] * 4
    mesh = make_mesh({"data": len(devices)}, devices=devices)
    parts = [denoise_multilevel(s, "sym8", levels=LEVELS, method="universal", mode="soft")
             for s in shard_batch(x, mesh)]
    sharded = torch.cat([p.to(dev) for p in parts])
    print(f"sharded over {len(devices)} shards: max |delta| vs one call "
          f"{(sharded - den).abs().max():.2e}")


if __name__ == "__main__":
    main()
