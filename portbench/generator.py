"""The one traffic generator: a cell's input batches from its seed.

A traffic file (``traffic/<name>.json``) gives ``batches``; the
configuration gives the rows a call ``rows``, the signal length ``n`` and
the signal-to-noise ratio ``snr_db``.  Each row is a Gaussian random walk,
price-like as the series of quant pipelines are, plus white noise whose
power lies ``snr_db`` under the walk's variance along that row.  Every
seed yields the same shapes; only the values change.  The batches are made
on the device in float64 and handed to the program in float32.
"""

from __future__ import annotations

import random

import torch


def make_inputs(cfg: dict, mix: dict, seed: int, device) -> list[torch.Tensor]:
    """``mix["batches"]`` distinct ``[rows, n]`` float32 batches."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    rows, n = cfg["rows"], cfg["n"]
    noise_scale = 10.0 ** (-cfg["snr_db"] / 20.0)
    out = []
    for _ in range(mix["batches"]):
        walk = torch.randn(rows, n, generator=gen, device=device, dtype=torch.float64)
        walk = walk.cumsum_(-1)
        noise = torch.randn(rows, n, generator=gen, device=device, dtype=torch.float64)
        noise *= walk.std(dim=-1, keepdim=True) * noise_scale
        out.append((walk + noise).to(torch.float32))
        del walk, noise
    return out


def kept_call(seed: int, first_calls: int) -> int:
    """The index, among the window's first calls, of the call whose outputs
    are compared besides the last call on each batch."""
    return random.Random(seed).randrange(first_calls)
