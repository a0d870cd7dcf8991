"""Static cost model with an optional calibration on the device.

Counterpart of ``vectorwave_tpu/cost_model.py``: the estimate of a
multi-level round trip's time is work over a sustained rate, the rate
measured once by :func:`calibrate` and kept in the port's cache directory
(``<config.cache_root()>/performance.json``, keyed ``cuda:<device name>`` or
``cpu``), or else a per-platform default with a wider interval.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import torch

from .config import cache_root
from .convert import _device

#: default sustained throughputs (samples/s) of a db4 6-level float32 round
#: trip per platform, replaced by calibrate() measurements.  ``cuda``: what
#: ``calibrate()`` measures at its defaults (8 x 16384 and 8 x 65536, the
#: median of the two) on an NVIDIA H100 80GB HBM3 at a 700 W power limit,
#: 8.77e8 and 9.90e8 in two runs of chip_smoke.py (launch-bound: a 8 x 16384
#: round trip is mostly host time).  ``cpu``: the JAX package's CPU default.
_DEFAULT_THROUGHPUT = {
    "cuda": 9.9e8,
    "cpu": 2.0e7,
}


@dataclasses.dataclass(frozen=True)
class PredictionResult:
    """An estimate with its confidence interval."""

    estimated_seconds: float
    lower_seconds: float
    upper_seconds: float
    calibrated: bool


def _store_path() -> str:
    root = cache_root()
    os.makedirs(root, exist_ok=True)
    return os.path.join(root, "performance.json")


def _load_store() -> dict:
    try:
        with open(_store_path()) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return {}


def _save_store(store: dict) -> None:
    with open(_store_path(), "w") as fh:
        json.dump(store, fh)


def _platform_key(dev: torch.device) -> str:
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return dev.type


def estimate_processing_time(
    signal_length: int,
    *,
    levels: int = 6,
    batch: int = 1,
    filter_length: int = 8,
    device="cuda",
) -> PredictionResult:
    """Predict a multi-level round trip's wall time on ``device`` (default:
    the card; pass ``device="cpu"`` for the CPU; without a card the default
    raises).

    Work scales with batch * N * levels * filter_length; the rate comes from
    the calibration kept for this device (a tight interval) or the
    platform's default (a wide one).
    """
    dev = _device(device)
    entry = _load_store().get(_platform_key(dev))
    work = batch * signal_length * levels * filter_length / (6 * 8)
    if entry:
        est = work / entry["samples_per_second"]
        return PredictionResult(est, est * 0.7, est * 1.5, True)
    est = work / _DEFAULT_THROUGHPUT.get(dev.type, 1e7)
    return PredictionResult(est, est * 0.2, est * 5.0, False)


def calibrate(
    *,
    sizes: tuple[int, ...] = (16384, 65536),
    batch: int = 8,
    levels: int = 6,
    wavelet: str = "db4",
    persist: bool = True,
    device="cuda",
) -> float:
    """Measure the sustained float32 round-trip throughput on ``device``
    (default: the card; pass ``device="cpu"`` for the CPU; without a card
    the default raises) and keep it.  Returns samples/s, the median over
    ``sizes``.  On the card the timed loop is closed by a synchronisation,
    so the rate counts the kernels' work, not their queueing."""
    from .transforms.multilevel import imodwt_multilevel, modwt_multilevel

    dev = _device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    gen = torch.Generator(device=dev).manual_seed(0)
    rates = []
    for n in sizes:
        x = torch.randn(batch, n, device=dev, generator=gen)

        def rt():
            return imodwt_multilevel(modwt_multilevel(x, wavelet, levels=levels), wavelet)

        rt()
        sync()
        iters = 10
        start = time.perf_counter()
        for _ in range(iters):
            rt()
        sync()
        rates.append(batch * n * iters / (time.perf_counter() - start))
    rates.sort()
    mid = len(rates) // 2
    rate = float(rates[mid] if len(rates) % 2 else (rates[mid - 1] + rates[mid]) / 2)
    if persist:
        store = _load_store()
        store[_platform_key(dev)] = {
            "samples_per_second": rate,
            "levels": levels,
            "wavelet": wavelet,
            "timestamp": time.time(),
        }
        _save_store(store)
    return rate
