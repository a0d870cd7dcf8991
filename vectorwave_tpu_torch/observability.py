"""Logging, counters and profiling hooks.

Counterpart of ``vectorwave_tpu/observability.py``: standard :mod:`logging`
under the logger ``vectorwave_tpu_torch`` with its level from
``$VECTORWAVE_TPU_TORCH_LOG_LEVEL``, a small thread-safe counter registry, a
throughput meter, and a :mod:`torch.profiler` trace around a block.
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import threading
import time

import torch

logger = logging.getLogger("vectorwave_tpu_torch")
_level = os.environ.get("VECTORWAVE_TPU_TORCH_LOG_LEVEL")
if _level:
    logger.setLevel(getattr(logging, _level.upper(), logging.INFO))


class Stats:
    """Thread-safe counters."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}

    def add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def get(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()


#: process-global stats registry
stats = Stats()


def _sync_card() -> None:
    """Wait for the card's queued work, when this process has used the card."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def throughput_meter(name: str, samples: int):
    """Time a block and record samples/s into :data:`stats`.  When the
    process has used the card, the card is synchronised before each reading
    of the clock, so the block's asynchronous launches are inside the time."""
    _sync_card()
    start = time.perf_counter()
    yield
    _sync_card()
    elapsed = time.perf_counter() - start
    stats.add(f"{name}.samples", samples)
    stats.add(f"{name}.seconds", elapsed)
    logger.debug("%s: %.0f samples/s", name, samples / max(elapsed, 1e-12))


@contextlib.contextmanager
def profiler_trace(log_dir: str | None = None):
    """Capture a :mod:`torch.profiler` trace (CPU and, when there is a card,
    CUDA activity) around a block and write it to ``log_dir`` as a Chrome
    trace (default: ``vectorwave_tpu_torch_trace`` in the temporary
    directory).  Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "vectorwave_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
