"""Real-time ingest: native ring buffer -> batched sliding-window transforms.

Counterpart of ``vectorwave_tpu/streaming/ingest.py``.  A producer thread
(market feed, sensor DMA, socket reader) hands samples to the consumer
through the native SPSC ring buffer (:mod:`vectorwave_tpu_torch.native`),
and the consumer drains *every* overlapping window that accumulated since
the last drain as ONE ``[k, buffer_size]`` batch on the device: one
transform call, whatever the backlog.

Window semantics are those of :mod:`.sliding`: the first window fills
``buffer_size`` samples, each later window advances by ``step =
buffer_size - overlap`` and re-covers the overlap.

The JAX package pads the batch to a power of two so that ``jax.jit``
compiles O(log k) programs; PyTorch runs eagerly, each window's
coefficients do not depend on the batch around it, so the port transforms
the k windows as they are.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import _device
from ..errors import ErrorCode, InvalidArgumentError
from ..native import RingBuffer
from ..transforms.modwt import _resolve_discrete, modwt
from ..transforms.multilevel import modwt_multilevel
from .sliding import step_size


class StreamIngest:
    """Producer/consumer bridge from a live sample feed to window transforms.

    Producer thread: :meth:`push` (wait-free in the native backend).
    Consumer thread: :meth:`drain`, which assembles every ready overlapping
    window, moves them to ``device`` (default: the card; without one it
    raises) and transforms them as one batch, returning the coefficients
    with a leading window axis (or ``None`` when nothing is ready).
    """

    def __init__(
        self,
        wavelet="db4",
        *,
        buffer_size: int = 512,
        levels: int = 1,
        boundary: str = "periodic",
        channels: int = 1,
        capacity: int | None = None,
        dtype=np.float32,
        backend: str | None = None,
        device="cuda",
    ) -> None:
        self.wavelet = _resolve_discrete(wavelet)
        self.levels = int(levels)
        self.boundary = boundary
        self.buffer_size = int(buffer_size)
        self.step = step_size(buffer_size, self.wavelet, levels=self.levels)
        self.overlap = self.buffer_size - self.step
        self.channels = int(channels)
        self.device = _device(device)
        if capacity is None:
            capacity = 64 * self.buffer_size
        if capacity < self.buffer_size:
            raise InvalidArgumentError(
                ErrorCode.VAL_TOO_SHORT,
                f"capacity {capacity} must hold at least one window "
                f"({self.buffer_size})",
            )
        self.ring = RingBuffer(
            capacity, channels=channels, dtype=dtype, backend=backend
        )
        self.windows_emitted = 0
        self.samples_transformed = 0

    def _xform(self, frames: torch.Tensor):
        if self.levels == 1:
            return modwt(frames, self.wavelet, boundary=self.boundary)
        return modwt_multilevel(frames, self.wavelet, levels=self.levels,
                                boundary=self.boundary)

    # -- producer side -------------------------------------------------------
    def push(self, samples) -> int:
        """Append samples ([n] or [n, channels]); returns ticks accepted."""
        return self.ring.push(samples)

    # -- consumer side -------------------------------------------------------
    @property
    def ready(self) -> int:
        """Windows that :meth:`drain` would emit right now."""
        avail = self.ring.available
        if avail < self.buffer_size:
            return 0
        return 1 + (avail - self.buffer_size) // self.step

    def drain(self, max_frames: int | None = None):
        """Transform every ready window in one call.

        Returns the coefficients with a leading ``[k]`` window axis
        (channels > 1 adds a ``[channels]`` axis after it), or ``None`` when
        no window is ready yet.
        """
        limit = max_frames if max_frames is not None else 2**31
        frames = self.ring.pop_frames(self.buffer_size, self.step, limit)
        k = frames.shape[0]
        if k == 0:
            return None
        if self.channels > 1:
            frames = np.moveaxis(frames, -1, 1)  # [k, channels, time]
        batch = torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)
        coeffs = self._xform(batch)
        self.windows_emitted += k
        self.samples_transformed += k * self.buffer_size
        return coeffs

    def latest_window(self) -> np.ndarray | None:
        """The newest ``buffer_size`` samples without consuming (monitors)."""
        out = self.ring.peek_latest(self.buffer_size)
        return out if out.shape[0] == self.buffer_size else None

    @property
    def statistics(self) -> dict:
        return {
            "backend": self.ring.backend,
            "queued": self.ring.available,
            "dropped": self.ring.dropped,
            "ready": self.ready,
            "windows_emitted": self.windows_emitted,
            "samples_transformed": self.samples_transformed,
            "buffer_size": self.buffer_size,
            "overlap": self.overlap,
        }
