"""Pure-NumPy ring buffer with the same semantics as ``ringbuf.cpp``.

Used when the host has no C++ toolchain (``native_available() is False``) or
when ``RingBuffer(backend="python")`` is requested explicitly (the parity
tests run both backends against each other).  A single mutex replaces the
native backend's wait-free atomics — correctness-identical, just slower.
"""

from __future__ import annotations

import threading

import numpy as np


class PyRingBuffer:
    """SPSC ring of multi-channel ticks; mirror of the C++ ABI."""

    def __init__(self, capacity: int, channels: int, dtype: np.dtype):
        self.capacity = int(capacity)
        self.channels = int(channels)
        self._data = np.empty((self.capacity, self.channels), dtype=dtype)
        self._head = 0  # ticks consumed (monotonic)
        self._tail = 0  # ticks written (monotonic)
        self._dropped = 0
        self._lock = threading.Lock()

    # -- helpers ------------------------------------------------------------
    def _copy_out(self, pos: int, nticks: int, dst: np.ndarray) -> None:
        start = pos % self.capacity
        first = min(nticks, self.capacity - start)
        dst[:first] = self._data[start : start + first]
        if first < nticks:
            dst[first:nticks] = self._data[: nticks - first]

    def _copy_in(self, pos: int, src: np.ndarray) -> None:
        nticks = src.shape[0]
        start = pos % self.capacity
        first = min(nticks, self.capacity - start)
        self._data[start : start + first] = src[:first]
        if first < nticks:
            self._data[: nticks - first] = src[first:]

    # -- ABI ---------------------------------------------------------------
    @property
    def available(self) -> int:
        with self._lock:
            return self._tail - self._head

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def push(self, arr: np.ndarray) -> int:
        with self._lock:
            free = self.capacity - (self._tail - self._head)
            n = min(arr.shape[0], free)
            if n > 0:
                self._copy_in(self._tail, arr[:n])
                self._tail += n
            self._dropped += arr.shape[0] - n
            return n

    def pop(self, out: np.ndarray) -> int:
        with self._lock:
            n = min(out.shape[0], self._tail - self._head)
            if n > 0:
                self._copy_out(self._head, n, out)
                self._head += n
            return n

    def peek_latest(self, out: np.ndarray) -> int:
        with self._lock:
            n = min(out.shape[0], self._tail - self._head)
            if n > 0:
                self._copy_out(self._tail - n, n, out)
            return n

    def pop_frames(self, out: np.ndarray, frame_len: int, hop: int) -> int:
        with self._lock:
            avail = self._tail - self._head
            if frame_len > self.capacity or avail < frame_len:
                return 0
            n_frames = min(out.shape[0], 1 + (avail - frame_len) // hop)
            for f in range(n_frames):
                self._copy_out(self._head + f * hop, frame_len, out[f])
            self._head += n_frames * hop
            return n_frames
