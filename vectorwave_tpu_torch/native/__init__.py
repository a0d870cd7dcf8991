"""Native host runtime: lock-free sample ingest for the streaming pipeline.

Counterpart of ``vectorwave_tpu/native/``.  The compute path of the port is
PyTorch and its CUDA kernels; the *host runtime* around it, getting
real-time samples from producer threads into device-ready batches, is plain
CPU work, where the reference uses JVM threads and ``Flow.Publisher``
plumbing (``MODWTStreamingTransformImpl.java``).  Here that half is a C++
single-producer/single-consumer ring buffer (``ringbuf.cpp``, the port's own
copy), compiled at first use with the system ``g++`` into ``_build/`` beside
this file and loaded with ctypes.  A host without a compiler falls back to a
NumPy implementation with identical semantics (``_fallback.PyRingBuffer``);
``backend="native"`` refuses the fallback.

Public surface:

* :class:`RingBuffer`: SPSC ring of multi-channel ticks; ``push`` / ``pop`` /
  ``pop_frames`` (overlapping frame assembly) / ``peek_latest``.
* :func:`native_available`: whether the C++ backend loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import pathlib
import subprocess
import tempfile
import threading

import numpy as np

from ..errors import ErrorCode, InvalidArgumentError, InvalidStateError
from ._fallback import PyRingBuffer

_log = logging.getLogger("vectorwave_tpu_torch.native")

_SOURCE = pathlib.Path(__file__).with_name("ringbuf.cpp")
BUILD_DIR = pathlib.Path(__file__).with_name("_build")
_lib = None
_lib_lock = threading.Lock()
_build_error: str | None = None


def _build_library() -> str | None:
    """Compile ringbuf.cpp into a shared library under :data:`BUILD_DIR`,
    keyed by the source's hash; None (and the error kept) on failure."""
    global _build_error
    tmp_name = None
    try:
        digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
        so_path = BUILD_DIR / f"ringbuf-{digest}.so"
        if so_path.exists():
            return str(so_path)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.NamedTemporaryFile(dir=BUILD_DIR, suffix=".so.tmp",
                                         delete=False) as tmp:
            tmp_name = tmp.name
        proc = subprocess.run(
            ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-o", tmp_name,
             str(_SOURCE)],
            capture_output=True, text=True, timeout=120,
        )
        if proc.returncode != 0:
            raise RuntimeError(proc.stderr[:500])
        os.replace(tmp_name, so_path)  # atomic publish
        return str(so_path)
    except (OSError, RuntimeError, subprocess.TimeoutExpired) as exc:
        _build_error = str(exc)
        _log.warning("native ringbuf build failed (%s); using NumPy fallback", exc)
        if tmp_name is not None:
            try:
                os.unlink(tmp_name)
            except OSError:
                pass
        return None


def _load() -> ctypes.CDLL | None:
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        so_path = _build_library()
        if so_path is None:
            return None
        lib = ctypes.CDLL(so_path)
        u64, u32, p = ctypes.c_uint64, ctypes.c_uint32, ctypes.c_void_p
        lib.vw_rb_create.restype = p
        lib.vw_rb_create.argtypes = [u64, u32, u32]
        lib.vw_rb_destroy.restype = None
        lib.vw_rb_destroy.argtypes = [p]
        for name in ("vw_rb_capacity", "vw_rb_available", "vw_rb_dropped"):
            fn = getattr(lib, name)
            fn.restype = u64
            fn.argtypes = [p]
        lib.vw_rb_push.restype = u64
        lib.vw_rb_push.argtypes = [p, p, u64]
        lib.vw_rb_pop.restype = u64
        lib.vw_rb_pop.argtypes = [p, p, u64]
        lib.vw_rb_peek_latest.restype = u64
        lib.vw_rb_peek_latest.argtypes = [p, p, u64]
        lib.vw_rb_pop_frames.restype = u64
        lib.vw_rb_pop_frames.argtypes = [p, p, u64, u64, u64]
        _lib = lib
        return _lib


def native_available() -> bool:
    """True when the C++ ring buffer compiled and loaded on this host."""
    return _load() is not None


def native_build_error() -> str | None:
    """The captured compiler error when the native build failed, else None."""
    _load()
    return _build_error


class RingBuffer:
    """SPSC ring buffer of multi-channel samples ("ticks").

    One producer thread calls :meth:`push`; one consumer thread calls
    :meth:`pop` / :meth:`pop_frames` / :meth:`peek_latest`.  Both sides are
    wait-free in the native backend.  A full buffer rejects new ticks
    (bounded memory, the analogue of the reference's 100 MB streaming cap)
    and counts them in :attr:`dropped`.

    ``pop_frames(frame_len, hop)`` assembles overlapping windows: each frame
    is ``frame_len`` consecutive ticks and consecutive frames share
    ``frame_len - hop`` ticks, matching ``streaming.sliding`` (use
    ``hop = buffer_size - overlap``) so the output batch feeds the batched
    sliding-window MODWT directly.
    """

    def __init__(
        self,
        capacity: int,
        *,
        channels: int = 1,
        dtype=np.float32,
        backend: str | None = None,
    ):
        dtype = np.dtype(dtype)
        if dtype.itemsize not in (4, 8) or dtype.kind != "f":
            raise InvalidArgumentError(
                ErrorCode.CFG_INVALID_CONFIG,
                f"RingBuffer supports float32/float64, got {dtype}",
            )
        if capacity < 1:
            raise InvalidArgumentError(
                ErrorCode.VAL_TOO_SHORT, f"capacity must be >= 1, got {capacity}"
            )
        if channels < 1:
            raise InvalidArgumentError(
                ErrorCode.CFG_INVALID_CONFIG, f"channels must be >= 1, got {channels}"
            )
        if backend not in (None, "native", "python"):
            raise InvalidArgumentError(
                ErrorCode.CFG_INVALID_CONFIG,
                f"backend must be one of None/'native'/'python', got {backend!r}",
            )
        self.capacity = int(capacity)
        self.channels = int(channels)
        self.dtype = dtype
        lib = _load() if backend in (None, "native") else None
        if backend == "native" and lib is None:
            raise InvalidArgumentError(
                ErrorCode.CFG_INVALID_CONFIG,
                "native ring buffer requested but the C++ backend failed "
                f"to build: {_build_error}",
                suggestions=("Install g++, or use backend='python'",),
            )
        self._closed = False
        self._impl = None
        self._lib = lib
        if lib is not None:
            handle = lib.vw_rb_create(capacity, channels, dtype.itemsize)
            if not handle:
                raise MemoryError("vw_rb_create failed")
            self._handle = handle
        else:
            self._impl = PyRingBuffer(capacity, channels, dtype)
            self._handle = None

    def _check_open(self) -> None:
        if self._closed:
            raise InvalidStateError(
                ErrorCode.STATE_CLOSED, "RingBuffer has been closed"
            )

    # -- introspection ----------------------------------------------------
    @property
    def backend(self) -> str:
        return "native" if self._handle is not None else "python"

    @property
    def available(self) -> int:
        """Ticks currently queued for the consumer."""
        self._check_open()
        if self._handle is not None:
            return int(self._lib.vw_rb_available(self._handle))
        return self._impl.available

    @property
    def dropped(self) -> int:
        """Ticks rejected because the buffer was full."""
        self._check_open()
        if self._handle is not None:
            return int(self._lib.vw_rb_dropped(self._handle))
        return self._impl.dropped

    # -- producer ----------------------------------------------------------
    def push(self, samples) -> int:
        """Append ticks; returns how many were accepted.

        ``samples`` is [n] (channels==1) or [n, channels], converted to the
        buffer dtype if needed.
        """
        self._check_open()
        arr = np.ascontiguousarray(samples, dtype=self.dtype)
        if self.channels == 1 and arr.ndim == 1:
            arr = arr[:, None]
        if arr.ndim != 2 or arr.shape[1] != self.channels:
            raise InvalidArgumentError(
                ErrorCode.CFG_INVALID_CONFIG,
                f"push expects [n] or [n, {self.channels}], got {arr.shape}",
            )
        n = arr.shape[0]
        if n == 0:
            return 0
        if self._handle is not None:
            return int(
                self._lib.vw_rb_push(
                    self._handle, arr.ctypes.data_as(ctypes.c_void_p), n
                )
            )
        return self._impl.push(arr)

    # -- consumer ----------------------------------------------------------
    def _out(self, nticks: int) -> np.ndarray:
        return np.empty((nticks, self.channels), dtype=self.dtype)

    def _squeeze(self, arr: np.ndarray) -> np.ndarray:
        return arr[..., 0] if self.channels == 1 else arr

    def pop(self, nticks: int) -> np.ndarray:
        """Consume up to ``nticks`` ticks; returns [k] or [k, channels]."""
        self._check_open()
        out = self._out(nticks)
        if self._handle is not None:
            k = int(
                self._lib.vw_rb_pop(
                    self._handle, out.ctypes.data_as(ctypes.c_void_p), nticks
                )
            )
        else:
            k = self._impl.pop(out)
        return self._squeeze(out[:k])

    def peek_latest(self, nticks: int) -> np.ndarray:
        """Copy the newest ticks without consuming (monitor semantics)."""
        self._check_open()
        out = self._out(nticks)
        if self._handle is not None:
            k = int(
                self._lib.vw_rb_peek_latest(
                    self._handle, out.ctypes.data_as(ctypes.c_void_p), nticks
                )
            )
        else:
            k = self._impl.peek_latest(out)
        return self._squeeze(out[:k])

    def pop_frames(
        self, frame_len: int, hop: int, max_frames: int = 2**31
    ) -> np.ndarray:
        """Assemble overlapping frames.

        Returns [k, frame_len] (channels==1) or [k, frame_len, channels]
        with k <= max_frames; consumes ``hop`` ticks per frame, so
        consecutive frames overlap by ``frame_len - hop`` ticks.
        """
        self._check_open()
        if not 1 <= hop <= frame_len:
            raise InvalidArgumentError(
                ErrorCode.CFG_INVALID_CONFIG,
                f"need 1 <= hop <= frame_len, got hop={hop} frame_len={frame_len}",
            )
        if frame_len > self.capacity:
            raise InvalidArgumentError(
                ErrorCode.VAL_TOO_LARGE,
                f"frame_len {frame_len} exceeds capacity {self.capacity}",
            )
        avail = self.available
        ready = 0 if avail < frame_len else 1 + (avail - frame_len) // hop
        k_alloc = min(max_frames, ready)
        out = np.empty((k_alloc, frame_len, self.channels), dtype=self.dtype)
        if k_alloc == 0:
            return self._squeeze(out)
        if self._handle is not None:
            k = int(
                self._lib.vw_rb_pop_frames(
                    self._handle,
                    out.ctypes.data_as(ctypes.c_void_p),
                    frame_len,
                    hop,
                    k_alloc,
                )
            )
        else:
            k = self._impl.pop_frames(out, frame_len, hop)
        return self._squeeze(out[:k])

    def close(self) -> None:
        """Release the buffer; further use raises ``InvalidStateError``."""
        if getattr(self, "_handle", None) is not None:
            self._lib.vw_rb_destroy(self._handle)
            self._handle = None
        self._impl = None
        self._closed = True

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


__all__ = ["RingBuffer", "native_available", "native_build_error"]
