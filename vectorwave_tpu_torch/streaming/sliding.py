"""Overlapping sliding-window streaming MODWT.

Counterpart of ``vectorwave_tpu/streaming/sliding.py`` (the reference's
``MODWTStreamingTransformImpl.java:45-120`` and
``MultiLevelMODWTStreamingTransform.java:169-203`` ``processSample``):

* a buffer of ``buffer_size`` samples keeps an overlap of ``filter_length -
  1`` (single level) or ``(L0-1)*(2^J - 1)`` (multi-level) samples in place
  between transforms;
* each transform consumes ``buffer_size - overlap`` NEW samples and emits
  coefficients for the full window, so consecutive windows share the
  overlap and interior coefficients are continuous;
* ``process_sample`` feeds one sample at a time, emitting a window result
  whenever the buffer fills.

A transition function ``state, new_samples -> state, window_coefficients``
and a thin stateful wrapper.  The window transform is :func:`modwt` or
:func:`modwt_multilevel`, which route by shape as everywhere in the port
(a 512-sample window takes the plain path).  The reference's 100 MB buffer
cap is kept as a validation guard.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..convert import _device
from ..errors import ErrorCode, InvalidArgumentError
from ..kernels.modwt_fused import total_halo
from ..transforms.modwt import MODWTResult, _resolve_discrete, modwt
from ..transforms.multilevel import MultiLevelMODWTResult, modwt_multilevel

#: reference cap: MAX_BUFFER_SIZE bounded so the window stays under 100 MB
_MAX_BUFFER_BYTES = 100 * 1024 * 1024


class SlidingWindowState(NamedTuple):
    """Carry: the current window contents plus fill accounting."""

    window: torch.Tensor  # [..., buffer_size]
    samples_seen: int  # total pushed, for readiness


def sliding_init(
    buffer_size: int,
    *,
    batch_shape: tuple[int, ...] = (),
    dtype=torch.float32,
    device="cuda",
) -> SlidingWindowState:
    """An empty window of ``buffer_size`` samples on ``device`` (default:
    the card; without one it raises)."""
    if buffer_size < 2:
        raise InvalidArgumentError(
            ErrorCode.VAL_TOO_SHORT,
            f"buffer_size must be >= 2, got {buffer_size}",
        )
    nbytes = buffer_size * torch.empty((), dtype=dtype).element_size()
    for dim in batch_shape:
        nbytes *= dim
    if nbytes > _MAX_BUFFER_BYTES:
        raise InvalidArgumentError(
            ErrorCode.VAL_TOO_LARGE,
            f"Sliding window of {nbytes} bytes exceeds the 100 MB cap",
            suggestions=("Reduce buffer_size or batch size",),
        )
    return SlidingWindowState(
        torch.zeros(tuple(batch_shape) + (buffer_size,), dtype=dtype,
                    device=_device(device)),
        0,
    )


def sliding_push(state: SlidingWindowState, new_samples) -> SlidingWindowState:
    """Shift ``k`` new samples into the window (oldest fall off the left)."""
    new_samples = torch.as_tensor(new_samples, dtype=state.window.dtype,
                                  device=state.window.device)
    k = new_samples.shape[-1]
    buffer_size = state.window.shape[-1]
    if k > buffer_size:
        new_samples = new_samples[..., -buffer_size:]
        k = buffer_size
    window = torch.cat([state.window[..., k:], new_samples], dim=-1)
    return SlidingWindowState(window, state.samples_seen + k)


def sliding_step(
    state: SlidingWindowState,
    new_samples,
    wavelet,
    *,
    boundary: str = "periodic",
) -> tuple[SlidingWindowState, MODWTResult]:
    """Push ``buffer_size - overlap`` new samples and transform the window.

    With ``new_samples`` of length ``step_size(...)``, consecutive calls
    reproduce the reference's consume/overlap cycle; the emitted
    coefficients cover the whole window, the overlap included.
    """
    state = sliding_push(state, new_samples)
    return state, modwt(state.window, wavelet, boundary=boundary)


def sliding_step_multilevel(
    state: SlidingWindowState,
    new_samples,
    wavelet,
    *,
    levels: int,
    boundary: str = "periodic",
) -> tuple[SlidingWindowState, MultiLevelMODWTResult]:
    """Multi-level window transform per push (processSample-cycle analogue)."""
    state = sliding_push(state, new_samples)
    return state, modwt_multilevel(
        state.window, wavelet, levels=levels, boundary=boundary
    )


def step_size(buffer_size: int, wavelet, *, levels: int = 1) -> int:
    """New samples consumed per transform: buffer_size - overlap, where
    overlap = filterLen-1 for a single level and the cumulative cascade halo
    (L0-1)*(2^J - 1) for multi-level windows."""
    w = _resolve_discrete(wavelet)
    overlap = total_halo(w.filter_length, levels)
    if overlap >= buffer_size:
        raise InvalidArgumentError(
            ErrorCode.VAL_TOO_SHORT,
            f"buffer_size {buffer_size} must exceed the overlap {overlap}",
            suggestions=("Increase buffer_size or reduce levels",),
        )
    return buffer_size - overlap


class SlidingStreamingTransform:
    """Stateful wrapper with the reference's streaming ergonomics:
    ``process`` (arbitrary-length sample arrays), ``process_sample``,
    ``flush``, ``reset``, ``statistics``.

    Emits one window result per ``buffer_size - overlap`` new samples, the
    first once the buffer has filled (MODWTStreamingTransformImpl.java:45-120).
    The window lives on ``device`` (default: the card; without one it
    raises).
    """

    def __init__(
        self,
        wavelet="db4",
        *,
        buffer_size: int = 512,
        levels: int = 1,
        boundary: str = "periodic",
        batch_shape: tuple[int, ...] = (),
        dtype=torch.float32,
        device="cuda",
    ) -> None:
        self.wavelet = _resolve_discrete(wavelet)
        self.levels = levels
        self.boundary = boundary
        self.buffer_size = buffer_size
        self.step = step_size(buffer_size, self.wavelet, levels=levels)
        self.overlap = buffer_size - self.step
        self._batch_shape = tuple(batch_shape)
        self._dtype = dtype
        self.device = _device(device)
        self.reset()

    def _xform(self, state, block):
        if self.levels == 1:
            return sliding_step(state, block, self.wavelet, boundary=self.boundary)
        return sliding_step_multilevel(state, block, self.wavelet, levels=self.levels,
                                       boundary=self.boundary)

    def _drain(self, results: list) -> None:
        while self._pending_count >= self._need:
            chunk = torch.cat(self._pending, dim=-1)
            block, rest = chunk[..., : self._need], chunk[..., self._need :]
            self._pending = [rest] if rest.shape[-1] else []
            self._pending_count = int(rest.shape[-1])
            self.state, coeffs = self._xform(self.state, block)
            self._need = self.step  # subsequent cycles keep the overlap
            self.windows_emitted += 1
            results.append(coeffs)

    def process(self, samples) -> list:
        """Feed an arbitrary-length sample array; returns the list of window
        results that became ready (possibly empty)."""
        samples = torch.as_tensor(samples, dtype=self._dtype, device=self.device)
        self._pending.append(samples)
        self._pending_count += samples.shape[-1]
        self.samples_processed += int(samples.shape[-1])
        results: list = []
        self._drain(results)
        return results

    def process_sample(self, sample):
        """Feed ONE sample; returns the window result if the cycle completed,
        else None (``processSample``)."""
        arr = torch.as_tensor(sample, dtype=self._dtype, device=self.device).reshape(
            self._batch_shape + (1,)
        )
        out = self.process(arr)
        return out[-1] if out else None

    def flush(self):
        """Zero-pad the partial cycle and emit a final window (``flush``)."""
        if self._pending_count == 0:
            return None
        pad = self._need - self._pending_count
        zeros = torch.zeros(self._batch_shape + (pad,), dtype=self._dtype,
                            device=self.device)
        before = self.samples_processed  # padding is not real input
        results = self.process(zeros)
        self.samples_processed = before
        return results[-1] if results else None

    def reset(self) -> None:
        self.state = sliding_init(self.buffer_size, batch_shape=self._batch_shape,
                                  dtype=self._dtype, device=self.device)
        self._pending: list = []
        self._pending_count = 0
        self._need = self.buffer_size  # the first cycle fills the whole buffer
        self.samples_processed = 0
        self.windows_emitted = 0

    @property
    def statistics(self) -> dict:
        return {
            "samples_processed": self.samples_processed,
            "windows_emitted": self.windows_emitted,
            "buffer_size": self.buffer_size,
            "overlap": self.overlap,
        }
