"""Block-streaming MODWT with explicit carry state.

Counterpart of ``vectorwave_tpu/streaming/stream.py`` (the reference's
``MODWTStreamingTransformImpl``, ``MultiLevelMODWTStreamingTransform`` and
the extensions' ``BatchStreamingMODWT``): a transition function ``state,
block -> state, coefficients`` plus a stateful wrapper.

* The plain tier carries, per level j, the last ``(L0-1) * 2^(j-1)``
  samples of that level's input stream; negative convolution indices read
  from it, so the concatenated block outputs equal the whole-signal
  transform for the zero and symmetric boundaries.  The periodic boundary
  treats each block circularly and keeps no state, as the reference does.
* The kernel tier carries the last ``S = (L0-1)(2^J-1)`` RAW samples and
  feeds them to the analysis kernel as its external left halo
  (:func:`..kernels.modwt_composite.analysis` with ``halo=``): one launch a
  block.  For the symmetric boundary the first block also splices in the
  head of the plain symmetric cascade of its first S samples, in the same
  launch.

Counters (``blocks_processed``) are Python ints, not device scalars: a
branch on a CUDA scalar would wait for the card on every block.  The
functions that take a state run on the state's device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import get_backend, normalize_backend
from ..convert import _device
from ..errors import ErrorCode, InvalidArgumentError
from ..kernels import modwt_composite
from ..kernels.modwt_fused import (
    _check_precision,
    _kernel_boundary,
    _kernel_filters,
    kernel_available,
)
from ..kernels.modwt_symmetric import _symmetric_cascade
from ..ops.convolve import atrous_analysis_pair, effective_length
from ..transforms.modwt import _resolve_discrete
from ..transforms.multilevel import MultiLevelMODWTResult

_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


class StreamingState(NamedTuple):
    """Carry: per-level left-history buffers (level-j input stream tails)."""

    histories: tuple[torch.Tensor, ...]
    blocks_processed: int  # first-block detection


def history_length(filter_length: int, level: int) -> int:
    """(L0-1) * 2^(j-1) = L_j - 1 (BatchStreamingMODWT.getHistoryLengthForLevel)."""
    return effective_length(filter_length, level) - 1


def suggest_flush_tail_length(wavelet, levels: int) -> int:
    """Tail needed to drain all levels (BatchStreamingMODWT.suggestFlushTailLength)."""
    w = _resolve_discrete(wavelet)
    return history_length(w.filter_length, levels)


def _check_levels(levels: int) -> None:
    if levels < 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL, f"levels must be >= 1, got {levels}"
        )


def streaming_init(
    wavelet,
    levels: int,
    *,
    batch_shape: tuple[int, ...] = (),
    dtype=torch.float32,
    device="cuda",
) -> StreamingState:
    """Zero-history initial state (zero-padding parity for the first block),
    on ``device`` (default: the card; without one it raises)."""
    _check_levels(levels)
    w = _resolve_discrete(wavelet)
    dev = _device(device)
    histories = tuple(
        torch.zeros(tuple(batch_shape) + (history_length(w.filter_length, j),),
                    dtype=dtype, device=dev)
        for j in range(1, levels + 1)
    )
    return StreamingState(histories, 0)


def _mirror_history(current: torch.Tensor, hist_len: int) -> torch.Tensor:
    """The symmetric first block's history: the reflections of the block
    head, tiled when the block is shorter than the history."""
    reps = -(-hist_len // max(current.shape[-1], 1))
    tiles, flip = [], True
    for _ in range(reps):
        tiles.append(torch.flip(current, dims=(-1,)) if flip else current)
        flip = not flip
    return torch.cat(tiles[::-1], dim=-1)[..., -hist_len:]


def modwt_stream_block(
    state: StreamingState,
    block,
    wavelet,
    *,
    boundary: str = "zero",
) -> tuple[StreamingState, MultiLevelMODWTResult]:
    """Process one block; returns (new_state, block coefficients).

    For ``zero``/``symmetric`` boundaries the concatenated per-block outputs
    equal the whole-signal transform (left-history contract).  For
    ``symmetric`` the reference mirrors the FIRST block into the history
    (``BatchStreamingMODWT.java:74-95``).  ``periodic`` treats each block
    circularly and keeps no state.
    """
    w = _resolve_discrete(wavelet)
    levels = len(state.histories)
    edge = _kernel_boundary(boundary, "streaming")
    low = w.dec_lo * _INV_SQRT2
    high = w.dec_hi * _INV_SQRT2
    current = torch.as_tensor(block, device=state.histories[0].device)

    if edge == "periodic":
        details = []
        for level in range(1, levels + 1):
            current, detail = atrous_analysis_pair(
                current, low, high, spacing=1 << (level - 1), boundary="periodic"
            )
            details.append(detail)
        new_state = StreamingState(state.histories, state.blocks_processed + 1)
        return new_state, MultiLevelMODWTResult(tuple(details), current)

    first = state.blocks_processed == 0
    details = []
    new_histories = []
    for level in range(1, levels + 1):
        hist_len = history_length(w.filter_length, level)
        history = state.histories[level - 1]
        if edge == "symmetric" and first and hist_len > 0:
            # whole-signal symmetric-extension parity at the stream start
            history = _mirror_history(current, hist_len)
        ext = torch.cat([history, current], dim=-1)
        approx, detail = atrous_analysis_pair(
            ext, low, high, spacing=1 << (level - 1), boundary="zero"
        )
        n_block = current.shape[-1]
        details.append(detail[..., -n_block:])
        new_histories.append(ext[..., ext.shape[-1] - hist_len:])
        current = approx[..., -n_block:]
    new_state = StreamingState(tuple(new_histories), state.blocks_processed + 1)
    return new_state, MultiLevelMODWTResult(tuple(details), current)


def modwt_stream_flush(
    state: StreamingState,
    wavelet,
    tail_length: int | None = None,
    *,
    boundary: str = "zero",
) -> tuple[StreamingState, MultiLevelMODWTResult]:
    """Drain the carried history by processing a zero tail
    (``flushMultiLevel``, BatchStreamingMODWT.java:181-258)."""
    levels = len(state.histories)
    if tail_length is None:
        tail_length = suggest_flush_tail_length(wavelet, levels)
    h0 = state.histories[0]
    zeros = torch.zeros(h0.shape[:-1] + (tail_length,), dtype=h0.dtype, device=h0.device)
    return modwt_stream_block(state, zeros, wavelet, boundary=boundary)


# ---------------------------------------------------------------------------
# Kernel tier: the analysis kernel with the carry as its external halo.  The
# whole-signal kernel computes every plane from x, so the carry is just the
# last S raw input samples, not per-level histories.
# ---------------------------------------------------------------------------


class KernelStreamingState(NamedTuple):
    """Carry for the kernel-tier stream: raw-input tail + block counter."""

    history: torch.Tensor  # [..., max(S, 1)] last raw samples seen
    blocks_processed: int


def kernel_history_length(wavelet, levels: int) -> int:
    """Cascade span: (L0-1)(2^J - 1) raw samples."""
    w = _resolve_discrete(wavelet)
    return modwt_composite.composite_halo_samples(w.filter_length, levels)


def kernel_streaming_init(
    wavelet,
    levels: int,
    *,
    batch_shape: tuple[int, ...] = (),
    dtype=torch.float32,
    device="cuda",
) -> KernelStreamingState:
    """Zero-history initial state for :func:`modwt_stream_block_kernel`, on
    ``device`` (default: the card; without one it raises)."""
    _check_levels(levels)
    span = kernel_history_length(wavelet, levels)
    return KernelStreamingState(
        torch.zeros(tuple(batch_shape) + (max(span, 1),), dtype=dtype,
                    device=_device(device)),
        0,
    )


def _kernel_tier(name: str, device: torch.device, dtype, servable: bool) -> bool:
    """The one routing rule of the streaming tiers, for a resolved backend
    ``name``: ``kernel`` takes the kernel tier, ``torch`` the plain one, and
    ``auto`` the kernel tier for float32 or bfloat16 on a Hopper card when
    the kernel can serve the shape (``servable``)."""
    if name != "auto":
        return name == "kernel"
    return (device.type == "cuda" and dtype in _KERNEL_DTYPES and servable
            and kernel_available())


def use_stream_kernel(x: torch.Tensor, backend: str | None, fits: bool) -> bool:
    """Whether a kernel-tier streaming step launches its kernel wrapper
    (True) or calls the plain version directly (False).

    ``backend`` (default: the configured one) routes by :func:`_kernel_tier`
    on ``x``, with ``fits`` whether the kernel's window fits shared memory:
    the wrapper on a CUDA tensor launches or raises and on a CPU tensor runs
    the plain version; under ``auto`` a shape it cannot serve takes the
    plain version before any launch."""
    name = get_backend() if backend is None else normalize_backend(backend)
    return _kernel_tier(name, x.device, x.dtype, fits)


def resolve_tier(backend: str | None, device: torch.device, dtype,
                 servable: bool = True) -> tuple[bool, str]:
    """A streaming class's tier, fixed at construction: (whether it takes
    the kernel tier, the ``backend`` its steps pass on).  ``None`` means
    ``auto``; a forced ``kernel`` stays forced in every step, so a shape
    the kernel cannot serve raises there."""
    name = "auto" if backend is None else normalize_backend(backend)
    return (_kernel_tier(name, device, dtype, servable),
            "kernel" if name == "kernel" else "auto")


def _tail(hist2: torch.Tensor, block2: torch.Tensor, keep: int) -> torch.Tensor:
    """The last ``keep`` samples of ``[hist2 | block2]``, contiguous."""
    n = block2.shape[-1]
    if n >= keep:
        return block2[:, n - keep:].contiguous()
    return torch.cat([hist2[:, n:], block2], dim=-1)


def modwt_stream_block_kernel(
    state: KernelStreamingState,
    block,
    wavelet,
    *,
    levels: int,
    boundary: str = "zero",
    precision: str | None = None,
    backend: str | None = None,
) -> tuple[KernelStreamingState, MultiLevelMODWTResult]:
    """Kernel-tier streaming step: (state, block) -> (state, coefficients).

    Semantics match :func:`modwt_stream_block` (concatenated block outputs
    equal the whole-signal transform for zero/symmetric; periodic is
    per-block circular), in one launch of the analysis kernel per block:
    the carry is the kernel's external left halo.  Not differentiable (the
    JAX kernel path has no VJP either); use :func:`modwt_stream_block` for
    gradients.

    ``symmetric``: the whole-signal transform mirrors the signal HEAD, so
    the first block's leading S outputs are spliced, in the same launch,
    from the plain symmetric cascade of the block's first S samples; the
    first block must be at least S samples long (every later block then
    lies beyond the mirror's reach, at any length).

    ``backend`` routes as :func:`use_stream_kernel` says; ``precision``
    names a tier, all of which run the same fp32 kernel.
    """
    _check_precision(precision)
    w = _resolve_discrete(wavelet)
    edge = _kernel_boundary(boundary, "streaming")
    filters = _kernel_filters(w, synthesis=False)
    block = torch.as_tensor(block, device=state.history.device)
    lead, n = block.shape[:-1], block.shape[-1]
    block2 = block.reshape(-1, n).contiguous()
    fits = modwt_composite.analysis_tile(w.filter_length, levels) is not None
    run = (modwt_composite.analysis if use_stream_kernel(block2, backend, fits)
           else modwt_composite.analysis_plain)

    if edge == "periodic":
        outs = run(block2, levels, filters, True)
        new_state = KernelStreamingState(state.history, state.blocks_processed + 1)
    else:
        span = modwt_composite.composite_halo_samples(w.filter_length, levels)
        keep = state.history.shape[-1]
        hist2 = state.history.reshape(-1, keep).to(block2.dtype).contiguous()
        head = None
        if edge == "symmetric" and state.blocks_processed == 0:
            if n < span:
                raise InvalidArgumentError(
                    ErrorCode.VAL_TOO_SHORT,
                    f"symmetric kernel streaming needs a first block of at least "
                    f"{span} samples (the filter span); got {n}",
                    suggestions=("Use a longer first block or modwt_stream_block "
                                 "(plain tier)",),
                )
            cd = modwt_composite._compute_dtype(block2)
            head = torch.stack(
                _symmetric_cascade(block2[:, :span].to(cd), filters, levels)
            ).contiguous()
        outs = run(block2, levels, filters, False, head, hist2)
        new_state = KernelStreamingState(
            _tail(hist2, block2, keep).reshape(lead + (keep,)).to(state.history.dtype),
            state.blocks_processed + 1,
        )
    details = tuple(o.reshape(lead + (n,)) for o in outs[:levels])
    return new_state, MultiLevelMODWTResult(details, outs[levels].reshape(lead + (n,)))


class StreamingTransform:
    """Stateful wrapper with reference-like ergonomics
    (``MODWTStreamingTransform`` / ``MultiLevelMODWTStreamingTransform``:
    process/flush/reset plus running statistics).  Holds the carry and
    steps it per block.

    ``backend``: ``auto`` (default) takes the kernel tier for float32 or
    bfloat16 on a Hopper card, the plain tier elsewhere; ``kernel`` /
    ``torch`` (aliases ``pallas`` / ``jnp``) force one.  The kernel state is
    a raw-input tail, the plain state per-level histories, chosen at
    construction (:attr:`backend` names the resolved one).  The state lives
    on ``device`` (default: the card; without one it raises).
    """

    def __init__(
        self,
        wavelet="db4",
        *,
        levels: int = 1,
        boundary: str = "zero",
        batch_shape: tuple[int, ...] = (),
        dtype=torch.float32,
        backend: str | None = None,
        device="cuda",
    ) -> None:
        self.wavelet = _resolve_discrete(wavelet)
        self.levels = levels
        self.boundary = boundary
        self._batch_shape = tuple(batch_shape)
        self._dtype = dtype
        self.device = _device(device)
        self._use_kernel, self._step_backend = resolve_tier(backend, self.device, dtype)
        #: the resolved tier, ``'kernel'`` or ``'torch'``
        self.backend = "kernel" if self._use_kernel else "torch"
        self.reset()

    def _init(self):
        init = kernel_streaming_init if self._use_kernel else streaming_init
        return init(self.wavelet, self.levels, batch_shape=self._batch_shape,
                    dtype=self._dtype, device=self.device)

    def _step(self, block: torch.Tensor) -> MultiLevelMODWTResult:
        if self._use_kernel:
            self.state, coeffs = modwt_stream_block_kernel(
                self.state, block, self.wavelet, levels=self.levels,
                boundary=self.boundary, backend=self._step_backend,
            )
        else:
            self.state, coeffs = modwt_stream_block(
                self.state, block, self.wavelet, boundary=self.boundary
            )
        return coeffs

    def process(self, block) -> MultiLevelMODWTResult:
        """Transform one block; returns its coefficients (``process``)."""
        coeffs = self._step(torch.as_tensor(block, dtype=self._dtype, device=self.device))
        self.samples_processed += int(coeffs.approx.shape[-1])
        self.blocks_processed += 1
        return coeffs

    def flush(self, tail_length: int | None = None) -> MultiLevelMODWTResult:
        """Drain the carried history (``flush``)."""
        if tail_length is None:
            tail_length = suggest_flush_tail_length(self.wavelet, self.levels)
        n_pad = tail_length
        if (self._use_kernel and _kernel_boundary(self.boundary, "streaming") == "symmetric"
                and self.state.blocks_processed == 0):
            # a first symmetric kernel block must cover the head splice
            n_pad = max(tail_length, kernel_history_length(self.wavelet, self.levels))
        zeros = torch.zeros(self._batch_shape + (n_pad,), dtype=self._dtype,
                            device=self.device)
        coeffs = self._step(zeros)
        if n_pad != tail_length:
            coeffs = MultiLevelMODWTResult(
                tuple(d[..., :tail_length] for d in coeffs.details),
                coeffs.approx[..., :tail_length],
            )
        self.blocks_processed += 1
        return coeffs

    def reset(self) -> None:
        """Clear all history (``reset``)."""
        self.state = self._init()
        self.samples_processed = 0
        self.blocks_processed = 0

    @property
    def statistics(self) -> dict:
        """Samples/blocks counters (the LongAdder statistics analogue)."""
        return {
            "samples_processed": self.samples_processed,
            "blocks_processed": self.blocks_processed,
        }
