"""Streaming wavelet denoiser with running noise estimation.

Counterpart of ``vectorwave_tpu/streaming/denoiser_stream.py`` (the
reference's ``MODWTStreamingDenoiser`` and the FAST/QUALITY implementations
of ``StreamingDenoiserFactory``): an explicit state and a per-block update,
plus a small class for tick-by-tick ergonomics.

Noise tracking mirrors the reference: level-1 detail coefficients of each
block are stratified-sampled into a fixed window; sigma = MAD(window)/0.6745
(or STD, or FIXED); the block is denoised with threshold ``sigma * sqrt(2 ln
W) * multiplier`` (divided by sqrt(2^j) at level j) and reconstructed.

Two tiers, as in the JAX package:

* the plain tier streams the transform (:func:`.stream.modwt_stream_block`)
  and inverts each block with a zero boundary;
* the kernel tier runs each block as ONE launch of the fused denoise kernel
  in stream mode (:func:`..kernels.modwt_composite.denoise` with ``halo=``):
  the raw stream tail is the analysis's left halo and the synthesis is
  block-local.  :func:`streaming_denoise_blocks_kernel` runs K buffered
  blocks in one launch, equal bit for bit to K single steps.

Counters (``window_pos``, ``window_fill``, the transform's
``blocks_processed``) are Python ints: a CUDA scalar tested on every block
would wait for the card each time.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..convert import _device
from ..errors import ErrorCode, InvalidArgumentError
from ..kernels import modwt_composite
from ..kernels.modwt_fused import _check_precision, _kernel_filters
from ..ops.thresholds import apply_threshold, median_magnitude
from ..transforms.modwt import _resolve_discrete
from ..transforms.multilevel import MultiLevelMODWTResult, imodwt_multilevel
from .stream import (
    StreamingState,
    _tail,
    kernel_history_length,
    modwt_stream_block,
    resolve_tier,
    streaming_init,
    use_stream_kernel,
)

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


class StreamingDenoiserState(NamedTuple):
    transform: StreamingState
    noise_window: torch.Tensor  # [..., W] window of sampled |detail| values
    window_pos: int
    window_fill: int


def streaming_denoiser_init(
    wavelet,
    *,
    levels: int = 1,
    noise_window_size: int = 256,
    batch_shape: tuple[int, ...] = (),
    dtype=torch.float32,
    device="cuda",
) -> StreamingDenoiserState:
    """Initial plain-tier state on ``device`` (default: the card; without one
    it raises)."""
    dev = _device(device)
    return StreamingDenoiserState(
        transform=streaming_init(wavelet, levels, batch_shape=batch_shape,
                                 dtype=dtype, device=dev),
        noise_window=torch.zeros(tuple(batch_shape) + (noise_window_size,),
                                 dtype=dtype, device=dev),
        window_pos=0,
        window_fill=0,
    )


def _update_noise_window(window: torch.Tensor, pos: int, fill: int,
                         detail: torch.Tensor, samples: int = 16):
    """Stratified-sample |detail| into the noise window
    (``updateNoiseEstimation``): every (N/samples)-th coefficient.

    The window is a shift register (newest samples at the end), as in the
    JAX package: the oldest ``take`` samples drop out and the new ones are
    appended, which keeps the same multiset as the reference's cursor ring,
    so sigma is unchanged.  ``pos`` stays as the reference's cursor
    statistic.
    """
    n = detail.shape[-1]
    w = window.shape[-1]
    take = min(samples, n, w)
    stride = max(1, n // take)
    picks = detail[..., : take * stride : stride].abs()
    window = torch.cat([window[..., take:], picks.to(window.dtype)], dim=-1)
    return window, (pos + take) % w, min(fill + take, w)


def _unknown_estimator(noise_estimation: str) -> InvalidArgumentError:
    return InvalidArgumentError(
        ErrorCode.CFG_INVALID_CONFIG,
        f"Unknown noise estimation: {noise_estimation!r}",
        suggestions=("Use 'mad', 'std' or 'fixed'",),
    )


def _fixed_sigma_missing() -> InvalidArgumentError:
    return InvalidArgumentError(
        ErrorCode.CFG_INVALID_CONFIG,
        "noise_estimation='fixed' requires fixed_sigma",
    )


def streaming_denoise_block(
    state: StreamingDenoiserState,
    block,
    wavelet,
    *,
    boundary: str = "zero",
    threshold_mode: str = "soft",
    noise_estimation: str = "mad",
    threshold_multiplier: float = 1.0,
    fixed_sigma: float | None = None,
) -> tuple[StreamingDenoiserState, torch.Tensor]:
    """Denoise one block; returns (new_state, denoised_block)."""
    w = _resolve_discrete(wavelet)
    block = torch.as_tensor(block, device=state.noise_window.device)
    new_transform, coeffs = modwt_stream_block(state.transform, block, w,
                                               boundary=boundary)
    window, pos, fill = _update_noise_window(
        state.noise_window, state.window_pos, state.window_fill, coeffs.details[0]
    )
    est = noise_estimation.lower()
    if est == "mad":
        # the median over the whole window, in its dtype (``jnp.median``'s
        # linear interpolation): zeros of its unfilled part bias early
        # estimates low, like a warm-up
        sigma = torch.quantile(window, 0.5, dim=-1, keepdim=True) / 0.6745
    elif est == "std":
        sigma = torch.std(window, dim=-1, keepdim=True, correction=0)
    elif est == "fixed":
        if fixed_sigma is None:
            raise _fixed_sigma_missing()
        sigma = torch.as_tensor(fixed_sigma, dtype=block.dtype, device=block.device)
    else:
        raise _unknown_estimator(noise_estimation)
    w_size = state.noise_window.shape[-1]
    threshold = sigma * math.sqrt(2.0 * math.log(w_size)) * threshold_multiplier
    denoised_details = tuple(
        apply_threshold(d, threshold / math.sqrt(2.0**level), threshold_mode)
        for level, d in enumerate(coeffs.details, start=1)
    )
    denoised = imodwt_multilevel(
        MultiLevelMODWTResult(denoised_details, coeffs.approx), w, boundary="zero"
    )
    return StreamingDenoiserState(new_transform, window, pos, fill), denoised


# ---------------------------------------------------------------------------
# Kernel tier: analysis -> threshold -> synthesis as one fused kernel pass a
# block, with the raw stream tail as the analysis's external halo.
# ---------------------------------------------------------------------------


class KernelStreamingDenoiserState(NamedTuple):
    """Carry for :func:`streaming_denoise_block_kernel`: a raw-input tail
    (the analysis halo) plus the noise window; no per-level histories."""

    history: torch.Tensor  # [..., max(S, 1)] raw x before the next block
    noise_window: torch.Tensor  # [..., W] sampled |detail| values
    window_pos: int
    window_fill: int


def kernel_streaming_denoiser_init(
    wavelet,
    *,
    levels: int = 1,
    noise_window_size: int = 256,
    batch_shape: tuple[int, ...] = (),
    dtype=torch.float32,
    device="cuda",
) -> KernelStreamingDenoiserState:
    """Initial kernel-tier state on ``device`` (default: the card; without
    one it raises)."""
    span = kernel_history_length(wavelet, levels)
    dev = _device(device)
    return KernelStreamingDenoiserState(
        torch.zeros(tuple(batch_shape) + (max(span, 1),), dtype=dtype, device=dev),
        torch.zeros(tuple(batch_shape) + (noise_window_size,), dtype=dtype, device=dev),
        0,
        0,
    )


def _sampled_d1(history: torch.Tensor, block: torch.Tensor, w, take: int):
    """The stratified level-1 detail samples the noise window consumes,
    computed directly from raw x (history + block) with the scaled analysis
    taps: the values of ``coeffs.details[0][..., :take*stride:stride]`` of
    the plain streaming cascade, without computing the whole plane.

    When ``stride >= L`` (every production shape) the samples come from
    strided block slices plus L-1 history reads, with no ``[hist | block]``
    copy of the block.
    """
    hi = [float(v) * _INV_SQRT2 for v in w.dec_hi]
    length = len(hi)
    n = block.shape[-1]
    stride = max(1, n // take)
    if stride < length or take < 2:
        # tiny blocks: sample positions reach into the history
        hist_tail = history[..., history.shape[-1] - (length - 1):]
        x_cat = torch.cat([hist_tail, block], dim=-1)
        off = x_cat.shape[-1] - n
        acc = None
        for k, h in enumerate(hi):
            term = h * x_cat[..., off - k: off - k + (take - 1) * stride + 1: stride]
            acc = term if acc is None else acc + term
        return acc
    # d1[p] = sum_k hi[k] x[p - k]; p = 0 reads the history tail, every later
    # sample position (p = j*stride >= L-1) stays inside the block
    hlen = history.shape[-1]
    first = None
    rest = None
    for k, h in enumerate(hi):
        f = block[..., :1] if k == 0 else history[..., hlen - k: hlen - k + 1]
        first = h * f if first is None else first + h * f
        sl = block[..., stride - k: stride - k + (take - 2) * stride + 1: stride]
        rest = h * sl if rest is None else rest + h * sl
    return torch.cat([first, rest], dim=-1)


def _sigma_from_window(window, noise_estimation, fixed_sigma, lead, dtype):
    est = noise_estimation.lower()
    if est == "mad":
        # median_magnitude: the JAX package's sort-free median, same value
        return median_magnitude(window) / 0.6745
    if est == "std":
        return torch.std(window, dim=-1, keepdim=True, correction=0)
    if est == "fixed":
        if fixed_sigma is None:
            raise _fixed_sigma_missing()
        return torch.full(tuple(lead) + (1,), fixed_sigma, dtype=dtype,
                          device=window.device)
    raise _unknown_estimator(noise_estimation)


def _level_thresholds(threshold: torch.Tensor, levels: int, rows: int) -> torch.Tensor:
    """[rows, levels] float32 thresholds, threshold / sqrt(2^j) at level j."""
    return torch.cat(
        [(threshold / math.sqrt(2.0**level)).reshape(rows, 1)
         for level in range(1, levels + 1)],
        dim=-1,
    ).to(torch.float32).contiguous()


def _check_mode(threshold_mode: str) -> str:
    mode = threshold_mode.lower()
    if mode not in ("soft", "hard"):
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"Unknown threshold type: {threshold_mode!r}",
            suggestions=("Use 'soft' or 'hard'",),
        )
    return mode


def _denoise(x2, halo2, ths, levels, w, mode, backend):
    """One fused denoise of the rows x2, their halos halo2: the kernel's
    stream mode or its plain version, as :func:`.stream.use_stream_kernel`
    routes."""
    fits = modwt_composite.denoise_tile(w.filter_length, levels) is not None
    run = (modwt_composite.denoise if use_stream_kernel(x2, backend, fits)
           else modwt_composite.denoise_plain)
    return run(x2, ths, levels, _kernel_filters(w, synthesis=False),
               _kernel_filters(w, synthesis=True), False, mode,
               halo2.to(x2.dtype).contiguous())


def streaming_denoise_block_kernel(
    state: KernelStreamingDenoiserState,
    block,
    wavelet,
    *,
    levels: int,
    threshold_mode: str = "soft",
    noise_estimation: str = "mad",
    threshold_multiplier: float = 1.0,
    fixed_sigma: float | None = None,
    precision: str | None = None,
    backend: str | None = None,
) -> tuple[KernelStreamingDenoiserState, torch.Tensor]:
    """Kernel-tier streaming denoise step (zero boundary): one fused
    analysis -> threshold -> synthesis launch per block.

    Semantics match :func:`streaming_denoise_block` with ``boundary='zero'``
    up to kernel precision: the analysis is continuous over the stream via
    the raw-x carry, the noise window sees the same stratified level-1
    samples, and the reconstruction zero-extends the block's coefficients.
    ``backend`` routes as :func:`.stream.use_stream_kernel` says (the plain
    version has the same state layout and results).
    """
    _check_precision(precision)
    mode = _check_mode(threshold_mode)
    w = _resolve_discrete(wavelet)
    block = torch.as_tensor(block, device=state.history.device)
    lead, n = block.shape[:-1], block.shape[-1]
    block2 = block.reshape(-1, n).contiguous()
    keep = state.history.shape[-1]
    hist2 = state.history.reshape(-1, keep)

    take = min(16, n, state.noise_window.shape[-1])
    d1_sub = _sampled_d1(hist2, block2, w, take).reshape(lead + (take,))
    window, pos, fill = _update_noise_window(
        state.noise_window, state.window_pos, state.window_fill, d1_sub
    )
    sigma = _sigma_from_window(window, noise_estimation, fixed_sigma, lead, block.dtype)
    w_size = state.noise_window.shape[-1]
    threshold = sigma * math.sqrt(2.0 * math.log(w_size)) * threshold_multiplier
    ths = _level_thresholds(threshold, levels, block2.shape[0])

    out2 = _denoise(block2, hist2, ths, levels, w, mode, backend)
    new_hist = _tail(hist2, block2.to(hist2.dtype), keep)
    new_state = KernelStreamingDenoiserState(
        new_hist.reshape(lead + (keep,)), window, pos, fill
    )
    return new_state, out2.reshape(lead + (n,))


def streaming_denoise_blocks_kernel(
    state: KernelStreamingDenoiserState,
    blocks,  # [K, ..., block]
    wavelet,
    *,
    levels: int,
    threshold_mode: str = "soft",
    noise_estimation: str = "mad",
    threshold_multiplier: float = 1.0,
    fixed_sigma: float | None = None,
    precision: str | None = None,
    backend: str | None = None,
) -> tuple[KernelStreamingDenoiserState, torch.Tensor]:
    """K buffered blocks in ONE fused kernel launch, equal bit for bit to K
    sequential :func:`streaming_denoise_block_kernel` steps.

    The carry is the RAW-INPUT tail, never an output: block i's pass depends
    only on block i-1's last S raw samples.  With K blocks in hand the K
    denoise passes are independent; only the noise-window / sigma chain is
    sequential, a Python loop of K small steps here (``lax.scan`` in the
    JAX package).  Then one ``[K*B, block]`` launch, each row's halo the tail
    of the block before it.

    Blocks shorter than the span (a tail then crosses two blocks), or K = 1,
    take the sequential steps.  Reference contract: the buffered-batch
    semantics of ``BatchStreamingMODWT.java:181-258`` and the streaming
    denoiser ``MODWTStreamingDenoiser.java:94-199``.
    """
    kwargs = dict(
        levels=levels, threshold_mode=threshold_mode,
        noise_estimation=noise_estimation,
        threshold_multiplier=threshold_multiplier,
        fixed_sigma=fixed_sigma, precision=precision, backend=backend,
    )
    blocks = torch.as_tensor(blocks, device=state.history.device)
    k = blocks.shape[0]
    lead, n = blocks.shape[1:-1], blocks.shape[-1]
    span = state.history.shape[-1]
    if n < span or k == 1:
        outs = []
        for i in range(k):
            state, out = streaming_denoise_block_kernel(state, blocks[i], wavelet,
                                                        **kwargs)
            outs.append(out)
        return state, torch.stack(outs)

    _check_precision(precision)
    mode = _check_mode(threshold_mode)
    w = _resolve_discrete(wavelet)
    blocks2 = blocks.reshape(k, -1, n)
    b2 = blocks2.shape[1]
    # per-block halos: block 0 takes the state's history, block i > 0 the
    # tail of block i-1 (n >= span, so one predecessor suffices)
    hists2 = torch.cat(
        [state.history.reshape(1, -1, span).to(blocks.dtype),
         blocks2[:-1, :, n - span:]],
        dim=0,
    )
    take = min(16, n, state.noise_window.shape[-1])
    d1_all = _sampled_d1(
        hists2.reshape(k * b2, span), blocks2.reshape(k * b2, n), w, take
    ).reshape((k,) + lead + (take,))

    window, pos, fill = state.noise_window, state.window_pos, state.window_fill
    sigmas = []
    for i in range(k):
        window, pos, fill = _update_noise_window(window, pos, fill, d1_all[i])
        sigmas.append(_sigma_from_window(window, noise_estimation, fixed_sigma, lead,
                                         blocks.dtype))
    w_size = state.noise_window.shape[-1]
    threshold = (torch.stack(sigmas) * math.sqrt(2.0 * math.log(w_size))
                 * threshold_multiplier)  # [K, ..., 1]
    ths = _level_thresholds(threshold, levels, k * b2)

    out2 = _denoise(blocks2.reshape(k * b2, n), hists2.reshape(k * b2, span), ths,
                    levels, w, mode, backend)
    new_state = KernelStreamingDenoiserState(
        blocks2[-1, :, n - span:].reshape(lead + (span,)).to(state.history.dtype)
        .contiguous(),
        window, pos, fill,
    )
    return new_state, out2.reshape((k,) + lead + (n,))


class StreamingDenoiser:
    """Convenience wrapper with reference-like ergonomics
    (``MODWTStreamingDenoiser.Builder``): holds the state and exposes
    ``denoise(samples)``; FAST = 1 level, QUALITY = 4 levels
    (``StreamingDenoiserFactory.Implementation``).

    ``backend``: ``auto`` (default) takes the fused kernel tier for the zero
    boundary in float32 on a Hopper card, the plain tier elsewhere;
    ``kernel`` / ``torch`` (aliases ``pallas`` / ``jnp``) force one, and
    ``kernel`` raises for what the kernel tier does not serve.  The state
    lives on ``device`` (default: the card; without one it raises).
    """

    def __init__(
        self,
        wavelet="db4",
        *,
        implementation: str = "fast",
        levels: int | None = None,
        boundary: str = "zero",
        noise_window_size: int = 256,
        threshold_mode: str = "soft",
        noise_estimation: str = "mad",
        threshold_multiplier: float = 1.0,
        dtype=torch.float32,
        backend: str | None = None,
        device="cuda",
    ) -> None:
        if levels is None:
            levels = 1 if implementation.lower() == "fast" else 4
        self.wavelet = _resolve_discrete(wavelet)
        self.boundary = boundary
        self.threshold_mode = threshold_mode
        self.noise_estimation = noise_estimation
        self.threshold_multiplier = threshold_multiplier
        self.levels = levels
        self._dtype = dtype
        self._window_size = noise_window_size
        self.device = _device(device)
        kernel_ok = dtype == torch.float32 and boundary.lower() in ("zero",
                                                                    "zero_padding")
        self._use_kernel, self._step_backend = resolve_tier(backend, self.device, dtype,
                                                            kernel_ok)
        if self._step_backend == "kernel" and not kernel_ok:
            # the fused streaming kernel serves the zero boundary in float32
            raise InvalidArgumentError(
                ErrorCode.CFG_UNSUPPORTED_BOUNDARY,
                "backend='kernel' streaming denoise serves the zero boundary "
                f"in float32 (got boundary={boundary!r}, dtype={dtype})",
                suggestions=("Use boundary='zero' with float32, or backend='torch'",),
            )
        #: the RESOLVED backend, ``'kernel'`` or ``'torch'``.  Under ``auto``
        #: it differs per environment, and so does the state layout
        #: (KernelStreamingDenoiserState's raw-input tail against
        #: StreamingDenoiserState's per-level histories): a checkpoint
        #: restores only onto an instance resolved to the same backend.
        self.backend = "kernel" if self._use_kernel else "torch"
        self.reset()

    def _init(self):
        init = (kernel_streaming_denoiser_init if self._use_kernel
                else streaming_denoiser_init)
        return init(self.wavelet, levels=self.levels,
                    noise_window_size=self._window_size, dtype=self._dtype,
                    device=self.device)

    @property
    def state(self):
        """The streaming state (checkpoint/restore surface)."""
        return self._state

    @state.setter
    def state(self, value):
        expected = (KernelStreamingDenoiserState if self._use_kernel
                    else StreamingDenoiserState)
        if not isinstance(value, expected):
            raise InvalidArgumentError(
                ErrorCode.CFG_INVALID_CONFIG,
                f"State layout {type(value).__name__} does not match this "
                f"denoiser's resolved backend {self.backend!r} (expected "
                f"{expected.__name__}). Checkpoints written under "
                "backend='auto' carry the layout of the environment that "
                "wrote them.",
                suggestions=(
                    "Construct StreamingDenoiser(backend="
                    f"{'torch' if self._use_kernel else 'kernel'!r}) to match "
                    "the checkpoint, or re-init and replay.",
                ),
            )
        self._state = value

    def denoise(self, samples) -> torch.Tensor:
        block = torch.as_tensor(samples, dtype=self._dtype, device=self.device)
        if self._use_kernel:
            self.state, out = streaming_denoise_block_kernel(
                self.state, block, self.wavelet, levels=self.levels,
                threshold_mode=self.threshold_mode,
                noise_estimation=self.noise_estimation,
                threshold_multiplier=self.threshold_multiplier,
                backend=self._step_backend,
            )
        else:
            self.state, out = streaming_denoise_block(
                self.state, block, self.wavelet, boundary=self.boundary,
                threshold_mode=self.threshold_mode,
                noise_estimation=self.noise_estimation,
                threshold_multiplier=self.threshold_multiplier,
            )
        self.samples_processed += int(out.shape[-1])
        self.blocks_processed += 1
        return out

    def reset(self) -> None:
        self.state = self._init()
        self.samples_processed = 0
        self.blocks_processed = 0

    @property
    def statistics(self) -> dict:
        """Samples/blocks counters (MODWTStreamingTransformImpl LongAdder stats)."""
        return {
            "samples_processed": self.samples_processed,
            "blocks_processed": self.blocks_processed,
        }
