"""Streaming transforms of the port: block streaming with carried state,
overlapping sliding windows, ring-buffer ingest and the streaming denoiser
(the counterpart of ``vectorwave_tpu.streaming``, with the same names)."""

from .stream import (
    KernelStreamingState,
    StreamingState,
    StreamingTransform,
    kernel_history_length,
    kernel_streaming_init,
    modwt_stream_block,
    modwt_stream_block_kernel,
    modwt_stream_flush,
    streaming_init,
    suggest_flush_tail_length,
)
from .sliding import (
    SlidingStreamingTransform,
    SlidingWindowState,
    sliding_init,
    sliding_push,
    sliding_step,
    sliding_step_multilevel,
    step_size,
)
from .ingest import StreamIngest
from .denoiser_stream import (
    KernelStreamingDenoiserState,
    StreamingDenoiser,
    StreamingDenoiserState,
    kernel_streaming_denoiser_init,
    streaming_denoiser_init,
    streaming_denoise_block,
    streaming_denoise_block_kernel,
    streaming_denoise_blocks_kernel,
)

__all__ = [
    "StreamingState",
    "StreamingTransform",
    "streaming_init",
    "modwt_stream_block",
    "KernelStreamingState",
    "kernel_streaming_init",
    "kernel_history_length",
    "modwt_stream_block_kernel",
    "modwt_stream_flush",
    "suggest_flush_tail_length",
    "SlidingStreamingTransform",
    "SlidingWindowState",
    "sliding_init",
    "sliding_push",
    "sliding_step",
    "sliding_step_multilevel",
    "step_size",
    "StreamIngest",
    "StreamingDenoiserState",
    "KernelStreamingDenoiserState",
    "streaming_denoiser_init",
    "kernel_streaming_denoiser_init",
    "streaming_denoise_block",
    "streaming_denoise_block_kernel",
    "streaming_denoise_blocks_kernel",
    "StreamingDenoiser",
]
