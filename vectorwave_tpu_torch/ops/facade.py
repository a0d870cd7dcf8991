"""FFT-versus-direct routing of the MODWT convolutions and the platform
report.

Counterpart of ``should_use_fft`` and ``get_performance_info`` in
``vectorwave_tpu/ops/facade.py``.  The FFT thresholds are the JAX package's:
the rolled form never touches the à trous zeros, so only the base tap count
matters.  They were measured on a TPU and stay until a measurement on the
GPU moves them.
"""

from __future__ import annotations

import dataclasses
import platform

import torch

FFT_MIN_SIGNAL = 1024
FFT_MIN_TAPS = 64


def should_use_fft(signal_length: int, base_filter_length: int) -> bool:
    """Whether the periodic MODWT convolution takes the FFT path."""
    return base_filter_length >= FFT_MIN_TAPS and signal_length >= FFT_MIN_SIGNAL


@dataclasses.dataclass(frozen=True)
class PerformanceInfo:
    """Platform capability report: ``cuda_kernels`` says whether the
    hand-written CUDA kernels can run (the JAX report's ``pallas_kernels``)."""

    platform: str
    device_kind: str
    device_count: int
    cuda_kernels: bool
    description: str


def get_performance_info(device=None) -> PerformanceInfo:
    """Report the platform the port runs on: the CUDA card (its name, the
    count of cards, whether the kernels are available) or, on a machine
    without one, the CPU.  ``device`` picks one (``"cuda"`` raises without a
    card); by default the card if there is one, else the CPU."""
    from ..convert import _device
    from ..kernels.modwt_fused import kernel_available

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = _device(device)
    if dev.type == "cuda":
        kind = torch.cuda.get_device_name(dev)
        count = torch.cuda.device_count()
        kernels = kernel_available()
    else:
        kind = platform.processor() or platform.machine() or "cpu"
        count = 1
        kernels = False
    tier = ("hand-written CUDA kernels for Hopper" if kernels
            else "plain PyTorch (no kernel tier)")
    return PerformanceInfo(
        platform=dev.type,
        device_kind=kind,
        device_count=count,
        cuda_kernels=kernels,
        description=f"{count}x {kind} ({dev.type}); compute tier: {tier}",
    )
