"""The MODWT convolution entry points, their FFT-versus-direct routing and
the platform report.

Counterpart of ``vectorwave_tpu/ops/facade.py``: ``circular_convolve_modwt``,
``zero_padding_convolve_modwt`` and ``symmetric_convolve_modwt`` (the
``WaveletOperations`` entry points of the Java reference), ``should_use_fft``
and ``get_performance_info``.  The rolled form never touches the à trous
zeros, so only the base tap count and the signal length matter.  CPU
tensors keep the JAX package's thresholds, so that the CPU parity tests
compare the same route; CUDA tensors take the crossover measured on the
card (``tools/sweep_gates.py fft``).
"""

from __future__ import annotations

import dataclasses
import platform

import numpy as np
import torch

from .convolve import atrous_convolve, fft_circular_convolve

#: the JAX package's thresholds, for CPU tensors
FFT_MIN_SIGNAL = 1024
FFT_MIN_TAPS = 64
#: CUDA tensors.  ``tools/sweep_gates.py fft`` on an NVIDIA H100 80GB HBM3
#: at 700.00 W: with each filter's spectrum computed once
#: (``convolve._filter_spectrum``), the FFT pair beats the rolled one in all
#: 312 swept cases, from db4's 8 taps and N = 256 (the smallest swept) to
#: db38's 76 taps and N = 2^20, batch 1 and 128, float32 and float64, by
#: 1.32x at the least (0.13-11.95 ms against 0.37-278.85 ms); the two differ
#: by at most 3.3e-6 in float32 and 6.2e-15 in float64.  On a first call
#: (``tools/sweep_gates.py fft_cold``, every spectrum made on the card) the
#: pair still won all 84 cases from 8 taps and 256 samples to 2^20 (0.20-0.87
#: ms against 0.30-21.95 ms), and J = 10 cascades 19 of 20 (db4 at 1 x 2^20
#: float32 lost, 4.79 against 4.72 ms) and all 4 runs of two wavelets at two
#: sizes that overflow the spectra's cache (9.15-19.52 ms against
#: 27.01-84.77 ms).
CUDA_FFT_MIN_SIGNAL = 256
CUDA_FFT_MIN_TAPS = 8


def should_use_fft(signal_length: int, base_filter_length: int, device=None) -> bool:
    """Whether the periodic MODWT convolution takes the FFT path, for a
    tensor on ``device`` (default the CPU: the JAX package's thresholds)."""
    if device is not None and torch.device(device).type == "cuda":
        return base_filter_length >= CUDA_FFT_MIN_TAPS and signal_length >= CUDA_FFT_MIN_SIGNAL
    return base_filter_length >= FFT_MIN_TAPS and signal_length >= FFT_MIN_SIGNAL


def circular_convolve_modwt(x: torch.Tensor, filt, *, spacing: int = 1) -> torch.Tensor:
    """Periodic MODWT convolution, on the FFT path where
    :func:`should_use_fft` takes ``x``'s length and the filter's taps on
    ``x``'s device, else rolled."""
    filt = np.asarray(filt)
    if should_use_fft(x.shape[-1], len(filt), device=x.device):
        return fft_circular_convolve(x, filt, spacing=spacing, sign=-1)
    return atrous_convolve(x, filt, spacing=spacing, boundary="periodic", sign=-1)


def zero_padding_convolve_modwt(x: torch.Tensor, filt, *, spacing: int = 1) -> torch.Tensor:
    """Zero-extension MODWT convolution."""
    return atrous_convolve(x, filt, spacing=spacing, boundary="zero", sign=-1)


def symmetric_convolve_modwt(x: torch.Tensor, filt, *, spacing: int = 1) -> torch.Tensor:
    """Symmetric-extension MODWT convolution."""
    return atrous_convolve(x, filt, spacing=spacing, boundary="symmetric", sign=-1)


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
