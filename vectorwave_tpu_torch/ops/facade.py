"""FFT-versus-direct routing of the MODWT convolutions.

Counterpart of ``should_use_fft`` in ``vectorwave_tpu/ops/facade.py``.  The
thresholds are the JAX package's: the rolled form never touches the à trous
zeros, so only the base tap count matters.  They were measured on a TPU and
stay until a measurement on the GPU moves them.
"""

from __future__ import annotations

FFT_MIN_SIGNAL = 1024
FFT_MIN_TAPS = 64


def should_use_fft(signal_length: int, base_filter_length: int) -> bool:
    """Whether the periodic MODWT convolution takes the FFT path."""
    return base_filter_length >= FFT_MIN_TAPS and signal_length >= FFT_MIN_SIGNAL
