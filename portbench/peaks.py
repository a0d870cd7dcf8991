"""The table of peaks and a call's least time on the card.

Published peaks of one NVIDIA H100 SXM5 80GB (NVIDIA's data sheet, dense,
at its 700 W limit): 3.35 TB/s of HBM3, 67 TFLOP/s float32 and 34 TFLOP/s
float64 outside the tensor cores.  A roofline share is read against these
with the card's power limit printed beside it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"float32": 67e12, "float64": 34e12}


def least(work: dict) -> dict:
    """``work`` (``bytes``, ``flops`` and the ``dtype`` they run in) with the
    call's least time ``least_s``, the larger of its bytes over the memory
    bandwidth and its FLOPs over the peak of that dtype, and the ``bound``
    that set it."""
    t_bytes = work["bytes"] / HBM_BYTES_PER_S
    t_flops = work["flops"] / FLOPS_PER_S[work["dtype"]]
    bound = "bytes" if t_bytes >= t_flops else "flops"
    return {**work, "least_s": max(t_bytes, t_flops), "bound": bound}
