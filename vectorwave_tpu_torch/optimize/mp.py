"""Matching pursuit over a continuous-wavelet dictionary (Mallat-Zhang).

Counterpart of ``vectorwave_tpu/optimize/mp.py``: greedy decomposition of a
signal into a few wavelet atoms ``x ~ sum_k c_k psi_{s_k}(t - tau_k)``.
Each step picks the atom with the largest normalized correlation against
the residual, subtracts its projection and repeats; the residual energy
falls monotonically.

* All correlations at once: one ``irfft(rfft(res) * conj(bank))`` gives
  ``<res, atom(s, tau)>`` for every scale and shift (the periodic CWT as the
  search engine), ``[B, S, N]`` a step.
* The atom is synthesized in the frequency domain, ``irfft(rfft(row) *
  phase(tau))``, with the phase's ``k tau`` reduced modulo N in integers
  first, so float32 keeps it exact.
* The steps run as a Python loop of tensor operations on the input's
  device, writing each step's outputs into preallocated ``[B, steps]``
  tensors.

Periodic boundary (the dictionary is circularly shifted); real wavelets
only (mexh, gausN, dog, morl...).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..errors import ErrorCode, InvalidArgumentError
from ..transforms.cwt import _resolve_continuous, _sample_bank, validate_scales

__all__ = ["MPResult", "matching_pursuit"]


class MPResult(NamedTuple):
    """Greedy decomposition: per-step atom parameters plus the split signal.

    ``scale_indices``/``shifts``/``coeffs`` are ``[..., steps]`` (the
    coefficient of the UNIT-NORM atom); ``energies`` is the residual energy
    after each step; ``approx + residual == x`` to machine precision.
    """

    scale_indices: torch.Tensor
    shifts: torch.Tensor
    coeffs: torch.Tensor
    energies: torch.Tensor
    approx: torch.Tensor
    residual: torch.Tensor
    scales: tuple

    def atom_scales(self) -> torch.Tensor:
        """Selected scale values ``[..., steps]`` (from ``scale_indices``)."""
        grid = torch.as_tensor(np.asarray(self.scales), device=self.scale_indices.device)
        return grid[self.scale_indices.long()]


def matching_pursuit(
    x: torch.Tensor,
    scales,
    wavelet="mexh",
    *,
    steps: int = 32,
) -> MPResult:
    """Run ``steps`` greedy iterations of matching pursuit on ``[..., N]``."""
    w = _resolve_continuous(wavelet)
    scales = validate_scales(scales)
    if steps < 1:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG, f"steps must be >= 1, got {steps}"
        )
    if x.ndim < 1 or x.shape[-1] < 2:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"matching_pursuit needs [..., N>=2] input, got {tuple(x.shape)}",
        )
    n = x.shape[-1]
    bank_np, is_complex = _sample_bank(w, scales, n)
    if is_complex:
        raise InvalidArgumentError(
            ErrorCode.CFG_UNSUPPORTED_WAVELET,
            f"matching_pursuit needs a REAL wavelet, got '{w.name}'",
            suggestions=("Use mexh, gaus1-8, dog, or morl",),
        )
    bank_np = bank_np.real
    norms_np = np.linalg.norm(bank_np, axis=-1)
    if (norms_np < 1e-30).any():
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            "dictionary contains a zero-norm atom (scale too small for psi)",
        )

    real_dtype = (torch.float32 if x.dtype in (torch.float32, torch.float16, torch.bfloat16)
                  else torch.float64)
    complex_dtype = torch.complex128 if real_dtype == torch.float64 else torch.complex64
    dev = x.device
    lead = x.shape[:-1]
    xb = x.to(real_dtype).reshape(-1, n)
    batch = xb.shape[0]
    n_scales = len(scales)

    spec = torch.as_tensor(np.fft.rfft(bank_np, axis=-1), dtype=complex_dtype, device=dev)
    spec_conj = torch.conj(spec)
    norms = torch.as_tensor(norms_np, dtype=real_dtype, device=dev)
    k_freq = torch.arange(n // 2 + 1, device=dev)  # rfft bin index

    res, approx = xb.clone(), torch.zeros_like(xb)
    s_arr = torch.empty((batch, steps), dtype=torch.int32, device=dev)
    t_arr = torch.empty((batch, steps), dtype=torch.int32, device=dev)
    c_arr = torch.empty((batch, steps), dtype=real_dtype, device=dev)
    e_arr = torch.empty((batch, steps), dtype=real_dtype, device=dev)
    rows = torch.arange(batch, device=dev)
    for k in range(steps):
        corr = torch.fft.irfft(torch.fft.rfft(res, dim=-1)[:, None, :] * spec_conj, n=n,
                               dim=-1)  # [B, S, N]: <res, row shifted by tau>
        flat = (corr / norms[:, None]).reshape(batch, n_scales * n)  # unit-atom correlation
        idx = flat.abs().argmax(dim=-1)  # [B]
        s_idx, tau = idx // n, idx % n
        coeff = flat[rows, idx]
        # unit atom at (s_idx, tau): its row circularly shifted by tau
        angle = (-2.0 * math.pi / n) * ((k_freq[None, :] * tau[:, None]) % n).to(real_dtype)
        atom = torch.fft.irfft(spec[s_idx] * torch.polar(torch.ones_like(angle), angle), n=n,
                               dim=-1) / norms[s_idx][:, None]
        update = coeff[:, None] * atom
        res = res - update
        approx = approx + update
        s_arr[:, k] = s_idx
        t_arr[:, k] = tau
        c_arr[:, k] = coeff
        e_arr[:, k] = (res**2).sum(dim=-1)
    return MPResult(
        s_arr.reshape(lead + (steps,)),
        t_arr.reshape(lead + (steps,)),
        c_arr.reshape(lead + (steps,)),
        e_arr.reshape(lead + (steps,)),
        approx.reshape(lead + (n,)),
        res.reshape(lead + (n,)),
        scales,
    )
