"""Cross-wavelet analysis: XWT, coherence, phase synchronization, ridges.

Counterpart of ``vectorwave_tpu/transforms/xwt.py`` (Torrence & Compo 1998
conventions).  Coefficients are ``[..., S, N]`` tensors on the input's
device.

* The Torrence–Compo smoothing runs as one batched spectral multiply: the
  per-scale Gaussian time kernels ``exp(-t^2 / 2 s^2)`` have the spectrum
  ``exp(-2 (pi f s)^2)``, so smoothing every scale is ``irfft(rfft(P) *
  bank)``; the scale smoothing is a boxcar moving mean along the scale axis.
* The ridge is a Viterbi dynamic program over time.  Short signals run the
  plain forward pass and backtrack; long ones the blocked max-plus form of
  the JAX package (per-block transfer matrices grown for every block at
  once, a scan over the block edges, then the forward and backward scores
  inside the blocks, ``path = argmax(F + B)``).  Each step is a few tensor
  operations launched from a Python loop: at 32 scales x 65536 samples that
  is 128 grow steps, 512 edge steps each way and 128 expansion steps each
  way.
* Instantaneous frequency uses the wrap-free phase increment
  ``angle(W_{t+1} conj(W_t))``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..errors import ErrorCode, InvalidArgumentError
from .cwt import CWTResult, _resolve_continuous, cwt, validate_scales

__all__ = [
    "cross_wavelet",
    "wavelet_coherence",
    "CoherenceResult",
    "phase_synchronization",
    "instantaneous_frequency",
    "extract_ridge",
    "RidgeResult",
]


def _complex_cwt(x, scales, wavelet, boundary: str, method: str) -> CWTResult:
    """CWT with complex coefficients (the analytic path for real wavelets),
    so phases are meaningful."""
    w = _resolve_continuous(wavelet)
    analytic = not bool(getattr(w, "is_complex", False))
    return cwt(x, scales, w, method=method, analytic=analytic, boundary=boundary)


def cross_wavelet(
    x: torch.Tensor,
    y: torch.Tensor,
    scales: Sequence[float],
    wavelet="morl",
    *,
    boundary: str = "zero",
    method: str = "fft",
) -> CWTResult:
    """Cross-wavelet transform ``W_xy = W_x * conj(W_y)``.

    ``|W_xy|`` is the shared power; ``angle(W_xy)`` the relative phase of
    ``x`` vs ``y`` at each (scale, time).  Real wavelets are analyzed
    against their analytic (Hilbert) signals so the phase is well-defined.
    """
    if x.shape[-1] != y.shape[-1]:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"series lengths differ: {x.shape[-1]} vs {y.shape[-1]}",
        )
    scales = validate_scales(scales)
    wx = _complex_cwt(x, scales, wavelet, boundary, method)
    wy = _complex_cwt(y, scales, wavelet, boundary, method)
    return CWTResult(wx.coeffs * torch.conj(wy.coeffs), scales, boundary)


def _scale_spacing_octaves(scales: tuple[float, ...]) -> float:
    if len(scales) < 2:
        return 1.0
    djs = np.abs(np.diff(np.log2(np.asarray(scales))))
    dj = float(np.mean(djs))
    return dj if dj > 1e-12 else 1.0


def _box(f: torch.Tensor, width: int) -> torch.Tensor:
    """Moving mean of ``width`` rows along dim -2, edges extended by their
    own row (``jnp.pad(mode="edge")``)."""
    lo, hi = width // 2, (width - 1) // 2
    fp = torch.cat([f[..., :1, :].expand(*f.shape[:-2], lo, f.shape[-1]), f,
                    f[..., -1:, :].expand(*f.shape[:-2], hi, f.shape[-1])], dim=-2)
    c = torch.cumsum(fp, dim=-2)
    c = torch.cat([torch.zeros_like(c[..., :1, :]), c], dim=-2)
    return (c[..., width:, :] - c[..., :-width, :]) / width


def _smooth(
    field: torch.Tensor,
    scales: tuple[float, ...],
    *,
    scale_decorrelation: float = 0.6,
) -> torch.Tensor:
    """Torrence–Compo smoothing: per-scale Gaussian in time (spectral
    multiply, one batched FFT) then a boxcar across scales."""
    n = field.shape[-1]
    real_dtype = field.real.dtype if field.is_complex() else field.dtype
    dev = field.device
    # the Gaussians' spectra, in float64 on the field's device
    s = torch.as_tensor(scales, dtype=torch.float64, device=dev)[:, None]
    grid = torch.fft.fftfreq if field.is_complex() else torch.fft.rfftfreq
    freqs = grid(n, dtype=torch.float64, device=dev)[None, :]
    bank = torch.exp(-2.0 * (math.pi * freqs * s) ** 2).to(real_dtype)
    if field.is_complex():
        # complex field: smooth real/imag with the same real kernel
        sm = torch.fft.ifft(torch.fft.fft(field, dim=-1) * bank, dim=-1)
    else:
        sm = torch.fft.irfft(torch.fft.rfft(field, dim=-1) * bank, n=n, dim=-1).to(field.dtype)
    width = max(1, int(round(scale_decorrelation / _scale_spacing_octaves(scales))))
    if width > 1 and len(scales) > 1:
        width = min(width, len(scales))
        if sm.is_complex():
            sm = torch.complex(_box(sm.real, width), _box(sm.imag, width))
        else:
            sm = _box(sm, width)
    return sm


class CoherenceResult(NamedTuple):
    """Squared coherence in [0, 1] and relative phase, each ``[..., S, N]``."""

    coherence: torch.Tensor
    phase: torch.Tensor
    scales: tuple[float, ...]

    def mean_coherence(self) -> torch.Tensor:
        """Time-averaged coherence per scale ``[..., S]``."""
        return self.coherence.mean(dim=-1)


def wavelet_coherence(
    x: torch.Tensor,
    y: torch.Tensor,
    scales: Sequence[float],
    wavelet="morl",
    *,
    boundary: str = "zero",
    method: str = "fft",
    scale_decorrelation: float = 0.6,
) -> CoherenceResult:
    """Squared wavelet coherence (Torrence & Compo):

    ``R^2 = |S(W_xy / s)|^2 / ( S(|W_x|^2 / s) * S(|W_y|^2 / s) )``

    with ``S`` the scale-dependent smoothing operator (a Gaussian of width
    ``s`` in time, a boxcar of ``scale_decorrelation`` octaves in scale).
    """
    scales = validate_scales(scales)
    wx = _complex_cwt(x, scales, wavelet, boundary, method)
    wy = _complex_cwt(y, scales, wavelet, boundary, method)
    inv_s = torch.as_tensor(1.0 / np.asarray(scales)[:, None], dtype=wx.coeffs.real.dtype,
                            device=wx.coeffs.device)
    sxy = _smooth(wx.coeffs * torch.conj(wy.coeffs) * inv_s, scales,
                  scale_decorrelation=scale_decorrelation)
    sxx = _smooth(wx.coeffs.abs() ** 2 * inv_s, scales, scale_decorrelation=scale_decorrelation)
    syy = _smooth(wy.coeffs.abs() ** 2 * inv_s, scales, scale_decorrelation=scale_decorrelation)
    r2 = sxy.abs() ** 2 / torch.clamp_min(sxx * syy, 1e-30)
    return CoherenceResult(torch.clamp(r2, 0.0, 1.0), torch.angle(sxy), scales)


def phase_synchronization(
    x: torch.Tensor,
    y: torch.Tensor,
    scales: Sequence[float],
    wavelet="morl",
    *,
    boundary: str = "zero",
    method: str = "fft",
) -> torch.Tensor:
    """Phase-locking value per scale ``[..., S]``:
    ``PLV_s = | mean_t exp(i (phi_x - phi_y)) |``."""
    wxy = cross_wavelet(x, y, scales, wavelet, boundary=boundary, method=method)
    unit = wxy.coeffs / torch.clamp_min(wxy.coeffs.abs(), 1e-30)
    return unit.mean(dim=-1).abs()


def instantaneous_frequency(
    result: CWTResult,
    *,
    dt: float = 1.0,
) -> torch.Tensor:
    """Instantaneous frequency (cycles per unit time) ``[..., S, N]`` from
    the wrap-free phase increment ``angle(W_{t+1} conj(W_t))``; the last
    column repeats the previous increment.  Real coefficients raise."""
    if not result.coeffs.is_complex():
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            "instantaneous frequency needs complex coefficients",
            suggestions=("Run cwt(..., analytic=True) or a complex wavelet",),
        )
    w = result.coeffs
    freq = torch.angle(w[..., 1:] * torch.conj(w[..., :-1])) / (2.0 * math.pi * dt)
    return torch.cat([freq, freq[..., -1:]], dim=-1)


class RidgeResult(NamedTuple):
    """Maximum-energy ridge through the scalogram, ``[..., N]`` per field."""

    indices: torch.Tensor  # int32 scale indices
    scales: torch.Tensor  # physical scale at each time
    amplitude: torch.Tensor  # |W| along the ridge


def _viterbi_indices_scan(obs_t: torch.Tensor, pen: torch.Tensor) -> torch.Tensor:
    """Sequential Viterbi (forward pass + backtrack), ``[N, ..., S] -> [N, ...]``."""
    n = obs_t.shape[0]
    carry = obs_t[0]
    bps = torch.empty(obs_t.shape, dtype=torch.long, device=obs_t.device)
    for t in range(1, n):
        best, arg = (carry[..., :, None] - pen).max(dim=-2)  # the first argmax, as jnp's
        carry = best + obs_t[t]
        bps[t] = arg
    idx = torch.empty(obs_t.shape[:-1], dtype=torch.long, device=obs_t.device)
    idx[n - 1] = carry.argmax(dim=-1)
    for t in range(n - 1, 0, -1):
        idx[t - 1] = torch.gather(bps[t], -1, idx[t][..., None])[..., 0]
    return idx


def _viterbi_indices_blocked(obs_t: torch.Tensor, pen: torch.Tensor,
                             block: int) -> torch.Tensor:
    """Blocked max-plus Viterbi (the JAX package's), sequential depth
    ``O(N / block + block)``:

    1. per-block transfer matrices ``W_b[i, j]`` (best within-block path
       entering at state i, leaving at j), grown ``block`` steps for all
       blocks at once (``[NB, ..., S, S]``);
    2. a scan over the NB block edges, forward and backward;
    3. forward scores F_t and backward scores B_t inside every block, again
       for all blocks at once; the path is ``argmax_j (F_t + B_t)``.

    The same optimum as the sequential pass (the sums associate otherwise,
    so near-ties may resolve to another maximising path)."""
    n = obs_t.shape[0]
    batch_shape = obs_t.shape[1:-1]
    s = obs_t.shape[-1]
    # steps 1..n-1 carry transitions; padded steps observe 0 in every state
    n_pad = -(n - 1) % block
    obs_p = torch.cat([obs_t, obs_t.new_zeros((n_pad, *batch_shape, s))], dim=0)
    nb = (n - 1 + n_pad) // block
    obs_bt = obs_p[1:].reshape(nb, block, *batch_shape, s).movedim(1, 0)  # [block, NB, ..., S]
    neg_inf = torch.finfo(obs_t.dtype).min

    # 1. transfer matrices
    eye = torch.full((s, s), neg_inf, dtype=obs_t.dtype, device=obs_t.device)
    eye.fill_diagonal_(0.0)
    w = eye.expand(nb, *batch_shape, s, s)
    for k in range(block):
        w = (w[..., :, :, None] - pen).max(dim=-2).values + obs_bt[k][..., None, :]

    # 2. block edges: the vector entering each block, and at each block's exit
    f0 = obs_t[0]
    f_edges = torch.empty((nb, *batch_shape, s), dtype=obs_t.dtype, device=obs_t.device)
    f = f0
    for i in range(nb):
        f_edges[i] = f
        f = (f[..., :, None] + w[i]).max(dim=-2).values
    b_edges = torch.empty_like(f_edges)
    b = torch.zeros_like(f0)
    for i in range(nb - 1, -1, -1):
        b_edges[i] = b
        b = (w[i] + b[..., None, :]).max(dim=-1).values

    # 3. expansion inside the blocks
    f_all = torch.empty_like(obs_bt)
    f = f_edges
    for k in range(block):
        f = (f[..., :, None] - pen).max(dim=-2).values + obs_bt[k]
        f_all[k] = f
    b_all = torch.empty_like(obs_bt)
    b = b_edges
    for k in range(block - 1, -1, -1):
        b_all[k] = b
        b = ((obs_bt[k] + b)[..., None, :] - pen).max(dim=-1).values

    tot = (f_all + b_all).movedim(0, 1).reshape(nb * block, *batch_shape, s)[: n - 1]
    first = (f0 + b[0]).argmax(dim=-1)  # b[0]: B_0, entering the first block
    return torch.cat([first[None], tot.argmax(dim=-1)], dim=0)


def extract_ridge(
    result: CWTResult,
    *,
    smoothness: float = 2.0,
    block_size: int = 128,
) -> RidgeResult:
    """Viterbi ridge: the scale path maximizing summed log-power minus
    ``smoothness * (delta log2 scale)^2`` jump penalties.

    ``smoothness=0`` reduces to the per-column argmax; larger values give
    continuous ridges through noise gaps.  Signals longer than ``4 *
    block_size`` use the blocked max-plus form
    (:func:`_viterbi_indices_blocked`), shorter ones the sequential pass, as
    in the JAX package.  Batched over leading axes.
    """
    if smoothness < 0:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"smoothness must be >= 0, got {smoothness}",
        )
    power = result.coeffs.abs()
    obs = torch.log(torch.clamp_min(power, 1e-30))
    log_scales = np.log2(np.asarray(result.scales))
    pen = smoothness * (log_scales[:, None] - log_scales[None, :]) ** 2
    pen_t = torch.as_tensor(pen, dtype=obs.dtype, device=obs.device)  # [S_from, S_to]

    obs_t = obs.movedim(-1, 0)  # time-major: [N, ..., S]
    if obs_t.shape[0] > 4 * block_size:
        indices = _viterbi_indices_blocked(obs_t, pen_t, block_size)
    else:
        indices = _viterbi_indices_scan(obs_t, pen_t)
    indices = indices.movedim(0, -1)  # [..., N]
    scale_grid = torch.as_tensor(np.asarray(result.scales), dtype=power.dtype,
                                 device=power.device)
    amplitude = torch.gather(power, -2, indices[..., None, :])[..., 0, :]
    return RidgeResult(indices.to(torch.int32), scale_grid[indices], amplitude)
