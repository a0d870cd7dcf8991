"""Continuous wavelet transform: FFT path, direct path, kernel-direct tier.

Counterpart of ``vectorwave_tpu/transforms/cwt.py``.  Coefficients are
``[..., S, N]`` tensors on the input's device; float64 input computes in
float64, any other in float32.

* The FFT path multiplies the signal's spectrum by the whole bank's (every
  scale at once): ``irfft(rfft(x) * conj(rfft(bank)))`` for a real wavelet,
  ``ifft(fft(x) * conj(fft(bank)))`` for a complex one or ``analytic=True``
  (the analytic signal: positive frequencies doubled, negative ones zeroed).
  The zero boundary convolves linearly at ``nextpow2(N + support - 1)`` with
  each scaled wavelet wrapped circularly around index 0; the periodic one
  circularly at N.  The bank's spectrum is computed once per (wavelet,
  scales, FFT size, dtype, device) and kept: in float64 on the host up to
  ``_BAKED_BANK_MAX_FFT``, above it on the device from the compact taps,
  cast once to the compute dtype.
* The direct path is one ``F.conv1d`` with the scales as output channels and
  zero padding (on the card it follows ``torch.backends.cudnn.allow_tf32``).
* The kernel-direct tier serves small-support scales of a periodic
  float32 CWT of a real wavelet through the filter-bank kernel
  (:func:`~vectorwave_tpu_torch.kernels.modwt_bank.bank_analysis_stacked`):
  ``out[t] = sum_k x[t + k] psi(k/s)/sqrt(s)``, the periodic FFT path's
  function computed directly (:func:`_kernel_direct_split`).  Under
  ``auto`` it takes a call whole or not at all, and its result is the
  bank's own ``[S, B, N]`` allocation seen as ``[B, S, N]``, not a copy;
  ``backend='kernel'`` joins its leading scales to FFT rows.
* :func:`icwt` is the log-scale single-sum reconstruction (Torrence & Compo
  eq. 11), equalized by the scale grid's aggregate frequency response or
  divided by a constant calibrated on the host.
* The scale tools and selectors are numpy, as in the JAX package.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..config import get_backend
from ..errors import ErrorCode, InvalidArgumentError, InvalidSignalError
from ..kernels import modwt_bank
from ..ops.constants import kept
from ..wavelets.base import ContinuousWavelet
from ..wavelets.registry import as_wavelet

#: total support of the sampled wavelet in units of scale*bandwidth (+-4)
SUPPORT_FACTOR = 8


class CWTResult(NamedTuple):
    """``[..., S, N]`` coefficients plus the scale grid.

    ``boundary`` records how the forward transform treated edges: ``zero``
    (linear convolution) or ``periodic`` (circular at N, which gives exact
    equalized inversion).
    """

    coeffs: torch.Tensor
    scales: tuple[float, ...]
    boundary: str = "zero"

    @property
    def n_scales(self) -> int:
        return len(self.scales)

    def magnitude(self) -> torch.Tensor:
        return self.coeffs.abs()

    def phase(self) -> torch.Tensor:
        """Phase angle; zeros for real coefficients."""
        if self.coeffs.is_complex():
            return torch.angle(self.coeffs)
        return torch.zeros_like(self.coeffs)

    def power(self) -> torch.Tensor:
        return self.coeffs.abs() ** 2

    def scalogram(self) -> torch.Tensor:
        """Per-scale energy over time ``[..., S]``."""
        return (self.coeffs.abs() ** 2).sum(dim=-1)


def _resolve_continuous(wavelet) -> ContinuousWavelet:
    w = as_wavelet(wavelet)
    if not isinstance(w, ContinuousWavelet):
        raise InvalidArgumentError(
            ErrorCode.CFG_UNSUPPORTED_TRANSFORM,
            f"Wavelet {getattr(w, 'name', w)!r} is discrete; CWT requires a continuous wavelet",
            suggestions=("Use modwt()/swt() for discrete wavelets",),
        )
    return w


def validate_scales(scales) -> tuple:
    """Shared scale validation: non-empty, all positive; returns floats."""
    scales = tuple(float(s) for s in scales)
    if not scales:
        raise InvalidArgumentError(
            ErrorCode.VAL_TOO_SHORT, "At least one scale is required"
        )
    if any(s <= 0 for s in scales):
        raise InvalidArgumentError(
            ErrorCode.VAL_TOO_SHORT,
            "All scales must be positive",
            context={"scales": scales},
        )
    return scales


def _half_support(scale: float, bandwidth: float) -> int:
    return max(1, int(math.ceil(scale * bandwidth * SUPPORT_FACTOR / 2)))


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _is_complex(w: ContinuousWavelet) -> bool:
    """Whether ``psi`` returns complex values (the frequency-defined
    families do, whatever ``is_complex`` says)."""
    return bool(np.iscomplexobj(np.asarray(w.psi(np.zeros(1)))))


def _sample_bank(
    w: ContinuousWavelet, scales: Sequence[float], fft_size: int
) -> tuple[np.ndarray, bool]:
    """Sample psi(k/s)/sqrt(s) for each scale, wrapped circularly at 0."""
    bank = np.zeros((len(scales), fft_size), dtype=np.complex128)
    for row, scale in enumerate(scales):
        half = _half_support(scale, w.bandwidth)
        k = np.arange(-half, half + 1)
        vals = np.asarray(w.psi(k / scale)) / math.sqrt(scale)
        bank[row, k % fft_size] += vals
    return bank, _is_complex(w)


def _row_taps(w: ContinuousWavelet, scale: float, fft_size: int):
    """The slots one row of :func:`_sample_bank` sets and their values,
    without the row: where the support wraps past ``fft_size`` a slot keeps
    the value the row's assignment leaves there."""
    half = _half_support(scale, w.bandwidth)
    k = np.arange(-half, half + 1)
    vals = np.asarray(w.psi(k / scale)) / math.sqrt(scale)
    idx = k % fft_size
    if len(idx) <= fft_size:
        return idx, vals
    row = np.zeros(fft_size, dtype=vals.dtype)
    row[idx] += vals
    slots = np.unique(idx)
    return slots, row[slots]


#: above this FFT size the bank is assembled on the device from its compact
#: taps rather than sampled whole on the host (a 64-scale bank at 2^20
#: samples would be 1 GiB of complex128)
_BAKED_BANK_MAX_FFT = 1 << 16


@functools.lru_cache(maxsize=8)
@kept
def _bank_spectrum(w: ContinuousWavelet, scales: tuple[float, ...], fft_size: int,
                   real: bool, complex_dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """``conj(rfft(bank))`` (``real``) or ``conj(fft(bank))``, ``[S, F]``,
    computed in float64 and cast once to ``complex_dtype`` on ``device``."""
    if fft_size <= _BAKED_BANK_MAX_FFT:
        bank, _ = _sample_bank(w, scales, fft_size)
        spec = np.fft.rfft(bank.real, axis=-1) if real else np.fft.fft(bank, axis=-1)
        return torch.from_numpy(np.conj(spec)).to(device=device, dtype=complex_dtype)
    rows, slots, vals = [], [], []
    for row, scale in enumerate(scales):
        idx, v = _row_taps(w, scale, fft_size)
        rows.append(np.full(len(idx), row))
        slots.append(idx)
        vals.append(v)
    v = np.concatenate(vals)
    bank = torch.zeros(len(scales), fft_size, device=device,
                       dtype=torch.float64 if real else torch.complex128)
    bank[torch.from_numpy(np.concatenate(rows)).to(device),
         torch.from_numpy(np.concatenate(slots)).to(device)] = torch.from_numpy(
        np.ascontiguousarray(v.real if real else v.astype(np.complex128))).to(device)
    spec = torch.fft.rfft(bank, dim=-1) if real else torch.fft.fft(bank, dim=-1)
    return torch.conj_physical(spec).to(complex_dtype)


class CWTConfig(NamedTuple):
    """CWT engine options.

    ``boundary``; ``method='auto'`` takes the FFT path from ``fft_threshold``
    samples on and the direct path below; ``fft_size`` (0 = automatic) is
    checked against the linear-convolution minimum; ``analytic`` as in
    :func:`cwt`.
    """

    boundary: str = "zero"
    method: str = "auto"  # auto | fft | direct
    fft_threshold: int = 64  # auto: FFT path when N >= threshold
    fft_size: int = 0  # 0 = auto (nextpow2(N + support - 1); N if periodic)
    analytic: bool = False

    def resolve_method(self, n: int) -> str:
        if self.method == "auto":
            return "fft" if n >= self.fft_threshold else "direct"
        return self.method


def cwt(
    x: torch.Tensor,
    scales: Sequence[float],
    wavelet="morl",
    *,
    method: str = "fft",
    analytic: bool = False,
    boundary: str = "zero",
    config: CWTConfig | None = None,
) -> CWTResult:
    """Continuous wavelet transform.

    Args:
      x: ``[..., N]`` real signal(s).
      scales: sequence of positive scales.
      wavelet: continuous wavelet name or instance.
      method: ``fft`` (default) or ``direct`` (time-domain convolution;
        equivalent results, for short supports).
      analytic: for REAL wavelets, compute complex coefficients against the
        analytic (Hilbert) signal.  Complex wavelets always produce complex
        coefficients.
      boundary: ``zero`` (linear convolution) or ``periodic``.
      config: a :class:`CWTConfig`; its boundary, analytic flag and method
        replace the arguments.

    Returns:
      :class:`CWTResult` with coefficients ``[..., S, N]``.
    """
    w = _resolve_continuous(wavelet)
    scales = validate_scales(scales)
    n = x.shape[-1]
    if n < 1:
        raise InvalidSignalError(
            ErrorCode.VAL_TOO_SHORT,
            f"Signal length {n} below minimum 1",
            context={"shape": tuple(x.shape)},
        )
    if config is not None:
        boundary = config.boundary
        analytic = config.analytic
        method = config.resolve_method(n)
    if boundary == "periodic":
        fft_size = n
    else:
        max_support = max(2 * _half_support(s, w.bandwidth) + 1 for s in scales)
        fft_size = _next_pow2(n + max_support - 1)
    if config is not None and config.fft_size:
        if config.fft_size < fft_size:
            raise InvalidArgumentError(
                ErrorCode.CFG_INVALID_CONFIG,
                f"fft_size {config.fft_size} below the linear-convolution "
                f"minimum {fft_size}",
                suggestions=("Use fft_size=0 for automatic sizing",),
            )
        fft_size = config.fft_size
    is_complex = _is_complex(w)
    complex_out = is_complex or analytic
    real_dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    xr = x.to(real_dtype)

    if method == "direct":
        return CWTResult(_cwt_direct(xr, w, scales, complex_out), scales, boundary)
    if method != "fft":
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"Unknown CWT method: {method!r}",
            suggestions=("Use 'fft' or 'direct'",),
        )
    complex_dtype = torch.complex128 if real_dtype == torch.float64 else torch.complex64

    if complex_out:
        spec_x = torch.fft.fft(xr, n=fft_size, dim=-1)
        if analytic and not is_complex:
            # analytic signal: double positive freqs, zero negative
            freq = torch.fft.fftfreq(fft_size, dtype=real_dtype, device=x.device)
            spec_x = spec_x * torch.where(freq > 0, 2.0, torch.where(freq == 0, 1.0, 0.0))
        bank_spec = _bank_spectrum(w, scales, fft_size, False, complex_dtype, x.device)
        out = torch.fft.ifft(spec_x[..., None, :] * bank_spec, dim=-1)[..., :n]
        return CWTResult(out, scales, boundary)

    n_small = _kernel_direct_split(x.device, w, scales, boundary, real_dtype)
    if not n_small:
        return CWTResult(_real_fft_rows(xr, w, scales, fft_size, n, complex_dtype),
                         scales, boundary)
    x2 = xr.reshape(-1, n).contiguous()
    parts = _cwt_kernel_direct(x2, w, scales[:n_small])
    if n_small < len(scales):
        parts.append(_real_fft_rows(x2, w, scales[n_small:], fft_size, n, complex_dtype))
    out = torch.cat(parts, dim=-2) if len(parts) > 1 else parts[0]
    return CWTResult(out.reshape(x.shape[:-1] + (len(scales), n)), scales, boundary)


def _real_fft_rows(x, w, scales_sub, fft_size: int, n: int, complex_dtype):
    """FFT-path rows ``[..., S, N]`` of a real wavelet: the whole bank in one
    product and one batched ``irfft``."""
    spec_x = torch.fft.rfft(x, n=fft_size, dim=-1)
    bank_spec = _bank_spectrum(w, tuple(scales_sub), fft_size, True, complex_dtype,
                               x.device)
    return torch.fft.irfft(spec_x[..., None, :] * bank_spec, n=fft_size, dim=-1)[..., :n]


#: largest half-support ``backend='kernel'`` sends through the kernel-direct
#: tier (the JAX package's cap; span 2 * half + 1 <= 4097 taps)
KERNEL_DIRECT_MAX_HALF = 2048
#: largest half-support ``auto`` sends through the tier on the card, for a
#: call whose scales all stay within it.  Dense taps cost 2h + 1 FMAs a
#: sample a scale, the FFT path's batched ``irfft`` a few passes over the
#: scale's spectrum whatever h is; on an H100 whole ``cwt`` calls of 16
#: scales with h up to this cap ran faster on the tier than on the FFT path
#: at both 1 x 2^20 and 128 x 65536 samples in every run of three calls'
#: gate sweeps; at 128 the tier lost one run of nine (a tie), at 256 most
#: (PERF.md, section 6).
AUTO_KERNEL_DIRECT_MAX_HALF = 64


def _kernel_direct_split(device: torch.device, w: ContinuousWavelet, scales,
                         boundary: str, real_dtype: torch.dtype) -> int:
    """How many LEADING scales the kernel-direct tier serves (0 = none).

    ``torch`` never takes it; ``kernel`` takes it up to
    :data:`KERNEL_DIRECT_MAX_HALF` (a CPU tensor runs the bank's plain
    version) and the FFT path the rest; ``auto`` only for a CUDA tensor on
    a card the kernels are built for, and only when every scale is at most
    :data:`AUTO_KERNEL_DIRECT_MAX_HALF` and they make one bank call, so that
    the result is that call's allocation and no rows are joined.  Either
    needs a periodic boundary, float32 compute and ascending scales (the
    split takes a leading run); any N and batch are served, the span past N
    included.
    """
    from ..kernels.modwt_fused import kernel_available

    backend = get_backend()
    if backend == "torch" or boundary != "periodic" or real_dtype != torch.float32:
        return 0
    whole = backend == "auto"
    n_small = _tier_scales(w, tuple(scales),
                           AUTO_KERNEL_DIRECT_MAX_HALF if whole else KERNEL_DIRECT_MAX_HALF, whole)
    if whole and n_small and not (device.type == "cuda" and kernel_available()):
        return 0
    return n_small


@functools.lru_cache(maxsize=64)
def _tier_scales(w: ContinuousWavelet, scales: tuple[float, ...], cap: int, whole: bool) -> int:
    """The leading ascending scales within ``cap``; with ``whole``, all of
    them in one chunk or none.  Cached: it runs before the call's first
    launch, and computed afresh it left ``auto`` 3-7% behind the plain
    route at config #5 on an H100 (PERF.md, section 6)."""
    if list(scales) != sorted(scales):
        return 0
    n_small = 0
    for s in scales:
        if _half_support(s, w.bandwidth) > cap:
            break
        n_small += 1
    if whole and (n_small < len(scales) or len(_kernel_direct_chunks(w, scales)) > 1):
        return 0
    return n_small


@functools.lru_cache(maxsize=32)
def _kernel_direct_chunks(w: ContinuousWavelet, scales: tuple[float, ...]):
    """The tier's bank calls: ``(maxhalf, dense)`` per chunk of consecutive
    scales, at most ``modwt_bank.MAX_PLANES`` of them whose window of
    ``2 * maxhalf`` fits the kernels' shared memory (a scale whose window
    fits alone makes a chunk of its own, which the card refuses).  Plane p
    of a chunk has the taps ``d[m] = c_{maxhalf - m}``, ``c_k = psi(k/s) /
    sqrt(s)`` for ``|k| <= half(s)`` and zero beyond, so the kernel, which
    takes the non-zero taps alone, costs each scale its own 2 half + 1 taps.
    Built once per (wavelet, scales): the bank finds its tap tables by the
    identity of ``dense``."""
    halves = [_half_support(s, w.bandwidth) for s in scales]
    starts = [0]
    for i in range(1, len(scales)):
        lo = starts[-1]
        if (i - lo >= modwt_bank.MAX_PLANES
                or not modwt_bank.span_fits(2 * max(halves[lo: i + 1]))):
            starts.append(i)
    chunks = []
    for lo, hi in zip(starts, starts[1:] + [len(scales)]):
        maxhalf = max(halves[lo:hi])
        k = maxhalf - np.arange(2 * maxhalf + 1)
        dense = []
        for i in range(lo, hi):
            c = np.zeros(2 * maxhalf + 1)
            mask = np.abs(k) <= halves[i]
            c[mask] = np.asarray(w.psi(k[mask] / scales[i])).real / math.sqrt(scales[i])
            dense.append(tuple(c.tolist()))
        chunks.append((maxhalf, tuple(dense)))
    return tuple(chunks)


def _cwt_kernel_direct(x2: torch.Tensor, w: ContinuousWavelet, scales_sub) -> list:
    """Real-wavelet periodic CWT rows of ``[B, N]`` float32 ``x2`` through
    the filter-bank kernel: one ``[B, P, N]`` view of the bank's ``[P, B,
    N]`` output a chunk of P scales.

    Each chunk is one backward-read bank call with the reversed,
    maxhalf-rebased taps on x rolled by ``-maxhalf``, which restores the
    two-sided correlation ``out[t] = sum_k x[t+k] psi(k/s)/sqrt(s)`` (one
    roll of x instead of one of each output row; the bank wraps modulo N,
    so any span is served)."""
    return [modwt_bank.bank_analysis_stacked(torch.roll(x2, -maxhalf, dims=-1), dense,
                                             True).movedim(0, -2)
            for maxhalf, dense in _kernel_direct_chunks(w, tuple(scales_sub))]


def _cwt_direct(
    x: torch.Tensor, w: ContinuousWavelet, scales: tuple[float, ...], complex_out: bool
) -> torch.Tensor:
    """Time-domain path: one 1-D convolution, scales = output channels."""
    n = x.shape[-1]
    halves = [_half_support(s, w.bandwidth) for s in scales]
    max_half = max(halves)
    length = 2 * max_half + 1
    bank = np.zeros((len(scales), length), dtype=np.complex128)
    for row, (scale, half) in enumerate(zip(scales, halves)):
        k = np.arange(-half, half + 1)
        bank[row, max_half - half : max_half + half + 1] = (
            np.conj(np.asarray(w.psi(k / scale))) / math.sqrt(scale)
        )
    lhs = x.reshape(-1, 1, n)

    def conv(filters: np.ndarray) -> torch.Tensor:
        rhs = torch.from_numpy(np.ascontiguousarray(filters[:, None, :])).to(
            device=x.device, dtype=x.dtype)  # [S, 1, L]
        out = F.conv1d(lhs, rhs, padding=max_half)
        return out.reshape(x.shape[:-1] + (len(scales), n))

    # both F.conv1d and the JAX package's lax.conv_general_dilated correlate:
    # out[s, i] = sum_j x[i + j - max_half] flipped[s, j]
    flipped = bank[:, ::-1]
    if complex_out:
        return torch.complex(conv(flipped.real), conv(-flipped.imag))
    return conv(flipped.real)


# --------------------------------------------------------------------------
# Inverse CWT
# --------------------------------------------------------------------------


def _log_weights(scales) -> np.ndarray:
    """The single-sum weights d(log s) / sqrt(s) of each scale."""
    log_s = np.log(np.asarray(scales))
    dls = np.gradient(log_s) if len(scales) > 1 else np.ones(1)
    return dls / np.sqrt(np.asarray(scales))


_CALIBRATION_CACHE: dict[tuple, float] = {}


def _delta_calibration(w: ContinuousWavelet, scales: tuple[float, ...]) -> float:
    """Reconstruction constant for the single-sum inverse, the numerical
    analogue of the admissibility constant C_psi.

    Calibrated on the host by least squares: transform a seeded noise signal
    band-limited to the frequency range the scale grid covers, reconstruct
    with C=1, and fit the scalar that recovers the input.  This holds for
    every wavelet family, odd ones included (where the classic delta formula
    degenerates because psi(0) = 0).
    """
    key = (w.name, w.center_frequency, w.bandwidth, scales)
    cached = _CALIBRATION_CACHE.get(key)
    if cached is not None:
        return cached
    n = 1024
    rng = np.random.default_rng(12345)
    x = rng.standard_normal(n)
    # band-limit to the representable band of the scale grid
    f_hi = min(0.5, 1.5 * w.center_frequency / min(scales))
    f_lo = max(1.0 / n, w.center_frequency / max(scales) / 1.5)
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(n)
    spec[(freqs < f_lo) | (freqs > f_hi)] = 0.0
    x = np.fft.irfft(spec, n)
    # numpy CWT with the same bank construction as the FFT path
    max_support = max(2 * _half_support(s, w.bandwidth) + 1 for s in scales)
    fft_size = _next_pow2(n + max_support - 1)
    bank, _ = _sample_bank(w, scales, fft_size)
    spec_x = np.fft.fft(x, fft_size)
    coeffs = np.fft.ifft(spec_x[None, :] * np.conj(np.fft.fft(bank, axis=-1)), axis=-1)[
        :, :n
    ]
    rec = np.real(coeffs).T @ _log_weights(scales)
    denom = float(np.dot(rec, x))
    c = float(np.dot(rec, rec)) / denom if abs(denom) > 1e-12 else 1.0
    _CALIBRATION_CACHE[key] = c
    return c


@functools.lru_cache(maxsize=16)
def _aggregate_response(
    w: ContinuousWavelet, scales: tuple[float, ...], n: int, boundary: str = "zero"
) -> np.ndarray:
    """Net frequency response G(f) of the weighted single-sum reconstruction:
    ``sum_j w_j conj(psi_hat(s_j f))`` on the length-n rfft grid.

    By linearity the weighted sum of the bank's rows is taken first, so one
    FFT of one row replaces one per scale."""
    if boundary == "periodic":
        fft_size = n
    else:
        max_support = max(2 * _half_support(s, w.bandwidth) + 1 for s in scales)
        fft_size = _next_pow2(n + max_support - 1)
    row = np.zeros(fft_size, dtype=np.complex128)
    for weight, scale in zip(_log_weights(scales), scales):
        idx, vals = _row_taps(w, scale, fft_size)
        row[idx] += weight * vals
    agg = np.conj(np.fft.fft(row))  # sum_j w_j conj(psi_hat) per scale
    # resample the fft_size grid onto the length-n rfft bins; the observable
    # response of Re(acc) is the Hermitian part H(f) = (G(f) + conj(G(-f)))/2
    # (halves the response of analytic wavelets, keeps odd real wavelets'
    # purely imaginary response intact)
    freqs_n = np.fft.rfftfreq(n)
    freqs_m = np.fft.fftfreq(fft_size)
    order = np.argsort(freqs_m)
    fm, ar, ai = freqs_m[order], agg.real[order], agg.imag[order]

    def interp(f):
        return np.interp(f, fm, ar) + 1j * np.interp(f, fm, ai)

    return 0.5 * (interp(freqs_n) + np.conj(interp(-freqs_n)))


@functools.lru_cache(maxsize=16)
@kept
def _equalizer(w: ContinuousWavelet, scales: tuple[float, ...], n: int, boundary: str,
               complex_dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """1 / G on the rfft bins where |G| is above 5% of its peak, 0 elsewhere."""
    g = _aggregate_response(w, scales, n, boundary)
    mag = np.abs(g)
    floor = 0.05 * mag.max()
    inv = np.where(mag > floor, 1.0 / np.where(mag > floor, g, 1.0), 0.0)
    return torch.from_numpy(inv).to(device=device, dtype=complex_dtype)


def _weighted_sum(coeffs: torch.Tensor, weights: np.ndarray) -> torch.Tensor:
    """``sum_s weights[s] Re(coeffs[..., s, :])``, as a vector-matrix product
    that reads the ``[..., S, N]`` rows in place."""
    real = coeffs.real if coeffs.is_complex() else coeffs
    return torch.matmul(torch.as_tensor(weights, dtype=real.dtype, device=real.device), real)


def icwt(
    result: CWTResult,
    wavelet="morl",
    *,
    equalize: bool = True,
) -> torch.Tensor:
    """Inverse CWT.

    ``equalize=True`` (default) divides the log-scale single-sum
    reconstruction by the scale grid's aggregate frequency response, giving
    near-exact recovery inside the band the scales cover.  ``equalize=False``
    is the classic single-sum formula (Torrence & Compo eq. 11) with a
    numerically calibrated constant.
    """
    w = _resolve_continuous(wavelet)
    scales = tuple(result.scales)
    n = result.coeffs.shape[-1]
    acc = _weighted_sum(result.coeffs, _log_weights(scales))
    if not equalize:
        return acc / _delta_calibration(w, scales)
    complex_dtype = torch.complex128 if acc.dtype == torch.float64 else torch.complex64
    inv = _equalizer(w, scales, n, result.boundary, complex_dtype, acc.device)
    out = torch.fft.irfft(torch.fft.rfft(acc, dim=-1) * inv, n=n, dim=-1)
    return out.to(acc.dtype)


def reconstruct_band(
    result: CWTResult,
    wavelet,
    min_scale: float,
    max_scale: float,
) -> torch.Tensor:
    """Band-limited reconstruction: only scales within [min_scale, max_scale]
    contribute (the calibration keeps the FULL scale grid, so bands sum to
    the full reconstruction)."""
    w = _resolve_continuous(wavelet)
    scales = tuple(result.scales)
    mask = np.array([(min_scale <= s <= max_scale) for s in scales], dtype=np.float64)
    c = _delta_calibration(w, scales)
    return _weighted_sum(result.coeffs, mask * _log_weights(scales)) / c


def reconstruct_frequency_band(
    result: CWTResult,
    wavelet,
    min_freq: float,
    max_freq: float,
    *,
    dt: float = 1.0,
) -> torch.Tensor:
    """Frequency-band reconstruction."""
    w = _resolve_continuous(wavelet)
    min_scale = frequency_to_scale(max_freq, w, dt=dt)
    max_scale = frequency_to_scale(min_freq, w, dt=dt)
    return reconstruct_band(result, w, min_scale, max_scale)


# --------------------------------------------------------------------------
# Scale spaces and selectors (host numpy)
# --------------------------------------------------------------------------


def _host_signal(x) -> np.ndarray:
    """A signal as a flat float64 numpy array (a tensor from any device)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, dtype=np.float64).reshape(-1)


def scale_to_frequency(scale, wavelet, *, dt: float = 1.0):
    """f = fc / (s * dt)."""
    w = _resolve_continuous(wavelet)
    return w.center_frequency / (np.asarray(scale) * dt)


def frequency_to_scale(freq, wavelet, *, dt: float = 1.0):
    w = _resolve_continuous(wavelet)
    return w.center_frequency / (np.asarray(freq) * dt)


def scales_linear(min_scale: float, max_scale: float, count: int) -> tuple[float, ...]:
    """Linear scale grid."""
    return tuple(np.linspace(min_scale, max_scale, count).tolist())


def scales_log(min_scale: float, max_scale: float, count: int) -> tuple[float, ...]:
    """Logarithmic scale grid."""
    return tuple(np.geomspace(min_scale, max_scale, count).tolist())


def scales_dyadic(levels: int, *, voices_per_octave: int = 1) -> tuple[float, ...]:
    """Dyadic scales 2^(j/v)."""
    j = np.arange(0, levels * voices_per_octave + 1)
    return tuple((2.0 ** (j / voices_per_octave)).tolist())


def select_scales_optimal(
    signal_length: int,
    wavelet,
    *,
    voices_per_octave: int = 10,
    dt: float = 1.0,
) -> tuple[float, ...]:
    """Nyquist-to-signal-length log coverage: scales spanning fc/Nyquist ..
    fc/(4/N) with v voices per octave."""
    w = _resolve_continuous(wavelet)
    s_min = max(w.center_frequency / (0.5 / dt), 2 * dt * w.center_frequency)
    s_max = w.center_frequency * signal_length * dt / 4.0
    octaves = max(1, int(math.ceil(math.log2(s_max / s_min))))
    j = np.arange(octaves * voices_per_octave + 1)
    return tuple((s_min * 2.0 ** (j / voices_per_octave)).tolist())


def select_scales_signal_adaptive(
    x,
    wavelet,
    *,
    n_scales: int = 32,
    dt: float = 1.0,
) -> tuple[float, ...]:
    """Energy-adaptive scale selection: allocate scales where the signal's
    spectrum carries energy.  On the host (the scale choice depends on the
    data)."""
    x = _host_signal(x)
    n = len(x)
    spec = np.abs(np.fft.rfft(x - x.mean())) ** 2
    freqs = np.fft.rfftfreq(n, d=dt)
    spec[0] = 0.0
    if spec.sum() <= 0:
        return select_scales_optimal(n, wavelet, voices_per_octave=max(4, n_scales // 8), dt=dt)
    cdf = np.cumsum(spec) / spec.sum()
    # sample frequencies at equal energy quantiles (clipped away from DC)
    quantiles = np.linspace(0.02, 0.98, n_scales)
    freq_samples = np.interp(quantiles, cdf, freqs)
    freq_samples = np.clip(freq_samples, freqs[1], freqs[-1])
    w = _resolve_continuous(wavelet)
    scales = np.unique(w.center_frequency / (freq_samples * dt))
    return tuple(scales.tolist())  # np.unique is ascending, like the other selectors


class ScaleSelectionConfig(NamedTuple):
    """Adaptive scale-selection options.

    ``min_frequency``/``max_frequency`` of 0 mean auto-detect.
    ``spacing`` is one of ``linear`` / ``logarithmic`` / ``dyadic``.
    """

    sampling_rate: float
    min_frequency: float = 0.0
    max_frequency: float = 0.0
    scales_per_octave: int = 10
    use_signal_adaptation: bool = True
    max_scales: int = 200
    spacing: str = "logarithmic"


def estimate_scale_count(
    min_freq: float, max_freq: float, *, scales_per_octave: int = 10
) -> int:
    """Scales needed for a frequency range."""
    if min_freq <= 0 or max_freq <= min_freq:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"Invalid frequency range [{min_freq}, {max_freq}]",
        )
    octaves = math.log2(max_freq / min_freq)
    return max(1, int(math.ceil(octaves * scales_per_octave)))


def frequency_range_of_scales(
    scales, wavelet, sampling_rate: float
) -> tuple[float, float]:
    """[minFreq, maxFreq] analyzed by ascending ``scales``."""
    scales = np.asarray(scales, dtype=np.float64)
    if scales.size == 0:
        return (0.0, 0.0)
    w = _resolve_continuous(wavelet)
    fc = w.center_frequency
    return (fc * sampling_rate / scales[-1], fc * sampling_rate / scales[0])


def select_scales_adaptive(
    x,
    wavelet,
    config: ScaleSelectionConfig,
) -> tuple[float, ...]:
    """Config-driven adaptive scale selection.

    Auto-detects the frequency range from the signal spectrum (energy
    quantiles, like :func:`select_scales_signal_adaptive`) when
    ``use_signal_adaptation`` is on, otherwise spans a-few-cycles .. Nyquist;
    then lays out up to ``max_scales`` scales in the requested spacing.  On
    the host: the scale choice depends on the data.
    """
    w = _resolve_continuous(wavelet)
    fs = float(config.sampling_rate)
    if fs <= 0:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG, f"sampling_rate must be > 0, got {fs}"
        )
    x = _host_signal(x)
    n = len(x)
    nyquist = fs / 2.0
    f_lo = config.min_frequency if config.min_frequency > 0 else 4.0 * fs / max(n, 8)
    f_hi = config.max_frequency if config.max_frequency > 0 else 0.5 * nyquist
    if config.use_signal_adaptation and n >= 16:
        spec = np.abs(np.fft.rfft(x - x.mean())) ** 2
        freqs = np.fft.rfftfreq(n, d=1.0 / fs)
        spec[0] = 0.0
        total = spec.sum()
        if total > 0:
            cdf = np.cumsum(spec) / total
            lo = float(np.interp(0.01, cdf, freqs))
            hi = float(np.interp(0.99, cdf, freqs))
            if config.min_frequency <= 0:
                f_lo = max(f_lo / 4.0, min(f_lo, lo))
            if config.max_frequency <= 0:
                f_hi = min(nyquist, max(f_hi, hi))
    f_lo = max(f_lo, fs / n)
    f_hi = max(min(f_hi, nyquist), f_lo * 1.0001)
    count = min(
        config.max_scales,
        estimate_scale_count(f_lo, f_hi, scales_per_octave=config.scales_per_octave),
    )
    fc = w.center_frequency
    s_min = fc * fs / f_hi  # high frequency -> small scale
    s_max = fc * fs / f_lo
    spacing = config.spacing.lower()
    if spacing.startswith("lin"):
        scales = np.linspace(s_min, s_max, count)
    elif spacing.startswith("dya"):
        j_lo = math.floor(math.log2(s_min))
        j_hi = math.ceil(math.log2(s_max))
        scales = 2.0 ** np.arange(j_lo, j_hi + 1)
        scales = scales[(scales >= s_min / 2) & (scales <= s_max * 2)][
            : config.max_scales
        ]
    elif spacing.startswith("log"):
        scales = np.geomspace(s_min, s_max, count)
    else:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"Unknown scale spacing {config.spacing!r}",
            suggestions=("Use 'linear', 'logarithmic' or 'dyadic'",),
        )
    return tuple(np.asarray(scales, dtype=np.float64).tolist())
