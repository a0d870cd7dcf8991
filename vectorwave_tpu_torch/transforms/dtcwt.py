"""Dual-tree complex wavelet transform (DTCWT), 1-D.

Counterpart of ``vectorwave_tpu/transforms/dtcwt.py``: two parallel decimated
trees whose wavelets form an approximate Hilbert pair give
near-shift-invariant complex coefficients (magnitude ~ local analytic
envelope, phase ~ local position) at 2x redundancy: Kingsbury's q-shift
construction.

Structure (all filters generated, see :mod:`..wavelets.qshift`):

* level 1: both trees run the same orthonormal wavelet (default ``sym8``);
  tree b's analysis is offset one input sample (``offset=1`` in the
  decimated ops), a half-sample delay at the decimated rate.
* levels >= 2: tree a runs the q-shift pair (group delay ``(L-1)/2-1/4``),
  tree b the time-reversed pair (``+1/4``): a further half-sample relative
  delay per stage, which is the Hilbert-pair condition.
* complex coefficients ``z_j = (d_a - i d_b)/sqrt(2)``.

Each tree is orthonormal, so the inverse runs the exact adjoint cascade per
tree and averages: perfect reconstruction to machine precision, and the
averaging cancels the trees' opposite aliasing.

Three routes, chosen by :func:`~vectorwave_tpu_torch.config.get_backend`:

* the whole dual tree as one full-rate launch of the filter-bank kernel
  (:mod:`..kernels.modwt_bank`) and a phase subsample per plane; the inverse
  is one synthesis bank launch on the zero-stuffed planes;
* one full-rate bank pair per tree and level, subsampled;
* the plain decimated ``convolve_downsample`` / ``upsample_convolve`` cascade.

``kernel`` takes the first that serves the call (on a CPU tensor the bank's
plain version) and raises on a CUDA tensor the kernel cannot take; ``torch``
takes the plain cascade; ``auto`` takes, on a float32 CUDA tensor on a Hopper
card, the route that measured fastest there (the whole tree up to
:data:`AUTO_WHOLE_TREE_MAX_WORK`, the per-level pairs beyond), and the plain
cascade otherwise.  The bank routes serve float32 only (the complex
highpasses have no bfloat16 form; float64 keeps the plain cascade) and any
``N`` divisible by ``2**levels``.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..errors import ErrorCode, InvalidArgumentError
from ..kernels import modwt_bank
from ..ops.dwt import convolve_downsample, upsample_convolve
from ..wavelets.base import WaveletType
from ..wavelets.qshift import qshift_filters
from .modwt import _resolve_discrete, _validate_signal
from .packets import _bank_route, _bank_serves, _upsample

_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_SQRT2 = math.sqrt(2.0)

#: The most work, in FMAs (samples times the bank's non-zero taps), that
#: ``auto`` sends through the whole-tree route; beyond it, one bank pair per
#: tree and level.  The full-rate tree does every level's work at the
#: input's rate but is two launches; the pairs are 4 J launches and the host
#: work between them.  On an H100 the two cross near 2^22 samples of the
#: 5-level sym8 tree (PERF.md, section 6).
AUTO_WHOLE_TREE_MAX_WORK = (1 << 22) * 2324

#: the q-shift pair, built once (read-only arrays)
_qshift = functools.lru_cache(maxsize=None)(qshift_filters)


def coefficient_delay(level: int, wavelet="sym8") -> float:
    """Accumulated analysis group delay at ``level``, in units of that
    level's coefficient spacing (``2^level`` input samples).

    A feature at input position ``p`` lands at coefficient index
    ``(p - delay_samples) / 2^level`` (correlation-style analysis), so under
    periodic boundaries rolling a magnitude field by
    ``+round(coefficient_delay(j))`` aligns it with the signal.
    """
    h1, _ = _level1(wavelet)
    hq, _ = _qshift()
    delay = (len(h1) - 1) / 2.0  # level-1 stage, input samples
    for stage in range(2, level + 1):
        delay += (2 ** (stage - 1)) * (len(hq) - 1) / 2.0
    return delay / (1 << level)


class DTCWTResult(NamedTuple):
    """Complex highpasses (finest first, ``[..., N/2^j]``) and the two trees'
    final real lowpasses."""

    highpasses: tuple[torch.Tensor, ...]
    lowpass_a: torch.Tensor
    lowpass_b: torch.Tensor

    @property
    def levels(self) -> int:
        return len(self.highpasses)

    def magnitudes(self) -> tuple[torch.Tensor, ...]:
        """Shift-robust envelopes per level."""
        return tuple(z.abs() for z in self.highpasses)

    def level_energy(self) -> torch.Tensor:
        """[..., J] energy per level (coefficient domain)."""
        return torch.stack(
            [(z.abs() ** 2).sum(dim=-1) for z in self.highpasses], dim=-1
        )


def _level1(wavelet):
    w = _resolve_discrete(wavelet)
    if w.wavelet_type is not WaveletType.ORTHOGONAL:
        raise InvalidArgumentError(
            ErrorCode.CFG_UNSUPPORTED_WAVELET,
            f"DTCWT level-1 wavelet must be orthogonal, got {w.name}",
            suggestions=("Use sym8 (default), a dbN, or coifN",),
        )
    return np.asarray(w.dec_lo), np.asarray(w.dec_hi)


def dtcwt_max_levels(n: int, wavelet="sym8") -> int:
    """Deepest usable level: every stage needs an even input length."""
    levels = 0
    while n % 2 == 0 and n // 2 >= len(_level1(wavelet)[0]):
        n //= 2
        levels += 1
    return levels


def _stage_filters(h1, g1, level: int):
    """(ha, ga, hb, gb, offset of tree b) of one stage."""
    if level == 1:
        return h1, g1, h1, g1, 1
    hq, gq = _qshift()
    return hq, gq, hq[::-1], gq[::-1], 0


# ---------------------------------------------------------------------------
# Whole-tree route: the decimated dual tree as one full-rate bank call.
# A decimated cascade composes like the à trous one (h(z) h(z^2) ...), so the
# level-j outputs are c_j[i] = (F_j *fwd x)[2^j i + phi_j] with F_j the
# upsampled-composed filter and phi_j the accumulated stage offsets.  The
# bank reads backward, so reversed taps and a per-plane roll serve the
# forward-read filter; subsampling is a strided slice.  The inverse is the
# exact adjoint: zero-stuff each plane at its phase and run the synthesis
# bank with the same reversed taps.  Every level runs at the input's rate.
# ---------------------------------------------------------------------------


def _tree_stage_filters(h1, g1, levels: int, tree: str):
    """[(h, g, offset)] per stage for tree 'a' or 'b', from the level-1 pair."""
    hq, gq = _qshift()
    if tree == "a":
        return [(h1, g1, 0)] + [(hq, gq, 0)] * (levels - 1)
    return [(h1, g1, 1)] + [(hq[::-1], gq[::-1], 0) for _ in range(levels - 1)]


def _composed_tree_planes(stages):
    """Composed full-rate plane filters [(taps, phi, level)] for
    [d1..dJ, aJ] of one decimated tree."""
    acc = np.array([1.0])
    phi = 0
    planes = []
    for k, (h, g, off) in enumerate(stages, start=1):
        s = 1 << (k - 1)
        phi_k = phi + s * off
        planes.append((np.convolve(acc, _upsample(g, s)), phi_k, k))
        acc = np.convolve(acc, _upsample(h, s))
        phi = phi_k
    planes.append((acc, phi, len(stages)))
    return planes


@functools.lru_cache(maxsize=32)
def _dual_tree_bank_cached(h1: bytes, g1: bytes, levels: int, scale: float):
    h1a, g1a = np.frombuffer(h1, np.float64), np.frombuffer(g1, np.float64)
    planes = []
    for tree in ("a", "b"):
        planes.extend(_composed_tree_planes(_tree_stage_filters(h1a, g1a, levels, tree)))
    dense = tuple(tuple((scale * t[::-1]).tolist()) for t, _, _ in planes)
    # (shift, level) per plane: plane p subsampled is roll(y_p, -shift)[::2^level]
    phases = tuple((phi + len(t) - 1, level) for t, phi, level in planes)
    return dense, phases


def _dual_tree_bank(wavelet, levels: int, scale: float = 1.0):
    """Both trees' composed planes as one bank, tree a's ``[d1..dJ, aJ]``
    then tree b's: (dense reversed taps times ``scale``, per-plane (shift,
    level)).  The same objects on every call, so the bank's tap tables are
    built once."""
    h1, g1 = _level1(wavelet)
    return _dual_tree_bank_cached(
        np.ascontiguousarray(h1, np.float64).tobytes(),
        np.ascontiguousarray(g1, np.float64).tobytes(), levels, scale,
    )


def _dtcwt_route(flat: torch.Tensor):
    return _bank_route(flat, "periodic", dtypes=(torch.float32,))


def _use_whole_tree(route: str, samples: int, dense) -> bool:
    """``kernel`` takes the whole tree first; ``auto`` up to the measured
    work."""
    return (route == "kernel"
            or samples * modwt_bank.bank_taps(dense).nonzeros <= AUTO_WHOLE_TREE_MAX_WORK)


def _whole_tree_bank(like: torch.Tensor, samples: int, wavelet, levels: int, scale: float):
    """Both trees' bank ``(dense, phases)`` where one bank call takes the
    whole dual tree (the route of ``like``'s dtype and device, the work of
    ``samples`` samples, a bank that fits), else None."""
    route = _dtcwt_route(like)
    if route is None:
        return None
    dense, phases = _dual_tree_bank(wavelet, levels, scale)
    if not (_use_whole_tree(route, samples, dense) and _bank_serves(like, dense, route)):
        return None
    return dense, phases


def _dtcwt_kernel_analysis(x: torch.Tensor, wavelet, levels: int):
    """Both trees' full decomposition in one bank call (the two trees share
    the input, so their composed planes concatenate into one multi-output
    bank), or None when this route does not serve the call."""
    lead, n = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, n).contiguous()
    bank = _whole_tree_bank(x2, x2.numel(), wavelet, levels, 1.0)
    if bank is None:
        return None
    dense, phases = bank
    y = modwt_bank.bank_analysis(x2, dense, True)
    outs = [
        torch.roll(y_p, -(shift % n), dims=-1)[..., :: 1 << level].reshape(
            lead + (n >> level,))
        for y_p, (shift, level) in zip(y, phases)
    ]
    a, b = outs[: levels + 1], outs[levels + 1 :]
    highpasses = tuple(
        torch.complex(a[j], -b[j]) * _INV_SQRT2 for j in range(levels)
    )
    return DTCWTResult(highpasses, a[levels], b[levels])


def _dtcwt_kernel_synthesis(result: DTCWTResult, wavelet):
    """Adjoint of :func:`_dtcwt_kernel_analysis`: one synthesis bank over both
    trees' zero-stuffed planes, the 0.5 of the tree average folded into the
    taps.  Returns None when this route does not serve the call."""
    levels = result.levels
    low = result.lowpass_a
    lead = low.shape[:-1]
    n = result.highpasses[0].shape[-1] * 2
    bank = _whole_tree_bank(low, n * math.prod(lead), wavelet, levels, 0.5)
    if bank is None:
        return None
    dense, phases = bank
    coeffs = [_SQRT2 * z.real for z in result.highpasses] + [result.lowpass_a]
    coeffs += [-_SQRT2 * z.imag for z in result.highpasses] + [result.lowpass_b]
    stuffed = []
    for c, (shift, level) in zip(coeffs, phases):
        c2 = c.reshape(-1, c.shape[-1])
        stride = 1 << level
        q, s0 = divmod(shift % n, stride)
        buf = c2.new_zeros((c2.shape[0], n))
        buf[..., s0::stride] = torch.roll(c2, q % c2.shape[-1], dims=-1)
        stuffed.append(buf)
    out = modwt_bank.bank_synthesis(tuple(stuffed), dense, True)
    return out.reshape(lead + (n,))


# ---------------------------------------------------------------------------
# Per-stage route: one full-rate bank pair per tree and level.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _stage_dense_cached(lo: bytes, hi: bytes):
    lo_a, hi_a = np.frombuffer(lo, np.float64), np.frombuffer(hi, np.float64)
    taps = max(len(lo_a), len(hi_a))
    lo_p = np.pad(lo_a, (0, taps - len(lo_a)))
    hi_p = np.pad(hi_a, (0, taps - len(hi_a)))
    return (tuple(lo_p[::-1].tolist()), tuple(hi_p[::-1].tolist())), taps


def _stage_dense(lo, hi):
    """The reversed (lo, hi) taps of one stage, padded to one length so that
    one roll serves both bank outputs, and that length."""
    return _stage_dense_cached(
        np.ascontiguousarray(lo, np.float64).tobytes(),
        np.ascontiguousarray(hi, np.float64).tobytes(),
    )


def _decimated_bank_ok(flat: torch.Tensor, lo, hi) -> bool:
    """Whether one stage takes the per-stage bank route."""
    route = _dtcwt_route(flat)
    if route is None:
        return False
    return route == "kernel" or _bank_serves(flat, _stage_dense(lo, hi)[0], route)


def _bank_convolve_downsample_pair(cur, lo, hi, offset: int):
    """One decimated analysis stage for both branches as one full-rate bank
    call and a phase subsample.

    ``convolve_downsample`` is ``out[i] = sum_j f[j] x[(2i+j+offset) % n]``
    (forward reads); the bank reads backward, so reversed taps and a
    ``-(L-1+offset)`` roll restore the alignment before the ``::2`` pick.
    """
    lead, n = cur.shape[:-1], cur.shape[-1]
    dense, taps = _stage_dense(lo, hi)
    y_lo, y_hi = modwt_bank.bank_analysis(cur.reshape(-1, n).contiguous(), dense, True)
    sh = (taps - 1 + offset) % n
    a = torch.roll(y_lo, -sh, dims=-1)[..., ::2].reshape(lead + (n // 2,))
    d = torch.roll(y_hi, -sh, dims=-1)[..., ::2].reshape(lead + (n // 2,))
    return a, d


def _bank_upsample_convolve_pair(a, d, lo, hi, n_out: int, offset: int):
    """Adjoint stage: ``upsample_convolve(a, lo) + upsample_convolve(d, hi)``
    as one synthesis bank call on the zero-stuffed planes."""
    lead = a.shape[:-1]
    dense, taps = _stage_dense(lo, hi)

    def stuff(c):
        c2 = c.reshape(-1, c.shape[-1])
        buf = c2.new_zeros((c2.shape[0], n_out))
        buf[..., ::2] = c2
        return buf

    y = modwt_bank.bank_synthesis((stuff(a), stuff(d)), dense, True)
    return torch.roll(y, (taps - 1 + offset) % n_out, dims=-1).reshape(lead + (n_out,))


def dtcwt(
    x: torch.Tensor,
    wavelet="sym8",
    *,
    levels: int,
) -> DTCWTResult:
    """Forward DTCWT of ``[..., N]`` signals (periodic boundaries).

    ``N`` must be divisible by ``2**levels``.  Returns complex highpasses
    per level plus both trees' final lowpasses.
    """
    h1, g1 = _level1(wavelet)
    _validate_signal(x, min_length=2)
    n = x.shape[-1]
    if levels < 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL, f"levels must be >= 1, got {levels}"
        )
    if n % (1 << levels):
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"N={n} must be divisible by 2^levels={1 << levels}",
            suggestions=("Pad the signal or reduce levels",),
        )
    kernel_res = _dtcwt_kernel_analysis(x, wavelet, levels)
    if kernel_res is not None:
        return kernel_res
    highpasses = []
    cur_a = cur_b = x
    for level in range(1, levels + 1):
        ha, ga, hb, gb, off_b = _stage_filters(h1, g1, level)
        if _decimated_bank_ok(cur_a, ha, ga):
            a_a, d_a = _bank_convolve_downsample_pair(cur_a, ha, ga, 0)
            a_b, d_b = _bank_convolve_downsample_pair(cur_b, hb, gb, off_b)
        else:
            d_a = convolve_downsample(cur_a, ga)
            a_a = convolve_downsample(cur_a, ha)
            d_b = convolve_downsample(cur_b, gb, offset=off_b)
            a_b = convolve_downsample(cur_b, hb, offset=off_b)
        highpasses.append(torch.complex(d_a, -d_b) * _INV_SQRT2)
        cur_a, cur_b = a_a, a_b
    return DTCWTResult(tuple(highpasses), cur_a, cur_b)


def idtcwt(result: DTCWTResult, wavelet="sym8") -> torch.Tensor:
    """Inverse DTCWT: exact adjoint cascade per tree, averaged."""
    kernel_out = _dtcwt_kernel_synthesis(result, wavelet)
    if kernel_out is not None:
        return kernel_out
    h1, g1 = _level1(wavelet)
    cur_a, cur_b = result.lowpass_a, result.lowpass_b
    for level in range(result.levels, 0, -1):
        z = result.highpasses[level - 1]
        d_a = _SQRT2 * z.real
        d_b = -_SQRT2 * z.imag
        n_out = 2 * z.shape[-1]
        ha, ga, hb, gb, off_b = _stage_filters(h1, g1, level)
        if _decimated_bank_ok(cur_a, ha, ga):
            cur_a = _bank_upsample_convolve_pair(cur_a, d_a, ha, ga, n_out, 0)
            cur_b = _bank_upsample_convolve_pair(cur_b, d_b, hb, gb, n_out, off_b)
        else:
            cur_a = upsample_convolve(cur_a, ha, n_out) + upsample_convolve(
                d_a, ga, n_out
            )
            cur_b = upsample_convolve(
                cur_b, hb, n_out, offset=off_b
            ) + upsample_convolve(d_b, gb, n_out, offset=off_b)
    return 0.5 * (cur_a + cur_b)
