"""2-D dual-tree complex wavelet transform: six oriented complex subbands.

Counterpart of ``vectorwave_tpu/transforms/dtcwt2.py``.  The dual tree runs
along both axes (four separable tree combinations, row tree x column tree
in {a, b}^2), and sum and difference combinations of each (LH, HL, HH)
quartet yield six complex subbands whose spectra each occupy one quadrant
corner of the frequency plane: orientations of roughly +-15, +-45 and +-75
degrees.  The filters are :mod:`.dtcwt`'s (the level-1 orthonormal wavelet,
then the generated q-shift pair).

Combination rule per subband quartet ``S_rc`` (r = row tree, c = column
tree): with ``u = (S_aa - S_bb)/sqrt(2)`` and ``v = (S_ab + S_ba)/sqrt(2)``
the two orientations are ``z+ = (u + i v)/sqrt(2)`` and
``z- = (u' + i v')/sqrt(2)`` from the complementary pair
``u' = (S_aa + S_bb)/sqrt(2)``, ``v' = (S_ab - S_ba)/sqrt(2)``: a unitary
map, so energy is preserved and the inverse is its adjoint.

The trees run on the plain decimated ops (periodic), as the JAX package's
do: no kernel route serves them.  float32 input gives complex64 subbands,
float64 input complex128.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..errors import ErrorCode, InvalidArgumentError
from ..ops.dwt import convolve_downsample, upsample_convolve
from .dtcwt import _level1, _qshift

__all__ = ["DTCWT2Result", "dtcwt2", "idtcwt2"]

#: Subband order (grating-normal angles): (-15, +15, -75, +75, +45, -45)
#: degrees.  The +-45 (HH) bands are near-perfectly one-quadrant; the +-15 /
#: +-75 bands keep about 15% mirror leakage, inherent to the standard
#: construction's half-sample-delayed lowpass pair.


class DTCWT2Result(NamedTuple):
    """Per level: complex ``[..., 6, H/2^j, W/2^j]`` oriented subbands;
    plus the four tree combinations' final lowpasses ``[..., 4, h, w]``."""

    highpasses: tuple[torch.Tensor, ...]
    lowpasses: torch.Tensor

    @property
    def levels(self) -> int:
        return len(self.highpasses)

    def magnitudes(self) -> tuple[torch.Tensor, ...]:
        return tuple(z.abs() for z in self.highpasses)

    def orientation_energy(self, level: int) -> torch.Tensor:
        """[..., 6] energy per orientation at ``level`` (1-based)."""
        z = self.highpasses[level - 1]
        return (z.abs() ** 2).sum(dim=(-2, -1))


def _filters_for(level: int, tree: str, h1, g1, hq, gq):
    if level == 1:
        return (h1, g1, 0) if tree == "a" else (h1, g1, 1)
    if tree == "a":
        return (hq, gq, 0)
    return (hq[::-1], gq[::-1], 0)


def _analysis_axis(x, lo, hi, offset, axis):
    """One decimated stage along ``axis``; returns (approx, detail)."""
    moved = torch.movedim(x, axis, -1)
    a = convolve_downsample(moved, lo, offset=offset)
    d = convolve_downsample(moved, hi, offset=offset)
    return torch.movedim(a, -1, axis), torch.movedim(d, -1, axis)


def _synthesis_axis(a, d, lo, hi, offset, axis, n_out):
    am = torch.movedim(a, axis, -1)
    dm = torch.movedim(d, axis, -1)
    out = upsample_convolve(am, lo, n_out, offset=offset) + upsample_convolve(
        dm, hi, n_out, offset=offset
    )
    return torch.movedim(out, -1, axis)


_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def _combine(quartet):
    """4 real subbands (aa, ab, ba, bb) -> 2 complex orientations."""
    s_aa, s_ab, s_ba, s_bb = quartet
    u = (s_aa - s_bb) * _INV_SQRT2
    v = (s_ab + s_ba) * _INV_SQRT2
    up = (s_aa + s_bb) * _INV_SQRT2
    vp = (s_ab - s_ba) * _INV_SQRT2
    return torch.complex(u, v) * _INV_SQRT2, torch.complex(up, vp) * _INV_SQRT2


def _split(z_pos, z_neg):
    """Adjoint of :func:`_combine`."""
    u = z_pos.real * math.sqrt(2.0)
    v = z_pos.imag * math.sqrt(2.0)
    up = z_neg.real * math.sqrt(2.0)
    vp = z_neg.imag * math.sqrt(2.0)
    s_aa = (u + up) * _INV_SQRT2
    s_bb = (up - u) * _INV_SQRT2
    s_ab = (v + vp) * _INV_SQRT2
    s_ba = (v - vp) * _INV_SQRT2
    return s_aa, s_ab, s_ba, s_bb


_TREES = ("aa", "ab", "ba", "bb")  # (row tree, column tree)


def dtcwt2(image: torch.Tensor, wavelet="sym8", *, levels: int) -> DTCWT2Result:
    """Forward 2-D DTCWT of ``[..., H, W]`` images (periodic boundaries).

    ``H`` and ``W`` must be divisible by ``2**levels``.  Level ``j``'s
    subbands are ``[..., 6, H/2^j, W/2^j]`` complex, orientation order
    ``(-15, +15, -75, +75, +45, -45)`` degrees (grating-normal angles).
    """
    h1, g1 = _level1(wavelet)
    hq, gq = _qshift()
    if image.dim() < 2:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"dtcwt2 expects [..., H, W], got {tuple(image.shape)}",
        )
    h, wd = image.shape[-2], image.shape[-1]
    if levels < 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL, f"levels must be >= 1, got {levels}"
        )
    if h % (1 << levels) or wd % (1 << levels):
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"H={h}, W={wd} must divide 2^levels={1 << levels}",
            suggestions=("Pad the image or reduce levels",),
        )
    lows = {t: image for t in _TREES}
    highpasses = []
    for level in range(1, levels + 1):
        subs = {}
        for t in _TREES:
            row_lo, row_hi, row_off = _filters_for(level, t[0], h1, g1, hq, gq)
            col_lo, col_hi, col_off = _filters_for(level, t[1], h1, g1, hq, gq)
            # rows = axis -2 filtered with the row tree, columns = axis -1
            a_r, d_r = _analysis_axis(lows[t], row_lo, row_hi, row_off, -2)
            ll, lh = _analysis_axis(a_r, col_lo, col_hi, col_off, -1)
            hl, hh = _analysis_axis(d_r, col_lo, col_hi, col_off, -1)
            subs[t] = (ll, lh, hl, hh)
            lows[t] = ll
        bands = []
        for k in (1, 2, 3):  # LH, HL, HH
            z_pos, z_neg = _combine(tuple(subs[t][k] for t in _TREES))
            bands.extend([z_pos, z_neg])
        highpasses.append(torch.stack(bands, dim=-3))
    lowpasses = torch.stack([lows[t] for t in _TREES], dim=-3)
    return DTCWT2Result(tuple(highpasses), lowpasses)


def idtcwt2(result: DTCWT2Result, wavelet="sym8") -> torch.Tensor:
    """Inverse 2-D DTCWT: the adjoint per tree combination, averaged over 4."""
    h1, g1 = _level1(wavelet)
    hq, gq = _qshift()
    lows = {t: result.lowpasses[..., i, :, :] for i, t in enumerate(_TREES)}
    for level in range(result.levels, 0, -1):
        z = result.highpasses[level - 1]
        quartets = {}
        for idx, k in enumerate((1, 2, 3)):
            parts = _split(z[..., 2 * idx, :, :], z[..., 2 * idx + 1, :, :])
            quartets[k] = dict(zip(_TREES, parts))
        for t in _TREES:
            row_lo, row_hi, row_off = _filters_for(level, t[0], h1, g1, hq, gq)
            col_lo, col_hi, col_off = _filters_for(level, t[1], h1, g1, hq, gq)
            ll = lows[t]
            lh, hl, hh = quartets[1][t], quartets[2][t], quartets[3][t]
            n_col = 2 * ll.shape[-1]
            a_r = _synthesis_axis(ll, lh, col_lo, col_hi, col_off, -1, n_col)
            d_r = _synthesis_axis(hl, hh, col_lo, col_hi, col_off, -1, n_col)
            n_row = 2 * ll.shape[-2]
            lows[t] = _synthesis_axis(a_r, d_r, row_lo, row_hi, row_off, -2, n_row)
    return 0.25 * sum(lows[t] for t in _TREES)
