"""Lifting-scheme DWT: the polyphase factorization and a lossless integer mode.

Counterpart of ``vectorwave_tpu/transforms/lifting.py``: the second
classical form of the fast wavelet transform (Daubechies & Sweldens 1998),
the one JPEG2000 standardised.  Each lifting step rounds its prediction
before adding it in the integer mode, so the inverse subtracts the same
rounded value and the round trip is exact on integer data (the reversible
LeGall 5/3).  The polyphase split is a strided slice, each step a one- or
two-tap ``roll`` and multiply-add on the half-rate grid.  Boundaries are
periodic; other modes raise.

Schemes are data (:class:`LiftingScheme`): Haar, LeGall 5/3, CDF 9/7 (the
registry's ``bior4.4``) and the D4 factorization of ``db2``.  The branch
normalisations come from the cascade's DC and Nyquist gains, so every scheme
lands on the ``sum dec_lo = sqrt(2)`` convention and :func:`lifting_dwt`
agrees with ``ops.dwt.dwt`` up to a circular shift.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..errors import ErrorCode, InvalidArgumentError
from ..ops.dwt import DWTResult, WavedecResult, _check_even

__all__ = [
    "LIFTING_SCHEMES",
    "LiftingScheme",
    "LiftingStep",
    "effective_filters",
    "get_lifting_scheme",
    "lifting_dwt",
    "lifting_dwt_int",
    "lifting_idwt",
    "lifting_idwt_int",
    "lifting_wavedec",
    "lifting_wavedec_int",
    "lifting_waverec",
    "lifting_waverec_int",
]


class LiftingStep(NamedTuple):
    """One predict/update step: target += sum_k taps[k] * source[n + offsets[k]].

    ``kind='predict'`` lifts the odd phase from the even phase;
    ``kind='update'`` lifts the even phase from the odd phase.  Offsets
    index the half-rate grid with periodic wrap.
    """

    kind: str
    taps: tuple[float, ...]
    offsets: tuple[int, ...]


class LiftingScheme(NamedTuple):
    """An ordered lifting cascade plus final branch normalisations."""

    name: str
    steps: tuple[LiftingStep, ...]
    k_approx: float
    k_detail: float


def _branch_gains(steps: tuple[LiftingStep, ...]) -> tuple[float, float]:
    """Normalisations from the unscaled cascade's gains: the approximation
    branch at DC and the detail branch at Nyquist, each to ``sqrt(2)``.

    A constant signal has constant polyphase components and lifting maps
    constants to constants, so both probes are scalar recursions.
    """

    def run(even: float, odd: float) -> tuple[float, float]:
        for step in steps:
            lift = sum(step.taps) * (even if step.kind == "predict" else odd)
            if step.kind == "predict":
                odd += lift
            else:
                even += lift
        return even, odd

    a_dc, _ = run(1.0, 1.0)  # x = 1: even = odd = 1
    _, d_ny = run(1.0, -1.0)  # x = (-1)^n: even = +1, odd = -1
    if abs(a_dc) < 1e-12 or abs(d_ny) < 1e-12:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            "Degenerate lifting cascade: zero DC (approx) or Nyquist (detail) gain",
        )
    return math.sqrt(2.0) / a_dc, math.sqrt(2.0) / d_ny


def _scheme(name: str, *steps: LiftingStep) -> LiftingScheme:
    k_a, k_d = _branch_gains(steps)
    return LiftingScheme(name, steps, k_a, k_d)


_SQRT3 = math.sqrt(3.0)

# CDF 9/7 lifting constants (Daubechies & Sweldens 1998, table 5; the
# JPEG2000 Part-1 irreversible transform).
_CDF97_ALPHA = -1.5861343420693648
_CDF97_BETA = -0.0529801185718856
_CDF97_GAMMA = 0.8829110755411875
_CDF97_DELTA = 0.4435068520511142

LIFTING_SCHEMES: dict[str, LiftingScheme] = {
    s.name: s
    for s in (
        _scheme(
            "haar",
            LiftingStep("predict", (-1.0,), (0,)),
            LiftingStep("update", (0.5,), (0,)),
        ),
        _scheme(
            "legall53",
            LiftingStep("predict", (-0.5, -0.5), (0, 1)),
            LiftingStep("update", (0.25, 0.25), (-1, 0)),
        ),
        _scheme(
            "cdf97",
            LiftingStep("predict", (_CDF97_ALPHA, _CDF97_ALPHA), (0, 1)),
            LiftingStep("update", (_CDF97_BETA, _CDF97_BETA), (-1, 0)),
            LiftingStep("predict", (_CDF97_GAMMA, _CDF97_GAMMA), (0, 1)),
            LiftingStep("update", (_CDF97_DELTA, _CDF97_DELTA), (-1, 0)),
        ),
        # Daubechies-Sweldens D4 factorization (1998, section 7.5).
        _scheme(
            "db2",
            LiftingStep("update", (_SQRT3,), (0,)),
            LiftingStep("predict", (-_SQRT3 / 4.0, -(_SQRT3 - 2.0) / 4.0), (0, -1)),
            LiftingStep("update", (-1.0,), (1,)),
        ),
    )
}

_ALIASES = {"bior2.2": "legall53", "bior4.4": "cdf97", "jpeg2000": "cdf97"}


def get_lifting_scheme(scheme) -> LiftingScheme:
    """A scheme by name (``haar``/``legall53``/``cdf97``/``db2`` or a
    JPEG2000/bior alias); a :class:`LiftingScheme` passes through."""
    if isinstance(scheme, LiftingScheme):
        return scheme
    key = str(scheme).lower()
    key = _ALIASES.get(key, key)
    found = LIFTING_SCHEMES.get(key)
    if found is None:
        raise InvalidArgumentError(
            ErrorCode.CFG_UNSUPPORTED_WAVELET,
            f"Unknown lifting scheme '{scheme}'",
            suggestions=(
                "One of: " + ", ".join(sorted(set(LIFTING_SCHEMES) | set(_ALIASES))),
            ),
        )
    return found


def _check_periodic(boundary: str) -> None:
    if boundary != "periodic":
        raise InvalidArgumentError(
            ErrorCode.CFG_UNSUPPORTED_BOUNDARY,
            f"Lifting transforms are periodic-only, got boundary='{boundary}'",
            suggestions=("Use boundary='periodic'",),
        )


def _step_sum(src: torch.Tensor, step: LiftingStep) -> torch.Tensor:
    out = None
    for tap, off in zip(step.taps, step.offsets):
        term = (torch.roll(src, -off, dims=-1) if off else src) * tap
        out = term if out is None else out + term
    return out


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    out = torch.stack([even, odd], dim=-1)
    return out.reshape(out.shape[:-2] + (2 * even.shape[-1],))


def lifting_dwt(x: torch.Tensor, scheme="cdf97", *, boundary: str = "periodic") -> DWTResult:
    """Single-level DWT by lifting (float path, normalised branches)."""
    _check_periodic(boundary)
    s = get_lifting_scheme(scheme)
    _check_even(x.shape[-1])
    even, odd = x[..., ::2], x[..., 1::2]
    for step in s.steps:
        if step.kind == "predict":
            odd = odd + _step_sum(even, step)
        else:
            even = even + _step_sum(odd, step)
    return DWTResult(even * s.k_approx, odd * s.k_detail)


def lifting_idwt(
    approx: torch.Tensor,
    detail: torch.Tensor,
    scheme="cdf97",
    *,
    boundary: str = "periodic",
) -> torch.Tensor:
    """Exact inverse: undo the scaling, run the steps backwards with signs
    flipped."""
    _check_periodic(boundary)
    s = get_lifting_scheme(scheme)
    even = approx / s.k_approx
    odd = detail / s.k_detail
    for step in reversed(s.steps):
        if step.kind == "predict":
            odd = odd - _step_sum(even, step)
        else:
            even = even - _step_sum(odd, step)
    return _interleave(even, odd)


def _lift_rounded(src: torch.Tensor, step: LiftingStep) -> torch.Tensor:
    """``floor(prediction + 1/2)`` in float64, cast back to the integer dtype.

    The forward step adds and the inverse subtracts the same expression of
    the same operand, so the round trip is exact; float64 keeps the
    prediction exact past 2^24 on every device.
    """
    pred = _step_sum(src.to(torch.float64), step)
    return torch.floor(pred + 0.5).to(src.dtype)


def _is_integer(x: torch.Tensor) -> bool:
    return not (x.dtype.is_floating_point or x.dtype.is_complex or x.dtype == torch.bool)


def lifting_dwt_int(x: torch.Tensor, scheme="legall53") -> DWTResult:
    """Reversible integer-to-integer DWT (the JPEG2000 lossless mode).

    The input must be an integer tensor; the branches are not normalised (a
    scale would break reversibility), as in the JPEG2000 reversible 5/3.
    The round trip through :func:`lifting_idwt_int` is exact.
    """
    if not _is_integer(x):
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"lifting_dwt_int needs an integer array, got dtype {x.dtype}",
            suggestions=("Cast to int32, or use lifting_dwt for float data",),
        )
    s = get_lifting_scheme(scheme)
    _check_even(x.shape[-1])
    even, odd = x[..., ::2], x[..., 1::2]
    for step in s.steps:
        if step.kind == "predict":
            odd = odd + _lift_rounded(even, step)
        else:
            even = even + _lift_rounded(odd, step)
    return DWTResult(even, odd)


def lifting_idwt_int(approx: torch.Tensor, detail: torch.Tensor,
                     scheme="legall53") -> torch.Tensor:
    """Exact inverse of :func:`lifting_dwt_int`."""
    s = get_lifting_scheme(scheme)
    even, odd = approx, detail
    for step in reversed(s.steps):
        if step.kind == "predict":
            odd = odd - _lift_rounded(even, step)
        else:
            even = even - _lift_rounded(odd, step)
    return _interleave(even, odd)


def _check_levels(n: int, levels: int | None) -> int:
    if levels is None:
        levels = 0
        m = n
        while m % 2 == 0 and m >= 4:
            m //= 2
            levels += 1
    if levels < 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL,
            f"levels must be >= 1, got {levels}",
            context={"signal_length": n},
        )
    if n % (1 << levels) != 0:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"Signal length {n} must be divisible by 2^levels = {1 << levels}",
            suggestions=("Reduce levels or pad the signal",),
        )
    return levels


def _wavedec(step, x: torch.Tensor, scheme, levels: int | None) -> WavedecResult:
    levels = _check_levels(x.shape[-1], levels)
    details = []
    current = x
    for _ in range(levels):
        res = step(current, scheme)
        details.append(res.detail)
        current = res.approx
    return WavedecResult(tuple(details), current)


def _waverec(step, result: WavedecResult, scheme) -> torch.Tensor:
    current = result.approx
    for level in range(result.levels, 0, -1):
        current = step(current, result.details[level - 1], scheme)
    return current


def lifting_wavedec(x: torch.Tensor, scheme="cdf97", *,
                    levels: int | None = None) -> WavedecResult:
    """Multi-level lifting decomposition (a pyramid on the approximation)."""
    return _wavedec(lifting_dwt, x, scheme, levels)


def lifting_waverec(result: WavedecResult, scheme="cdf97") -> torch.Tensor:
    """Inverse of :func:`lifting_wavedec`."""
    return _waverec(lifting_idwt, result, scheme)


def lifting_wavedec_int(x: torch.Tensor, scheme="legall53", *,
                        levels: int | None = None) -> WavedecResult:
    """Multi-level reversible integer decomposition (the lossless pyramid)."""
    return _wavedec(lifting_dwt_int, x, scheme, levels)


def lifting_waverec_int(result: WavedecResult, scheme="legall53") -> torch.Tensor:
    """Exact inverse of :func:`lifting_wavedec_int`."""
    return _waverec(lifting_idwt_int, result, scheme)


def effective_filters(scheme, n: int = 64) -> tuple[np.ndarray, np.ndarray]:
    """Length-``n`` circular rows of the equivalent analysis filters, in
    float64.

    The pair satisfies ``approx[i] = sum_j lo[(j - 2i) mod n] * x[j]`` (and
    likewise for ``hi``), the indexing of ``ops.dwt.dwt``'s
    ``out[i] = sum_j f[j] x[(2i + j) mod N]`` read at ``i = 0``.
    """
    s = get_lifting_scheme(scheme)
    res = lifting_dwt(torch.eye(n, dtype=torch.float64), s)  # rows = basis vectors
    return res.approx[:, 0].numpy(), res.detail[:, 0].numpy()
