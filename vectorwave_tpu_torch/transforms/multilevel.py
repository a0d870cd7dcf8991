"""Multi-level MODWT decomposition / reconstruction (à trous cascade).

Counterpart of ``vectorwave_tpu/transforms/multilevel.py``.  Both analysis
and synthesis use the level-j à trous filter (the base filter at stride
``2^(j-1)``, scaled by ``1/sqrt(2)`` per stage); the upsampled filter is
never materialized.

Routing: on an eligible CUDA tensor (float32 or bfloat16, at least 2
levels and :data:`KERNEL_MIN_N` samples, windows that fit) the whole
cascade is one launch of a hand-written CUDA kernel (:mod:`..kernels`);
everything else runs the plain PyTorch cascade below.  Periodic and zero
boundaries need a halo that fits; a symmetric boundary runs the
zero-boundary analysis kernel with its head spliced in, and the symmetric
synthesis kernel with its head and tail spliced in, so it needs the
analysis span within the signal and splice windows that do not overlap
(:mod:`..kernels.modwt_symmetric`), and its synthesis a call of
:data:`SYMMETRIC_SYNTHESIS_MIN_SAMPLES` samples.
``backend='torch'`` forces the plain path, ``backend='kernel'`` the kernel
tier (whose wrappers run their plain versions on CPU tensors).

The exact tier (``precision='exact'``, or a tolerance below 3e-6, on float32
or bfloat16 input) returns an :class:`ExactMODWTResult` of double-float
(hi, lo) planes from the fp64 exact kernels (:mod:`..kernels.modwt_exact`),
whatever ``backend`` says; float64 input takes the plain float64 cascade,
which is exact-grade already.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import get_backend, normalize_backend
from ..errors import ErrorCode, InvalidArgumentError
from ..ops.convolve import (
    atrous_analysis_pair,
    atrous_convolve,
    effective_length,
    fft_analysis_pair,
)
from ..ops.facade import should_use_fft
from ..wavelets.base import DiscreteWavelet
from .modwt import _resolve_discrete, _validate_signal

_INV_SQRT2 = 1.0 / math.sqrt(2.0)

#: Hard cap on decomposition depth.
MAX_DECOMPOSITION_LEVELS = 10

#: The shortest signal the cascade kernels serve under ``auto`` (the JAX
#: router's floor, 4096, was tuned on a TPU).  ``tools/sweep_gates.py`` on an
#: NVIDIA H100 80GB HBM3 at 700.00 W: the kernel pair (2 launches) beats the
#: plain cascade (108-524 launches) at every swept N from 128 to 8192 that
#: its halo admits, batch 1 and 128, db4 J=2/4/6 and sym8 J=4, periodic and
#: zero: 0.24-0.66 ms against 1.29-11.75 ms.  So do the fused denoise
#: (0.64-2.72 ms against 1.87-14.66 ms) and the symmetric analysis's mirror
#: kernel (0.19-0.82 ms against 1.09-26.36 ms, N to 131072).  Nothing shorter
#: than 128 was swept.  It binds the symmetric route alone: the periodic and
#: zero halo rule (the halo rounded up to 128, at most N) admits nothing
#: shorter anyway.
KERNEL_MIN_N = 128
#: The symmetric synthesis kernel's floor, on the samples of a call (batch
#: times N): its head and tail windows run on the plain inverse, 197-787
#: launches whatever the size, so at batch 1 it loses to the plain synthesis
#: (98-393 launches) at every swept N to 131072 (3.43-14.46 ms against
#: 1.12-7.42 ms), and it wins in every swept case from 128 x 65536 samples
#: on (3.10-13.41 ms against 6.33-50.21 ms; the same sweep).  The samples,
#: not N, decide: ``tools/sweep_gates.py samples`` (same card) at batch 1,
#: 8, 32 and 128, each at 2^20 ... 2^24 samples, found the kernel winning
#: all 32 cases from 2^23 samples (2.70-12.77 ms against 6.27-49.77 ms), 10
#: of 16 at 2^22 and none of 32 below, at every batch alike.
SYMMETRIC_SYNTHESIS_MIN_SAMPLES = 1 << 23


class MultiLevelMODWTResult(NamedTuple):
    """Multi-level MODWT coefficients.

    ``details[j-1]`` holds the level-j detail coefficients; ``approx`` is the
    final (coarsest) approximation.  All tensors share the input shape.
    """

    details: tuple[torch.Tensor, ...]
    approx: torch.Tensor

    @property
    def levels(self) -> int:
        return len(self.details)

    @property
    def signal_length(self) -> int:
        return self.approx.shape[-1]

    def detail_energy(self, level: int) -> torch.Tensor:
        """Energy of one detail level."""
        return (self.details[level - 1] ** 2).sum(dim=-1)

    def approx_energy(self) -> torch.Tensor:
        return (self.approx**2).sum(dim=-1)

    def total_energy(self) -> torch.Tensor:
        total = self.approx_energy()
        for d in self.details:
            total = total + (d**2).sum(dim=-1)
        return total

    def relative_energy_distribution(self) -> torch.Tensor:
        """Per-level relative energies ``[levels+1]``, detail 1..J then approx."""
        energies = [(d**2).sum(dim=-1) for d in self.details] + [self.approx_energy()]
        stacked = torch.stack(energies, dim=-1)
        return stacked / stacked.sum(dim=-1, keepdim=True)


class ExactMODWTResult(NamedTuple):
    """Exact-tier multi-level result: every plane is a double-float pair.

    ``details``/``approx`` are the float32 leading words, usable wherever a
    :class:`MultiLevelMODWTResult` is; ``details_lo``/``approx_lo`` carry the
    trailing words (about 48 effective bits combined).  Combine ``hi + lo``
    in float64 for a full-precision reading; feed the whole result back to
    :func:`imodwt_multilevel` for the <=1e-10 round trip.
    """

    details: tuple[torch.Tensor, ...]
    approx: torch.Tensor
    details_lo: tuple[torch.Tensor, ...]
    approx_lo: torch.Tensor

    @property
    def levels(self) -> int:
        return len(self.details)

    @property
    def signal_length(self) -> int:
        return self.approx.shape[-1]


#: Requested max |error| -> cheapest precision tier that meets it (the JAX
#: package's ladder; thresholds are ladder boundaries, not error claims).
_TOLERANCE_LADDER = ((3e-2, "bf16"), (1e-4, "bf16_3x"), (3e-6, "float32"))


def resolve_tolerance(tolerance: float) -> str:
    """Map a requested max error to a precision tier
    (``bf16 | bf16_3x | float32 | exact``)."""
    if not (tolerance > 0):
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"tolerance must be positive, got {tolerance}",
        )
    for bound, tier in _TOLERANCE_LADDER:
        if tolerance >= bound:
            return tier
    return "exact"


def _resolve_tier(tolerance, precision) -> str | None:
    """Combine the ``tolerance=`` / ``precision=`` kwargs into a tier
    (explicit ``precision`` wins; both None = config default)."""
    if precision is not None:
        valid = ("float32", "bf16_3x", "bf16", "exact")
        if precision not in valid:
            raise InvalidArgumentError(
                ErrorCode.CFG_INVALID_CONFIG,
                f"Unknown precision {precision!r}",
                suggestions=(f"Use one of {valid}",),
            )
        return precision
    if tolerance is not None:
        return resolve_tolerance(tolerance)
    return None


def _exact_profile(tolerance) -> str:
    """Tolerances under 5e-11 select the JAX package's ``full`` profile,
    anything else ``balanced`` (a no-op choice on the fp64 kernels)."""
    return "full" if tolerance is not None and tolerance < 5e-11 else "balanced"


def max_levels(signal_length: int, wavelet) -> int:
    """Maximum decomposition depth: largest J with ``(L0-1)*2^(J-1)+1 <= N``,
    capped at :data:`MAX_DECOMPOSITION_LEVELS`."""
    w = _resolve_discrete(wavelet)
    filter_length = w.filter_length
    if signal_length <= filter_length:
        return 0
    level = 1
    while level < MAX_DECOMPOSITION_LEVELS:
        if effective_length(filter_length, level) > signal_length:
            break
        level += 1
    return level - 1


def _check_level_fits(w: DiscreteWavelet, level: int, n: int) -> None:
    if effective_length(w.filter_length, level) > n:
        raise InvalidArgumentError(
            ErrorCode.VAL_TOO_LARGE,
            "Upsampled filter length exceeds signal length",
            context={
                "wavelet": w.name,
                "level": level,
                "effective_filter_length": effective_length(w.filter_length, level),
                "signal_length": n,
            },
            suggestions=("Reduce decomposition levels or increase signal length",),
        )


def _resolve_backend(backend: str | None, eligible) -> bool:
    """Map the ``backend`` argument to a use-the-kernel decision.

    ``None``/``'auto'`` routes by eligibility; ``'torch'`` (alias ``'jnp'``)
    forces the plain path; ``'kernel'`` (alias ``'pallas'``) forces the
    kernel tier; anything else raises.  ``eligible`` is a thunk so the
    forced choices skip the probe.
    """
    name = "auto" if backend is None else normalize_backend(backend)
    if name == "kernel":
        return True
    if name == "torch":
        return False
    return eligible()


def _kernel_eligible(x: torch.Tensor, w: DiscreteWavelet, levels: int,
                     boundary: str, synthesis: bool = False) -> bool:
    """Whether the CUDA kernel tier serves this call: a CUDA tensor on a
    Hopper card, float32/bfloat16, >= 2 levels, N >= :data:`KERNEL_MIN_N`
    (and :data:`SYMMETRIC_SYNTHESIS_MIN_SAMPLES` samples for a symmetric
    synthesis) and windows that fit (the kernels' shared-memory
    budget).  Periodic and zero boundaries need a halo of at most N and the
    room of the cascade pair, whose kernels are each other's backward
    (``modwt_composite.kernels_fit``); symmetric ones
    the gate of its direction (``synthesis``), ``modwt_symmetric.route_fits``."""
    from ..kernels.modwt_composite import kernels_fit
    from ..kernels.modwt_fused import kernel_available, total_halo

    backend = get_backend()
    if backend == "torch":
        return False
    if backend == "auto" and (x.device.type != "cuda" or not kernel_available()):
        return False
    if x.dtype not in (torch.float32, torch.bfloat16):
        return False
    b = boundary.lower()
    if not (b.startswith("per") or b.startswith("zero") or b.startswith("sym")):
        return False
    if levels < 2:
        return False
    n = x.shape[-1]
    if n < KERNEL_MIN_N:
        return False
    if b.startswith("sym"):
        if synthesis and math.prod(x.shape) < SYMMETRIC_SYNTHESIS_MIN_SAMPLES:
            return False
        from ..kernels.modwt_symmetric import route_fits

        return route_fits(w, levels, n, synthesis)
    halo_pad = -(-max(total_halo(w.filter_length, levels), 1) // 128) * 128
    return halo_pad <= n and kernels_fit(w.filter_length, levels)


def modwt_multilevel(
    x: torch.Tensor,
    wavelet,
    *,
    levels: int | None = None,
    boundary: str = "periodic",
    backend: str | None = None,
    tolerance: float | None = None,
    precision: str | None = None,
) -> MultiLevelMODWTResult:
    """Multi-level MODWT decomposition.

    At level j the previous approximation is convolved with the base filters
    at stride ``2^(j-1)``, scaled ``1/sqrt(2)`` per stage.  On an eligible
    CUDA tensor the whole cascade is one kernel launch.

    ``tolerance=`` requests a max-error budget and routes the precision tier
    (:func:`resolve_tolerance`); ``precision=`` picks one explicitly
    (``bf16 | bf16_3x | float32 | exact``).  The ``exact`` tier returns an
    :class:`ExactMODWTResult` (double-float planes from the fp64 exact
    kernels) whose round trip through :func:`imodwt_multilevel` stays
    within 1e-10; float64 input takes the plain float64 cascade instead,
    which is exact-grade already.
    """
    w = _resolve_discrete(wavelet)
    _validate_signal(x)
    n = x.shape[-1]
    if levels is None:
        levels = max_levels(n, w)
    if levels < 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL,
            f"levels must be >= 1, got {levels}",
            context={"signal_length": n, "wavelet": w.name},
        )
    _check_level_fits(w, levels, n)

    tier = _resolve_tier(tolerance, precision)
    if tier == "exact" and x.dtype == torch.float64:
        tier = None  # the float64 plain path is already exact-grade
    if tier == "exact":
        from ..kernels.modwt_exact import modwt_multilevel_exact

        lead = x.shape[:-1]
        flat = x.reshape(-1, n) if x.dim() > 2 else x
        dpairs, apair = modwt_multilevel_exact(
            flat.to(torch.float32), w, levels=levels, boundary=boundary,
            profile=_exact_profile(tolerance),
        )
        if x.dim() > 2:
            dpairs = tuple((hi.reshape(lead + (n,)), lo.reshape(lead + (n,)))
                           for hi, lo in dpairs)
            apair = tuple(p.reshape(lead + (n,)) for p in apair)
        return ExactMODWTResult(
            tuple(hi for hi, _ in dpairs), apair[0],
            tuple(lo for _, lo in dpairs), apair[1],
        )

    use_kernel = _resolve_backend(
        backend, lambda: _kernel_eligible(x, w, levels, boundary)
    )
    if use_kernel:
        from ..kernels.modwt_fused import fused_analysis

        details, approx = fused_analysis(
            x, w, levels=levels, boundary=boundary, precision=tier
        )
        return MultiLevelMODWTResult(tuple(details), approx)

    low = w.dec_lo * _INV_SQRT2
    high = w.dec_hi * _INV_SQRT2
    use_fft = boundary.lower().startswith("per") and should_use_fft(
        n, w.filter_length, x.device)
    details = []
    current = x
    for level in range(1, levels + 1):
        spacing = 1 << (level - 1)
        if use_fft:
            current, detail = fft_analysis_pair(current, low, high, spacing=spacing)
        else:
            current, detail = atrous_analysis_pair(
                current, low, high, spacing=spacing, boundary=boundary
            )
        details.append(detail)
    return MultiLevelMODWTResult(tuple(details), current)


class _AlignmentDecision(NamedTuple):
    approx_plus: bool
    delta_approx: int
    detail_plus: bool
    delta_detail: int


#: Per-(wavelet, level) symmetric-inverse decisions, the JAX package's
#: sweep-derived table; deeper levels reuse the last entry.
_DERIVED_ALIGNMENT: dict[str, list[tuple[bool, int, bool, int]]] = {
    "haar": [(True, 0, True, 0), (True, -1, True, -1), (True, -1, True, -1), (True, -1, True, -1), (True, -1, False, -1)],
    "db2": [(False, -1, True, -1), (False, 0, False, -1), (False, 1, True, 1), (False, -1, False, -1), (False, 1, True, 1)],
    "db4": [(False, -1, True, 0), (False, -1, True, 1), (False, -1, True, 1), (True, 1, False, 1), (False, 1, False, 1)],
    "db6": [(True, 1, False, -1), (False, -1, True, -1), (False, -1, False, -1), (False, 1, False, -1), (False, -1, True, -1)],
    "db8": [(False, 1, True, 1), (False, 1, False, 1), (False, 1, False, 0), (True, 1, True, 1), (False, -1, True, 1)],
    "db10": [(False, -1, False, -1), (True, 1, True, 1), (False, -1, True, 1), (False, 1, True, -1), (False, 1, True, 1)],
    "sym4": [(False, 0, True, 0), (True, -1, True, -1), (True, 1, True, 1), (False, 1, False, -1), (False, 1, True, 1)],
    "sym8": [(True, 0, False, 1), (False, 1, False, 0), (False, 1, True, 0), (False, 1, True, -1), (True, -1, False, 1)],
    "sym12": [(False, 0, False, 1), (False, 1, True, -1), (False, 1, False, 1), (True, -1, True, -1), (False, 1, False, -1)],
    "coif2": [(True, 0, False, 0), (True, 1, False, 1), (True, 1, True, 0), (True, 1, False, -1), (True, -1, False, -1)],
    "coif3": [(False, 0, False, 1), (False, 1, True, 1), (False, -1, True, -1), (True, -1, False, -1), (True, -1, True, -1)],
    "coif5": [(False, 1, True, 1), (False, 1, False, 1), (True, 1, True, 1), (False, -1, True, 1), (False, -1, True, -1)],
    "bior2.2": [(True, 1, True, 1), (True, 0, True, 1), (True, 1, True, 0), (True, 0, True, -1), (True, -1, True, -1)],
    "bior4.4": [(True, 1, True, -1), (True, 1, True, 1), (True, 1, True, 1), (True, 1, True, 0), (True, -1, True, 0)],
}


def _symmetric_alignment(w: DiscreteWavelet, level: int) -> _AlignmentDecision:
    """Symmetric-inverse orientation decision: the derived per-level table,
    else the heuristic table for wavelets not yet swept."""
    derived = _DERIVED_ALIGNMENT.get(w.name)
    if derived is not None:
        entry = derived[min(level, len(derived)) - 1]
        return _AlignmentDecision(*entry)
    base_len = w.rec_lo.shape[0]
    name = w.name

    if base_len <= 2:  # Haar
        return _AlignmentDecision(True, 0 if level <= 1 else -1, True, 0)

    if name == "db6":
        return _AlignmentDecision(
            False, 0 if level <= 1 else -1, True, 1 if level >= 3 else 0
        )
    if name == "db8":
        return _AlignmentDecision(
            False, 0 if level <= 1 else 1, True, 1 if level >= 2 else 0
        )
    if name == "sym4":
        return _AlignmentDecision(True, 0, False, 0)
    if name == "sym8":
        if level <= 1:
            return _AlignmentDecision(False, 0, True, 0)
        if level == 2:
            return _AlignmentDecision(False, 1, True, 0)
        return _AlignmentDecision(False, 1, True, 1)
    if name == "coif2":
        return _AlignmentDecision(True, 0 if level <= 1 else 1, False, 0)
    if name == "coif3":
        if level <= 1:
            return _AlignmentDecision(False, 0, False, 0)
        return _AlignmentDecision(False, -1, False, 1)
    if base_len >= 12:
        if level <= 1:
            return _AlignmentDecision(False, 0, True, 0)
        even = level % 2 == 0
        delta = 0 if even else -1
        return _AlignmentDecision(False, delta, True, delta)
    # DB4-length families (L0 = 8)
    if level <= 1:
        return _AlignmentDecision(False, 0, True, 0)
    return _AlignmentDecision(False, -1, True, 0)


def _tau_j(base_filter_length: int, level: int) -> int:
    """Center offset of the level-j à trous filter."""
    if level <= 1:
        return max(0, (base_filter_length - 1) // 2)
    return (effective_length(base_filter_length, level) - 1) // 2


def imodwt_multilevel(
    result: MultiLevelMODWTResult,
    wavelet,
    *,
    boundary: str = "periodic",
    backend: str | None = None,
    tolerance: float | None = None,
    precision: str | None = None,
) -> torch.Tensor:
    """Multi-level MODWT reconstruction, coarsest to finest.  Routes through
    the CUDA synthesis kernel like :func:`modwt_multilevel`.

    An :class:`ExactMODWTResult` goes through the exact synthesis kernel,
    whatever ``backend`` says, and comes back as the float32 hi word: the
    correctly rounded reconstruction, within 1e-10 of the float32 input of
    the analysis (in practice equal to it).
    """
    w = _resolve_discrete(wavelet)
    tier = _resolve_tier(tolerance, precision)
    if isinstance(result, ExactMODWTResult):
        return _imodwt_exact(result, w, boundary, tolerance)
    if tier == "exact":
        if result.approx.dtype != torch.float64:
            raise InvalidArgumentError(
                ErrorCode.CFG_INVALID_CONFIG,
                "tolerance/precision requests the exact tier, but this result "
                "carries plain float32 planes (the analysis already rounded them)",
                suggestions=("Run modwt_multilevel with the same tolerance=/"
                             "precision= so it returns an ExactMODWTResult",),
            )
        tier = None  # the float64 plain path below is exact-grade
    use_kernel = _resolve_backend(
        backend,
        lambda: _kernel_eligible(result.approx, w, result.levels, boundary,
                                 synthesis=True),
    )
    if use_kernel:
        from ..kernels.modwt_fused import fused_synthesis

        return fused_synthesis(
            result.details, result.approx, w, boundary=boundary, precision=tier
        )
    low = w.rec_lo * _INV_SQRT2
    high = w.rec_hi * _INV_SQRT2
    symmetric = boundary.lower().startswith("sym")
    current = result.approx
    for level in range(result.levels, 0, -1):
        detail = result.details[level - 1]
        spacing = 1 << (level - 1)
        _check_level_fits(w, level, current.shape[-1])
        if symmetric:
            dec = _symmetric_alignment(w, level)
            tau_h = _tau_j(w.rec_lo.shape[0], level) + dec.delta_approx
            tau_g = _tau_j(w.rec_hi.shape[0], level) + dec.delta_detail
            rec_a = atrous_convolve(
                current, low, spacing=spacing, boundary="symmetric",
                sign=+1 if dec.approx_plus else -1,
                offset=-tau_h if dec.approx_plus else tau_h,
            )
            rec_d = atrous_convolve(
                detail, high, spacing=spacing, boundary="symmetric",
                sign=+1 if dec.detail_plus else -1,
                offset=-tau_g if dec.detail_plus else tau_g,
            )
        else:
            rec_a = atrous_convolve(
                current, low, spacing=spacing, boundary=boundary, sign=+1
            )
            rec_d = atrous_convolve(
                detail, high, spacing=spacing, boundary=boundary, sign=+1
            )
        current = rec_a + rec_d
    return current


def _imodwt_exact(result: ExactMODWTResult, w: DiscreteWavelet, boundary: str,
                  tolerance) -> torch.Tensor:
    from ..kernels.modwt_exact import imodwt_multilevel_exact

    if boundary.lower().startswith("sym"):
        raise InvalidArgumentError(
            ErrorCode.CFG_UNSUPPORTED_BOUNDARY,
            "The exact tier has no symmetric inverse: the alignment-shifted "
            "symmetric inverse is a boundary approximation by design",
            suggestions=("Use periodic/zero boundaries for the exact round trip, "
                         "or the default tiers for a symmetric inverse",),
        )
    n = result.approx.shape[-1]
    lead = result.approx.shape[:-1]
    flatten = result.approx.dim() > 2

    def flat(p):
        return p.reshape(-1, n) if flatten else p

    dpairs = tuple((flat(hi), flat(lo)) for hi, lo in zip(result.details, result.details_lo))
    hi, _lo = imodwt_multilevel_exact(
        dpairs, (flat(result.approx), flat(result.approx_lo)), w, boundary=boundary,
        profile=_exact_profile(tolerance),
    )
    # hi == fl(hi + lo): the correctly rounded float32 reconstruction
    return hi.reshape(lead + (n,)) if flatten else hi
