"""The exact precision tier: MODWT planes as double-float (hi, lo) float32
pairs, round trips within 1e-10.

Counterpart of ``vectorwave_tpu/kernels/modwt_exact.py``.  A TPU has no f64
units, so the JAX package carries each plane as an unevaluated float32 sum
``hi + lo`` and computes every dot error-free from 8-bit bf16 slices.  The
H100 has native fp64: the two kernels here (:func:`.modwt_composite.exact_analysis`
and :func:`.modwt_composite.exact_synthesis`, sources
``csrc/modwt_exact_{analysis,synthesis}.cu``) read each pair as a double,
run the à trous cascade in fp64 and write each result back as a pair, hi the
correctly rounded float32 value.  So the planes keep the JAX contract of
about 48 effective bits, and the round trip of float32 data comes back with
RMSE near 1e-16 and hi equal to x.

``profile=`` keeps the JAX names (:data:`PROFILES`) and is validated, but is
otherwise a no-op: fp64 meets both the ``balanced`` (<=1e-10) and the
``full`` (~1e-13) contract.  The JAX ``interpret=`` and ``tile=`` arguments
are dropped.  The tier has no gradient, as in JAX: an input that requires
grad raises.

``halo=`` is the sharded exact tier's neighbour exchange
(``parallel.tiled``): a left halo of raw float32 samples for the analysis,
one right ``(hi, lo)`` halo pair per plane for the synthesis, with zero
edges beyond them (``periodic`` must be False; JAX lets the halo override
it).  Where the launch plan is one window launch (db4 J=6, the config #2
shape) the kernels read the halo through a load rule.  Where the plan is
split (several launches, as sym8 J=10, or a ``direct`` level) the later
launches would read an approximation pair the neighbour never sent, so the
wrapper materialises ``[halo | x]`` (``[plane | halo]``) once, runs the
zero-edge plan and slices each plane back to N.
"""

from __future__ import annotations

import torch

from ..errors import ErrorCode, InvalidArgumentError
from . import modwt_composite
from .modwt_fused import _kernel_filters

#: The JAX package's exact profiles, by name, with what each promises.  The
#: fp64 kernels meet both, so the choice changes nothing here.
PROFILES: dict[str, str] = {
    "full": "~1e-13 round trip (JAX: 21 exact slice pairs)",
    "balanced": "<=1e-10 round trip (JAX: 19 slice pairs, bucketed combine)",
}


def _resolve_profile(profile) -> str:
    if profile in PROFILES:
        return profile
    raise InvalidArgumentError(
        ErrorCode.CFG_INVALID_CONFIG,
        f"Unknown exact profile {profile!r}",
        suggestions=(f"Use one of {tuple(PROFILES)}",),
    )


def _f32(t: torch.Tensor | None) -> torch.Tensor | None:
    return None if t is None else t.to(torch.float32).contiguous()


def analysis_exact(
    x: torch.Tensor,
    levels: int,
    filters: tuple,
    periodic: bool,
    x_lo: torch.Tensor | None = None,
    halo: torch.Tensor | None = None,
    profile="balanced",
):
    """[B, N] (or a pair with ``x_lo``) -> tuple of ``levels + 1`` (hi, lo)
    float32 plane pairs, d_1 .. d_J then a_J.  One launch of the exact
    analysis kernel on a CUDA tensor (more where a deep halo does not fit
    shared memory), its plain version on a CPU tensor.  ``halo``: ``[B, H]``
    raw samples just left of each row (module docstring)."""
    _resolve_profile(profile)
    return modwt_composite.exact_analysis(_f32(x), _f32(x_lo), levels, filters, periodic,
                                          halo=_f32(halo))


def synthesis_exact(coeff_pairs, levels: int, filters: tuple, periodic: bool,
                    halo=None, profile="balanced"):
    """Tuple of ``levels + 1`` (hi, lo) pairs -> the reconstructed (hi, lo).
    ``halo``: one ``(hi, lo)`` pair of ``[B, H]`` samples just right of each
    plane's end (module docstring)."""
    _resolve_profile(profile)
    pairs = tuple((_f32(hi), _f32(lo)) for hi, lo in coeff_pairs)
    if halo is not None:
        halo = tuple((_f32(hi), _f32(lo)) for hi, lo in halo)
    return modwt_composite.exact_synthesis(pairs, levels, filters, periodic, halo=halo)


def modwt_roundtrip_exact(x, wavelet, *, levels: int, profile="balanced"):
    """Periodic analysis + synthesis through the exact kernels; returns the
    reconstructed (hi, lo) pair (combine in float64 to evaluate)."""
    from ..transforms.modwt import _resolve_discrete

    w = _resolve_discrete(wavelet)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None, :]
    pairs = analysis_exact(x, levels, _kernel_filters(w, synthesis=False), True,
                           profile=profile)
    hi, lo = synthesis_exact(pairs, levels, _kernel_filters(w, synthesis=True), True,
                             profile=profile)
    if squeeze:
        hi, lo = hi[0], lo[0]
    return hi, lo


def analysis_exact_symmetric(x, levels: int, filters: tuple,
                             x_lo: torch.Tensor | None = None, profile="balanced"):
    """Exact symmetric analysis: the per-level mirrored cascade.

    The symmetric cascade mirrors the evolving approximation at each level,
    so it is not a filter composition.  Each level is one launch of the
    exact analysis kernel, at that level's stride, with zero edges, on the
    (hi, lo) approximation with its own half-point mirror prepended (a flip:
    no arithmetic, so the pairs keep their ~48 bits).  The symmetric inverse
    is not part of the exact tier, as in JAX.
    """
    _resolve_profile(profile)
    low = filters[0]
    cur_hi, cur_lo = _f32(x), _f32(x_lo)
    outs = []
    for j in range(1, levels + 1):
        hist = (len(low) - 1) << (j - 1)

        def mirrored(t):
            return torch.cat([torch.flip(t[..., :hist], dims=(-1,)), t], dim=-1)

        (d_hi, d_lo), (a_hi, a_lo) = modwt_composite.exact_analysis(
            mirrored(cur_hi), None if cur_lo is None else mirrored(cur_lo), 1,
            filters, False, first_level=j,
        )
        outs.append((d_hi[..., hist:].contiguous(), d_lo[..., hist:].contiguous()))
        cur_hi, cur_lo = a_hi[..., hist:].contiguous(), a_lo[..., hist:].contiguous()
    outs.append((cur_hi, cur_lo))
    return tuple(outs)


def modwt_multilevel_exact(x, wavelet, *, levels: int, boundary: str = "periodic",
                           profile="balanced"):
    """Public exact-tier analysis: [B, N] (or [N]) -> ``(details, approx)``
    where every plane is a float32 (hi, lo) pair.  Combine ``hi + lo`` in
    float64 for a full-precision reading; the round trip through
    :func:`imodwt_multilevel_exact` stays within 1e-10 RMSE.  Periodic, zero
    and symmetric boundaries (symmetric by :func:`analysis_exact_symmetric`;
    its inverse stays periodic or zero)."""
    from ..transforms.modwt import _resolve_discrete

    b_l = boundary.lower()
    if not (b_l.startswith("per") or b_l.startswith("zero") or b_l.startswith("sym")):
        raise InvalidArgumentError(
            ErrorCode.CFG_UNSUPPORTED_BOUNDARY,
            "Exact-tier kernels support periodic/zero/symmetric boundaries",
        )
    w = _resolve_discrete(wavelet)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None, :]
    filters = _kernel_filters(w, synthesis=False)
    if b_l.startswith("sym"):
        pairs = analysis_exact_symmetric(x, levels, filters, profile=profile)
    else:
        pairs = analysis_exact(x, levels, filters, b_l.startswith("per"),
                               profile=profile)
    if squeeze:
        pairs = tuple((hi[0], lo[0]) for hi, lo in pairs)
    return tuple(pairs[:levels]), pairs[levels]


def imodwt_multilevel_exact(details, approx, wavelet, *, boundary: str = "periodic",
                            profile="balanced"):
    """Inverse of :func:`modwt_multilevel_exact`: (hi, lo) plane pairs ->
    the reconstructed (hi, lo) pair.  A boundary other than periodic takes
    zero edges, as in JAX."""
    from ..transforms.modwt import _resolve_discrete

    w = _resolve_discrete(wavelet)
    pairs = tuple(details) + (approx,)
    squeeze = pairs[0][0].dim() == 1
    if squeeze:
        pairs = tuple((hi[None, :], lo[None, :]) for hi, lo in pairs)
    hi, lo = synthesis_exact(pairs, len(details), _kernel_filters(w, synthesis=True),
                             boundary.lower().startswith("per"), profile=profile)
    if squeeze:
        hi, lo = hi[0], lo[0]
    return hi, lo
