"""2-D wavelet transforms (separable).

Counterpart of ``vectorwave_tpu/transforms/twodim.py``.  Conventions follow
the 1-D engine: undecimated MODWT2 with the per-stage 1/sqrt(2) scaling and
the same three boundary modes; decimated DWT2 with the ``ops.dwt`` indexing.

Band names: the first letter is the filter along H (rows), the second along
W (columns).  ``ll`` is low/low (smooth), ``lh`` low along H and high along W
(vertical edges, variation along W), ``hl`` high along H and low along W
(horizontal edges), ``hh`` high/high (diagonal).  Arrays are ``[..., H, W]``;
leading axes are batch.  As in the 1-D engine, only periodic round trips are
exact to machine precision; zero and symmetric ones are exact in the
interior.

Routing of the multi-level pair: ``backend='auto'`` (the default) sends an
eligible CUDA tensor to the 2-D kernel tier (:mod:`..kernels.modwt2`: one
hand-written CUDA launch per level and direction, for periodic, zero and
symmetric boundaries) and everything else to the plain per-level cascade;
``'torch'`` (alias ``'jnp'``) forces the plain cascade; ``'kernel'`` (alias
``'pallas'``) forces the kernel tier, whose wrappers run their plain versions
on a CPU tensor and which raises on a CUDA tensor it cannot serve.  The JAX
module's three routes (the Pallas kernels, the reflect-padded symmetric fast
paths, the banded-matmul path) are one kernel tier here, which has a
symmetric edge mode of its own.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import get_backend, normalize_backend
from ..errors import ErrorCode, InvalidArgumentError, InvalidSignalError
from ..kernels import modwt2 as k2
from ..kernels.modwt_fused import _kernel_filters
from ..ops.dwt import dwt, idwt
from .modwt import MODWTResult, _resolve_discrete, imodwt, modwt
from .multilevel import _check_level_fits


def _check_2d(x: torch.Tensor, name: str) -> None:
    if x.dim() < 2:
        raise InvalidSignalError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"{name} needs [..., H, W] input, got shape {tuple(x.shape)}",
        )


def _swap(t: torch.Tensor) -> torch.Tensor:
    return t.transpose(-1, -2)


class MODWT2Result(NamedTuple):
    """Single-level 2-D MODWT bands, each shaped like the input."""

    ll: torch.Tensor
    lh: torch.Tensor
    hl: torch.Tensor
    hh: torch.Tensor

    def energy(self) -> torch.Tensor:
        return sum((b**2).sum(dim=(-1, -2)) for b in self)


def modwt2(x: torch.Tensor, wavelet, *, boundary: str = "periodic") -> MODWT2Result:
    """Single-level separable 2-D MODWT: the pass along W, then along H."""
    _check_2d(x, "modwt2")
    w = _resolve_discrete(wavelet)
    col = modwt(x, w, boundary=boundary)  # along W
    a = _rows_pair(col.approx, w, boundary)  # along H: (low-H, high-H)
    d = _rows_pair(col.detail, w, boundary)
    return MODWT2Result(ll=a[0], lh=d[0], hl=a[1], hh=d[1])


def _rows_pair(x: torch.Tensor, w, boundary: str):
    res = modwt(_swap(x), w, boundary=boundary)
    return _swap(res.approx), _swap(res.detail)


def imodwt2(result: MODWT2Result, wavelet, *, boundary: str = "periodic") -> torch.Tensor:
    """Inverse separable 2-D MODWT (the inverse along H, then along W)."""
    w = _resolve_discrete(wavelet)

    def inv_rows(a, d):
        return _swap(imodwt(MODWTResult(_swap(a), _swap(d)), w, boundary=boundary))

    col_approx = inv_rows(result.ll, result.hl)  # low-W bands: (low-H, high-H)
    col_detail = inv_rows(result.lh, result.hh)  # high-W bands
    return imodwt(MODWTResult(col_approx, col_detail), w, boundary=boundary)


class MultiLevelMODWT2Result(NamedTuple):
    """J-level 2-D MODWT: per-level ``(lh, hl, hh)`` triples and the final
    ``ll``."""

    details: tuple  # ((lh, hl, hh), ...) level 1..J
    approx: torch.Tensor

    @property
    def levels(self) -> int:
        return len(self.details)

    def detail_energy(self, level: int) -> torch.Tensor:
        lh, hl, hh = self.details[level - 1]
        return (lh**2 + hl**2 + hh**2).sum(dim=(-1, -2))


def _kernel_route(x: torch.Tensor, w, levels: int, boundary: str, backend) -> bool:
    name = get_backend() if backend is None else normalize_backend(backend)
    if name != "auto":
        return name == "kernel"
    return k2.modwt2_kernel_eligible(x, w, levels, boundary)


def modwt2_multilevel(
    x: torch.Tensor,
    wavelet,
    *,
    levels: int,
    boundary: str = "periodic",
    backend: str | None = None,
) -> MultiLevelMODWT2Result:
    """J-level separable 2-D MODWT with à trous spacing ``2^(j-1)`` at level
    j along both axes (the 1-D cascade's convention), so the level-j bands
    isolate dyadic scale 2^j in H and W.  On an eligible CUDA tensor each
    level is one launch of the 2-D analysis kernel."""
    _check_2d(x, "modwt2_multilevel")
    if levels < 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL, f"levels must be >= 1, got {levels}"
        )
    w = _resolve_discrete(wavelet)
    _check_level_fits(w, levels, min(x.shape[-1], x.shape[-2]))
    if _kernel_route(x, w, levels, boundary, backend):
        details, ll = k2.modwt2_multilevel_kernel(x, w, levels, boundary)
        return MultiLevelMODWT2Result(details, ll)
    filters = _kernel_filters(w, synthesis=False)
    details = []
    cur = x
    for level in range(1, levels + 1):
        cur, lh, hl, hh = k2.analysis2_level_plain(cur, filters, 1 << (level - 1),
                                                   boundary)
        details.append((lh, hl, hh))
    return MultiLevelMODWT2Result(tuple(details), cur)


def imodwt2_multilevel(
    result: MultiLevelMODWT2Result,
    wavelet,
    *,
    boundary: str = "periodic",
    backend: str | None = None,
) -> torch.Tensor:
    """Inverse of :func:`modwt2_multilevel`, coarsest level first: per level
    the inverse along H on ``(ll, hl)`` and on ``(lh, hh)``, then along W
    (symmetric boundaries take the 1-D engine's alignment table).  On an
    eligible CUDA tensor each level is one launch of the 2-D synthesis
    kernel."""
    w = _resolve_discrete(wavelet)
    if _kernel_route(result.approx, w, result.levels, boundary, backend):
        return k2.imodwt2_multilevel_kernel(result.details, result.approx, w, boundary)
    filters = _kernel_filters(w, synthesis=True)
    edge = "symmetric" if boundary.lower().startswith("sym") else boundary
    ops = k2.synthesis_ops(w, result.levels, edge)
    cur = result.approx
    for level in range(result.levels, 0, -1):
        lh, hl, hh = result.details[level - 1]
        cur = k2.synthesis2_level_plain(cur, lh, hl, hh, filters, 1 << (level - 1),
                                        ops[level - 1], boundary)
    return cur


class DWT2Result(NamedTuple):
    """Single-level decimated 2-D DWT: ``[..., H/2, W/2]`` bands."""

    ll: torch.Tensor
    lh: torch.Tensor
    hl: torch.Tensor
    hh: torch.Tensor


def dwt2(x: torch.Tensor, wavelet, *, boundary: str = "periodic") -> DWT2Result:
    """Single-level separable decimated DWT (H and W must be even)."""
    _check_2d(x, "dwt2")
    col = dwt(x, wavelet, boundary=boundary)

    def rows(v):
        r = dwt(_swap(v), wavelet, boundary=boundary)
        return _swap(r.approx), _swap(r.detail)

    a = rows(col.approx)  # (low-H, high-H) of low-W
    d = rows(col.detail)  # (low-H, high-H) of high-W
    return DWT2Result(ll=a[0], lh=d[0], hl=a[1], hh=d[1])


def idwt2(result: DWT2Result, wavelet, *, boundary: str = "periodic") -> torch.Tensor:
    def inv_rows(a, d):
        return _swap(idwt(_swap(a), _swap(d), wavelet, boundary=boundary))

    col_approx = inv_rows(result.ll, result.hl)  # low-W bands: (low-H, high-H)
    col_detail = inv_rows(result.lh, result.hh)  # high-W bands
    return idwt(col_approx, col_detail, wavelet, boundary=boundary)


def wavedec2(x: torch.Tensor, wavelet, *, levels: int, boundary: str = "periodic"):
    """J-level decimated 2-D pyramid; returns ``(details list, ll)`` with
    ``details[j-1] = (lh, hl, hh)`` at level j."""
    if levels < 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL, f"levels must be >= 1, got {levels}"
        )
    _check_2d(x, "wavedec2")
    h_dim, w_dim = x.shape[-2], x.shape[-1]
    div = 1 << levels
    if h_dim % div or w_dim % div:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"Image dims {h_dim}x{w_dim} must be divisible by 2^levels = {div}",
            suggestions=("Reduce levels or pad the image",),
        )
    details = []
    cur = x
    for _ in range(levels):
        res = dwt2(cur, wavelet, boundary=boundary)
        details.append((res.lh, res.hl, res.hh))
        cur = res.ll
    return details, cur


def waverec2(details, ll, wavelet, *, boundary: str = "periodic") -> torch.Tensor:
    cur = ll
    for lh, hl, hh in reversed(details):
        cur = idwt2(DWT2Result(cur, lh, hl, hh), wavelet, boundary=boundary)
    return cur


def denoise2(
    x: torch.Tensor,
    wavelet,
    *,
    levels: int = 3,
    method: str = "universal",
    mode: str = "soft",
    boundary: str = "periodic",
) -> torch.Tensor:
    """2-D denoising: threshold each detail band per level with the
    sigma-scaled rule of the 1-D engine (the finest HH estimates the noise).

    Band statistics are taken over the whole ``[H, W]`` plane, so sigma is
    one estimate per image and the universal threshold uses N = H*W (the 2-D
    VisuShrink rule); the result commutes with transposition."""
    from ..ops.thresholds import apply_threshold, mad_sigma, select_threshold

    def _flat(b):
        return b.reshape(*b.shape[:-2], -1)

    res = modwt2_multilevel(x, wavelet, levels=levels, boundary=boundary)
    sigma = mad_sigma(_flat(res.details[0][2]))  # finest diagonal band
    new_details = []
    for level, bands in enumerate(res.details, start=1):
        level_sigma = sigma / (2.0**level)  # two 1/sqrt(2) stages per level
        new_details.append(tuple(
            apply_threshold(b, select_threshold(_flat(b), level_sigma, method)[..., None],
                            mode)
            for b in bands
        ))
    return imodwt2_multilevel(
        MultiLevelMODWT2Result(tuple(new_details), res.approx), wavelet, boundary=boundary
    )
