"""Wavelet-domain sparse recovery: FISTA over the MODWT tight frame.

Counterpart of ``vectorwave_tpu/optimize/sparse.py``: missing-sample
inpainting (1-D and 2-D), basis-pursuit denoising and recovery from an
arbitrary differentiable measurement map, each solved by accelerated
proximal gradient (FISTA, Beck & Teboulle 2009).

* The per-stage ``1/sqrt(2)`` MODWT is a Parseval tight frame, so the
  synthesis operator has unit spectral norm and the default step size 1.0
  converges: no line search on the hot path.
* The data-term gradient is :func:`torch.autograd.grad` through the
  synthesis itself.  On an eligible CUDA tensor the 1-D synthesis is the
  cascade synthesis kernel, whose backward is the analysis kernel, so each
  FISTA step launches one synthesis and one analysis kernel.  The 2-D
  kernel tier has no gradient on the card (nor has the JAX tier): the 2-D
  data term differentiates through the plain 2-D cascade, while the first
  analysis and the final synthesis take the 2-D kernels.
* The loop is a Python loop with no host synchronisation inside it.  The
  reference's float32 scalars are kept: FISTA's momentum ``t`` and ``beta``
  are float32 even for float64 unknowns, and so is the regularisation
  weight λ.  Both depend on no data beyond λ's endpoints, so they are
  computed once on the host and indexed on the device: the continuation
  λ_i = λ0 (λ/λ0)^(i/(K-1)) in float32 as the JAX package's compiled loop
  evaluates it on the CPU (i times the float32 reciprocal of K-1, the C
  library's single-precision ``powf``).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..errors import ErrorCode, InvalidArgumentError
from ..ops.thresholds import mad_sigma, soft_threshold, universal_threshold
from ..transforms.modwt import _resolve_discrete
from ..transforms.multilevel import imodwt_multilevel, max_levels, modwt_multilevel
from ..transforms.twodim import imodwt2_multilevel, modwt2_multilevel

__all__ = [
    "SparseRecovery",
    "fista",
    "bpdn",
    "inpaint",
    "inpaint2",
    "sparse_recover",
]

#: default decomposition depth cap for the solvers: λ-continuation shrinks
#: every detail level, so coarse structure must survive in the unpenalised
#: approximation plane, which at the deepest levels is about the global mean
#: (the JAX package's rule: J = 17 at 2^20 samples fails to interpolate a
#: smooth signal where J = 8 restores it).  Pass ``levels=`` to override.
_MAX_SOLVER_LEVELS = 8


def _default_levels(n: int, w) -> int:
    return min(max_levels(n, w), _MAX_SOLVER_LEVELS)


class SparseRecovery(NamedTuple):
    """Solution of a wavelet-sparse inverse problem.

    ``signal`` is the synthesis of ``coeffs``; ``coeffs`` is the (sparse)
    multi-level MODWT result the solver converged to.
    """

    signal: torch.Tensor
    coeffs: object


def _tree_map(fn, *trees):
    """``fn`` over the tensors of matching tuple / NamedTuple trees."""
    head = trees[0]
    if isinstance(head, torch.Tensor):
        return fn(*trees)
    if isinstance(head, tuple):
        parts = [_tree_map(fn, *items) for items in zip(*trees)]
        return type(head)(*parts) if hasattr(head, "_fields") else type(head)(parts)
    raise InvalidArgumentError(
        ErrorCode.VAL_INVALID_SHAPE,
        f"fista unknowns must be tensors in tuples or NamedTuples, got {type(head).__name__}",
    )


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for item in tree for leaf in _leaves(item)]


def _momentum(steps: int) -> list[float]:
    """FISTA's ``beta`` per step, from the float32 recursion
    ``t' = (1 + sqrt(1 + 4 t^2)) / 2``, ``beta = (t - 1) / t'``, t = 1."""
    f32 = np.float32
    t = f32(1.0)
    betas = []
    for _ in range(steps):
        t_new = f32(0.5) * (f32(1.0) + np.sqrt(f32(1.0) + f32(4.0) * t * t))
        betas.append(float((t - f32(1.0)) / t_new))
        t = t_new
    return betas


def fista(
    grad_fn: Callable,
    prox_fn: Callable,
    c0,
    *,
    steps: int,
    step_size: float = 1.0,
):
    """Accelerated proximal gradient over a tuple / NamedTuple tree of
    tensors.

    Solves ``min_c f(c) + g(c)`` where ``grad_fn(c)`` returns ∇f as a
    matching tree and ``prox_fn(c, i)`` applies the prox of
    ``step_size * g`` at iteration ``i`` (a Python int, for continuation
    schedules).  The momentum runs in float32 as in the JAX package.
    """
    if steps < 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL, f"steps must be >= 1, got {steps}"
        )
    c = z = c0
    for i, beta in enumerate(_momentum(steps)):
        g = grad_fn(z)
        stepped = _tree_map(lambda zi, gi: zi - step_size * gi, z, g)
        c_new = prox_fn(stepped, i)
        z = _tree_map(lambda cn, co: cn + beta * (cn - co), c_new, c)
        c = c_new
    return c


@functools.lru_cache(maxsize=1)
def _powf():
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    fn = libm.powf
    fn.restype = ctypes.c_float
    fn.argtypes = [ctypes.c_float, ctypes.c_float]
    return fn


def _as_f32(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().to("cpu", torch.float64).numpy()
    return np.asarray(v, dtype=np.float32)


def _thresholds(lam, lam_init, steps: int, step_size: float, like: torch.Tensor):
    """The prox's threshold ``step_size * λ_i`` per step as one tensor of
    ``like``'s dtype and device, ``[steps, *λ shape]``, its values float32
    as the JAX package computes them.  Without continuation it is built on
    the device; with it, λ's endpoints come to the host once."""
    scale = np.float32(step_size)
    if lam_init is None:
        if isinstance(lam, torch.Tensor):
            lam32 = lam.to(device=like.device, dtype=torch.float32)
        else:
            lam32 = torch.tensor(_as_f32(lam), device=like.device)
        thr = (lam32 * torch.tensor(scale, device=like.device)).to(like.dtype)
        return thr.expand((steps,) + tuple(thr.shape))
    lam32, lam0 = np.broadcast_arrays(_as_f32(lam), _as_f32(lam_init))
    ratio = (lam32 / lam0).astype(np.float32)
    # i / (K - 1) as the compiled reference evaluates it: float32 i times the
    # float32 reciprocal of K - 1
    recip = np.float32(1.0) / np.float32(max(steps - 1, 1))
    powf = _powf()
    table = np.empty((steps,) + lam32.shape, np.float32)
    for i in range(steps):
        frac = float(np.float32(i) * recip)
        power = np.array([powf(float(r), frac) for r in ratio.reshape(-1)], np.float32)
        table[i] = scale * (lam0 * power.reshape(ratio.shape))
    return torch.from_numpy(table).to(device=like.device, dtype=like.dtype)


def _detail_prox(thresholds: torch.Tensor, penalize_approx: bool):
    """Soft-threshold the detail subtree (and optionally the approx)."""

    def prox(c, i):
        thr = thresholds[i]
        details = tuple(_tree_map(lambda d: soft_threshold(d, thr), d) for d in c.details)
        approx = soft_threshold(c.approx, thr) if penalize_approx else c.approx
        return type(c)(details, approx)

    return prox


def _frame(w, levels: int, boundary: str, ndim: int):
    """(analysis, synthesis, the synthesis the gradient differentiates) for
    the 1-D or 2-D MODWT frame."""
    if ndim == 1:
        def synthesis(c):
            return imodwt_multilevel(c, w, boundary=boundary)

        return (
            lambda v: modwt_multilevel(v, w, levels=levels, boundary=boundary),
            synthesis,
            synthesis,
        )
    if ndim == 2:
        return (
            lambda v: modwt2_multilevel(v, w, levels=levels, boundary=boundary),
            lambda c: imodwt2_multilevel(c, w, boundary=boundary),
            lambda c: imodwt2_multilevel(c, w, boundary=boundary, backend="torch"),
        )
    raise InvalidArgumentError(
        ErrorCode.VAL_INVALID_SHAPE, f"ndim must be 1 or 2, got {ndim}"
    )


def _autograd(data_loss):
    """The gradient of ``data_loss`` with respect to a tree of planes."""

    def grad_fn(c):
        with torch.enable_grad():
            planes = _tree_map(lambda t: t.detach().requires_grad_(True), c)
            grads = torch.autograd.grad(data_loss(planes), _leaves(planes))
        it = iter(grads)
        return _tree_map(lambda _: next(it), c)

    return grad_fn


def _solve(y, mask, w, levels, boundary, lam, lam_init, steps, ndim, penalize_approx):
    analysis, synthesis, grad_synthesis = _frame(w, levels, boundary, ndim)

    def data_loss(c):
        r = grad_synthesis(c) - y
        if mask is not None:
            r = r * mask
        return 0.5 * (r * r).sum()

    with torch.no_grad():
        c0 = analysis(y if mask is None else y * mask)
    prox = _detail_prox(_thresholds(lam, lam_init, steps, 1.0, c0.approx), penalize_approx)
    c = fista(_autograd(data_loss), prox, c0, steps=steps, step_size=1.0)
    with torch.no_grad():
        return SparseRecovery(synthesis(c), c)


def bpdn(
    y: torch.Tensor,
    wavelet,
    *,
    levels: int | None = None,
    lam=None,
    steps: int = 100,
    boundary: str = "periodic",
    penalize_approx: bool = False,
) -> SparseRecovery:
    """Basis-pursuit denoising: ``min_c 0.5 ||S(c) - y||² + λ Σ|c_detail|``.

    ``lam`` defaults to one quarter of the universal threshold (level-1 MAD
    σ): at an ℓ1 fixed point every surviving coefficient stays biased by
    about λ, and the redundant frame spreads the penalty over about J+1
    correlated coefficients a sample, so the one-shot λ over-shrinks.
    Batched over leading axes; the default ``lam`` is per signal, so a
    batched solve equals the stacked individual solves.
    """
    w = _resolve_discrete(wavelet)
    n = y.shape[-1]
    if levels is None:
        levels = _default_levels(n, w)
    if lam is None:
        probe = modwt_multilevel(y, w, levels=1, boundary=boundary)
        lam = 0.25 * universal_threshold(n, mad_sigma(probe.details[0]))
    return _solve(y, None, w, levels, boundary, lam, None, steps, 1, penalize_approx)


def _default_inpaint_lams(details, lam, lam_init):
    """Continuation endpoints from the observed data's coefficient range
    (``details``: the probe's detail planes)."""
    peak = torch.stack([d.abs().max() for d in details]).max()
    peak = torch.clamp(peak, min=float(np.finfo(np.float32).tiny))
    if lam is None:
        lam = 1e-3 * peak
    if lam_init is None:
        lam_init = peak
    return lam, lam_init


def inpaint(
    y: torch.Tensor,
    mask,
    wavelet,
    *,
    levels: int | None = None,
    lam=None,
    lam_init=None,
    steps: int = 200,
    boundary: str = "periodic",
    enforce_data: bool = True,
) -> torch.Tensor:
    """Fill missing samples by wavelet-sparse interpolation.

    ``mask`` is 1 where ``y`` is observed, 0 where it is missing (values at
    missing positions are ignored, NaN included).  Solves
    ``min_c 0.5 ||mask ⊙ (S(c) - y)||² + λ_i Σ|c_detail|`` with geometric
    λ-continuation from ``lam_init`` (default: the largest observed
    coefficient) down to ``lam`` (default: 1e-3 of it).  With
    ``enforce_data`` the observed samples are copied back verbatim.  Prefer
    wavelets with many vanishing moments (db8, sym8) for smooth data.
    """
    w = _resolve_discrete(wavelet)
    mask = torch.as_tensor(mask, device=y.device).to(y.dtype)
    # values at missing positions are ignored: zero them so NaN
    # placeholders cannot poison the solve
    y = torch.where(mask > 0, y, torch.zeros_like(y))
    if levels is None:
        levels = _default_levels(y.shape[-1], w)
    if lam is None or lam_init is None:
        probe = modwt_multilevel(y, w, levels=1, boundary=boundary)
        lam, lam_init = _default_inpaint_lams(probe.details, lam, lam_init)
    out = _solve(y, mask, w, levels, boundary, lam, lam_init, steps, 1, False).signal
    return torch.where(mask > 0, y, out) if enforce_data else out


def inpaint2(
    img: torch.Tensor,
    mask,
    wavelet,
    *,
    levels: int,
    lam=None,
    lam_init=None,
    steps: int = 200,
    boundary: str = "periodic",
    enforce_data: bool = True,
) -> torch.Tensor:
    """2-D :func:`inpaint` over the separable MODWT pyramid
    (:func:`~vectorwave_tpu_torch.modwt2_multilevel`).  ``mask`` is per
    pixel.  Each step's gradient runs the plain 2-D cascade (the 2-D kernel
    tier has no gradient on the card)."""
    w = _resolve_discrete(wavelet)
    mask = torch.as_tensor(mask, device=img.device).to(img.dtype)
    img = torch.where(mask > 0, img, torch.zeros_like(img))  # NaN-safe, as inpaint
    if lam is None or lam_init is None:
        probe = modwt2_multilevel(img, w, levels=1, boundary=boundary)
        bands = [b for trip in probe.details for b in trip]
        lam, lam_init = _default_inpaint_lams(bands, lam, lam_init)
    out = _solve(img, mask, w, levels, boundary, lam, lam_init, steps, 2, False).signal
    return torch.where(mask > 0, img, out) if enforce_data else out


def sparse_recover(
    measurements: torch.Tensor,
    forward: Callable[[torch.Tensor], torch.Tensor],
    wavelet,
    *,
    signal_shape: tuple[int, ...],
    lam,
    lam_init=None,
    steps: int = 300,
    levels: int | None = None,
    boundary: str = "periodic",
    step_size: float | None = None,
    ndim: int = 1,
    dtype=torch.float32,
) -> SparseRecovery:
    """Recover a wavelet-sparse signal from measurements ``forward(x)``.

    ``forward`` is any map differentiable by autograd (a random projection
    for compressed sensing, a blur, a subsampling).  Solves
    ``min_c 0.5 ||forward(S(c)) - m||² + λ_i Σ|c_detail|`` on the device of
    ``measurements``.

    ``step_size`` must satisfy ``step <= 1 / ||forward∘S||²``; the default
    estimates ``||forward||²`` by 16 power iterations on a fixed probe with
    a 10% back-off (S has unit norm).  The estimate assumes a linear
    ``forward`` (the vjp is taken at one point); pass an explicit
    ``step_size`` for nonlinear maps.  Reading the estimate is the solve's
    one host synchronisation.
    """
    w = _resolve_discrete(wavelet)
    dev = measurements.device
    if levels is None:
        levels = _default_levels(signal_shape[-1], w)
    analysis, synthesis, grad_synthesis = _frame(w, levels, boundary, ndim)

    if step_size is None:
        # ||A||^2 by power iteration on A^T A from a deterministic probe
        probe = torch.cos(torch.arange(math.prod(signal_shape), dtype=dtype, device=dev)
                          ).reshape(signal_shape)
        _, vjp = torch.func.vjp(forward, probe)
        tiny = float(torch.finfo(dtype).tiny)
        v = probe
        for _ in range(16):
            (u,) = vjp(forward(v))
            v = u / torch.clamp(torch.linalg.vector_norm(u.reshape(-1)), min=tiny)
        fv = forward(v).reshape(-1)
        sq_norm = torch.dot(fv, fv) / torch.dot(v.reshape(-1), v.reshape(-1))
        # the Rayleigh quotient lower-bounds ||forward||^2: back off 10% so a
        # slowly converging power iteration cannot pass the 1/L bound
        step_size = float(torch.div(torch.tensor(0.9, dtype=sq_norm.dtype, device=dev),
                                    torch.clamp(sq_norm, min=1e-12)))

    def data_loss(c):
        r = forward(grad_synthesis(c)) - measurements
        return 0.5 * (r * r).sum()

    with torch.no_grad():
        c0 = analysis(torch.zeros(signal_shape, dtype=dtype, device=dev))
    prox = _detail_prox(_thresholds(lam, lam_init, steps, step_size, c0.approx), False)
    c = fista(_autograd(data_loss), prox, c0, steps=steps, step_size=step_size)
    with torch.no_grad():
        return SparseRecovery(synthesis(c), c)
