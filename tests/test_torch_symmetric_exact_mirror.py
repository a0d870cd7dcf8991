"""Mirrors of the JAX package's symmetric, SWT-denoise, exact and BASELINE tests.

``tests/test_symmetric_kernel.py``, ``tests/test_denoise_swt.py``,
``tests/test_exact_mode.py`` and ``tests/test_baseline_configs.py``: the
same names, seeds, shapes, wavelets and boundaries, and the JAX test's own
assertions and bounds, run on the port and held to the JAX package.  The
tests of these files that earlier port tests mirror under their own names
(``tests/test_torch_swt.py``: the SWT, padding, single-level denoise,
config #3; ``tests/test_torch_parallel.py``: config #4;
``tests/test_torch_cwt_tiled.py``: config #5) are not repeated here.

On the CPU the port's kernel entry points (``fused_analysis``,
``fused_synthesis``, ``analysis_exact``, ``synthesis_exact``, the exact
public pair) run their plain versions.  The JAX side runs ``backend='jnp'``
(the jnp symmetric cascade and inverse, the float64 cascade for the exact
tier), jitted once a shape from a module-scoped fixture; no JAX Pallas
kernel runs here: ``tests/test_torch_symmetric.py``
(``test_kernel_tier_matches_jax_kernel_tier``) and ``tests/test_torch_exact.py``
(``test_analysis_exact_matches_jax``) hold the port's symmetric and exact
tiers to the JAX kernels in interpret mode at these shapes.

Tolerances: the JAX tests' own (5e-6 for the symmetric pair in float32,
1e-6 / 1e-5 for the short symmetric call, 1e-5 and 2e-6 of the largest
entry for the symmetric gradients, 1e-10 for a float64 interior, 5e-13 for
the exact analysis against the float64 cascade, 1e-11 / 1e-12 / 1e-10 for
the exact round trips), else 1e-12 in float64 and 1e-10 for a denoiser whose
thresholds pass through a sort.

Differences by design, asserted on both sides: the port's symmetric gate
(``modwt_symmetric.route_fits``) admits the 200-sample call the JAX
symmetric wrappers send to jnp, and its synthesis gate
(``multilevel.SYMMETRIC_SYNTHESIS_MIN_SAMPLES``) keeps ``auto``'s 2 x 2048
symmetric inverse on the plain route while ``backend='kernel'`` serves it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from tools import mirror_cases
from vectorwave_tpu.kernels import fused_analysis as jax_fused_analysis
from vectorwave_tpu.kernels.modwt_symmetric import (
    symmetric_synthesis_plane_filters as jax_plane_filters,
)
from vectorwave_tpu_torch.kernels import modwt_exact as exact
from vectorwave_tpu_torch.kernels import modwt_symmetric as ms
from vectorwave_tpu_torch.kernels.modwt_fused import _kernel_filters
from vectorwave_tpu_torch.transforms import multilevel as ml

from .conftest import composite_sin

torch.set_num_threads(1)

TOL_F64 = 1e-12
TOL_SYMMETRIC = 5e-6


def _np(t):
    return t.detach().double().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float64)


def _maxdiff(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    out = 0.0
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        out = max(out, float(np.max(np.abs(g - w))))
    return out


def _t(x):
    return torch.from_numpy(np.array(x))


def _x32(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _planes(res):
    return (*res.details, res.approx)


def _combine(pair):
    return pair[0].double() + pair[1].double()


class JaxRefs:
    """The JAX package's jnp MODWT pair, jitted once per shape and static
    arguments, each result made once per input."""

    def __init__(self):
        self._jits = {}
        self._memo = {}

    def _jit(self, key, make):
        if key not in self._jits:
            self._jits[key] = jax.jit(make())
        return self._jits[key]

    def decompose(self, x, name, levels, boundary):
        key = ("dec", x.tobytes(), x.shape, x.dtype.str, name, levels, boundary)
        if key not in self._memo:
            fn = self._jit(("dec", name, levels, boundary), lambda: lambda y: vw.modwt_multilevel(
                y, name, levels=levels, boundary=boundary, backend="jnp"))
            self._memo[key] = fn(jnp.asarray(x))
        return self._memo[key]

    def roundtrip(self, x, name, levels, boundary):
        key = ("rt", x.tobytes(), x.shape, x.dtype.str, name, levels, boundary)
        if key not in self._memo:
            fn = self._jit(("inv", name, boundary), lambda: lambda r: vw.imodwt_multilevel(
                r, name, boundary=boundary, backend="jnp"))
            self._memo[key] = fn(self.decompose(x, name, levels, boundary))
        return self._memo[key]


@pytest.fixture(scope="module")
def jax_refs():
    return JaxRefs()


# --- tests/test_symmetric_kernel.py ---------------------------------------------------


@pytest.mark.parametrize("name,levels", [("db4", 3), ("sym8", 2), ("haar", 4), ("bior2.2", 3)])
def test_symmetric_kernel_parity_both_directions(jax_refs, name, levels):
    """The port's symmetric kernel entry points within 5e-6 of the JAX jnp
    symmetric cascade and of its inverse (given the JAX planes).  On a card
    the kernels serve both directions (``route_fits``); ``auto`` sends the
    analysis to its kernel and keeps the 4096-sample inverse on the plain
    route (below ``SYMMETRIC_SYNTHESIS_MIN_SAMPLES``)."""
    x = _x32((2, 2048), 0)
    w = vt.wavelet(name)
    details, approx = vt.fused_analysis(_t(x), w, levels=levels, boundary="symmetric",
                                        precision="float32")
    ref = jax_refs.decompose(x, name, levels, "symmetric")
    assert _maxdiff((*details, approx), _planes(ref)) <= TOL_SYMMETRIC
    xr = vt.fused_synthesis([_t(d) for d in ref.details], _t(ref.approx), w,
                            boundary="symmetric", precision="float32")
    assert _maxdiff(xr, jax_refs.roundtrip(x, name, levels, "symmetric")) <= TOL_SYMMETRIC
    assert ms.route_fits(w, levels, 2048, False) and ms.route_fits(w, levels, 2048, True)
    vt.set_backend("kernel")
    try:
        assert ml._kernel_eligible(_t(x), w, levels, "symmetric")
        assert not ml._kernel_eligible(_t(x), w, levels, "symmetric", synthesis=True)
    finally:
        vt.set_backend("auto")
    assert 2 * 2048 < ml.SYMMETRIC_SYNTHESIS_MIN_SAMPLES


def test_symmetric_fused_api_routes_and_short_fallback(jax_refs):
    """200 samples: the JAX symmetric wrappers take their jnp fallback (200
    is below two 128-rounded spans and not a multiple of 128); the port's
    gates admit both directions (the mirror's reach, 28 samples, and
    windows that do not overlap), so on a card its kernels serve the call (a
    difference by design).  Both results equal: the analysis within 1e-6 of
    JAX's fused call and of the jnp cascade, the inverse within 1e-5."""
    x = _x32(200, 1)
    w = vt.wavelet("db4")
    assert ms.route_fits(w, 3, 200, False) and ms.route_fits(w, 3, 200, True)
    assert ms.mirror_reach(w.filter_length, 3) == 28
    d, a = vt.fused_analysis(_t(x), "db4", levels=3, boundary="symmetric")
    jd, ja = jax_fused_analysis(jnp.asarray(x), "db4", levels=3, boundary="symmetric",
                                interpret=True)
    ref = jax_refs.decompose(x, "db4", 3, "symmetric")
    assert _maxdiff((*d, a), (*jd, ja)) <= 1e-6
    assert _maxdiff((*d, a), _planes(ref)) <= 1e-6
    xr = vt.fused_synthesis(d, a, "db4", boundary="symmetric")
    assert _maxdiff(xr, jax_refs.roundtrip(x, "db4", 3, "symmetric")) <= 1e-5


def test_symmetric_gradients_match_jnp():
    """Through ``fused_analysis`` (the mirror-mode analysis, whose backward
    is the synthesis and the head's VJP) within 1e-5 of jax.grad of the jnp
    cascade; through ``fused_synthesis`` (its backward the symmetric
    adjoint), with weights, within 2e-6 of the largest entry of jax.grad of
    the jnp inverse."""
    x = _x32((1, 2048), 2)
    w = vt.wavelet("db4")
    xt = _t(x).requires_grad_(True)
    d, a = vt.fused_analysis(xt, w, levels=3, boundary="symmetric", precision="float32")
    (gk,) = torch.autograd.grad(sum((p ** 2).sum() for p in d) + 0.5 * (a ** 2).sum(), xt)

    def loss_j(y):
        r = vw.modwt_multilevel(y, "db4", levels=3, boundary="symmetric", backend="jnp")
        return sum(jnp.sum(p ** 2) for p in r.details) + 0.5 * jnp.sum(r.approx ** 2)

    assert _maxdiff(gk, jax.jit(jax.grad(loss_j))(jnp.asarray(x))) <= 1e-5

    res = vw.modwt_multilevel(jnp.asarray(x), "db4", levels=3, boundary="symmetric",
                              backend="jnp")
    weights = np.arange(2048, dtype=np.float32)
    planes = [_t(p).requires_grad_(True) for p in _planes(res)]
    xr = vt.fused_synthesis(planes[:-1], planes[-1], w, boundary="symmetric",
                            precision="float32")
    gk = torch.autograd.grad((xr ** 2 * _t(weights)).sum(), planes)

    def sloss_j(ds, ap):
        y = vw.imodwt_multilevel(vw.MultiLevelMODWTResult(ds, ap), "db4",
                                 boundary="symmetric", backend="jnp")
        return jnp.sum(y ** 2 * weights)

    gj = jax.jit(jax.grad(sloss_j, argnums=(0, 1)))(res.details, res.approx)
    gj = (*gj[0], gj[1])
    scale = max(float(np.abs(np.asarray(b)).max()) for b in gj)
    assert _maxdiff(gk, gj) <= 2e-6 * scale


def test_composed_plane_filters_reproduce_jnp_inverse_interior(jax_refs):
    """The port's composed plane filters equal JAX's, and applied densely in
    float64 they are the JAX jnp symmetric inverse away from the edges
    (1e-10)."""
    x = np.random.default_rng(3).standard_normal(1024)
    w = vt.wavelet("db4")
    res = jax_refs.decompose(x, "db4", 3, "symmetric")
    ref = np.asarray(jax_refs.roundtrip(x, "db4", 3, "symmetric"))
    pf = ms.symmetric_synthesis_plane_filters(w, 3)
    for (arr, start), (jarr, jstart) in zip(pf, jax_plane_filters(vw.wavelet("db4"), 3)):
        assert start == jstart
        np.testing.assert_allclose(np.asarray(arr), np.asarray(jarr), rtol=0, atol=1e-15)
    planes = [np.asarray(p, np.float64) for p in _planes(res)]
    spans = [(max(0, -s), s + len(arr) - 1) for arr, s in pf]
    span_l = max(left for left, _ in spans)
    span_r = max(right for _, right in spans)
    n = 1024
    out = np.zeros(n)
    for (arr, start), plane in zip(pf, planes):
        for k, v in enumerate(np.asarray(arr)):
            if v == 0.0:
                continue
            delta = start + k
            lo, hi = max(0, -delta), min(n, n - delta)
            out[lo:hi] += v * plane[lo + delta:hi + delta]
    interior = slice(span_l, n - span_r)
    np.testing.assert_allclose(out[interior], ref[interior], rtol=0, atol=1e-10)
    got = vt.imodwt_multilevel(vt.MultiLevelMODWTResult(tuple(_t(p) for p in planes[:-1]),
                                                        _t(planes[-1])),
                               "db4", boundary="symmetric")
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL_F64)


# --- tests/test_denoise_swt.py (the tests tests/test_torch_swt.py does not mirror) ---


def _noisy(n=512, noise=0.5, seed=3):
    """``tests/test_denoise_swt.py::_noisy``."""
    rng = np.random.default_rng(seed)
    clean = composite_sin(n)
    return clean, clean + rng.normal(0, noise, n)


def test_soft_hard_threshold():
    c = np.array([-3.0, -1.0, -0.2, 0.0, 0.4, 1.5, 2.5])
    soft = vt.soft_threshold(_t(c), 1.0).numpy()
    hard = vt.hard_threshold(_t(c), 1.0).numpy()
    np.testing.assert_allclose(soft, [-2.0, 0.0, 0.0, 0.0, 0.0, 0.5, 1.5], atol=1e-15)
    np.testing.assert_allclose(hard, [-3.0, 0.0, 0.0, 0.0, 0.0, 1.5, 2.5], atol=1e-15)
    np.testing.assert_array_equal(soft, np.asarray(vw.soft_threshold(jnp.asarray(c), 1.0)))
    np.testing.assert_array_equal(hard, np.asarray(vw.hard_threshold(jnp.asarray(c), 1.0)))


def test_mad_sigma_estimates_noise():
    """The MODWT detail's MAD sigma of white noise of sigma 2 within 0.15 of
    2 / sqrt(2), and within 1e-12 of JAX's."""
    x = np.random.default_rng(0).normal(0, 2.0, 4096)
    sigma = vt.mad_sigma(vt.modwt(_t(x), "db4").detail)
    assert abs(float(sigma[..., 0]) - 2.0 / np.sqrt(2.0)) < 0.15
    want = vw.mad_sigma(vw.modwt(jnp.asarray(x), "db4").detail)
    assert _maxdiff(sigma, want) <= TOL_F64


#: the draws of ``test_denoise_multilevel_improves_snr`` held to JAX's
#: denoiser (each a compile of about a second); all eight hold the JAX
#: test's own check
DENOISE_AGAINST_JAX = (("universal", "soft"), ("sure", "hard"), ("bayes", "soft"))


@pytest.mark.parametrize("method", ["universal", "sure", "minimax", "bayes"])
@pytest.mark.parametrize("mode", ["soft", "hard"])
def test_denoise_multilevel_improves_snr(method, mode):
    """The denoised error below the noisy input's on every draw; on
    :data:`DENOISE_AGAINST_JAX` within 1e-10 of JAX's jitted denoiser."""
    clean, noisy = _noisy()
    den = vt.denoise_multilevel(_t(noisy), "db4", levels=4, method=method, mode=mode).numpy()
    assert np.mean((den - clean) ** 2) < np.mean((noisy - clean) ** 2), (method, mode)
    if (method, mode) in DENOISE_AGAINST_JAX:
        want = jax.jit(lambda y: vw.denoise_multilevel(y, "db4", levels=4, method=method,
                                                       mode=mode))(jnp.asarray(noisy))
        assert _maxdiff(den, want) <= 1e-10


# --- tests/test_exact_mode.py ---------------------------------------------------------


@pytest.mark.parametrize("wavelet,levels", [("db4", 4), ("sym8", 3)])
def test_exact_roundtrip_below_1e10(jax_refs, wavelet, levels):
    """The exact pair's periodic round trip: balanced under 1e-11 RMSE, full
    under 1e-12; the analysis's hi + lo within 5e-13 of the JAX float64
    cascade."""
    x = _x32((2, 1024), 3)
    x64 = x.astype(np.float64)
    hi, lo = exact.modwt_roundtrip_exact(_t(x), wavelet, levels=levels)
    assert float(np.sqrt(np.mean((_combine((hi, lo)).numpy() - x64) ** 2))) < 1e-11
    hi, lo = exact.modwt_roundtrip_exact(_t(x), wavelet, levels=levels, profile="full")
    assert float(np.sqrt(np.mean((_combine((hi, lo)).numpy() - x64) ** 2))) < 1e-12
    pairs = exact.analysis_exact(_t(x), levels, _kernel_filters(vt.wavelet(wavelet), False),
                                 True)
    ref = jax_refs.decompose(x64, wavelet, levels, "periodic")
    assert _maxdiff([_combine(p) for p in pairs], _planes(ref)) <= 5e-13


def test_exact_analysis_matches_f64_cascade(jax_refs):
    x = _x32((1, 512), 4)
    pairs = exact.analysis_exact(_t(x), 3, _kernel_filters(vt.wavelet("db4"), synthesis=False),
                                 True)
    ref = jax_refs.decompose(x.astype(np.float64), "db4", 3, "periodic")
    assert _maxdiff([_combine(p) for p in pairs], _planes(ref)) <= 5e-13


def test_exact_synthesis_inverts_exact_analysis_zero_boundary(jax_refs):
    """Zero edge: the interior past the span reconstructs within 1e-12; the
    analysis within 5e-13 of the JAX float64 zero cascade."""
    x = _x32((1, 512), 5)
    w = vt.wavelet("db4")
    pairs = exact.analysis_exact(_t(x), 2, _kernel_filters(w, synthesis=False), False)
    hi, lo = exact.synthesis_exact(pairs, 2, _kernel_filters(w, synthesis=True), False)
    span = (w.filter_length - 1) * (2 ** 2 - 1)
    got = _combine((hi, lo)).numpy()[:, span:-span]
    np.testing.assert_allclose(got, x.astype(np.float64)[:, span:-span], rtol=0, atol=1e-12)
    ref = jax_refs.decompose(x.astype(np.float64), "db4", 2, "zero")
    assert _maxdiff([_combine(p) for p in pairs], _planes(ref)) <= 5e-13


def test_public_exact_api_roundtrip_below_1e10(jax_refs):
    """``modwt_multilevel_exact`` / ``imodwt_multilevel_exact``: hi + lo
    round trips within 1e-10 RMSE, batched and 1-D; the batched analysis
    within 5e-13 of the JAX float64 cascade."""
    x = _x32((2, 2048), 11)
    details, approx = vt.modwt_multilevel_exact(_t(x), "db4", levels=4)
    assert len(details) == 4 and len(approx) == 2
    ref = jax_refs.decompose(x.astype(np.float64), "db4", 4, "periodic")
    assert _maxdiff([_combine(p) for p in (*details, approx)], _planes(ref)) <= 5e-13
    hi, lo = vt.imodwt_multilevel_exact(details, approx, "db4")
    err = _combine((hi, lo)).numpy() - x.astype(np.float64)
    assert float(np.sqrt(np.mean(err ** 2))) <= 1e-10
    d1, a1 = vt.modwt_multilevel_exact(_t(x[0]), "sym8", levels=3)
    h1, l1 = vt.imodwt_multilevel_exact(d1, a1, "sym8")
    err1 = _combine((h1, l1)).numpy() - x[0].astype(np.float64)
    assert float(np.sqrt(np.mean(err1 ** 2))) <= 1e-10


# --- tests/test_baseline_configs.py (configs #1 and #2; #3-#5 mirrored elsewhere) ----


def test_config1_haar_1level_1024_periodic():
    x = composite_sin(1024, noise_std=0.3)
    res = vt.modwt(_t(x), "haar", boundary="periodic")
    assert _maxdiff(vt.imodwt(res, "haar", boundary="periodic"), x) < 1e-10
    want = vw.modwt(jnp.asarray(x), "haar", boundary="periodic")
    assert _maxdiff((res.approx, res.detail), (want.approx, want.detail)) <= TOL_F64


def test_config2_db4_6level_65536_periodic(jax_refs):
    """The round trip under 1e-10 RMSE ("bit-parity grade"); the planes
    within 1e-12 of JAX's."""
    x = composite_sin(65536, noise_std=0.3)
    res = vt.modwt_multilevel(_t(x), "db4", levels=6, boundary="periodic")
    xr = vt.imodwt_multilevel(res, "db4", boundary="periodic").numpy()
    assert float(np.sqrt(np.mean((x - xr) ** 2))) < 1e-10
    assert _maxdiff(_planes(res), _planes(jax_refs.decompose(x, "db4", 6, "periodic"))) <= TOL_F64


# --- the card's cases, run on the CPU -------------------------------------------------


@pytest.mark.parametrize("label", mirror_cases.family_labels("symmetric and exact"))
def test_family_case_runs_its_plain_versions_on_the_cpu(label):
    """Each symmetric, SWT, denoise, exact and config #4 case phase 2c runs on
    the card, here on CPU tensors: within its bounds of the plain route, no
    launch, no refusal."""
    assert not mirror_cases.cpu_problems(label)
