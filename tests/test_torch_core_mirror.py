"""Mirrors of the JAX package's MODWT core tests on the port.

``tests/test_modwt.py``, ``tests/test_multilevel.py`` and
``tests/test_tolerance_routing.py``, test by test: the same names, seeds,
shapes, wavelets and boundaries, and the JAX test's own assertions, run on
the port (its plain PyTorch path on the CPU).  Each test also holds the port
to the JAX package on the same numpy input, with the tolerance it states:

* float64 planes and inverses against ``backend='jnp'`` in float64:
  1e-12 of the largest value (the same rolled cascade in the same order);
* the exact tier's hi + lo against the JAX jnp cascade in float64 of the
  float32 input: the JAX test's own bounds, 5e-11 (balanced) and 2e-12
  (full);
* float32 outputs against the JAX jnp path in float32: 2e-5 (fp32 in
  another summation order, values of order 1);
* errors: both packages raise.

The JAX references come from one module-scoped fixture (``jax_refs``), each
call jitted as the JAX tests jit it and made once per shape.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from tools.mirror_cases import interior_nrmse, nrmse_baseline
from vectorwave_tpu_torch.errors import ErrorCode, InvalidArgumentError
from vectorwave_tpu_torch.transforms import multilevel as ml

from .conftest import composite_sin
from .golden import imodwt_golden, modwt_golden, modwt_multilevel_golden

torch.set_num_threads(1)

TOL = 1e-12
TOL_F32 = 2e-5


def _np(t):
    return t.detach().double().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol=TOL):
    got, want = _np(got), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@partial(jax.jit, static_argnames=("name", "boundary"))
def _jax_forward(x, name, boundary):
    return vw.modwt(x, name, boundary=boundary)


@partial(jax.jit, static_argnames=("name", "boundary"))
def _jax_inverse(approx, detail, name, boundary):
    return vw.imodwt(vw.MODWTResult(approx, detail), name, boundary=boundary)


@partial(jax.jit, static_argnames=("name", "levels", "boundary"))
def _jax_decompose(x, name, levels, boundary):
    return vw.modwt_multilevel(x, name, levels=levels, boundary=boundary, backend="jnp")


@partial(jax.jit, static_argnames=("name", "boundary"))
def _jax_reconstruct(res, name, boundary):
    return vw.imodwt_multilevel(res, name, boundary=boundary, backend="jnp")


class JaxRefs:
    """The JAX package's results, each made once: keyed by the call and the
    input's bytes."""

    def __init__(self):
        self._memo = {}

    def _once(self, fn, x, *args):
        key = (fn.__name__, x.shape, x.dtype.str, x.tobytes(), args)
        if key not in self._memo:
            self._memo[key] = fn(jnp.asarray(x), *args)
        return self._memo[key]

    def forward(self, x, name, boundary="periodic"):
        return self._once(_jax_forward, x, name, boundary)

    def decompose(self, x, name, levels, boundary="periodic"):
        return self._once(_jax_decompose, x, name, levels, boundary)

    def roundtrip(self, x, name, levels, boundary="periodic"):
        key = ("roundtrip", x.tobytes(), x.shape, name, levels, boundary)
        if key not in self._memo:
            self._memo[key] = _jax_reconstruct(self.decompose(x, name, levels, boundary),
                                               name, boundary)
        return self._memo[key]


@pytest.fixture(scope="module")
def jax_refs():
    return JaxRefs()


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# --- tests/test_modwt.py ---------------------------------------------------------------


@pytest.mark.parametrize("n", [128, 129, 256])
@pytest.mark.parametrize("name", ["haar", "db4"])
def test_periodic_roundtrip(jax_refs, name, n):
    """Exact reconstruction (< 1e-9) and energy (1e-8 relative); the planes
    against JAX's at 1e-12."""
    x = composite_sin(n, noise_std=0.3)
    res = vt.modwt(_t(x), name, boundary="periodic")
    xr = vt.imodwt(res, name, boundary="periodic")
    assert float((_t(x) - xr).abs().max()) < 1e-9
    energy_in = float((x ** 2).sum())
    assert abs(energy_in - float(res.energy())) / energy_in < 1e-8
    want = jax_refs.forward(x, name)
    _close(res.approx, want.approx)
    _close(res.detail, want.detail)


def test_haar_percival_walden_values(jax_refs):
    """W_t = (x_t - x_{t-1})/2, V_t = (x_t + x_{t-1})/2 at 1e-12, on both
    packages."""
    x = np.array([1.0, 2.0, -3.0, 4.5, 0.25, -1.0, 7.0, 3.0])
    res = vt.modwt(_t(x), "haar", boundary="periodic")
    n = len(x)
    detail = np.array([(x[t] - x[t - 1]) / 2.0 for t in range(n)])
    approx = np.array([(x[t] + x[t - 1]) / 2.0 for t in range(n)])
    want = jax_refs.forward(x, "haar")
    for got in (res, want):
        np.testing.assert_allclose(_np(got.detail), detail, rtol=0, atol=1e-12)
        np.testing.assert_allclose(_np(got.approx), approx, rtol=0, atol=1e-12)


def test_impulse_response_is_scaled_filter(jax_refs):
    """A unit impulse gives the 1/sqrt(2)-scaled filter at the taps, 1e-14."""
    n = 32
    x = np.zeros(n)
    x[0] = 1.0
    w = vt.wavelet("db4")
    expected = np.zeros(n)
    for k, c in enumerate(w.dec_hi / np.sqrt(2.0)):
        expected[k % n] += c
    detail = vt.modwt(_t(x), "db4", boundary="periodic").detail
    np.testing.assert_allclose(_np(detail), expected, rtol=0, atol=1e-14)
    np.testing.assert_allclose(_np(jax_refs.forward(x, "db4").detail), expected, rtol=0,
                               atol=1e-14)


@pytest.mark.parametrize("boundary", ["periodic", "zero", "symmetric"])
@pytest.mark.parametrize("name", ["haar", "db4"])
def test_golden_equivalence_forward(jax_refs, name, boundary):
    """N = 97 (odd): the golden oracle at 1e-12, and JAX's planes."""
    x = composite_sin(97, noise_std=0.5)
    res = vt.modwt(_t(x), name, boundary=boundary)
    g_approx, g_detail = modwt_golden(x, vt.wavelet(name), boundary)
    np.testing.assert_allclose(_np(res.approx), g_approx, rtol=0, atol=1e-12)
    np.testing.assert_allclose(_np(res.detail), g_detail, rtol=0, atol=1e-12)
    want = jax_refs.forward(x, name, boundary)
    _close(res.approx, want.approx)
    _close(res.detail, want.detail)


@pytest.mark.parametrize("boundary", ["periodic", "zero", "symmetric"])
def test_golden_equivalence_inverse(jax_refs, boundary):
    """The single-level inverse of db4 planes at N = 64 against the golden
    oracle and JAX's inverse of the same planes, 1e-12."""
    x = composite_sin(64)
    res = vt.modwt(_t(x), "db4", boundary=boundary)
    xr = vt.imodwt(res, "db4", boundary=boundary)
    g = imodwt_golden(_np(res.approx), _np(res.detail), vt.wavelet("db4"), boundary)
    np.testing.assert_allclose(_np(xr), g, rtol=0, atol=1e-12)
    want = _jax_inverse(jnp.asarray(_np(res.approx)), jnp.asarray(_np(res.detail)), "db4",
                        boundary)
    _close(xr, want)


def test_shift_invariance_periodic(jax_refs):
    """A circular shift of the input shifts the periodic detail (1e-12)."""
    x = composite_sin(128, noise_std=0.2)
    res = vt.modwt(_t(x), "db4", boundary="periodic")
    shifted = vt.modwt(_t(np.roll(x, 13)), "db4", boundary="periodic")
    np.testing.assert_allclose(_np(shifted.detail), np.roll(_np(res.detail), 13), atol=1e-12)
    _close(shifted.detail, jax_refs.forward(np.roll(x, 13), "db4").detail)


def test_batch_leading_axes(jax_refs):
    """Leading axes are a batch: each row equals its own transform (1e-14)."""
    batch = np.stack([composite_sin(64, seed=s, noise_std=0.1) for s in range(5)])
    res = vt.modwt(_t(batch), "db4", boundary="periodic")
    assert res.approx.shape == (5, 64)
    for i in range(5):
        single = vt.modwt(_t(batch[i]), "db4", boundary="periodic")
        np.testing.assert_allclose(_np(res.detail[i]), _np(single.detail), atol=1e-14)
    _close(res.detail, jax_refs.forward(batch, "db4").detail)


def test_continuous_wavelet_rejected():
    with pytest.raises(InvalidArgumentError):
        vt.modwt(torch.zeros(16), vt.ContinuousWavelet("fake", "Fake", lambda t: t, 1.0, 1.0))
    with pytest.raises(vw.InvalidArgumentError):
        vw.modwt(jnp.zeros(16), vw.ContinuousWavelet("fake", "Fake", lambda t: t, 1.0, 1.0))


# --- tests/test_multilevel.py ----------------------------------------------------------


@pytest.mark.parametrize(
    "name,levels,n",
    [("haar", 5, 512), ("db4", 6, 1024), ("sym8", 4, 512), ("db8", 5, 1024)],
)
def test_periodic_multilevel_roundtrip(jax_refs, name, levels, n):
    """RMSE < 1e-10; the planes and the inverse against JAX's at 1e-12."""
    x = composite_sin(n, noise_std=0.4)
    res = vt.modwt_multilevel(_t(x), name, levels=levels, boundary="periodic")
    xr = vt.imodwt_multilevel(res, name, boundary="periodic")
    assert float((_t(x) - xr).pow(2).mean().sqrt()) < 1e-10
    want = jax_refs.decompose(x, name, levels)
    for g, w in zip((*res.details, res.approx), (*want.details, want.approx)):
        _close(g, w)
    _close(xr, jax_refs.roundtrip(x, name, levels))


@pytest.mark.parametrize("boundary", ["periodic", "zero", "symmetric"])
def test_golden_equivalence_multilevel(jax_refs, boundary):
    """db4 J=3 at N = 80: every plane against the golden cascade and JAX's,
    1e-12."""
    x = composite_sin(80, noise_std=0.3)
    res = vt.modwt_multilevel(_t(x), "db4", levels=3, boundary=boundary)
    g_details, g_approx = modwt_multilevel_golden(x, vt.wavelet("db4"), 3, boundary)
    want = jax_refs.decompose(x, "db4", 3, boundary)
    for j in range(3):
        np.testing.assert_allclose(_np(res.details[j]), g_details[j], rtol=0, atol=1e-12)
        _close(res.details[j], want.details[j])
    np.testing.assert_allclose(_np(res.approx), g_approx, rtol=0, atol=1e-12)
    _close(res.approx, want.approx)


def test_energy_distribution_sums_to_one(jax_refs):
    x = composite_sin(256, noise_std=0.2)
    res = vt.modwt_multilevel(_t(x), "db4", levels=4, boundary="periodic")
    dist = _np(res.relative_energy_distribution())
    assert dist.shape == (5,)
    assert abs(dist.sum() - 1.0) < 1e-12
    assert (dist >= 0).all()
    _close(dist, jax_refs.decompose(x, "db4", 4).relative_energy_distribution())


def test_energy_preservation_periodic(jax_refs):
    """Energy preserved across levels to 1e-10 relative, on both packages."""
    x = composite_sin(512, noise_std=0.4)
    expected = float((x ** 2).sum())
    total = float(vt.modwt_multilevel(_t(x), "db4", levels=5).total_energy())
    assert abs(total - expected) / expected < 1e-10
    assert abs(total - float(jax_refs.decompose(x, "db4", 5).total_energy())) <= TOL * expected


def test_max_levels():
    """(L0-1)*2^(J-1)+1 <= N, capped at 10; equal on both packages."""
    assert vt.max_levels(1024, "db4") == 8
    assert vt.max_levels(8, "db4") == 0
    assert vt.max_levels(1 << 20, "haar") in (9, 10)
    assert vt.max_levels(16, "haar") == 4
    assert vt.MAX_DECOMPOSITION_LEVELS == vw.MAX_DECOMPOSITION_LEVELS
    for n, name in ((1024, "db4"), (8, "db4"), (1 << 20, "haar"), (16, "haar")):
        assert vt.max_levels(n, name) == vw.max_levels(n, name)


def test_too_deep_raises():
    """db4 J=6 needs 225 samples; 64 raise VAL_TOO_LARGE on both packages,
    from ``_check_level_fits``."""
    with pytest.raises(InvalidArgumentError) as exc_info:
        vt.modwt_multilevel(torch.zeros(64), "db4", levels=6)
    assert exc_info.value.code is ErrorCode.VAL_TOO_LARGE
    with pytest.raises(vw.InvalidArgumentError) as jax_info:
        vw.modwt_multilevel(jnp.zeros(64), "db4", levels=6)
    assert jax_info.value.code is vw.ErrorCode.VAL_TOO_LARGE
    ml._check_level_fits(vt.wavelet("db4"), 5, 113)  # 7*16+1 = 113 fits
    with pytest.raises(InvalidArgumentError):
        ml._check_level_fits(vt.wavelet("db4"), 5, 112)


@pytest.mark.parametrize("name,n,levels", [("haar", 257, 5), ("db4", 257, 4), ("sym8", 257, 4)])
def test_symmetric_interior_nrmse_guard(jax_refs, name, n, levels):
    """The symmetric round trip's interior NRMSE (margin min(N/4, L_J/2))
    within 10% above the committed baseline
    (``tests/baselines/symmetric_nrmse_baseline.json``, read only); the
    round trip against JAX's at 1e-12."""
    x = composite_sin(n, noise_std=0.3)
    res = vt.modwt_multilevel(_t(x), name, levels=levels, boundary="symmetric")
    xr = _np(vt.imodwt_multilevel(res, name, boundary="symmetric"))
    nrmse = interior_nrmse(x, xr, vt.wavelet(name).filter_length, levels)
    baseline = nrmse_baseline(name, n, levels)
    assert nrmse <= baseline * 1.10, (nrmse, baseline)
    _close(xr, jax_refs.roundtrip(x, name, levels, "symmetric"))


def test_multilevel_batch(jax_refs):
    batch = np.stack([composite_sin(128, seed=s) for s in range(4)])
    res = vt.modwt_multilevel(_t(batch), "db4", levels=3, boundary="periodic")
    assert res.approx.shape == (4, 128)
    assert len(res.details) == 3
    _close(res.approx, jax_refs.decompose(batch, "db4", 3).approx)


def test_symmetric_alignment_matches_jax():
    """The symmetric inverse's per-level orientation table
    (``_symmetric_alignment``), derived and heuristic entries, levels 1-10."""
    from vectorwave_tpu.transforms import multilevel as jml

    for name in ("haar", "db2", "db4", "db6", "db8", "db10", "sym4", "sym8", "sym12",
                 "coif2", "coif3", "coif5", "bior2.2", "bior4.4", "db3", "db12", "sym6",
                 "bior2.4", "rbio3.1", "coif1"):
        for level in range(1, 11):
            assert tuple(ml._symmetric_alignment(vt.wavelet(name), level)) == tuple(
                jml._symmetric_alignment(vw.wavelet(name), level)), (name, level)


# --- tests/test_tolerance_routing.py ---------------------------------------------------


def test_resolve_tolerance_ladder():
    for tol, tier in ((0.5, "bf16"), (1e-3, "bf16_3x"), (1e-5, "float32"), (1e-10, "exact")):
        assert vt.resolve_tolerance(tol) == vw.resolve_tolerance(tol) == tier
    with pytest.raises(InvalidArgumentError):
        vt.resolve_tolerance(0.0)
    with pytest.raises(vw.InvalidArgumentError):
        vw.resolve_tolerance(0.0)


def _exact_against_jax_f64(res, x, name, levels, tol):
    """hi + lo of every plane against the JAX jnp cascade of x in float64."""
    want = _jax_decompose(jnp.asarray(np.asarray(x, np.float64)), name, levels, "periodic")
    for h, lo, w in zip((*res.details, res.approx), (*res.details_lo, res.approx_lo),
                        (*want.details, want.approx)):
        np.testing.assert_allclose(_np(h) + _np(lo), np.asarray(w), rtol=0, atol=tol)


def test_tolerance_1e10_roundtrip_meets_contract():
    """tolerance=1e-10 from the default API: an ExactMODWTResult whose
    hi + lo lies within 5e-11 of the float64 cascade (the JAX test's bound
    for its balanced profile), and a float32 round trip within 1e-10 RMSE."""
    x = np.random.default_rng(0).standard_normal((2, 4096)).astype(np.float32)
    res = vt.modwt_multilevel(_t(x), "db4", levels=5, tolerance=1e-10)
    assert isinstance(res, vt.ExactMODWTResult)
    _exact_against_jax_f64(res, x, "db4", 5, 5e-11)
    xr = vt.imodwt_multilevel(res, "db4")
    assert xr.dtype == torch.float32
    assert float((xr.double() - _t(x).double()).pow(2).mean().sqrt()) <= 1e-10


def test_precision_kwarg_explicit():
    """precision='exact' and 'float32' pick their result types; an unknown
    name raises on both packages, and ``_resolve_tier`` combines the two
    arguments as JAX's does."""
    x = np.random.default_rng(1).standard_normal(4096).astype(np.float32)
    assert isinstance(vt.modwt_multilevel(_t(x), "sym8", levels=3, precision="exact"),
                      vt.ExactMODWTResult)
    assert isinstance(vt.modwt_multilevel(_t(x), "sym8", levels=3, precision="float32"),
                      vt.MultiLevelMODWTResult)
    with pytest.raises(InvalidArgumentError):
        vt.modwt_multilevel(_t(x), "sym8", levels=3, precision="fp8")
    with pytest.raises(vw.InvalidArgumentError):
        vw.modwt_multilevel(jnp.asarray(x), "sym8", levels=3, precision="fp8")
    from vectorwave_tpu.transforms import multilevel as jml

    for tol, prec in ((None, None), (1e-3, None), (1e-12, None), (1e-12, "float32"),
                      (None, "bf16"), (0.5, "exact")):
        assert ml._resolve_tier(tol, prec) == jml._resolve_tier(tol, prec), (tol, prec)


def test_exact_tier_batched_leading_dims():
    """[2, 3, 2048] on the exact tier: the planes keep the shape, the round
    trip within 1e-10 RMSE, hi + lo within 5e-11 of the JAX float64 cascade."""
    x = np.random.default_rng(2).standard_normal((2, 3, 2048)).astype(np.float32)
    res = vt.modwt_multilevel(_t(x), "db4", levels=3, tolerance=1e-10)
    assert res.approx.shape == x.shape
    _exact_against_jax_f64(res, x, "db4", 3, 5e-11)
    xr = vt.imodwt_multilevel(res, "db4")
    assert float((xr.double() - _t(x).double()).pow(2).mean().sqrt()) <= 1e-10


def test_plain_result_with_exact_tolerance_raises():
    """Planes already rounded to float32 cannot be inverted exactly: both
    packages raise, naming ExactMODWTResult."""
    res = vt.modwt_multilevel(torch.zeros(2, 4096), "db4", levels=3)
    with pytest.raises(InvalidArgumentError, match="ExactMODWTResult"):
        vt.imodwt_multilevel(res, "db4", tolerance=1e-10)
    jres = vw.modwt_multilevel(jnp.zeros((2, 4096), jnp.float32), "db4", levels=3)
    with pytest.raises(vw.InvalidArgumentError, match="ExactMODWTResult"):
        vw.imodwt_multilevel(jres, "db4", tolerance=1e-10)


def test_exact_result_symmetric_inverse_raises():
    """The exact tier has no symmetric inverse, on either package."""
    res = vt.modwt_multilevel(torch.zeros(2, 2048), "db4", levels=3, precision="exact",
                              boundary="symmetric")
    assert isinstance(res, vt.ExactMODWTResult)
    with pytest.raises(InvalidArgumentError, match="symmetric"):
        vt.imodwt_multilevel(res, "db4", boundary="symmetric")
    zeros = jnp.zeros((2, 2048), jnp.float32)
    jres = vw.ExactMODWTResult((zeros,) * 3, zeros, (zeros,) * 3, zeros)
    with pytest.raises(vw.InvalidArgumentError, match="symmetric"):
        vw.imodwt_multilevel(jres, "db4", boundary="symmetric")


def test_f64_input_short_circuits_exact_tier(jax_refs):
    """A float64 signal keeps the plain path under tolerance=1e-10: float64
    planes (against JAX's at 1e-12) and a round trip within 1e-10 RMSE."""
    x = np.random.default_rng(3).standard_normal(4096)
    res = vt.modwt_multilevel(_t(x), "db4", levels=4, tolerance=1e-10)
    assert isinstance(res, vt.MultiLevelMODWTResult)
    assert res.approx.dtype == torch.float64
    xr = vt.imodwt_multilevel(res, "db4", tolerance=1e-10)
    assert float((xr - _t(x)).pow(2).mean().sqrt()) <= 1e-10
    _close(res.approx, jax_refs.decompose(x, "db4", 4).approx)


def test_denoise_tolerance_clamps_to_f32_floor():
    """A sub-float32 tolerance serves the float32 tier: equal to
    precision='float32' exactly, and within 2e-5 of JAX's float32 denoise."""
    x = np.random.default_rng(4).standard_normal((2, 4096)).astype(np.float32)
    out = vt.denoise_multilevel(_t(x), "db4", levels=4, tolerance=1e-10)
    ref = vt.denoise_multilevel(_t(x), "db4", levels=4, precision="float32")
    assert torch.equal(out, ref)
    want = jax.jit(lambda z: vw.denoise_multilevel(z, "db4", levels=4, tolerance=1e-10))(
        jnp.asarray(x))
    np.testing.assert_allclose(_np(out), np.asarray(want, np.float64), rtol=0, atol=TOL_F32)


def test_tolerance_below_1e11_escalates_to_full_profile():
    """tolerance=1e-12 selects the full profile (``_exact_profile``: below
    5e-11, as in JAX) and hi + lo sits within 2e-12 of the float64 cascade."""
    assert ml._exact_profile(1e-12) == ml._exact_profile(4.9e-11) == "full"
    assert ml._exact_profile(5e-11) == ml._exact_profile(1e-10) == "balanced"
    assert ml._exact_profile(None) == "balanced"
    x = np.random.default_rng(5).standard_normal((2, 2048)).astype(np.float32)
    res = vt.modwt_multilevel(_t(x), "db4", levels=4, tolerance=1e-12)
    _exact_against_jax_f64(res, x, "db4", 4, 2e-12)


def test_denoise_explicit_exact_precision_raises():
    """A named precision='exact' on the denoise surface raises on both
    packages (its output is float32)."""
    with pytest.raises(InvalidArgumentError, match="float32 tier"):
        vt.denoise_multilevel(torch.zeros(2, 4096), "db4", levels=4, precision="exact")
    with pytest.raises(vw.InvalidArgumentError, match="float32 tier"):
        vw.denoise_multilevel(jnp.zeros((2, 4096), jnp.float32), "db4", levels=4,
                              precision="exact")
