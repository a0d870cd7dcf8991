"""Port parity: the exact precision tier against vectorwave_tpu's exact tier.

The same seeded float32 input goes through the JAX exact kernels (Pallas in
interpret mode, as ``tests/test_exact_mode.py`` runs them) and through the
port, whose kernel wrappers run their plain float64 versions on the CPU.
Limits on hi + lo combined in float64, for unit-variance data:

* port against JAX, ``balanced`` profile: 5e-11 max abs (the JAX balanced
  slicing differs from a float64 cascade by 1.2-2.0e-11 at these sizes);
* port against JAX, ``full`` profile: 1e-12 (JAX full: ~2.2e-13);
* port round trip against x: RMSE 1e-12, and the hi words equal x bitwise
  (the port carries float64 planes split into float32 pairs, ~4-6e-16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from vectorwave_tpu.errors import InvalidArgumentError as JaxInvalidArgumentError
from vectorwave_tpu.kernels import modwt_exact as jax_exact
from vectorwave_tpu.kernels.modwt_pallas import _kernel_filters as jax_kernel_filters
from vectorwave_tpu_torch.errors import ErrorCode, InvalidArgumentError
from vectorwave_tpu_torch.kernels import modwt_composite as mc
from vectorwave_tpu_torch.kernels import modwt_exact as port_exact
from vectorwave_tpu_torch.kernels.modwt_fused import _kernel_filters

from .conftest import composite_sin

torch.set_num_threads(1)

TOL_BALANCED = 5e-11
TOL_FULL = 1e-12
RT_RMSE = 1e-12


def _x32(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _combine(hi, lo):
    if isinstance(hi, torch.Tensor):
        hi, lo = hi.numpy(), lo.numpy()
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def _pair_err(got_pairs, want_pairs):
    return max(float(np.max(np.abs(_combine(*g) - _combine(*w))))
               for g, w in zip(got_pairs, want_pairs))


def _planes(res):
    """(hi, lo) pairs of an ExactMODWTResult, details then approx."""
    return list(zip((*res.details, res.approx), (*res.details_lo, res.approx_lo)))


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)))


@pytest.fixture(scope="module")
def jax_db4():
    """One JAX exact analysis and inverse, db4 J=3, 2x512 periodic."""
    x = _x32((2, 512), seed=21)
    res = vw.modwt_multilevel(jnp.asarray(x), "db4", levels=3, precision="exact")
    y = vw.imodwt_multilevel(res, "db4")
    return x, res, np.asarray(y)


# (wavelet, levels, shape, periodic, profile, with x_lo)
ANALYSIS_CASES = [
    ("db4", 3, (1, 512), True, "balanced", False),
    ("db4", 3, (1, 512), False, "balanced", False),
    ("sym8", 3, (2, 1024), True, "full", False),
    ("sym8", 3, (2, 1024), False, "balanced", True),
]


@pytest.mark.parametrize("name,levels,shape,periodic,profile,with_lo", ANALYSIS_CASES)
def test_analysis_exact_matches_jax(name, levels, shape, periodic, profile, with_lo):
    x = _x32(shape, seed=levels + shape[1])
    # a lo word of a few ulps of hi, as a chained pipeline would carry
    x_lo = (_x32(shape, seed=99) * np.abs(x) * 2.0**-26).astype(np.float32) if with_lo else None
    want = jax_exact.analysis_exact(
        jnp.asarray(x), levels, jax_kernel_filters(vw.wavelet(name), synthesis=False),
        periodic, interpret=True, profile=profile,
        x_lo=None if x_lo is None else jnp.asarray(x_lo),
    )
    got = port_exact.analysis_exact(
        torch.from_numpy(x), levels, _kernel_filters(vt.wavelet(name), synthesis=False),
        periodic, x_lo=None if x_lo is None else torch.from_numpy(x_lo), profile=profile,
    )
    assert len(got) == len(want) == levels + 1
    assert all(h.dtype == l.dtype == torch.float32 and h.shape == shape for h, l in got)
    tol = TOL_FULL if profile == "full" else TOL_BALANCED
    assert _pair_err(got, want) <= tol
    # hi is the correctly rounded float32 value of the pair
    for hi, lo in got:
        assert torch.equal(hi, (hi.double() + lo.double()).float())


@pytest.mark.parametrize("how", [{"precision": "exact"}, {"tolerance": 1e-10}])
def test_public_exact_analysis_matches_jax(jax_db4, how):
    x, want, _ = jax_db4
    got = vt.modwt_multilevel(torch.from_numpy(x), "db4", levels=3, **how)
    assert isinstance(got, vt.ExactMODWTResult)
    assert got.levels == 3 and got.signal_length == 512
    assert _pair_err(_planes(got), _planes(want)) <= TOL_BALANCED


def test_public_exact_full_profile_on_3d_input_matches_jax():
    x = _x32((2, 2, 256), seed=22)
    want = vw.modwt_multilevel(jnp.asarray(x), "db4", levels=2, tolerance=1e-12)
    got = vt.modwt_multilevel(torch.from_numpy(x), "db4", levels=2, tolerance=1e-12)
    assert isinstance(got, vt.ExactMODWTResult)
    assert all(p.shape == (2, 2, 256) for pair in _planes(got) for p in pair)
    assert _pair_err(_planes(got), _planes(want)) <= TOL_FULL
    y = vt.imodwt_multilevel(got, "db4", tolerance=1e-12)
    assert y.shape == x.shape and torch.equal(y, torch.from_numpy(x))


def test_public_exact_1d_input_matches_jax():
    x = _x32((300,), seed=23)
    want = vw.modwt_multilevel(jnp.asarray(x), "sym8", levels=2, precision="exact")
    got = vt.modwt_multilevel(torch.from_numpy(x), "sym8", levels=2, precision="exact")
    assert got.approx.shape == (300,) and got.details_lo[1].shape == (300,)
    assert _pair_err(_planes(got), _planes(want)) <= TOL_BALANCED


def test_jax_planes_through_the_port_inverse(jax_db4):
    x, want, jax_y = jax_db4
    res = vt.convert.exact_result_from_arrays(
        [np.asarray(d) for d in want.details], np.asarray(want.approx),
        [np.asarray(d) for d in want.details_lo], np.asarray(want.approx_lo),
        device="cpu",
    )
    y = vt.imodwt_multilevel(res, "db4")
    assert y.dtype == torch.float32
    assert _rmse(y.numpy(), x) <= 1e-10
    np.testing.assert_array_equal(y.numpy(), jax_y)


def test_port_planes_through_the_jax_inverse(jax_db4):
    x, _, _ = jax_db4
    pairs = port_exact.analysis_exact(
        torch.from_numpy(x), 3, _kernel_filters(vt.wavelet("db4"), synthesis=False), True)
    hi, lo = jax_exact.synthesis_exact(
        tuple((jnp.asarray(h.numpy()), jnp.asarray(l.numpy())) for h, l in pairs), 3,
        jax_kernel_filters(vw.wavelet("db4"), synthesis=True), True, interpret=True)
    assert _rmse(_combine(hi, lo), x) <= 1e-10


def test_roundtrip_exact_matches_jax_and_x(jax_db4):
    x, _, jax_y = jax_db4
    hi, lo = vt.modwt_roundtrip_exact(torch.from_numpy(x), "db4", levels=3)
    assert _rmse(_combine(hi, lo), x) <= RT_RMSE
    assert torch.equal(hi, torch.from_numpy(x))
    np.testing.assert_array_equal(hi.numpy(), jax_y)
    h1, l1 = vt.modwt_roundtrip_exact(torch.from_numpy(x[0]), "db4", levels=3)
    assert h1.shape == (512,) and torch.equal(h1, hi[0]) and torch.equal(l1, lo[0])


def test_analysis_exact_symmetric_matches_jax():
    x = _x32((1, 512), seed=24)
    filters = _kernel_filters(vt.wavelet("db4"), synthesis=False)
    want = jax_exact.analysis_exact_symmetric(
        jnp.asarray(x), 2, jax_kernel_filters(vw.wavelet("db4"), synthesis=False),
        interpret=True)
    got = port_exact.analysis_exact_symmetric(torch.from_numpy(x), 2, filters)
    assert _pair_err(got, want) <= TOL_BALANCED
    # and the float64 plain symmetric cascade, within the pairs' 48 bits
    ref = vt.modwt_multilevel(torch.from_numpy(x.astype(np.float64)), "db4", levels=2,
                              boundary="symmetric", backend="torch")
    d, a = vt.modwt_multilevel_exact(torch.from_numpy(x), "db4", levels=2,
                                     boundary="symmetric")
    for (hi, lo), r in zip((*d, a), (*ref.details, ref.approx)):
        assert float((hi.double() + lo.double() - r).abs().max()) <= 1e-13


def test_public_exact_round_trips_and_hi_equals_x():
    for name, levels, boundary in (("db4", 4, "periodic"), ("sym8", 3, "zero")):
        x = torch.from_numpy(_x32((2, 2048), seed=25))
        res = vt.modwt_multilevel(x, name, levels=levels, boundary=boundary,
                                  precision="exact")
        hi, lo = vt.imodwt_multilevel_exact(
            tuple(zip(res.details, res.details_lo)), (res.approx, res.approx_lo),
            name, boundary=boundary)
        span = (vt.wavelet(name).filter_length - 1) * (2**levels - 1)
        inner = slice(None) if boundary == "periodic" else slice(span, -span)
        assert _rmse(_combine(hi, lo)[:, inner], x.numpy()[:, inner]) <= RT_RMSE
        assert torch.equal(hi[:, inner], x[:, inner])


def test_levels_split_over_launches_match_one_cascade():
    """A cascade split at a level boundary (as the kernels split a halo that
    does not fit shared memory) agrees with the unsplit one to 2^-48."""
    x = torch.from_numpy(_x32((2, 4096), seed=26))
    filters = _kernel_filters(vt.wavelet("sym8"), synthesis=False)
    whole = mc.exact_analysis(x, None, 5, filters, True)
    head = mc.exact_analysis(x, None, 3, filters, True)
    tail = mc.exact_analysis(*head[3], 2, filters, True, first_level=4)
    assert _pair_err(head[:3] + tail, whole) <= 1e-14
    rec = _kernel_filters(vt.wavelet("sym8"), synthesis=True)
    coarse = mc.exact_synthesis(whole[3:], 2, rec, True, first_level=4)
    fine = mc.exact_synthesis(whole[:3] + (coarse,), 3, rec, True)
    assert _pair_err([fine], [mc.exact_synthesis(whole, 5, rec, True)]) <= 1e-14
    plan = mc.exact_launches(mc.exact_analysis_shared_bytes, 16, 10)
    assert plan == [(1, 9, 2048, False), (10, 1, 2048, False)]  # sym8 J=10: two launches
    assert mc.exact_launches(mc.exact_synthesis_shared_bytes, 8, 6) == [(1, 6, 2048, False)]
    # db38 J=9: levels 8 and 9 of the inverse each have a halo too long for
    # shared memory, so each is one direct launch
    plan = mc.exact_launches(mc.exact_synthesis_shared_bytes, 76, 9)
    assert [(first, count, direct) for first, count, _, direct in plan] == [
        (1, 6, False), (7, 1, False), (8, 1, True), (9, 1, True)]


def test_baseline_config1_haar_one_level_on_the_exact_tier():
    x = torch.from_numpy(composite_sin(1024, noise_std=0.3).astype(np.float32))
    res = vt.modwt_multilevel(x, "haar", levels=1, boundary="periodic", precision="exact")
    xr = vt.imodwt_multilevel(res, "haar", boundary="periodic")
    assert isinstance(res, vt.ExactMODWTResult)
    assert float((x - xr).abs().max()) < 1e-10


def test_baseline_config2_db4_six_levels_65536_on_the_exact_tier():
    x = torch.from_numpy(composite_sin(65536, noise_std=0.3).astype(np.float32))
    res = vt.modwt_multilevel(x, "db4", levels=6, boundary="periodic", precision="exact")
    xr = vt.imodwt_multilevel(res, "db4", boundary="periodic")
    assert isinstance(res, vt.ExactMODWTResult)
    assert float(((x.double() - xr.double()) ** 2).mean().sqrt()) < 1e-10


def test_exact_tier_errors_match_jax():
    x = _x32((1, 512), seed=27)
    xt = torch.from_numpy(x)
    res = vt.modwt_multilevel(xt, "db4", levels=2, precision="exact")
    # the exact tier has no symmetric inverse
    with pytest.raises(InvalidArgumentError) as err:
        vt.imodwt_multilevel(res, "db4", boundary="symmetric")
    assert err.value.code == ErrorCode.CFG_UNSUPPORTED_BOUNDARY
    # an exact request on a plain float32 result
    plain = vt.modwt_multilevel(xt, "db4", levels=2, precision="float32")
    jplain = vw.modwt_multilevel(jnp.asarray(x), "db4", levels=2, precision="float32")
    with pytest.raises(InvalidArgumentError, match="ExactMODWTResult") as err:
        vt.imodwt_multilevel(plain, "db4", precision="exact")
    assert err.value.code == ErrorCode.CFG_INVALID_CONFIG
    with pytest.raises(JaxInvalidArgumentError, match="ExactMODWTResult"):
        vw.imodwt_multilevel(jplain, "db4", precision="exact")
    # unknown profile and boundary
    with pytest.raises(InvalidArgumentError, match="Unknown exact profile") as err:
        vt.modwt_roundtrip_exact(xt, "db4", levels=2, profile="fast")
    assert err.value.code == ErrorCode.CFG_INVALID_CONFIG
    with pytest.raises(JaxInvalidArgumentError, match="Unknown exact profile"):
        jax_exact._resolve_profile("fast")
    with pytest.raises(InvalidArgumentError) as err:
        vt.modwt_multilevel_exact(xt, "db4", levels=2, boundary="mirror")
    assert err.value.code == ErrorCode.CFG_UNSUPPORTED_BOUNDARY
    with pytest.raises(JaxInvalidArgumentError):
        vw.modwt_multilevel_exact(jnp.asarray(x), "db4", levels=2, boundary="mirror")


def test_exact_tier_refuses_inputs_that_require_grad():
    x = torch.from_numpy(_x32((1, 512), seed=28)).requires_grad_(True)
    with pytest.raises(InvalidArgumentError, match="no gradient") as err:
        vt.modwt_multilevel(x, "db4", levels=2, precision="exact")
    assert err.value.code == ErrorCode.CFG_INVALID_CONFIG
    with torch.no_grad():
        res = vt.modwt_multilevel(x, "db4", levels=2, precision="exact")
    planes = [p.clone().requires_grad_(True) for p in res.details]
    with pytest.raises(InvalidArgumentError, match="no gradient"):
        vt.imodwt_multilevel(res._replace(details=tuple(planes)), "db4")
    with pytest.raises(InvalidArgumentError, match="no gradient"):
        vt.modwt_roundtrip_exact(x, "db4", levels=2)


def test_exact_result_from_arrays_checks_shapes():
    a = np.zeros((2, 64), np.float32)
    res = vt.convert.exact_result_from_arrays([a, a], a, [a, a], a, device="cpu")
    assert res.levels == 2 and res.approx_lo.dtype == torch.float32
    with pytest.raises(InvalidArgumentError):
        vt.convert.exact_result_from_arrays([a, a], a, [a], a, device="cpu")
    with pytest.raises(InvalidArgumentError):
        vt.convert.exact_result_from_arrays([a], a, [a], np.zeros((2, 32), np.float32),
                                            device="cpu")
