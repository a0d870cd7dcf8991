"""Port parity: cross-wavelet analysis (``transforms.xwt``) and the
significance tests (``transforms.significance``), mirroring the xwt and
significance halves of ``tests/test_variance_xwt.py``.

The same seeded numpy signals go through the JAX package and the port in
float64 on the CPU.  Tolerances, with their reasons:

* ``cross_wavelet``, ``wavelet_coherence``, ``phase_synchronization``,
  ``instantaneous_frequency``, ``significance_levels`` and
  ``significant_power``'s levels: 1e-12 of the largest value (the same FFT
  products and sums in another FFT library); masks equal;
* ``extract_ridge``: equal indices on a chirp on both paths (the
  sequential pass below 4 x block_size samples, the blocked max-plus form
  above), and on random fields, where near-ties may resolve to another
  maximising path, equal path scores within 1e-10 of the score;
* the surrogates: the port's phase-to-surrogate step fed JAX's own uniform
  draw, 1e-12; the generator's draw itself is the port's (torch's stream,
  not JAX's), checked for its spectrum and repeatability.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from vectorwave_tpu.transforms import xwt as jx
from vectorwave_tpu_torch.errors import InvalidArgumentError
from vectorwave_tpu_torch.transforms import significance as ts
from vectorwave_tpu_torch.transforms import xwt as tx

from . import cwt_periodic

torch.set_num_threads(1)

TOL = 1e-12
N = 1024
SCALES = tuple(vw.scales_log(2, 64, 24))


def _pair(seed=0, noise=0.3, lag=np.pi / 3, f0=0.05, n=N):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = np.sin(2 * np.pi * f0 * t) + noise * rng.standard_normal(n)
    y = np.sin(2 * np.pi * f0 * t - lag) + noise * rng.standard_normal(n)
    return x, y


def _rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name,boundary", [("morl", "zero"), ("cmor", "periodic")])
def test_cross_wavelet_coherence_and_plv(name, boundary):
    x, y = _pair()
    xb, yb = np.stack([x, y]), np.stack([y, x])  # a batch, as test_xwt_batch_and_jit
    want = vw.cross_wavelet(jnp.asarray(xb), jnp.asarray(yb), SCALES, name, boundary=boundary)
    got = vt.cross_wavelet(_t(xb), _t(yb), SCALES, name, boundary=boundary)
    assert got.coeffs.is_complex() and _rel(got.coeffs, want.coeffs) <= TOL
    want = vw.wavelet_coherence(jnp.asarray(xb), jnp.asarray(yb), SCALES, name,
                                boundary=boundary)
    got = vt.wavelet_coherence(_t(xb), _t(yb), SCALES, name, boundary=boundary)
    assert _rel(got.coherence, want.coherence) <= TOL
    assert _rel(got.mean_coherence(), want.mean_coherence()) <= TOL
    # the phase where the cross spectrum is not vanishingly small
    strong = np.asarray(want.coherence) > 1e-3
    assert np.abs(got.phase.numpy()[strong] - np.asarray(want.phase)[strong]).max() <= 1e-9
    plv = vt.phase_synchronization(_t(xb), _t(yb), SCALES, name, boundary=boundary)
    assert _rel(plv, vw.phase_synchronization(jnp.asarray(xb), jnp.asarray(yb), SCALES, name,
                                              boundary=boundary)) <= TOL


@pytest.mark.parametrize("decorrelation", [0.0, 0.6, 2.0])
def test_smoothing_operator(decorrelation):
    """``_smooth`` on a real and a complex field, boxcar widths 1 to many."""
    rng = np.random.default_rng(1)
    field = rng.standard_normal((2, 24, 256))
    cfield = field + 1j * rng.standard_normal((2, 24, 256))
    for f in (field, cfield):
        want = jx._smooth(jnp.asarray(f), SCALES, scale_decorrelation=decorrelation)
        got = tx._smooth(_t(f), SCALES, scale_decorrelation=decorrelation)
        assert _rel(got, want) <= TOL


def test_instantaneous_frequency_and_its_refusal():
    """Fed JAX's own coefficients (the phase of a coefficient near zero is
    ill-conditioned, so the two CWTs' last-bit differences would show)."""
    t = np.arange(N)
    tone = np.sin(2 * np.pi * 0.05 * t)
    res = vw.cwt(jnp.asarray(tone), SCALES, "morl", analytic=True)
    want = vw.instantaneous_frequency(res, dt=0.5)
    got = vt.instantaneous_frequency(
        vt.convert.cwt_result_from_arrays(np.asarray(res.coeffs), SCALES, device="cpu"), dt=0.5)
    assert _rel(got, want) <= TOL
    with pytest.raises(InvalidArgumentError) as e:
        vt.instantaneous_frequency(vt.cwt(_t(tone), SCALES, "morl"))
    assert e.value.code.name == "CFG_INVALID_CONFIG"
    with pytest.raises(InvalidArgumentError):
        vt.cross_wavelet(torch.ones(64), torch.ones(128), (2.0, 4.0), "morl")


@pytest.mark.parametrize("n", [512, 1024])  # the sequential pass, the blocked form
def test_ridge_on_a_chirp_equals_jax(n):
    t = np.arange(n)
    chirp = np.sin(2 * np.pi * (0.01 * t + 0.00005 * t**2))
    want = vw.extract_ridge(vw.cwt(jnp.asarray(chirp), SCALES, "morl", analytic=True))
    got = vt.extract_ridge(vt.cwt(_t(chirp), SCALES, "morl", analytic=True))
    assert got.indices.dtype == torch.int32
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    assert _rel(got.scales, want.scales) == 0.0 and _rel(got.amplitude, want.amplitude) <= TOL
    r0 = vt.extract_ridge(vt.cwt(_t(chirp), SCALES, "morl", analytic=True), smoothness=0.0)
    np.testing.assert_array_equal(r0.indices.numpy(), np.asarray(
        jnp.abs(vw.cwt(jnp.asarray(chirp), SCALES, "morl", analytic=True).coeffs).argmax(-2)))
    with pytest.raises(InvalidArgumentError):
        vt.extract_ridge(vt.cwt(_t(chirp[:64]), SCALES, "morl", analytic=True),
                         smoothness=-1.0)


def _path_score(obs, pen, idx):
    """sum_t obs[t, idx_t] - sum_t pen[idx_{t-1}, idx_t] per batch row."""
    obs, idx = np.asarray(obs), np.asarray(idx)
    picked = np.take_along_axis(obs, idx[..., None], -1)[..., 0].sum(0)
    return picked - pen[idx[:-1], idx[1:]].sum(0)


@pytest.mark.parametrize("n", [300, 1025, 1153])
def test_viterbi_scores_on_random_fields(n):
    """Random fields (batched), lengths that leave a ragged last block: the
    port's path on either form scores what JAX's does, within 1e-10."""
    rng = np.random.default_rng(21 + n)
    log_scales = np.log2(np.geomspace(2, 64, 6))
    pen = 1.5 * (log_scales[:, None] - log_scales[None, :]) ** 2
    obs = rng.standard_normal((n, 3, 6)) * 2
    want = np.asarray(jx._viterbi_indices_scan(jnp.asarray(obs), jnp.asarray(pen)))
    best = _path_score(obs, pen, want)
    for form in (lambda o, p: tx._viterbi_indices_scan(o, p),
                 lambda o, p: tx._viterbi_indices_blocked(o, p, 128)):
        got = form(_t(obs), _t(pen)).numpy()
        assert np.abs(_path_score(obs, pen, got) - best).max() <= 1e-10 * np.abs(best).max()


def _periodic_red_noise_response(scales, name: str, n: int, lag1: float) -> np.ndarray:
    """``mean_f(P(f) |A(f) C_s(f)|^2)`` per scale in numpy: P the AR(1)
    spectrum, A the analytic signal's weights, C_s the spectrum of the JAX
    wavelet's real taps summed modulo ``n`` (the periodic bank, however often
    a support wraps).  The significance level is this times a chi-square
    factor that does not depend on the scale."""
    f = np.fft.fftfreq(n)
    psd = (1 - lag1**2) / (1 + lag1**2 - 2 * lag1 * np.cos(2 * np.pi * f))
    analytic = np.where(f > 0, 2.0, np.where(f == 0, 1.0, 0.0))
    return np.array([np.mean(psd * np.abs(analytic * np.fft.fft(
        cwt_periodic.folded_taps(name, s, n))) ** 2) for s in scales])


def test_significance_levels_and_significant_power():
    x, _ = _pair(seed=3, noise=1.0)
    red = np.zeros(N)
    e = np.random.default_rng(4).standard_normal(N)
    for i in range(1, N):
        red[i] = 0.7 * red[i - 1] + e[i]
    xb = np.stack([x, red])
    for analytic in (True, False):
        want = vw.significance_levels(SCALES, "morl", n=N, lag1=jnp.asarray([0.0, 0.7]),
                                      variance=jnp.asarray([1.0, 2.0]), analytic=analytic,
                                      confidence=0.9)
        got = vt.significance_levels(SCALES, "morl", n=N, lag1=_t([0.0, 0.7]),
                                     variance=_t([1.0, 2.0]), analytic=analytic,
                                     confidence=0.9)
        assert _rel(got, want) <= TOL
    # on 256 samples mexh's largest supports wrap past N: there the port's
    # bank is the periodic correlation's (JAX's keeps one tap a slot), so
    # those scales are held to that bank's own response, the rest to JAX
    got = vt.significance_levels(SCALES, "mexh", n=256, lag1=0.3, device="cpu").numpy()
    want = np.asarray(vw.significance_levels(SCALES, "mexh", n=256, lag1=0.3))
    response = _periodic_red_noise_response(SCALES, "mexh", 256, 0.3)
    fits = np.array([not cwt_periodic.wraps("mexh", s, 256) for s in SCALES])
    assert 0 < fits.sum() < len(SCALES)
    assert _rel(got[fits], want[fits]) <= TOL
    assert _rel(got, response * (want[0] / response[0])) <= TOL
    assert _rel(vt.ar1_coefficient(_t(xb)), vw.ar1_coefficient(jnp.asarray(xb))) <= TOL
    for analytic in (True, False):
        r_want = vw.cwt(jnp.asarray(xb), SCALES, "morl", analytic=analytic)
        r_got = vt.cwt(_t(xb), SCALES, "morl", analytic=analytic)
        want = vw.significant_power(r_want, jnp.asarray(xb), "morl")
        got = vt.significant_power(r_got, _t(xb), "morl")
        assert _rel(got.levels, want.levels) <= TOL and _rel(got.coi_scales,
                                                             want.coi_scales) == 0.0
        # the mask: equal wherever the power is not within 1e-9 of its level
        power = np.abs(np.asarray(r_want.coeffs)) ** 2
        near = np.abs(power - np.asarray(want.levels)[..., None]) <= 1e-9 * power.max()
        assert (got.mask.numpy() == np.asarray(want.mask))[~near].all()
    assert _rel(vt.cone_of_influence(300, dt=0.5, device="cpu"),
                vw.cone_of_influence(300, dt=0.5)) == 0.0
    for call in (lambda: vt.significance_levels((2.0,), n=64, lag1=0.0, confidence=1.5,
                                                device="cpu"),
                 lambda: vt.cone_of_influence(0, device="cpu"),
                 lambda: vt.phase_randomized_surrogates(torch.ones(8), 0),
                 lambda: vt.coherence_significance(torch.ones(64), torch.ones(64), (2.0,),
                                                   confidence=2.0)):
        with pytest.raises(InvalidArgumentError):
            call()


@pytest.mark.parametrize("n", [256, 255])  # with and without a Nyquist bin
def test_surrogates_from_jax_phases(n):
    x = np.random.default_rng(5).standard_normal((2, n))
    key = jax.random.key(0)
    spec_shape = (4, 2, n // 2 + 1)
    phases = jax.random.uniform(key, spec_shape, minval=0.0, maxval=2.0 * np.pi)
    want = vw.phase_randomized_surrogates(jnp.asarray(x), 4, key=key)
    got = ts._surrogates_from_phases(_t(x), _t(np.asarray(phases)))
    assert _rel(got, want) <= TOL


def test_surrogates_and_coherence_significance_draw_from_a_generator():
    x, y = _pair(seed=6, noise=1.0, n=256)
    s = vt.phase_randomized_surrogates(_t(x), 4)
    assert s.shape == (4, 256)
    assert np.allclose(np.abs(np.fft.rfft(s.numpy())), np.abs(np.fft.rfft(x))[None], atol=1e-9)
    assert torch.equal(s, vt.phase_randomized_surrogates(_t(x), 4))  # seeded 0 by default
    gen = torch.Generator().manual_seed(3)
    assert not torch.equal(s, vt.phase_randomized_surrogates(_t(x), 4, generator=gen))
    scales = tuple(vw.scales_log(4, 32, 6))
    lev = vt.coherence_significance(_t(x), _t(y), scales, "morl", n_surrogates=8)
    assert lev.shape == (6,) and bool(((lev > 0) & (lev <= 1)).all())
    assert torch.equal(lev, vt.coherence_significance(_t(x), _t(y), scales, "morl",
                                                      n_surrogates=8))
    # the same function as JAX's, given the same surrogates
    gen = torch.Generator().manual_seed(7)
    sx = vt.phase_randomized_surrogates(_t(x), 8, generator=gen)
    sy = vt.phase_randomized_surrogates(_t(y), 8, generator=gen)
    want = np.quantile(np.asarray(vw.wavelet_coherence(
        jnp.asarray(sx.numpy()), jnp.asarray(sy.numpy()), scales, "morl").mean_coherence()),
        0.95, axis=0)
    assert _rel(lev, want) <= TOL
