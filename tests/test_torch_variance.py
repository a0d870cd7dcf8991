"""Port parity: the wavelet variance family and its stream
(``transforms.variance``), long memory (``transforms.longmemory``) and the
variance stream's state carried across through ``convert``, mirroring the
variance halves of ``tests/test_variance_xwt.py`` and
``tests/test_longmemory.py``.

The same seeded numpy signals go through the JAX package (its jnp path on
the CPU) and the port in float64.  Tolerances, with their reasons:

* the variances, covariances, correlations and intervals: 1e-10 of the
  largest value (the same cascades and means, summed in another order);
* ``hurst_exponent``'s H, slope and intercept: 1e-9 absolute (a weighted
  fit of logs of those variances, through torch's digamma and trigamma);
* ``variance_change_test``: the statistic at 1e-10 of its value, the
  location and the decision equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from vectorwave_tpu.streaming import modwt_stream_block as jax_stream_block
from vectorwave_tpu.streaming import streaming_init as jax_streaming_init
from vectorwave_tpu.transforms.longmemory import kolmogorov_critical_value as jax_kolmogorov
from vectorwave_tpu_torch import convert
from vectorwave_tpu_torch.errors import InvalidArgumentError
from vectorwave_tpu_torch.streaming import (
    kernel_streaming_init,
    modwt_stream_block,
    modwt_stream_block_kernel,
    streaming_init,
)
from vectorwave_tpu_torch.transforms.longmemory import kolmogorov_critical_value

torch.set_num_threads(1)

TOL = 1e-10
TOL_H = 1e-9


def _rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _noise(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def _t(a):
    return torch.from_numpy(np.array(a))


def _same_variance(got, want):
    for field in ("variance", "ci_low", "ci_high"):
        assert _rel(getattr(got, field), getattr(want, field)) <= TOL, field
    np.testing.assert_array_equal(got.edof, np.asarray(want.edof))
    np.testing.assert_array_equal(got.scales, np.asarray(want.scales))


#: the shapes and depths the JAX calls share, so its compiled ops serve many tests
SHAPE = (3, 2048)


@pytest.mark.parametrize("name,levels,unbiased,shape", [
    ("db4", 4, True, SHAPE), ("db4", None, True, SHAPE), ("sym5", 5, False, (2048,))])
def test_wavelet_variance_matches_jax(name, levels, unbiased, shape):
    x = 2.0 * _noise(shape, 0)
    want = vw.wavelet_variance(jnp.asarray(x), name, levels, unbiased=unbiased, confidence=0.9,
                               dt=0.5)
    got = vt.wavelet_variance(_t(x), name, levels, unbiased=unbiased, confidence=0.9, dt=0.5)
    _same_variance(got, want)
    assert got.n_levels == want.n_levels


def test_white_noise_variance_halves_per_level():
    x = _t(2.0 * _noise(2**14, 0))
    r = vt.wavelet_variance(x, "db4", 6)
    np.testing.assert_allclose(r.variance.numpy(), 4.0 / 2.0 ** np.arange(1, 7), rtol=0.15)
    assert bool(((r.ci_low <= r.variance) & (r.variance <= r.ci_high)).all())
    assert list(r.scales) == [1, 2, 4, 8, 16, 32]


def test_biased_estimator_energy_identity_and_mean_offset():
    """sum_j nu_j^2 + mean(a_J^2) == mean(x^2) (periodic MODWT); the mean
    drops out of the unbiased estimator."""
    x = _t(_noise(4096, 1))
    r = vt.wavelet_variance(x, "sym5", 5, unbiased=False)
    res = vt.modwt_multilevel(x, "sym5", levels=5, boundary="periodic")
    total = (r.variance.sum() + (res.approx**2).mean()).item()
    assert total == pytest.approx((x**2).mean().item(), rel=1e-12)
    np.testing.assert_allclose(vt.wavelet_variance(x + 1000.0, "db4", 4).variance.numpy(),
                               vt.wavelet_variance(x, "db4", 4).variance.numpy(),
                               rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("levels,unbiased", [(4, True), (None, True)])
def test_covariance_and_correlation_match_jax(levels, unbiased):
    x, y = _noise(SHAPE, 4), _noise(SHAPE, 5)
    y = 0.6 * x + y
    want = vw.wavelet_covariance(jnp.asarray(x), jnp.asarray(y), "db4", levels,
                                 unbiased=unbiased, dt=2.0)
    got = vt.wavelet_covariance(_t(x), _t(y), "db4", levels, unbiased=unbiased, dt=2.0)
    assert _rel(got[0], want[0]) <= TOL
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    want = vw.wavelet_correlation(jnp.asarray(x), jnp.asarray(y), "db4", levels,
                                  unbiased=unbiased)
    got = vt.wavelet_correlation(_t(x), _t(y), "db4", levels, unbiased=unbiased)
    assert _rel(got[0], want[0]) <= TOL


def test_correlation_identical_and_opposite():
    x = _t(_noise(4096, 3))
    rho, scales = vt.wavelet_correlation(x, x, "db4", 4)
    np.testing.assert_allclose(rho.numpy(), 1.0, rtol=1e-12)
    rho2, _ = vt.wavelet_correlation(x, -x, "db4", 4)
    np.testing.assert_allclose(rho2.numpy(), -1.0, rtol=1e-12)
    assert list(scales) == [1, 2, 4, 8]


def test_variance_batch_rows_equal_single_calls():
    xb = _t(_noise((3, 4096), 5))
    r = vt.wavelet_variance(xb, "db4", 4)
    assert r.variance.shape == (3, 4)
    assert torch.equal(r.variance[1], vt.wavelet_variance(xb[1], "db4", 4).variance)


def _code(exc_info) -> str:
    return exc_info.value.code.value


@pytest.mark.parametrize("call,code", [
    (lambda: vt.wavelet_variance(torch.ones(64), "db4", 0), "VAL_006"),
    # db4 at level 5: L_j = 7 * 31 + 1 > 64, no boundary-free coefficients
    (lambda: vt.wavelet_variance(torch.ones(64), "db4", 5), "VAL_006"),
    (lambda: vt.wavelet_covariance(torch.ones(64), torch.ones(128), "db4", 2), "VAL_007"),
    (lambda: vt.variance_stream_init("db4", 0, device="cpu"), "VAL_006"),
])
def test_variance_errors(call, code):
    with pytest.raises(InvalidArgumentError) as got:
        call()
    assert _code(got) == code


def test_error_codes_match_jax():
    """The port raises the JAX package's codes for the same bad calls."""
    from vectorwave_tpu.errors import InvalidArgumentError as JaxInvalid

    for jax_call, port_call in (
        (lambda: vw.wavelet_variance(jnp.ones(64), "db4", 5),
         lambda: vt.wavelet_variance(torch.ones(64), "db4", 5)),
        (lambda: vw.hurst_exponent(jnp.ones(8192), "db4", 6, model="arfima"),
         lambda: vt.hurst_exponent(torch.ones(8192), "db4", 6, model="arfima")),
        (lambda: vw.variance_change_test(jnp.zeros(32), "db8", level=2),
         lambda: vt.variance_change_test(torch.zeros(32), "db8", level=2)),
    ):
        with pytest.raises(JaxInvalid) as want:
            jax_call()
        with pytest.raises(InvalidArgumentError) as got:
            port_call()
        assert _code(got) == want.value.code.value


# --- the stream -------------------------------------------------------------------------


@pytest.mark.parametrize("step", ["plain", "kernel"])
@pytest.mark.parametrize("name,levels,block,shape", [
    ("db4", 4, 256, SHAPE), ("db4", None, 300, SHAPE), ("sym5", 5, 100, (2048,))])
def test_variance_stream_equals_whole_signal(step, name, levels, block, shape):
    """Folding zero-boundary blocks (the last one shorter) reproduces the
    unbiased estimator of the whole signal, on the plain step and on the
    kernel-tier step (its plain version on a CPU tensor), and equals the
    JAX package's ``wavelet_variance`` of the whole signal (the JAX stream
    is held to it by the JAX tests, and to the port's stream below)."""
    x = _noise(shape, 0)
    levels = levels or vt.wavelet_variance(_t(x), name).n_levels
    ref = vt.wavelet_variance(_t(x), name, levels)
    if step == "plain":
        st = streaming_init(name, levels, batch_shape=shape[:-1], dtype=torch.float64,
                            device="cpu")
    else:
        st = kernel_streaming_init(name, levels, batch_shape=shape[:-1], dtype=torch.float64,
                                   device="cpu")
    acc = vt.variance_stream_init(name, levels, batch_shape=shape[:-1], dtype=torch.float64,
                                  device="cpu")
    for i in range(0, shape[-1], block):
        blk = x[..., i: i + block]
        if step == "plain":
            st, res = modwt_stream_block(st, _t(blk), name, boundary="zero")
        else:
            st, res = modwt_stream_block_kernel(st, _t(blk), name, levels=levels,
                                                boundary="zero")
        acc = vt.variance_stream_update(acc, res.details, name)
    assert acc.position == shape[-1]
    out = vt.variance_stream_result(acc, confidence=0.9)
    _same_variance(out, vw.wavelet_variance(jnp.asarray(x), name, levels, confidence=0.9))
    assert _rel(out.variance, ref.variance) <= TOL


def test_variance_stream_resumes_from_a_jax_state():
    """A JAX accumulator carried to the port through ``convert`` gives the
    same result as the JAX stream carried on, and the same sums and counts
    at every step."""
    x = _noise((2, 1024), 8)
    jst = jax_streaming_init("db4", 3, batch_shape=(2,), dtype=jnp.float64)
    jacc = vw.variance_stream_init("db4", 3, batch_shape=(2,), dtype=jnp.float64)
    for i in range(0, 512, 256):
        jst, jres = jax_stream_block(jst, jnp.asarray(x[:, i: i + 256]), "db4", boundary="zero")
        jacc = vw.variance_stream_update(jacc, jres.details, "db4")
    acc = convert.variance_stream_state_from_arrays(
        np.asarray(jacc.sumsq), np.asarray(jacc.counts), np.asarray(jacc.position),
        device="cpu")
    st = convert.streaming_state_from_arrays([np.asarray(h) for h in jst.histories],
                                             np.asarray(jst.blocks_processed), device="cpu")
    assert acc.position == 512 and acc.counts.dtype == np.int64
    for i in range(512, 1024, 256):
        jst, jres = jax_stream_block(jst, jnp.asarray(x[:, i: i + 256]), "db4", boundary="zero")
        jacc = vw.variance_stream_update(jacc, jres.details, "db4")
        st, res = modwt_stream_block(st, _t(x[:, i: i + 256]), "db4", boundary="zero")
        acc = vt.variance_stream_update(acc, res.details, "db4")
        assert acc.position == int(jacc.position)
        np.testing.assert_array_equal(acc.counts, np.asarray(jacc.counts))
        assert _rel(acc.sumsq, jacc.sumsq) <= TOL
    _same_variance(vt.variance_stream_result(acc), vw.variance_stream_result(jacc))
    with pytest.raises(InvalidArgumentError):
        convert.variance_stream_state_from_arrays(np.zeros((2, 3)), np.zeros(4), 0,
                                                  device="cpu")


def test_variance_stream_validation_and_device():
    acc = vt.variance_stream_init("db4", 4, device="cpu")
    st = streaming_init("db4", 2, device="cpu")
    st, res = modwt_stream_block(st, torch.zeros(64, dtype=torch.float32), "db4")
    with pytest.raises(InvalidArgumentError):
        vt.variance_stream_update(acc, res.details, "db4")
    if not torch.cuda.is_available():
        with pytest.raises(InvalidArgumentError):
            vt.variance_stream_init("db4", 4)  # the default device is the card


# --- long memory ---------------------------------------------------------------------


def _fgn(hurst: float, n: int, seed: int) -> np.ndarray:
    """Spectral synthesis of fractional Gaussian noise (f^-(2H-1) spectrum)."""
    rng = np.random.default_rng(seed)
    freqs = np.fft.rfftfreq(n)
    amp = np.zeros_like(freqs)
    amp[1:] = freqs[1:] ** (-(2.0 * hurst - 1.0) / 2.0)
    spec = amp * np.exp(2j * np.pi * rng.random(freqs.shape))
    spec[0] = 0.0
    x = np.fft.irfft(spec, n=n)
    return x / x.std()


@pytest.mark.parametrize("signal,model,levels,min_level,max_level", [
    ("white", "fgn", None, 1, None), ("walk", "fbm", None, 3, None),
    ("fgn85", "fgn", 4, 2, 4)])
def test_hurst_exponent_matches_jax(signal, model, levels, min_level, max_level):
    if signal == "white":
        x = _noise(SHAPE, 2)
    elif signal == "walk":
        x = np.cumsum(_noise(SHAPE, 1), axis=-1)
    else:
        x = np.stack([_fgn(0.85, SHAPE[-1], 85 + i) for i in range(SHAPE[0])])
    want = vw.hurst_exponent(jnp.asarray(x), "db4", levels, model=model, min_level=min_level,
                             max_level=max_level)
    got = vt.hurst_exponent(_t(x), "db4", levels, model=model, min_level=min_level,
                            max_level=max_level)
    for field in ("hurst", "slope", "intercept", "stderr", "spectral_exponent"):
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        assert g.shape == w.shape and np.abs(g.numpy() - w).max() <= TOL_H, field
    assert _rel(got.variance, want.variance) <= TOL
    np.testing.assert_array_equal(got.scales, np.asarray(want.scales))


def test_hurst_ground_truths():
    """White noise is H = 0.5 fGn, its cumulative sum H = 0.5 fBm (the fine
    octaves biased, min_level drops them), synthesized fGn its own H."""
    r = vt.hurst_exponent(_t(_noise(2**15, 0)), "db4", 8)
    assert abs(r.hurst.item() - 0.5) < 0.03 and abs(r.spectral_exponent.item()) < 0.06
    walk = _t(np.cumsum(_noise(2**15, 1)))
    r = vt.hurst_exponent(walk, "db4", 8, model="fbm", min_level=3)
    biased = vt.hurst_exponent(walk, "db4", 8, model="fbm")
    assert abs(r.hurst.item() - 0.5) < 0.05
    assert abs(r.hurst.item() - 0.5) < abs(biased.hurst.item() - 0.5)
    r = vt.hurst_exponent(_t(_fgn(0.85, 2**15, 85)), "db4", 8)
    assert abs(r.hurst.item() - 0.85) < 0.07


@pytest.mark.parametrize("kwargs,code", [
    ({"model": "arfima"}, "CFG_003"), ({"min_level": 6}, "VAL_006"),
    ({"min_level": 0}, "VAL_006"), ({"min_level": 2, "max_level": 7}, "VAL_006")])
def test_hurst_validation(kwargs, code):
    with pytest.raises(InvalidArgumentError) as got:
        vt.hurst_exponent(_t(_noise(8192, 4)), "db4", 6, **kwargs)
    assert _code(got) == code


@pytest.mark.parametrize("name,level,shape", [("db4", 1, SHAPE), ("db4", 3, (2, 1001))])
def test_variance_change_test_matches_jax(name, level, shape):
    x = _noise(shape, 5)
    x[..., shape[-1] // 2:] *= 3.0
    want = vw.variance_change_test(jnp.asarray(x), name, level=level, confidence=0.9)
    got = vt.variance_change_test(_t(x), name, level=level, confidence=0.9)
    assert _rel(got.statistic, want.statistic) <= TOL
    np.testing.assert_array_equal(got.location.numpy(), np.asarray(want.location))
    np.testing.assert_array_equal(got.reject.numpy(), np.asarray(want.reject))
    assert got.critical_value == want.critical_value and got.level == level


def test_variance_change_detects_break_and_holds_its_size():
    x = _noise(4096, 5)
    x[2048:] *= 3.0
    r = vt.variance_change_test(_t(x), "db4", level=1)
    assert bool(r.reject) and abs(int(r.location) - 2048) < 4096 // 10
    r = vt.variance_change_test(_t(_noise((256, 1024), 6)).float(), "db4", level=1)
    assert r.statistic.shape == (256,) and r.reject.float().mean().item() <= 0.12


def test_kolmogorov_quantiles_and_validation():
    for c in (0.9, 0.95, 0.99):
        assert kolmogorov_critical_value(c) == jax_kolmogorov(c)
    assert abs(kolmogorov_critical_value(0.95) - 1.358) < 2e-3
    with pytest.raises(InvalidArgumentError) as got:
        kolmogorov_critical_value(1.5)
    assert _code(got) == "CFG_003"
    with pytest.raises(InvalidArgumentError) as got:
        vt.variance_change_test(torch.zeros(32), "db8", level=2)  # M too small
    assert _code(got) == "VAL_006"
    with pytest.raises(InvalidArgumentError):
        vt.variance_change_test(torch.zeros(1024), "db4", level=0)
