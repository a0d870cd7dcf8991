"""Test mirrors of the JAX package's analysis tests built on the CWT family, on the port.

Mirrors the wavelet-variance half of ``tests/test_variance_xwt.py`` (the
variance, covariance, correlation and the variance stream),
``tests/test_finance.py`` and ``tests/test_incremental_wavelet.py`` test by
test, under the JAX tests' names, at their shapes and seeds; the audit of
the seven files of the CWT family is in CHANGES.md.

These JAX tests state properties of the package's output (white-noise
variance halving per level, the energy identity, crashes flagged, regimes
told apart).  Here the port is held to the same property on its own
output; the earlier parity tests (``test_torch_variance.py``,
``test_torch_finance.py``) hold it to JAX value by value.  Each family is
anchored to the JAX package once more, at a named draw of its mirror,
through a module-scoped fixture (``anchor_*``); the JAX side runs its jnp
path, never a Pallas kernel.  A JAX ``jit`` or ``lax.scan`` half has no
counterpart (the port does not trace); its batch or loop half is
mirrored.  The analyzers turn host prices into tensors of the default
dtype, so the finance tests run with torch's default dtype set to
float64, the counterpart of the JAX tests' x64 float, and ``device="cpu"``.

Tolerances: the anchors 1e-10 of the largest value (float64 on both
sides); the properties at the JAX tests' own bounds.

The phase 2e cases of these files (``tools/mirror_cases.analysis_cases``)
run here on CPU tensors (``mirror_cases.cpu_problems``).
"""

import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from tools import mirror_cases
from vectorwave_tpu import finance as jf
from vectorwave_tpu_torch import finance as tf
from vectorwave_tpu_torch.errors import InvalidArgumentError
from vectorwave_tpu_torch.streaming import (kernel_streaming_init, modwt_stream_block,
                                            modwt_stream_block_kernel, streaming_init)

torch.set_num_threads(1)

ANCHOR = 1e-10
F64 = torch.float64
CPU = "cpu"


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _t(a, dtype=F64) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


@pytest.fixture
def float64_default():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


# --- the anchors: each family against the JAX package once ---------------------------


@pytest.fixture(scope="module")
def anchor_variance():
    """JAX's unbiased and biased wavelet variance at
    test_biased_estimator_energy_identity's draw (sym5 J=5, 4096)
    (ANCHOR_VARIANCE)."""
    x = np.random.default_rng(1).standard_normal(4096)
    return x, [np.asarray(vw.wavelet_variance(jnp.asarray(x), "sym5", 5, unbiased=u).variance)
               for u in (True, False)]


def test_anchor_variance_matches_jax(anchor_variance):
    x, want = anchor_variance
    for unbiased, w in zip((True, False), want):
        assert _rel(vt.wavelet_variance(_t(x), "sym5", 5, unbiased=unbiased).variance,
                    w) <= ANCHOR


@pytest.fixture(scope="module")
def anchor_finance():
    """JAX's wavelet indicators at test_wavelet_indicators' draw (512
    prices, seed 8) (ANCHOR_FINANCE)."""
    prices = mirror_cases.price_series(512, 8)
    return prices, jf.calculate_wavelet_indicators(prices)


def test_anchor_indicators_match_jax(anchor_finance, float64_default):
    prices, want = anchor_finance
    got = tf.calculate_wavelet_indicators(prices, device=CPU)
    for field in got._fields:
        assert _rel(getattr(got, field), getattr(want, field)) <= ANCHOR, field


@pytest.fixture(scope="module")
def anchor_ticks():
    """JAX's tick stream at test_scan_matches_loop's walk (200 ticks,
    float64) (ANCHOR_TICKS)."""
    prices = _walk(200)
    m = jf.analyze_ticks_incremental(jnp.asarray(prices))
    return prices, np.asarray(m.crash_score), np.asarray(m.risk_level), np.asarray(m.macd)


def test_anchor_tick_stream_matches_jax(anchor_ticks):
    prices, crash, risk, macd = anchor_ticks
    got = tf.analyze_ticks_incremental(_t(prices))
    for g, w in ((got.crash_score, crash), (got.risk_level, risk), (got.macd, macd)):
        assert _rel(g, w) <= ANCHOR


# --- tests/test_variance_xwt.py: the wavelet variance ----------------------------------


def test_white_noise_variance_halves_per_level():
    x = _t(np.random.default_rng(0).standard_normal(2**16) * 2.0)
    r = vt.wavelet_variance(x, "db4", 6)
    np.testing.assert_allclose(_np(r.variance), 4.0 / 2.0 ** np.arange(1, 7), rtol=0.12)
    assert bool(((r.ci_low <= r.variance) & (r.variance <= r.ci_high)).all())
    assert r.n_levels == 6 and list(r.scales) == [1, 2, 4, 8, 16, 32]


def test_biased_estimator_energy_identity():
    x = _t(np.random.default_rng(1).standard_normal(4096))
    r = vt.wavelet_variance(x, "sym5", 5, unbiased=False)
    res = vt.modwt_multilevel(x, "sym5", levels=5, boundary="periodic")
    total = float(r.variance.sum() + (res.approx**2).mean())
    assert total == pytest.approx(float((x**2).mean()), rel=1e-12)


def test_variance_ignores_mean_offset():
    x = _t(np.random.default_rng(2).standard_normal(4096))
    r1 = vt.wavelet_variance(x, "db4", 4)
    r2 = vt.wavelet_variance(x + 1000.0, "db4", 4)
    np.testing.assert_allclose(_np(r1.variance), _np(r2.variance), rtol=1e-6, atol=1e-9)


def test_correlation_identical_and_opposite():
    x = _t(np.random.default_rng(3).standard_normal(4096))
    rho, scales = vt.wavelet_correlation(x, x, "db4", 4)
    np.testing.assert_allclose(_np(rho), 1.0, rtol=1e-12)
    rho2, _ = vt.wavelet_correlation(x, -x, "db4", 4)
    np.testing.assert_allclose(_np(rho2), -1.0, rtol=1e-12)
    assert list(scales) == [1, 2, 4, 8]


def test_covariance_of_independent_series_is_small():
    rng = np.random.default_rng(4)
    x = _t(rng.standard_normal(2**14))
    y = _t(rng.standard_normal(2**14))
    cov, _ = vt.wavelet_covariance(x, y, "db4", 4)
    assert float(cov.abs().max()) < 0.05


def test_variance_batch_and_jit():
    """The batch half (the port does not trace): a row of the batch equals
    its own call bit for bit."""
    xb = _t(np.random.default_rng(5).standard_normal((3, 4096)))
    r = vt.wavelet_variance(xb, "db4", 4)
    assert tuple(r.variance.shape) == (3, 4)
    single = vt.wavelet_variance(xb[1], "db4", 4)
    np.testing.assert_array_equal(_np(r.variance[1]), _np(single.variance))


def test_variance_errors():
    x = torch.ones(64, dtype=F64)
    with pytest.raises(InvalidArgumentError):
        vt.wavelet_variance(x, "db4", 0)
    with pytest.raises(InvalidArgumentError):
        vt.wavelet_variance(x, "db38", 6)
    with pytest.raises(InvalidArgumentError):
        vt.wavelet_covariance(torch.ones(64, dtype=F64), torch.ones(128, dtype=F64), "db4", 2)


# --- tests/test_variance_xwt.py: the variance stream -----------------------------------


@pytest.mark.parametrize("step", ["plain", "kernel"])
def test_variance_stream_matches_whole_signal(step):
    """Both streaming steps (the kernel tier's plain version on a CPU
    tensor), float64, against the whole-signal estimator."""
    x = _t(np.random.default_rng(7).standard_normal(1024))
    ref = vt.wavelet_variance(x, "db4", 4)
    init = streaming_init if step == "plain" else kernel_streaming_init
    st = init("db4", 4, dtype=F64, device=CPU)
    acc = vt.variance_stream_init("db4", 4, dtype=F64, device=CPU)
    for i in range(0, 1024, 128):
        if step == "plain":
            st, res = modwt_stream_block(st, x[i: i + 128], "db4", boundary="zero")
        else:
            st, res = modwt_stream_block_kernel(st, x[i: i + 128], "db4", levels=4,
                                                boundary="zero")
        acc = vt.variance_stream_update(acc, res.details, "db4")
    out = vt.variance_stream_result(acc)
    np.testing.assert_allclose(_np(out.variance), _np(ref.variance), rtol=1e-12)
    np.testing.assert_allclose(out.edof, ref.edof, rtol=1e-12)
    np.testing.assert_allclose(_np(out.ci_low), _np(ref.ci_low), rtol=1e-10)
    np.testing.assert_allclose(_np(out.ci_high), _np(ref.ci_high), rtol=1e-10)
    assert int(acc.position) == 1024


@pytest.mark.parametrize("step", ["plain", "kernel"])
def test_variance_stream_batched_and_jittable(step):
    """The loop half (the port does not trace): three float32 streams of
    blocks of 64 on either step, against the whole signal within 2e-5."""
    x = _t(np.random.default_rng(8).standard_normal((3, 512)), torch.float32)
    ref = vt.wavelet_variance(x, "haar", 3)
    init = streaming_init if step == "plain" else kernel_streaming_init
    st = init("haar", 3, batch_shape=(3,), device=CPU)
    acc = vt.variance_stream_init("haar", 3, batch_shape=(3,), device=CPU)
    for i in range(0, 512, 64):
        blk = x[:, i: i + 64]
        if step == "plain":
            st, res = modwt_stream_block(st, blk, "haar", boundary="zero")
        else:
            st, res = modwt_stream_block_kernel(st, blk, "haar", levels=3, boundary="zero")
        acc = vt.variance_stream_update(acc, res.details, "haar")
    out = vt.variance_stream_result(acc)
    assert tuple(out.variance.shape) == (3, 3)
    np.testing.assert_allclose(_np(out.variance), _np(ref.variance), rtol=2e-5)


def test_variance_stream_validation():
    with pytest.raises(InvalidArgumentError):
        vt.variance_stream_init("db4", 0, device=CPU)
    acc = vt.variance_stream_init("db4", 4, device=CPU)
    st = streaming_init("db4", 2, device=CPU)
    st, res = modwt_stream_block(st, torch.zeros(64), "db4", boundary="zero")
    with pytest.raises(InvalidArgumentError):
        vt.variance_stream_update(acc, res.details, "db4")


@pytest.mark.parametrize("label", mirror_cases.analysis_labels("analysis"))
def test_analysis_case_runs_its_plain_versions_on_the_cpu(label):
    """Each phase 2e case of this file on CPU tensors: no launch, no
    refusal, the plain route's result within the case's bounds."""
    assert not mirror_cases.cpu_problems(label)


def _jax_test_source(source):
    module, name = source.split("::")
    mod = importlib.import_module(f"tests.{module[:-3]}")
    return inspect.getsource(getattr(mod, name)), mod


def test_analysis_cases_are_the_jax_tests_shapes():
    """Every phase 2e case names a JAX test that exists and whose source (or
    its module's) names the case's wavelet (the analyzers' own wavelets
    aside) and every extent of its shape; a seeded draw's seed is in the
    test, and the inputs made with the JAX tests' helpers equal the
    helpers' (float32 cast)."""
    cases = mirror_cases.analysis_cases()
    assert len({c.label for c in cases}) == len(cases)
    for case in cases:
        src, mod = _jax_test_source(case.source)
        module_src = inspect.getsource(mod)
        if case.kind != "finance":
            assert f'"{case.wavelet}"' in src or f'"{case.wavelet}"' in module_src, case.label
        for extent in case.shape:
            forms = {str(extent)} | ({f"2**{extent.bit_length() - 1}"}
                                     if extent & (extent - 1) == 0 else set())
            assert any(f in src or f in module_src for f in forms), (case.label, extent)
        kind = case.data[0]
        if kind == "two_tone":
            want = mod._two_tone(case.shape[-1])
        elif kind == "prices":
            want = mod._price_series(case.shape[-1], seed=case.data[1], crash_at=case.data[2])
        elif kind == "sharpe_returns":
            assert "0.001 + 0.002 * np.sin(np.arange(2048) / 64)" in src
            assert "default_rng(2)" in src and "normal(0, 0.02, 2048)" in src
            continue
        else:
            assert f"default_rng({case.data[1]})" in src, case.label
            if kind == "scaled":
                assert f"* {case.data[2]}" in src, case.label
            continue
        np.testing.assert_array_equal(mirror_cases.case_input(case), want.astype(case.dtype))
    assert {c.source.split("::")[0] for c in cases} == {
        "test_cwt.py", "test_variance_xwt.py", "test_finance.py"}


# --- tests/test_finance.py -------------------------------------------------------------


def _price_series(n=1024, seed=0, crash_at=None):
    return mirror_cases.price_series(n, seed, crash_at)


def test_sharpe_ratio(float64_default):
    rets = np.random.default_rng(1).normal(0.001, 0.01, 2048)
    sr = float(tf.sharpe_ratio(rets, device=CPU))
    assert abs(sr - rets.mean() / rets.std(ddof=1)) < 1e-10
    assert float(tf.sharpe_ratio(rets, risk_free_rate=0.001, device=CPU)) < sr


def test_wavelet_sharpe_denoises(float64_default):
    rng = np.random.default_rng(2)
    rets = 0.001 + 0.002 * np.sin(np.arange(2048) / 64) + rng.normal(0, 0.02, 2048)
    assert float(tf.wavelet_sharpe_ratio(rets, device=CPU)) > float(
        tf.sharpe_ratio(rets, device=CPU))


def test_crash_asymmetry_flags_crashes(float64_default):
    calm = _price_series(512, seed=3)
    crashed = _price_series(512, seed=3, crash_at=256)
    assert float(tf.crash_asymmetry(crashed, device=CPU)) > float(
        tf.crash_asymmetry(calm, device=CPU))


def test_detect_market_crashes(float64_default):
    result = tf.detect_market_crashes(_price_series(512, seed=4, crash_at=300), device=CPU)
    assert result.max_severity > 0
    assert any(280 <= p <= 320 for p in result.crash_points), result.crash_points
    assert all(0.0 <= prob <= 1.0 for prob in result.crash_probabilities.values())


def test_analyze_volatility_clusters(float64_default):
    rng = np.random.default_rng(5)
    rets = np.concatenate([rng.normal(0, 0.005, 256), rng.normal(0, 0.04, 256)])
    result = tf.analyze_volatility(100 * np.exp(np.cumsum(rets)), device=CPU)
    assert result.max_volatility > result.average_volatility
    assert len(result.volatility_clusters) >= 2
    inst = result.instantaneous_volatility
    assert inst[260:].mean() > 2 * inst[:250].mean()


def test_cyclical_analysis_finds_period(float64_default):
    prices = 100 + 5 * np.sin(2 * np.pi * np.arange(1024) / 64)
    result = tf.analyze_cyclical_patterns(prices, device=CPU)
    assert result.dominant_cycles
    top = result.dominant_cycles[0]
    assert abs(top.period - 64) / 64 < 0.35, top


def test_analyze_market(float64_default):
    result = tf.analyze_market(_price_series(1024, seed=6, crash_at=700), device=CPU)
    assert 0 <= result.max_drawdown <= 1
    assert result.current_risk_level > 0
    assert result.regime_map
    assert any(a.type is tf.AnomalyType.PRICE_SPIKE for a in result.anomalies)


def test_trading_signals(float64_default):
    result = tf.generate_trading_signals(_price_series(512, seed=7, crash_at=256), device=CPU)
    assert result.signals
    assert any(s.type is tf.SignalType.SELL for s in result.signals)
    assert 0.0 <= result.win_rate <= 1.0


def test_wavelet_indicators(float64_default):
    prices = _price_series(512, seed=8)
    ind = tf.calculate_wavelet_indicators(prices, device=CPU)
    assert ind.trend_strength.shape == (512,) and ind.momentum.shape == (512,)
    assert (ind.trend_strength >= 0).all() and (ind.trend_strength <= 1).all()
    assert (ind.volatility_index >= 0).all()


def test_incremental_scan_consistency():
    """The loop half (the port does not trace ``lax.scan``): 256 ticks in
    float64, the max drawdown against the batch computation, and a prefix's
    state its own loop's."""
    prices = _price_series(256, seed=9)
    state = tf.incremental_init(F64, device=CPU)
    vol_fast = []
    for p in prices:
        state, m = tf.incremental_update(state, p)
        vol_fast.append(float(state.ewma_vol_fast))
    assert int(state.count) == 256
    peaks = np.maximum.accumulate(prices)
    assert abs(float(state.max_drawdown) - ((peaks - prices) / peaks).max()) < 1e-10
    s2 = tf.incremental_init(F64, device=CPU)
    for p in prices[:10]:
        s2, _ = tf.incremental_update(s2, p)
    assert float(s2.ewma_vol_fast) == vol_fast[9]
    assert float(s2.last_price) == prices[9]


# --- tests/test_incremental_wavelet.py -------------------------------------------------


def _walk(n, seed=0, drift=0.0005, vol=0.01):
    rng = np.random.default_rng(seed)
    return 100.0 * np.exp(np.cumsum(drift + vol * rng.standard_normal(n)))


def test_haar_detail_closed_form():
    st = tf.incremental_wavelet_init(dtype=F64, device=CPU)
    details = []
    for p in _t([100.0, 102.0, 101.0, 101.0]):
        st, m = tf.incremental_wavelet_update(st, p)
        details.append(float(m.haar_detail))
    np.testing.assert_allclose(details, [0.0, 1.0, -0.5, 0.0], atol=1e-12)


def test_scan_matches_loop():
    prices = _t(_walk(200), torch.float32)
    metrics = tf.analyze_ticks_incremental(prices)
    st = tf.incremental_wavelet_init(device=CPU)
    for p in prices:
        st, m = tf.incremental_wavelet_update(st, p)
    np.testing.assert_allclose(float(metrics.crash_score[-1]), float(m.crash_score),
                               rtol=1e-5)
    assert tuple(metrics.base.ret.shape) == (200,)


def test_crash_detection_fires_on_crash():
    n = 400
    prices = _walk(n, seed=3, vol=0.005)
    prices[300:] = prices[300:] * np.exp(-0.04 * np.arange(1, n - 300 + 1))
    metrics = tf.analyze_ticks_incremental(_t(prices, torch.float32))
    crash = _np(metrics.crash_detected)
    assert crash[300:340].any(), "crash window should trigger detection"
    assert not crash[:250].any(), "calm period should not trigger"
    risk = _np(metrics.risk_level)
    assert risk[300:340].max() > risk[100:250].max()


def test_regime_codes():
    up = tf.analyze_ticks_incremental(_t(_walk(300, seed=5, drift=0.004, vol=0.003),
                                         torch.float32))
    assert int(np.median(_np(up.regime_code)[100:])) == 0
    down = tf.analyze_ticks_incremental(_t(_walk(300, seed=6, drift=-0.004, vol=0.003),
                                           torch.float32))
    assert int(np.median(_np(down.regime_code)[100:])) >= 2


def test_macd_and_wavelet_vol_finite():
    metrics = tf.analyze_ticks_incremental(_t(_walk(500, seed=7), torch.float32))
    assert np.isfinite(_np(metrics.macd)).all()
    assert np.isfinite(_np(metrics.wavelet_vol)).all()
    assert (_np(metrics.wavelet_vol)[10:] >= 0).all()


def test_jit_single_update():
    """The update's half (the port does not trace): two float32 updates."""
    st = tf.incremental_wavelet_init(device=CPU)
    st, m = tf.incremental_wavelet_update(st, torch.tensor(100.0))
    st, m = tf.incremental_wavelet_update(st, torch.tensor(101.0))
    assert float(m.haar_detail) == pytest.approx(0.5)
