"""Port parity: the financial analyzers (``finance``) and matching pursuit
(``optimize.mp``), mirroring ``tests/test_finance.py``,
``tests/test_incremental_wavelet.py`` and ``tests/test_matching_pursuit.py``.

The same seeded numpy prices go through the JAX package (float64, the
conftest's x64) and the port on the CPU with ``torch``'s default dtype set
to float64, its counterpart of JAX's default float.  Tolerances:

* numeric outputs 1e-10 of the largest value (the CWT, the denoise and the
  MODWT of both packages agree to about 1e-13 in float64; the analyzers add
  host numpy on top);
* discrete outputs (crash points, clusters, regimes, anomalies, signals,
  chosen atoms) equal.  Each depends on a continuous value against a
  threshold, so the test also checks that every such value at these seeds
  lies well away from its threshold (more than 1e-6 of its scale): a flip
  would otherwise be rounding, not a fault;
* matching pursuit: equal atoms and shifts, coefficients and energies
  1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from vectorwave_tpu import finance as jf
from vectorwave_tpu.optimize.mp import matching_pursuit as j_mp
from vectorwave_tpu_torch import finance as tf
from vectorwave_tpu_torch.errors import InvalidArgumentError

torch.set_num_threads(1)

TOL = 1e-10
MARGIN = 1e-6


@pytest.fixture(autouse=True)
def float64_default():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


def _prices(n=1024, seed=0, crash_at=None):
    rng = np.random.default_rng(seed)
    rets = rng.normal(0.0005, 0.01, n)
    if crash_at is not None:
        rets[crash_at] = -0.12
        rets[crash_at + 1] = -0.06
    return 100.0 * np.exp(np.cumsum(rets))


def _rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _away(values, threshold, scale):
    """Every value lies more than MARGIN * scale from the threshold."""
    assert np.abs(np.asarray(values) - threshold).min() > MARGIN * scale


def test_sharpe_ratios_and_crash_asymmetry():
    rng = np.random.default_rng(2)
    rets = 0.001 + 0.002 * np.sin(np.arange(2048) / 64) + rng.normal(0, 0.02, (3, 2048))
    t = torch.from_numpy(rets)
    assert _rel(tf.sharpe_ratio(t, 0.001), jf.sharpe_ratio(jnp.asarray(rets), 0.001)) <= TOL
    assert _rel(tf.wavelet_sharpe_ratio(t), jf.wavelet_sharpe_ratio(jnp.asarray(rets))) <= TOL
    assert _rel(tf.wavelet_sharpe_ratio(rets, wavelet="sym8", levels=2, device="cpu"),
                jf.wavelet_sharpe_ratio(jnp.asarray(rets), wavelet="sym8", levels=2)) <= TOL
    for crash_at in (None, 256):
        p = _prices(512, seed=3, crash_at=crash_at)
        assert _rel(tf.crash_asymmetry(torch.from_numpy(p)),
                    jf.crash_asymmetry(jnp.asarray(p))) <= TOL
    assert tf.sharpe_ratio(torch.ones(8)).item() == 0.0  # std 0: divided by inf


def test_detect_market_crashes():
    prices = _prices(512, seed=4, crash_at=300)
    want = jf.detect_market_crashes(prices)
    got = tf.detect_market_crashes(prices, device="cpu")
    assert got.crash_points == want.crash_points and got.crash_points
    _away(want.severity, 1.0 / 0.65, want.max_severity)
    assert _rel(got.severity, want.severity) <= TOL
    assert abs(got.max_severity - want.max_severity) <= TOL * want.max_severity
    assert got.crash_probabilities.keys() == want.crash_probabilities.keys()
    assert max(abs(got.crash_probabilities[k] - v)
               for k, v in want.crash_probabilities.items()) <= TOL


def test_analyze_volatility_and_cycles():
    rng = np.random.default_rng(5)
    rets = np.concatenate([rng.normal(0, 0.005, 256), rng.normal(0, 0.04, 256)])
    prices = 100 * np.exp(np.cumsum(rets))
    want = jf.analyze_volatility(prices)
    got = tf.analyze_volatility(torch.from_numpy(prices))
    inst = want.instantaneous_volatility
    z = (inst - want.average_volatility) / (inst.std() + 1e-30)
    for cut in (-0.5, 0.75, 2.0):
        _away(z, cut, 1.0)
    assert _rel(got.instantaneous_volatility, inst) <= TOL
    assert [(c.start_index, c.end_index, c.level.value) for c in got.volatility_clusters] == [
        (c.start_index, c.end_index, c.level.value) for c in want.volatility_clusters]
    assert _rel([c.average_volatility for c in got.volatility_clusters],
                [c.average_volatility for c in want.volatility_clusters]) <= TOL
    t = np.arange(1024)
    prices = 100 + 5 * np.sin(2 * np.pi * t / 64) + 0.1 * np.sin(2 * np.pi * t / 200)
    want = jf.analyze_cyclical_patterns(prices)
    got = tf.analyze_cyclical_patterns(prices, device="cpu")
    assert _rel(got.spectral_density, want.spectral_density) <= TOL
    assert [c.period for c in got.dominant_cycles] == [c.period for c in want.dominant_cycles]
    assert _rel([[c.strength, c.phase] for c in got.dominant_cycles],
                [[c.strength, c.phase] for c in want.dominant_cycles]) <= TOL
    assert got.periodogram.keys() == want.periodogram.keys()


def test_analyze_market():
    prices = _prices(1024, seed=6, crash_at=700)
    want = jf.analyze_market(prices)
    got = tf.analyze_market(prices, device="cpu")
    assert got.regime_map == {k: tf.MarketRegime(v.value) for k, v in want.regime_map.items()}
    assert got.regime_changes == want.regime_changes
    assert [(a.time_index, a.type.value, a.description) for a in got.anomalies] == [
        (a.time_index, a.type.value, a.description) for a in want.anomalies]
    assert abs(got.current_risk_level - want.current_risk_level) <= TOL
    assert got.max_drawdown == want.max_drawdown
    # the regime thresholds at this seed: slopes and volatilities away from them
    smooth = np.asarray(vw.denoise_multilevel(jnp.asarray(prices), "db4", levels=3))
    inst = jf.analyze_volatility(prices).instantaneous_volatility
    scale = np.abs(np.diff(smooth)).mean()
    starts = range(0, 1023, 32)
    slopes = [(smooth[min(s + 32, 1023)] - smooth[s]) / (min(s + 32, 1023) - s) for s in starts]
    _away(slopes, 0.4 * scale, scale)
    _away(slopes, -0.4 * scale, scale)
    _away([inst[s:s + 32].mean() for s in starts], inst.mean() + inst.std(), inst.mean())


def test_trading_signals_and_indicators():
    prices = _prices(512, seed=7, crash_at=256)
    want = jf.generate_trading_signals(prices)
    got = tf.generate_trading_signals(prices, device="cpu")
    assert [(s.time_index, s.type.value, s.rationale) for s in got.signals] == [
        (s.time_index, s.type.value, s.rationale) for s in want.signals]
    assert _rel([s.confidence for s in got.signals],
                [s.confidence for s in want.signals]) <= TOL
    assert abs(got.sharpe_ratio - want.sharpe_ratio) <= TOL * abs(want.sharpe_ratio)
    assert got.win_rate == want.win_rate
    ind_want = jf.calculate_wavelet_indicators(prices)
    ind_got = tf.calculate_wavelet_indicators(torch.from_numpy(prices))
    _away(ind_want.momentum, 0.0, np.abs(ind_want.momentum).max())
    for a, b in zip(ind_got, ind_want):
        assert _rel(a, b) <= TOL


def _walk(n, seed=0, drift=0.0005, vol=0.01):
    rng = np.random.default_rng(seed)
    return 100.0 * np.exp(np.cumsum(drift + vol * rng.standard_normal(n)))


def _flat(metrics):
    out = []
    for v in metrics:
        out += _flat(v) if isinstance(v, tuple) else [np.asarray(v.detach().numpy()
                                                                 if isinstance(v, torch.Tensor)
                                                                 else v)]
    return out


def _same(got, want):
    """Integer and boolean fields equal, the others within TOL."""
    for a, b in zip(got, want):
        if b.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b)
        else:
            assert _rel(a, b) <= TOL


def test_tick_stream_and_its_jax_checkpoint():
    """The whole stream (with a crash) against JAX's scan; then JAX's state
    after 150 ticks, carried into the port, resumes the stream."""
    prices = _walk(300, seed=3, vol=0.005)
    prices[220:] = prices[220:] * np.exp(-0.04 * np.arange(1, 81))
    want = jf.analyze_ticks_incremental(jnp.asarray(prices))
    got = tf.analyze_ticks_incremental(prices, device="cpu")
    assert got.crash_detected.dtype == torch.bool and got.regime_code.dtype == torch.int32
    assert np.asarray(want.crash_detected).any()
    _away(np.asarray(want.crash_score)[32:], 3.0, 1.0)
    _same(_flat(got), _flat(want))
    st = jf.incremental_wavelet_init(dtype=jnp.float64)
    for p in prices[:150]:
        st, _ = jf.incremental_wavelet_update(st, p)
    ported = vt.convert.incremental_wavelet_state_from_arrays(
        tuple(st.base), st.ret_window, st.ema12, st.ema26, st.ema50, st.wavelet_vol,
        st.max_crash_score, device="cpu")
    for p in prices[150:]:
        st, m_want = jf.incremental_wavelet_update(st, p)
        ported, m_got = tf.incremental_wavelet_update(ported, p)
    _same(_flat(m_got) + _flat(ported), _flat(m_want) + _flat(st))
    base = vt.convert.incremental_state_from_arrays(*st.base, device="cpu")
    (nxt, m), (nxt_j, m_j) = tf.incremental_update(base, 101.0), jf.incremental_update(
        st.base, 101.0)
    _same(_flat(m) + _flat(nxt), _flat(m_j) + _flat(nxt_j))
    with pytest.raises(InvalidArgumentError):
        vt.convert.incremental_state_from_arrays(*([np.zeros(2)] * 8), device="cpu")


def test_haar_detail_closed_form():
    st = tf.incremental_wavelet_init(dtype=torch.float64, device="cpu")
    details = []
    for p in (100.0, 102.0, 101.0, 101.0):
        st, m = tf.incremental_wavelet_update(st, p)
        details.append(float(m.haar_detail))
    np.testing.assert_allclose(details, [0.0, 1.0, -0.5, 0.0], atol=1e-12)
    state = tf.incremental_init(torch.float64, device="cpu")
    assert state.count.dtype == torch.float64 and state.count.device.type == "cpu"


SCALES = (2.0, 4.0, 8.0, 16.0, 32.0)


def _atom(n, scale_idx, shift):
    from vectorwave_tpu.transforms.cwt import _resolve_continuous, _sample_bank

    bank, _ = _sample_bank(_resolve_continuous("mexh"), SCALES, n)
    row = np.roll(bank[scale_idx].real, shift)
    return row / np.linalg.norm(row)


@pytest.mark.parametrize("name,steps", [("mexh", 8), ("morl", 5)])
def test_matching_pursuit_equals_jax(name, steps):
    # planted atoms under noise, and noise: once the planted atoms are taken
    # the residual is noise of 0.1, never the rounding left by an exact fit,
    # whose argmax would be a tie
    rng = np.random.default_rng(11)
    x = np.stack([3.0 * _atom(512, 1, 100) - 2.0 * _atom(512, 3, 380)
                  + 0.1 * rng.standard_normal(512), rng.standard_normal(512)])
    want = j_mp(jnp.asarray(x), SCALES, name, steps=steps)
    got = vt.matching_pursuit(torch.from_numpy(x), SCALES, name, steps=steps)
    np.testing.assert_array_equal(got.scale_indices.numpy(), np.asarray(want.scale_indices))
    np.testing.assert_array_equal(got.shifts.numpy(), np.asarray(want.shifts))
    for field in ("coeffs", "energies", "approx", "residual"):
        assert _rel(getattr(got, field), getattr(want, field)) <= TOL, field
    assert _rel(got.atom_scales(), want.atom_scales()) == 0.0
    assert float((got.approx + got.residual - torch.from_numpy(x)).abs().max()) <= 1e-12


def test_matching_pursuit_refusals():
    x = torch.zeros(64, dtype=torch.float64)
    for call in (lambda: vt.matching_pursuit(x, SCALES, "cmor"),
                 lambda: vt.matching_pursuit(x, SCALES, steps=0),
                 lambda: vt.matching_pursuit(torch.zeros(1), SCALES),
                 lambda: vt.matching_pursuit(x, (0.0,))):
        with pytest.raises(InvalidArgumentError):
            call()

