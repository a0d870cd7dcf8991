"""Test mirrors of the JAX package's spectral 1-D and 2-D analysis tests, on the port.

Mirrors ``tests/test_ewt.py``, ``tests/test_scattering.py`` and
``tests/test_scattering2d.py`` test by test, under the JAX tests' names, at
their shapes and seeds; the audit of the eight files of the 1-D analysis
modules is in CHANGES.md.

These JAX tests state properties of the package's output (the EWT's tight
frame and its modes, the scattering features' invariance to translation,
a tone's frequency in the first order, a modulation in the second, textures
told apart).  Here the port is held to the same property on its own output;
the earlier parity tests (``test_torch_ewt_scattering.py``,
``test_torch_cwt2.py``) hold it to JAX value by value.  Each family is
anchored to the JAX package once more, at a named draw of its mirror,
through a module-scoped fixture (``anchor_*``); the JAX side runs under one
``jax.jit`` (its eager form compiles op by op), never a Pallas kernel.  The
2-D scattering anchor serves its slow mirror alone, as all four JAX 2-D
scattering tests are slow (``test_torch_cwt2.py`` holds ``scattering2d`` to
JAX in tier 1).  A JAX ``jit`` half has no counterpart (the port does not
trace); its batch half is mirrored, and the traced boundaries of
``ewt`` are the port's tensor boundaries (a difference by design).

Tolerances: the anchors 1e-10 of the largest value (float64 on both sides,
the same FFT products in another FFT library; the EWT's boundaries equal);
the properties at the JAX tests' own bounds.

These modules reach no CUDA kernel (their banks are FFT products), so they
have no phase 2f case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from vectorwave_tpu_torch.errors import InvalidArgumentError, VectorWaveError
from vectorwave_tpu_torch.transforms import ewt as te
from vectorwave_tpu_torch.transforms import scattering as ts

torch.set_num_threads(1)

ANCHOR = 1e-10
F64 = torch.float64


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _t(a, dtype=F64) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _three_tone(n=4096, seed=0):
    """``tests/test_ewt.py::_three_tone``: three tones and seeded noise,
    float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    parts = [np.sin(2 * np.pi * 0.03 * t), 0.8 * np.sin(2 * np.pi * 0.11 * t),
             0.6 * np.sin(2 * np.pi * 0.3 * t)]
    x = sum(parts) + 0.05 * rng.standard_normal(n)
    return x.astype(np.float32), parts


# --- the anchors: each family against the JAX package once ---------------------------


@pytest.fixture(scope="module")
def anchor_ewt():
    """JAX's boundaries of test_modes_match_their_sources' three tones and
    its EWT at them, in float64 (ANCHOR_EWT)."""
    x, _ = _three_tone()
    bounds = vw.ewt_boundaries(x, 3)
    comps = jax.jit(lambda z: vw.ewt(z, bounds))(jnp.asarray(x, jnp.float64))
    return x, bounds, np.asarray(comps)


def test_anchor_ewt_matches_jax(anchor_ewt):
    x, bounds, comps = anchor_ewt
    got = vt.ewt_boundaries(x, 3)
    assert tuple(got) == tuple(bounds)
    assert _rel(vt.ewt(_t(x), got), comps) <= ANCHOR


@pytest.fixture(scope="module")
def anchor_scattering():
    """JAX's scattering of test_s1_localizes_tone_frequency's 0.1 tone
    (4096, J=6, Q=8), in float64 (ANCHOR_SCATTERING)."""
    tone = np.cos(2 * np.pi * 0.1 * np.arange(4096))
    s1, feats = jax.jit(lambda z: (lambda r: (r.s1, r.feature_vector()))(
        vw.scattering1d(z, J=6, Q=8)))(jnp.asarray(tone))
    return tone, np.asarray(s1), np.asarray(feats)


def test_anchor_scattering_matches_jax(anchor_scattering):
    tone, s1, feats = anchor_scattering
    got = vt.scattering1d(_t(tone), J=6, Q=8)
    assert _rel(got.s1, s1) <= ANCHOR and _rel(got.feature_vector(), feats) <= ANCHOR


@pytest.fixture(scope="module")
def anchor_scattering2d():
    """JAX's 2-D scattering of test_shapes_orders_and_validation's draw
    (2 x 64 x 64, J=3, L=4), in float64 (ANCHOR_SCATTERING2D); used by
    that slow mirror alone."""
    x = np.random.default_rng(2).standard_normal((2, 64, 64))
    s1, feats = jax.jit(lambda z: (lambda r: (r.s1, r.feature_vector()))(
        vw.scattering2d(z, J=3, L=4)))(jnp.asarray(x))
    return x, np.asarray(s1), np.asarray(feats)


# --- tests/test_ewt.py -----------------------------------------------------------------


def test_boundaries_separate_known_tones():
    x, _ = _three_tone()
    b = vt.ewt_boundaries(x, 3)
    assert len(b) == 2
    assert 0.03 < b[0] < 0.11
    assert 0.11 < b[1] < 0.3


def test_tight_frame_and_perfect_reconstruction():
    x, _ = _three_tone()
    xt = torch.from_numpy(x)
    for bounds in [(0.05, 0.2), (0.01, 0.02, 0.4), (0.25,)]:
        bank = te.ewt_filterbank(4096, bounds, np.float64)
        np.testing.assert_allclose((bank**2).sum(axis=0), 1.0, atol=1e-12)  # tight frame
        comps = vt.ewt(xt, bounds)
        assert float((vt.iewt(comps, bounds) - xt).abs().max()) < 1e-5
        assert comps.shape == (len(bounds) + 1, 4096)


def test_modes_match_their_sources():
    x, parts = _three_tone()
    bounds = vt.ewt_boundaries(x, 3)
    comps = _np(vt.ewt(torch.from_numpy(x), bounds))
    for band, src in enumerate(parts):
        corr = np.corrcoef(comps[band], src)[0, 1]
        assert corr > 0.98, (band, corr)


def test_hilbert_modes_give_instantaneous_amplitude():
    x, _ = _three_tone()
    bounds = vt.ewt_boundaries(x, 3)
    analytic = _np(vt.ewt_hilbert(torch.from_numpy(x), bounds))
    for band, amp in enumerate((1.0, 0.8, 0.6)):
        env = np.abs(analytic[band])[64:-64]
        assert abs(env.mean() - amp) < 0.08
        assert env.std() < 0.1


def test_batch_and_jit_with_static_boundaries():
    """The batch half (the ``jax.jit`` half: no counterpart): every row's
    modes are its own call's, and the batch round trip within 1e-5."""
    x = torch.from_numpy(
        np.random.default_rng(2).standard_normal((2, 3, 1024)).astype(np.float32))
    bounds = (0.1, 0.25)
    comps = vt.ewt(x, bounds)
    assert comps.shape == (2, 3, 3, 1024)
    assert float((vt.iewt(comps, bounds) - x).abs().max()) < 1e-5
    assert float((comps[1, 2] - vt.ewt(x[1, 2], bounds)).abs().max()) <= 1e-6


def test_validation():
    with pytest.raises(VectorWaveError):
        vt.ewt(torch.zeros(256), (0.3, 0.2))  # not increasing
    with pytest.raises(VectorWaveError):
        vt.ewt(torch.zeros(256), (0.6,))  # out of range
    with pytest.raises(VectorWaveError):
        vt.ewt_boundaries(np.zeros(256), 1)  # n_bands < 2
    with pytest.raises(VectorWaveError):
        vt.ewt_boundaries(np.ones(64), 5)  # too few peaks


def test_ewt_hilbert_keeps_nyquist_even_length():
    t = np.arange(512)
    x = torch.from_numpy(
        (np.sin(2 * np.pi * 0.45 * t) + np.sin(2 * np.pi * 0.08 * t)).astype(np.float32))
    comps = _np(vt.ewt(x, (0.25,)))
    np.testing.assert_allclose(_np(vt.ewt_hilbert(x, (0.25,)).real), comps, atol=1e-5)


def test_ewt_boundaries_rank_by_prominence_not_height():
    rng = np.random.default_rng(0)
    n = 4096
    t = np.arange(n)
    strong = (1 + 0.35 * np.cos(2 * np.pi * 0.004 * t)) * np.sin(2 * np.pi * 0.10 * t)
    weak = 0.18 * np.sin(2 * np.pi * 0.35 * t)
    sig = strong + weak + 0.01 * rng.standard_normal(n)
    (bound,) = vt.ewt_boundaries(sig, 2, smooth=3)
    assert 0.11 < bound < 0.34


def test_ewt_traced_boundaries_match_static():
    """The traced half is the port's tensor boundaries (a difference by
    design): the same windows as the tuple, the round trip at two boundary
    sets, and gradients that reach the boundaries."""
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(4096).astype(np.float32))
    bounds = (0.05, 0.15, 0.35)
    a = _np(vt.ewt(x, bounds))
    b = _np(vt.ewt(x, torch.tensor(bounds)))
    np.testing.assert_allclose(a, b, atol=1e-5)
    for bs in ((0.05, 0.15, 0.35), (0.08, 0.22, 0.4)):
        bd = torch.tensor(bs)
        err = float((vt.iewt(vt.ewt(x, bd), bd) - x).abs().max())
        assert err < 1e-5, (bs, err)
    bd = torch.tensor(bounds, requires_grad=True)
    (g,) = torch.autograd.grad((vt.ewt(x, bd)[0] ** 2).sum(), bd)
    assert bool(torch.isfinite(g).all())


def test_ewt_concrete_array_boundaries_validated():
    x = torch.zeros(1024)
    with pytest.raises(InvalidArgumentError):
        vt.ewt(x, torch.tensor([0.3, 0.1]))
    with pytest.raises(InvalidArgumentError):
        vt.ewt(x, torch.tensor([0.7]))


# --- tests/test_scattering.py ----------------------------------------------------------


def test_filterbank_partitions_the_spectrum():
    psis, xis, phi = ts.scattering_filterbank(2048, J=6, Q=8)
    assert len(xis) == psis.shape[0]
    assert np.all(np.diff(xis) < 0)  # descending ladder
    freqs = np.fft.fftfreq(2048)
    total = (np.abs(psis) ** 2).sum(axis=0) + np.abs(phi) ** 2
    band = (freqs > 1.5 / 64) & (freqs < 0.4)
    assert total[band].min() > 0.2 * total[band].max()
    assert np.abs(psis[:, freqs < 0]).max() == 0.0  # analytic
    assert np.abs(psis[:, 0]).max() < 1e-12  # DC-free


def test_translation_invariance_of_features():
    rng = np.random.default_rng(0)
    n = 4096
    t = np.arange(n)
    x = (np.sin(2 * np.pi * 0.05 * t) * np.exp(-0.5 * ((t - 2000) / 300) ** 2)
         + 0.1 * rng.standard_normal(n)).astype(np.float32)
    f0 = _np(vt.scattering1d(torch.from_numpy(x), J=7, Q=8).feature_vector())
    for shift in (8, 64):
        fs = _np(vt.scattering1d(torch.from_numpy(np.roll(x, shift)), J=7, Q=8)
                 .feature_vector())
        assert np.linalg.norm(fs - f0) / np.linalg.norm(f0) < 0.02


def test_s1_localizes_tone_frequency():
    t = np.arange(4096)
    for f in (0.04, 0.1, 0.22):
        tone = torch.from_numpy(np.cos(2 * np.pi * f * t).astype(np.float32))
        res = vt.scattering1d(tone, J=6, Q=8)
        peak = res.xi1[int(np.argmax(_np(res.s1).mean(-1)))]
        assert abs(np.log2(peak / f)) < 1.0 / 8 + 1e-6  # within one Q-step


def test_order2_detects_amplitude_modulation():
    t = np.arange(4096)
    carrier = np.cos(2 * np.pi * 0.1 * t)
    am = (carrier * (1 + 0.8 * np.cos(2 * np.pi * 0.004 * t))).astype(np.float32)
    r_am = vt.scattering1d(torch.from_numpy(am), J=8, Q=8)
    r_pu = vt.scattering1d(torch.from_numpy(carrier.astype(np.float32)), J=8, Q=8)
    diff = _np(r_am.s2).mean(-1) - _np(r_pu.s2).mean(-1)
    i1, i2 = r_am.pairs[int(np.argmax(diff))]
    assert abs(np.log2(r_am.xi1[i1] / 0.1)) < 0.3  # carrier band
    assert r_am.xi2[i2] < 0.02  # slow-modulation band
    assert diff.max() > 3 * np.abs(_np(r_pu.s2).mean(-1)).max() / 10


def test_shapes_batch_jit_and_nonnegativity():
    """The batch half (the ``jax.jit`` half: no counterpart): a row's
    features are its own call's within 1e-6 of their largest value."""
    x = torch.from_numpy(
        np.random.default_rng(1).standard_normal((2, 3, 2048)).astype(np.float32))
    res = vt.scattering1d(x, J=5, Q=4)
    feats = res.feature_vector()
    n1 = len(res.xi1)
    assert res.s0.shape == (2, 3, 2048 // 32)
    assert res.s1.shape == (2, 3, n1, 64)
    assert res.s2.shape[:-1] == (2, 3, len(res.pairs))
    assert feats.shape == (2, 3, 1 + n1 + len(res.pairs))
    assert float(res.s1.min()) >= 0 and float(res.s2.min()) >= 0
    assert _rel(feats[1, 2], vt.scattering1d(x[1, 2], J=5, Q=4).feature_vector()) <= 1e-6
    r1 = vt.scattering1d(x, J=5, Q=4, order=1)
    assert r1.s2 is None
    assert r1.feature_vector().shape == (2, 3, 1 + n1)


def test_validation():
    with pytest.raises(VectorWaveError):
        vt.scattering1d(torch.zeros(32), J=6)  # too short
    with pytest.raises(VectorWaveError):
        vt.scattering1d(torch.zeros(1024), J=5, order=3)
    with pytest.raises(VectorWaveError):
        vt.scattering1d(torch.zeros(1000), J=5)  # stride must divide n


# --- tests/test_scattering2d.py (all four slow, as in JAX) ------------------------------


@pytest.mark.slow
def test_translation_invariance():
    rng = np.random.default_rng(0)
    n = 128
    yy, xx = np.mgrid[0:n, 0:n]
    img = (np.cos(2 * np.pi * 0.12 * (0.8 * xx + 0.6 * yy))
           + 0.2 * rng.standard_normal((n, n))).astype(np.float32)
    f0 = _np(vt.scattering2d(torch.from_numpy(img), J=4, L=6).feature_vector())
    for s in (4, 8):
        shifted = np.roll(img, (s, s), axis=(0, 1))
        fs = _np(vt.scattering2d(torch.from_numpy(shifted), J=4, L=6).feature_vector())
        assert np.linalg.norm(fs - f0) / np.linalg.norm(f0) < 0.01


@pytest.mark.slow
def test_angle_profile_follows_texture_orientation():
    n = 128
    yy, xx = np.mgrid[0:n, 0:n]
    for deg, expected_idx in ((0, 0), (45, 2), (90, 4), (135, 6)):
        th = np.deg2rad(deg)
        g = np.cos(2 * np.pi * 0.12 * (np.cos(th) * xx + np.sin(th) * yy)).astype(np.float32)
        res = vt.scattering2d(torch.from_numpy(g), J=3, L=8, order=1)
        energies = np.stack([_np(res.angle_energy(j, 8)) for j in range(3)])
        j = int(np.argmax(energies.sum(axis=1)))
        assert int(np.argmax(energies[j])) == expected_idx, (deg, energies[j])


@pytest.mark.slow
def test_texture_discrimination_in_order2():
    """Same spectrum band, different spatial structure: stripes vs
    checkerboard-modulated stripes separate in the features."""
    rng = np.random.default_rng(1)
    n = 128
    yy, xx = np.mgrid[0:n, 0:n]
    base = np.cos(2 * np.pi * 0.15 * xx)
    mod = np.sign(np.cos(2 * np.pi * xx / 32) * np.cos(2 * np.pi * yy / 32))

    def feats(img, seed):
        noisy = (img + 0.1 * rng.standard_normal((n, n))).astype(np.float32)
        return _np(vt.scattering2d(torch.from_numpy(noisy), J=4, L=4).feature_vector())

    fa = np.stack([feats(base, i) for i in range(4)])
    fb = np.stack([feats(base * mod, i) for i in range(4)])
    within = (np.linalg.norm(fa - fa.mean(0), axis=1).mean()
              + np.linalg.norm(fb - fb.mean(0), axis=1).mean())
    between = np.linalg.norm(fa.mean(0) - fb.mean(0))
    assert between > 2 * within


@pytest.mark.slow
def test_shapes_orders_and_validation(anchor_scattering2d):
    x64, s1_jax, feats_jax = anchor_scattering2d
    got = vt.scattering2d(_t(x64), J=3, L=4)
    assert _rel(got.s1, s1_jax) <= ANCHOR and _rel(got.feature_vector(), feats_jax) <= ANCHOR
    x = torch.from_numpy(
        np.random.default_rng(2).standard_normal((2, 64, 64)).astype(np.float32))
    res = vt.scattering2d(x, J=3, L=4)
    assert res.s0.shape == (2, 8, 8)
    assert res.s1.shape == (2, 12, 8, 8)
    assert res.s2.shape[1] == len(res.pairs)
    assert float(res.s1.min()) >= 0
    assert vt.scattering2d(x, J=3, L=4, order=1).s2 is None
    with pytest.raises(VectorWaveError):
        vt.scattering2d(torch.zeros(64), J=2)
    with pytest.raises(VectorWaveError):
        vt.scattering2d(torch.zeros((60, 64)), J=3)  # stride must divide
    with pytest.raises(VectorWaveError):
        vt.scattering2d(torch.zeros((64, 64)), J=3, order=5)
