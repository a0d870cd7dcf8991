"""Test mirrors of the JAX package's CWT tests, on the port.

Mirrors ``tests/test_cwt.py``, ``tests/test_cwt2.py``, ``tests/test_sst.py``,
``tests/test_matching_pursuit.py`` and the cross-wavelet, ridge and
significance half of ``tests/test_variance_xwt.py`` test by test, under the
JAX tests' names, at their shapes and seeds (256-4096 samples, 16-60
scales); the audit of the seven files of the CWT family is in CHANGES.md.

Most of these JAX tests state a property of the package's output (a ridge
near ``fc * 32``, a calibrated exceedance rate, the SST's concentration,
planted atoms found).  Here the port is held to the same property on its
own output; the earlier parity tests (``test_torch_cwt.py``,
``test_torch_cwt2.py``, ``test_torch_sst.py``, ``test_torch_xwt.py``,
``test_torch_finance.py``) hold the port to JAX value by value.  Each
family is anchored to the JAX package once more, at a named draw of its
mirror, through a module-scoped fixture (``anchor_*``); the JAX side runs
its jnp path, never a Pallas kernel.  A JAX ``jit`` half has no
counterpart (the port does not trace); its batch half is mirrored.  A test
that draws from a JAX key draws here from a ``torch.Generator`` at a named
seed: its guarantee is statistical.

Tolerances: the anchors 1e-10 of the largest value (the same float64 FFT
products in another FFT library); the properties at the JAX tests' own
bounds.

The phase 2e cases of ``test_cwt.py`` (``tools/mirror_cases.analysis_cases``)
run here on CPU tensors (``mirror_cases.cpu_problems``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from tools import mirror_cases
from vectorwave_tpu.optimize.mp import matching_pursuit as j_mp
from vectorwave_tpu_torch.errors import InvalidArgumentError, VectorWaveError
from vectorwave_tpu_torch.transforms import cwt as tcwt
from vectorwave_tpu_torch.transforms import xwt as txwt
from vectorwave_tpu_torch.transforms.cwt2 import _l2_norm

from . import cwt_periodic

torch.set_num_threads(1)

ANCHOR = 1e-10
F64 = torch.float64

ALL_CONTINUOUS = ["morl", "cmor", "mexh", "gaus1", "gaus2", "cgau2", "paul4",
                  "dog2", "shan", "cshanb", "shangabor", "fbsp", "meyr", "morse",
                  "herm2", "mexh_matlab", "cshan"]


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _t(a, dtype=F64) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _two_tone(n=1024):
    t = np.arange(n)
    return np.sin(2 * np.pi * t / 32) + 0.5 * np.sin(2 * np.pi * t / 128)


# --- the anchors: each family against the JAX package once ---------------------------


def _fitting(scales, n: int, name: str = "morl") -> tuple:
    """The leading scales whose support fits in ``n`` samples (2h + 1 <= n)."""
    bw = vt.wavelet(name).bandwidth
    return tuple(s for s in scales if 2 * tcwt._half_support(s, bw) + 1 <= n)


@pytest.fixture(scope="module")
def anchor_cwt():
    """JAX's periodic morl CWT and its equalized inverse at
    test_icwt_periodic_near_exact's draw (the two tones, 60 scales 2-256),
    on its 51 scales whose support fits in the 1024 samples: past N JAX's
    bank keeps one sample a slot (``vectorwave_tpu/transforms/cwt.py:122``),
    where the port sums them (ANCHOR_CWT)."""
    x = _two_tone()
    scales = _fitting(vw.scales_log(2, 256, 60), 1024)
    res = vw.cwt(jnp.asarray(x), scales, "morl", boundary="periodic")
    return x, scales, np.asarray(res.coeffs), np.asarray(vw.icwt(res, "morl"))


def test_anchor_cwt_and_icwt_match_jax(anchor_cwt):
    """All 60 rows against the periodic correlation at 1e-12 of the largest
    coefficient, and the 51 within N against JAX's (past N JAX's bank keeps
    one tap a slot)."""
    x, scales, coeffs, inverse = anchor_cwt
    assert len(scales) == 51
    grid = vt.scales_log(2, 256, 60)
    assert _fitting(grid, 1024) == tuple(scales) == tuple(grid[:51])
    res = vt.cwt(_t(x), scales, "morl", boundary="periodic")
    assert _rel(res.coeffs, coeffs) <= ANCHOR
    assert _rel(vt.icwt(res, "morl"), inverse) <= ANCHOR
    whole = vt.cwt(_t(x), grid, "morl", boundary="periodic").coeffs
    assert _rel(whole[:51], coeffs) <= ANCHOR
    assert _rel(whole, np.stack([cwt_periodic.periodic_correlation(x, "morl", s)
                                 for s in grid])) <= 1e-12


@pytest.fixture(scope="module")
def anchor_cwt2():
    """JAX's mexh2 ``cwt2`` at test_matches_spatial_oracle's draw (64 x 64,
    scale 3) (ANCHOR_CWT2)."""
    img = _bandlimited_image(64, 64, 0.03, 0.35, dtype=np.float64)
    return img, np.asarray(vw.cwt2(jnp.asarray(img), (3.0,), "mexh2").coeffs)


def test_anchor_cwt2_matches_jax(anchor_cwt2):
    img, want = anchor_cwt2
    assert _rel(vt.cwt2(_t(img), (3.0,), "mexh2").coeffs, want) <= ANCHOR


@pytest.fixture(scope="module")
def anchor_sst():
    """JAX's synchrosqueezed transform of test_sst.py's two tones (2048
    samples, 48 scales 2-64) (ANCHOR_SST)."""
    x = _sst_two_tone()
    res = vw.synchrosqueeze(jnp.asarray(x), SST_SCALES, "morl")
    return x, np.asarray(res.coeffs), np.asarray(res.freqs)


def test_anchor_sst_matches_jax(anchor_sst):
    x, coeffs, freqs = anchor_sst
    res = vt.synchrosqueeze(_t(x), SST_SCALES, "morl")
    np.testing.assert_allclose(res.freqs, freqs, rtol=1e-14)
    assert _rel(res.coeffs, coeffs) <= ANCHOR


@pytest.fixture(scope="module")
def anchor_xwt():
    """JAX's wavelet coherence of test_coherence_separates_locked_from_independent's
    locked pair (1024 samples, 24 scales, noise 0.3) and its ridge of
    test_ridge_tracks_chirp's chirp (ANCHOR_XWT)."""
    x, y = _tone_pair(noise=0.3)
    coh = vw.wavelet_coherence(jnp.asarray(x), jnp.asarray(y), XWT_SCALES, "morl")
    r = vw.cwt(jnp.asarray(_chirp()), XWT_SCALES, "morl", analytic=True)
    return x, y, np.asarray(coh.coherence), np.asarray(vw.extract_ridge(r).indices)


def test_anchor_coherence_and_ridge_match_jax(anchor_xwt):
    x, y, coherence, ridge = anchor_xwt
    got = vt.wavelet_coherence(_t(x), _t(y), XWT_SCALES, "morl").coherence
    assert _rel(got, coherence) <= ANCHOR
    r = vt.cwt(_t(_chirp()), XWT_SCALES, "morl", analytic=True)
    np.testing.assert_array_equal(_np(vt.extract_ridge(r).indices), ridge)


@pytest.fixture(scope="module")
def anchor_significance():
    """JAX's significance levels of test_white_noise_exceedance_calibrated's
    first draw (2048 samples, 16 scales, lag1 0) (ANCHOR_SIGNIFICANCE)."""
    x = np.random.default_rng(30).standard_normal(2048)
    r = vw.cwt(jnp.asarray(x), vw.scales_log(2, 64, 16), "morl", analytic=True,
               boundary="periodic")
    return x, np.asarray(vw.significant_power(r, jnp.asarray(x), "morl", lag1=0.0).levels)


def test_anchor_significance_matches_jax(anchor_significance):
    x, levels = anchor_significance
    r = vt.cwt(_t(x), vt.scales_log(2, 64, 16), "morl", analytic=True, boundary="periodic")
    got = vt.significant_power(r, _t(x), "morl", lag1=0.0).levels
    assert _rel(got, levels) <= ANCHOR


@pytest.fixture(scope="module")
def anchor_mp():
    """JAX's matching pursuit of test_recovers_planted_atoms's signal (512
    samples, 6 steps) (ANCHOR_MP)."""
    x = 3.0 * _atom(512, 1, 100) - 2.0 * _atom(512, 3, 380)
    res = j_mp(jnp.asarray(x), MP_SCALES, "mexh", steps=6)
    return x, res


def test_anchor_matching_pursuit_matches_jax(anchor_mp):
    """The two planted atoms' steps equal; after them the residual is the
    rounding of an exact fit, whose argmax is a tie in either package, so
    the later steps are held by their energies, within 1e-10 of the
    signal's."""
    x, want = anchor_mp
    got = vt.matching_pursuit(_t(x), MP_SCALES, "mexh", steps=6)
    np.testing.assert_array_equal(_np(got.scale_indices)[:2],
                                  np.asarray(want.scale_indices)[:2])
    np.testing.assert_array_equal(_np(got.shifts)[:2], np.asarray(want.shifts)[:2])
    assert _rel(got.coeffs[:2], np.asarray(want.coeffs)[:2]) <= ANCHOR
    assert np.abs(_np(got.energies) - np.asarray(want.energies)).max() \
        <= ANCHOR * float((x**2).sum())


# --- tests/test_cwt.py -----------------------------------------------------------------


def test_cwt_shape_and_ridge():
    x = _t(_two_tone())
    scales = vt.scales_log(2, 256, 48)
    res = vt.cwt(x, scales, "morl")
    assert tuple(res.coeffs.shape) == (48, 1024)
    mag = _np(res.magnitude()).mean(axis=-1)
    fc = vt.wavelet("morl").center_frequency
    ridge = scales[int(np.argmax(mag))]
    assert abs(ridge - fc * 32) / (fc * 32) < 0.25


@pytest.mark.parametrize("name", ALL_CONTINUOUS)
def test_wavelets_unit_energy_and_cwt_runs(name):
    w = vt.wavelet(name)
    t = np.linspace(-64, 64, 1 << 14)
    energy = np.trapezoid(np.abs(np.asarray(w.psi(t))) ** 2, t)
    assert abs(energy - 1.0) < 0.05, energy
    res = vt.cwt(_t(_two_tone(256)), (4.0, 8.0, 16.0), w)
    assert tuple(res.coeffs.shape) == (3, 256)
    assert bool(torch.isfinite(res.coeffs).all())


def test_direct_equals_fft():
    x = _t(_two_tone(512))
    scales = vt.scales_log(2, 16, 8)
    direct = vt.cwt(x, scales, "morl", method="direct").coeffs
    fft = vt.cwt(x, scales, "morl", method="fft").coeffs
    assert float((direct - fft).abs().max()) <= 1e-12


@pytest.mark.parametrize("name", ["morl", "mexh", "paul4", "cmor", "morse"])
def test_icwt_periodic_near_exact(name):
    x = _two_tone()
    res = vt.cwt(_t(x), vt.scales_log(2, 256, 60), name, boundary="periodic")
    xr = _np(vt.icwt(res, name))
    assert np.sqrt(np.mean((xr - x) ** 2)) / np.std(x) < 1e-8


def test_icwt_linear_reference_parity_quality():
    x = _two_tone()
    res = vt.cwt(_t(x), vt.scales_log(2, 256, 60), "mexh")
    xr = _np(vt.icwt(res, "mexh"))
    assert np.sqrt(np.mean((xr - x) ** 2)) / np.std(x) < 0.10


def test_band_reconstruction_separates_components():
    t = np.arange(1024)
    hi = np.sin(2 * np.pi * t / 32)
    x = 0.5 * np.sin(2 * np.pi * t / 128) + hi
    res = vt.cwt(_t(x), vt.scales_log(2, 256, 60), "morl", boundary="periodic")
    s_hi = vt.wavelet("morl").center_frequency * 32
    band = _np(vt.reconstruct_band(res, "morl", s_hi / 2, s_hi * 2))
    assert np.sqrt(np.mean((band - hi) ** 2)) / np.std(hi) < 0.15


def test_reconstruct_frequency_band():
    res = vt.cwt(_t(_two_tone()), vt.scales_log(2, 256, 60), "morl", boundary="periodic")
    band = _np(vt.reconstruct_frequency_band(res, "morl", 1 / 48, 1 / 22))
    hi = np.sin(2 * np.pi * np.arange(1024) / 32)
    assert np.sqrt(np.mean((band - hi) ** 2)) / np.std(hi) < 0.1


@pytest.mark.parametrize("name", ["morl", "mexh"])
def test_kernel_tier_takes_the_supports_that_wrap_past_n(name):
    """test_icwt_periodic_near_exact under ``backend='kernel'``: the tier
    takes all 60 scales, the 9 whose support wraps past N (2h + 1 > 1024)
    among them, and sums their wrapped taps as the FFT path's bank does, so
    every row is the FFT path's within 2e-5 of the largest coefficient and
    the round trip is near exact in float32 (on the CPU the bank's plain
    version)."""
    x = _t(_two_tone(), torch.float32)
    scales = vt.scales_log(2, 256, 60)
    w = vt.wavelet(name)
    assert len(_fitting(scales, 1024, name)) == 51
    fft = vt.cwt(x, scales, name, boundary="periodic").coeffs
    with mirror_cases.using_backend("kernel"):
        n_small = tcwt._kernel_direct_split(x.device, w, scales, "periodic", torch.float32)
        tier = vt.cwt(x, scales, name, boundary="periodic")
    assert n_small == 60
    assert float((tier.coeffs - fft).abs().max()) <= 2e-5 * float(fft.abs().max())
    xr = vt.icwt(tier, name).double()
    assert float((xr - x.double()).pow(2).mean().sqrt() / x.double().std()) < 1e-6


@pytest.mark.parametrize("n", [128, 129])
def test_auto_tier_on_the_card_takes_short_rows_whole(monkeypatch, n):
    """``auto`` on a card takes morl scales 2-16 (h 8-64, within the auto
    cap) whole on 129 samples, where every support fits, and on 128, where
    scale 16's span of 129 taps wraps: the tier and the FFT path both give
    the periodic correlation there (the tier's plain version on the CPU,
    under ``kernel``, within 2e-5 of the FFT path's largest coefficient)."""
    from vectorwave_tpu_torch.kernels import modwt_fused

    w = vt.wavelet("morl")
    scales = (2.0, 4.0, 8.0, 16.0)
    assert 2 * tcwt._half_support(16.0, w.bandwidth) + 1 == 129
    with monkeypatch.context() as m:
        m.setattr(modwt_fused, "kernel_available", lambda: True)
        assert tcwt._kernel_direct_split(torch.device("cuda"), w, scales, "periodic",
                                         torch.float32) == 4
    x = _t(np.random.default_rng(n).standard_normal((2, n)), torch.float32)
    fft = vt.cwt(x, scales, "morl", boundary="periodic").coeffs
    with mirror_cases.using_backend("kernel"):
        tier = vt.cwt(x, scales, "morl", boundary="periodic").coeffs
    assert float((tier - fft).abs().max()) <= 2e-5 * float(fft.abs().max())
    past = cwt_periodic.periodic_correlation(_np(x), "morl", 16.0)
    assert _rel(fft[:, 3], past) <= 2e-6


def test_scale_tools():
    np.testing.assert_allclose(vt.scales_linear(1, 10, 10), np.linspace(1, 10, 10))
    np.testing.assert_allclose(vt.scales_log(1, 16, 5), [1, 2, 4, 8, 16])
    np.testing.assert_allclose(vt.scales_dyadic(3), [1, 2, 4, 8])
    f = vt.scale_to_frequency(2.0, "morl")
    assert abs(vt.frequency_to_scale(f, "morl") - 2.0) < 1e-12
    opt = vt.select_scales_optimal(1024, "morl")
    assert len(opt) > 10 and all(a < b for a, b in zip(opt, opt[1:]))
    assert len(vt.select_scales_signal_adaptive(_two_tone(), "morl", n_scales=16)) >= 4


def test_analytic_phase_tracks_oscillation():
    x = np.sin(2 * np.pi * np.arange(512) / 32)
    res = vt.cwt(_t(x), (vt.wavelet("morl").center_frequency * 32,), "morl", analytic=True)
    interior = np.unwrap(_np(res.phase())[0][100:400])
    assert abs(np.mean(np.diff(interior)) - 2 * np.pi / 32) < 0.02


def test_cwt_batch():
    x = _t(np.stack([_two_tone(), _two_tone() * 2]))
    res = vt.cwt(x, (4.0, 8.0), "morl")
    assert tuple(res.coeffs.shape) == (2, 2, 1024)
    assert float((res.coeffs[1] - 2 * res.coeffs[0]).abs().max()) <= 1e-10


def test_discrete_wavelet_rejected_for_cwt():
    with pytest.raises(InvalidArgumentError):
        vt.cwt(torch.zeros(64, dtype=F64), (2.0,), "db4")
    with pytest.raises(InvalidArgumentError):
        vt.cwt(torch.zeros(64, dtype=F64), (0.0,), "morl")


def test_adaptive_scale_selector():
    fs = 1000.0
    t = np.arange(2048) / fs
    x = np.sin(2 * np.pi * 50 * t) + 0.5 * np.sin(2 * np.pi * 120 * t)
    cfg = vt.ScaleSelectionConfig(sampling_rate=fs)
    scales = vt.select_scales_adaptive(x, "morl", cfg)
    assert 1 <= len(scales) <= cfg.max_scales
    assert list(scales) == sorted(scales)
    lo, hi = vt.frequency_range_of_scales(scales, "morl", fs)
    assert lo < 50 < hi and lo < 120 < hi


def test_adaptive_selector_spacings_and_count():
    fs = 100.0
    x = np.sin(2 * np.pi * 10 * np.arange(512) / fs)
    base = dict(sampling_rate=fs, min_frequency=2.0, max_frequency=40.0,
                use_signal_adaptation=False)
    log_s = vt.select_scales_adaptive(x, "morl", vt.ScaleSelectionConfig(**base))
    lin_s = vt.select_scales_adaptive(x, "morl",
                                      vt.ScaleSelectionConfig(**base, spacing="linear"))
    dy_s = vt.select_scales_adaptive(x, "morl",
                                     vt.ScaleSelectionConfig(**base, spacing="dyadic"))
    assert len(log_s) == vt.estimate_scale_count(2.0, 40.0, scales_per_octave=10)
    diffs = np.diff(lin_s)
    np.testing.assert_allclose(diffs, diffs[0], rtol=1e-9)
    assert all(abs(np.log2(s) - round(np.log2(s))) < 1e-12 for s in dy_s)
    with pytest.raises(InvalidArgumentError):
        vt.select_scales_adaptive(x, "morl",
                                  vt.ScaleSelectionConfig(sampling_rate=fs, spacing="weird"))
    with pytest.raises(InvalidArgumentError):
        vt.estimate_scale_count(10.0, 5.0)


def test_adaptive_selector_max_scales_cap():
    x = np.random.default_rng(0).standard_normal(4096)
    cfg = vt.ScaleSelectionConfig(sampling_rate=1000.0, max_scales=16)
    assert len(vt.select_scales_adaptive(x, "morl", cfg)) <= 16


def test_cwt_config_object():
    x = _t(_two_tone())
    cfg = vt.CWTConfig(boundary="zero", method="auto", fft_threshold=64)
    res = vt.cwt(x, (4.0, 8.0), "morl", config=cfg)
    base = vt.cwt(x, (4.0, 8.0), "morl", method="fft", boundary="zero")
    assert float((res.coeffs - base.coeffs).abs().max()) <= 1e-10
    small = vt.cwt(_t(_two_tone()[:64]), (2.0,), "morl",
                   config=vt.CWTConfig(method="auto", fft_threshold=10**9))
    assert tuple(small.coeffs.shape) == (1, 64)
    with pytest.raises(InvalidArgumentError):
        vt.cwt(x, (4.0, 8.0), "morl", config=vt.CWTConfig(fft_size=8))
    assert vt.cwt(x, (8.0,), "morl", config=vt.CWTConfig(analytic=True)).coeffs.is_complex()


@pytest.mark.parametrize("label", mirror_cases.analysis_labels("cwt"))
def test_analysis_case_runs_its_plain_versions_on_the_cpu(label):
    """Each phase 2e case of this file on CPU tensors: no launch, no
    refusal, the plain route's result within the case's bounds."""
    assert not mirror_cases.cpu_problems(label)


# --- tests/test_cwt2.py ----------------------------------------------------------------


def _bandlimited_image(h, w, lo, hi, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((h, w))
    ky, kx = np.meshgrid(np.fft.fftfreq(h), np.fft.fftfreq(w), indexing="ij")
    r = np.hypot(ky, kx)
    img = np.real(np.fft.ifft2(np.fft.fft2(img) * ((r > lo) & (r < hi))))
    img -= img.mean()
    return img.astype(dtype)


def _spatial_oracle(img, wavelet, scale, theta):
    """The defining integral evaluated by the FFT of a sampled spectrum on
    the image's own periodic grid, independent of ``cwt2``'s filters (the
    port's ``psi_hat`` takes torch tensors, a difference by design)."""
    h, w = img.shape
    ky, kx = np.meshgrid(2 * np.pi * np.fft.fftfreq(h), 2 * np.pi * np.fft.fftfreq(w),
                         indexing="ij")
    c, s = math.cos(theta), math.sin(theta)
    kxr, kyr = c * kx + s * ky, -s * kx + c * ky
    spec = _np(torch.as_tensor(wavelet.psi_hat(_t(scale * kxr), _t(scale * kyr))))
    g = np.conj(spec) * (scale / _l2_norm(wavelet))
    return np.fft.ifft2(np.fft.fft2(img) * g)


@pytest.mark.parametrize("wavelet", [vt.morlet2(), vt.mexican_hat2(),
                                     vt.gaussian2(3, directional=True)],
                         ids=["morl2", "mexh2", "gaus3d"])
def test_matches_spatial_oracle(wavelet):
    img = _bandlimited_image(64, 64, 0.03, 0.35, dtype=np.float64)
    theta = 0.0 if wavelet.isotropic else np.pi / 5
    res = vt.cwt2(_t(img), (3.0,), wavelet, angles=(theta,))
    oracle = _spatial_oracle(img, wavelet, 3.0, theta)
    got = _np(res.coeffs[0, 0])
    if not res.coeffs.is_complex():
        oracle = oracle.real
    np.testing.assert_allclose(got, oracle, atol=1e-5 * np.abs(oracle).max())


def test_oriented_stripes_peak_at_expected_scale_and_angle():
    h = w = 128
    theta0, f0 = np.pi / 3, 0.09
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.cos(2 * np.pi * f0 * (math.cos(theta0) * xx + math.sin(theta0) * yy))
    scales = tuple(np.geomspace(3, 30, 24))
    angles = tuple(np.linspace(0, np.pi, 12, endpoint=False))
    res = vt.cwt2(_t(img, torch.float32), scales, "morl2", angles=angles)
    sg = _np(res.scalogram())
    si, ai = np.unravel_index(np.argmax(sg), sg.shape)
    expected = vt.morlet2().peak_freq / (2 * np.pi * f0)
    assert abs(math.log(scales[si] / expected)) < math.log(1.3)
    assert abs(angles[ai] - theta0) <= np.pi / 12 + 1e-9
    orient = _np(res.dominant_orientation())
    assert np.mean(np.abs(orient - theta0) <= np.pi / 12 + 1e-9) > 0.95


def test_scale_frequency_helpers_roundtrip():
    for f in (0.02, 0.1, 0.3):
        (s,) = vt.scales_for_frequencies2("mexh2", [f])
        assert vt.scale_to_frequency2("mexh2", s) == pytest.approx(f)


@pytest.mark.parametrize("angles_mode", ["half", "full"])
def test_icwt2_morlet_near_exact_periodic(angles_mode):
    img = _bandlimited_image(128, 128, 0.03, 0.3)
    scales = tuple(np.geomspace(2.5, 30, 24))
    if angles_mode == "half":
        angles = tuple(np.linspace(0, np.pi, 8, endpoint=False))
    else:
        angles = tuple(np.linspace(0, 2 * np.pi, 16, endpoint=False))
    rec = _np(vt.icwt2(vt.cwt2(_t(img, torch.float32), scales, "morl2", angles=angles),
                       "morl2"))
    assert np.abs(rec - img).max() < 1e-5 * np.abs(img).max()


def test_icwt2_mexh_real_path_and_mean():
    img = _bandlimited_image(96, 96, 0.05, 0.3) + 2.5
    res = vt.cwt2(_t(img, torch.float32), tuple(np.geomspace(0.8, 6, 24)), "mexh2")
    assert not res.coeffs.is_complex()
    rec = _np(vt.icwt2(res, "mexh2", mean=float(img.mean())))
    assert np.abs(rec - img).max() < 1e-4 * np.abs(img - img.mean()).max()


@pytest.mark.slow
def test_icwt2_zero_boundary_interior():
    img = _bandlimited_image(128, 128, 0.05, 0.3)
    g = vt.gaussian2(2, directional=True)
    res = vt.cwt2(_t(img, torch.float32), tuple(np.geomspace(1.2, 10, 20)), g,
                  angles=tuple(np.linspace(0, np.pi, 6, endpoint=False)), boundary="zero")
    rec = _np(vt.icwt2(res, g))
    assert np.abs(rec - img)[24:-24, 24:-24].max() / np.abs(img).max() < 5e-2


def test_batch_axes_and_jit():
    """The batch half (the port does not trace): three images in one call,
    each row its own call within 2e-6."""
    imgs = np.stack([_bandlimited_image(48, 48, 0.05, 0.3, seed=i) for i in range(3)])
    kw = dict(angles=(0.0, np.pi / 2))
    out = vt.cwt2(_t(imgs, torch.float32), (2.0, 4.0), "morl2", **kw).coeffs
    assert tuple(out.shape) == (3, 2, 2, 48, 48)
    single = vt.cwt2(_t(imgs[1], torch.float32), (2.0, 4.0), "morl2", **kw).coeffs
    assert float((out[1] - single).abs().max()) <= 2e-6


def test_isotropic_rotation_invariance():
    img = _t(_bandlimited_image(64, 64, 0.05, 0.3), torch.float32)
    base = vt.cwt2(img, (3.0,), "mexh2")
    w_rot = vt.ContinuousWavelet2D("mexh2", vt.mexican_hat2().psi_hat, False, False,
                                   math.sqrt(2.0))
    rot = vt.cwt2(img, (3.0,), w_rot, angles=(1.1,))
    assert float((base.coeffs[0, 0] - rot.coeffs[0, 0]).abs().max()) <= 1e-5


def test_validation_errors():
    img = torch.zeros(16, 16)
    for call in (lambda: vt.cwt2(img, (), "morl2"),
                 lambda: vt.cwt2(img, (-1.0,), "morl2"),
                 lambda: vt.cwt2(img, (2.0,), "mexh2", angles=(0.0, 1.0)),
                 lambda: vt.cwt2(torch.zeros(16), (2.0,), "morl2"),
                 lambda: vt.cwt2(img, (2.0,), "nosuch2"),
                 lambda: vt.cwt2(img, (2.0,), "morl2", boundary="reflect"),
                 lambda: vt.morlet2(omega0=1.0),
                 lambda: vt.gaussian2(0)):
        with pytest.raises(VectorWaveError):
            call()


# --- tests/test_sst.py -----------------------------------------------------------------

SST_N = 2048
SST_T = np.arange(SST_N)
SST_SCALES = vt.scales_log(2, 64, 48)


def _sst_two_tone(f1=0.04, f2=0.06, a2=0.8):
    return np.sin(2 * np.pi * f1 * SST_T) + a2 * np.sin(2 * np.pi * f2 * SST_T)


def _top_frac(p, k=4):
    s = np.sort(p)[::-1]
    return s[:k].sum() / p.sum()


def test_sst_concentrates_energy():
    x = _t(_sst_two_tone())
    res = vt.synchrosqueeze(x, SST_SCALES, "morl")
    assert tuple(res.coeffs.shape) == (48, SST_N) and res.n_bins == 48
    p_sst = _np(res.power()).mean(axis=-1)
    p_cwt = _np(vt.cwt(x, SST_SCALES, "morl", analytic=True).coeffs.abs() ** 2).mean(axis=-1)
    assert _top_frac(p_sst) > 0.9
    assert _top_frac(p_sst) > _top_frac(p_cwt) + 0.25


def test_sst_peaks_at_true_frequencies():
    res = vt.synchrosqueeze(_t(_sst_two_tone()), SST_SCALES, "morl")
    p = _np(res.power()).mean(axis=-1)
    peaks = sorted(res.freqs[np.argsort(p)[::-1][:2]])
    assert abs(peaks[0] - 0.04) < 0.005 and abs(peaks[1] - 0.06) < 0.005


def test_isst_matches_icwt_quality():
    x = _t(_sst_two_tone())
    xr_sst = vt.isst(vt.synchrosqueeze(x, SST_SCALES, "morl"), "morl")
    xr_icwt = vt.icwt(vt.cwt(x, SST_SCALES, "morl", analytic=True), "morl")
    interior = slice(256, -256)
    err_sst = float((xr_sst - x)[interior].abs().max())
    err_icwt = float((xr_icwt - x)[interior].abs().max())
    assert err_sst < err_icwt + 0.02


def test_mode_extraction_separates_close_tones():
    res = vt.synchrosqueeze(_t(_sst_two_tone()), SST_SCALES, "morl")
    m1 = _np(vt.extract_mode(res, torch.full((SST_N,), 0.04, dtype=F64), "morl",
                             bandwidth_octaves=0.4))
    m2 = _np(vt.extract_mode(res, torch.full((SST_N,), 0.06, dtype=F64), "morl",
                             bandwidth_octaves=0.4))
    tone1 = np.sin(2 * np.pi * 0.04 * SST_T)
    tone2 = 0.8 * np.sin(2 * np.pi * 0.06 * SST_T)
    i = slice(256, -256)
    assert np.sqrt(np.mean((m1[i] - tone1[i]) ** 2)) < 0.2
    assert np.sqrt(np.mean((m2[i] - tone2[i]) ** 2)) < 0.2
    assert np.corrcoef(m1[i], tone1[i])[0, 1] > 0.95
    assert np.corrcoef(m2[i], tone2[i])[0, 1] > 0.95
    assert abs(np.corrcoef(m1[i], tone2[i])[0, 1]) < 0.3


def test_dominant_frequencies_track_chirp():
    chirp = np.sin(2 * np.pi * (0.01 * SST_T + 2e-5 * SST_T**2))
    res = vt.synchrosqueeze(_t(chirp), SST_SCALES, "morl")
    dom = _np(vt.dominant_frequencies(res))
    true_if = 0.01 + 4e-5 * SST_T
    i = slice(256, -256)
    assert np.median(np.abs(dom[i] - true_if[i]) / true_if[i]) < 0.05


def test_sst_batch_and_jit():
    """The batch half (the port does not trace): two signals in one call,
    the first its own call within 1e-10."""
    xb = _t(np.stack([_sst_two_tone(), _sst_two_tone(0.03, 0.09)]))
    res = vt.synchrosqueeze(xb, SST_SCALES, "morl")
    assert tuple(res.coeffs.shape) == (2, 48, SST_N)
    single = vt.synchrosqueeze(xb[0], SST_SCALES, "morl")
    assert float((res.coeffs[0] - single.coeffs).abs().max()) <= 1e-10


def test_sst_gamma_drops_small_coefficients():
    rng = np.random.default_rng(3)
    x = _t(np.sin(2 * np.pi * 0.05 * SST_T) + 0.01 * rng.standard_normal(SST_N))
    hard = vt.synchrosqueeze(x, SST_SCALES, "morl", gamma=1.0)
    soft = vt.synchrosqueeze(x, SST_SCALES, "morl", gamma=0.0)
    assert float(hard.power().sum()) <= float(soft.power().sum())


def test_sst_errors():
    x = _t(_sst_two_tone())
    with pytest.raises(InvalidArgumentError):
        vt.synchrosqueeze(x, SST_SCALES, "morl", gamma=-1.0)
    with pytest.raises(InvalidArgumentError):
        vt.synchrosqueeze(x, SST_SCALES, "morl", n_bins=1)
    res = vt.synchrosqueeze(x, SST_SCALES, "morl")
    with pytest.raises(InvalidArgumentError):
        vt.extract_mode(res, torch.full((SST_N,), 0.05, dtype=F64), "morl",
                        bandwidth_octaves=0.0)


# --- tests/test_matching_pursuit.py ----------------------------------------------------

MP_SCALES = (2.0, 4.0, 8.0, 16.0, 32.0)


def _atom(n: int, scale_idx: int, shift: int) -> np.ndarray:
    """The JAX test's atom from the port's own bank sampling."""
    bank, _ = tcwt._sample_bank(tcwt._resolve_continuous("mexh"), MP_SCALES, n)
    row = np.roll(bank[scale_idx].real, shift)
    return row / np.linalg.norm(row)


def test_recovers_planted_atoms():
    x = 3.0 * _atom(512, 1, 100) - 2.0 * _atom(512, 3, 380)
    res = vt.matching_pursuit(_t(x), MP_SCALES, "mexh", steps=6)
    picks = {(int(s), int(t)) for s, t in zip(_np(res.scale_indices), _np(res.shifts))}
    assert any(s == 1 and abs(t - 100) <= 1 for s, t in picks)
    assert any(s == 3 and abs(t - 380) <= 1 for s, t in picks)
    coeffs = np.sort(np.abs(_np(res.coeffs)))[::-1]
    assert coeffs[0] == pytest.approx(3.0, rel=0.1)
    assert coeffs[1] == pytest.approx(2.0, rel=0.15)
    assert float(res.energies[-1]) < 1e-2 * float((x**2).sum())


def test_energy_monotone_and_split_invariant(rng):
    x = _t(rng.standard_normal(256))
    res = vt.matching_pursuit(x, MP_SCALES, "mexh", steps=12)
    e = _np(res.energies)
    assert (np.diff(e) <= 1e-9).all()
    assert float((res.approx + res.residual - x).abs().max()) <= 1e-10
    assert float(e[-1]) < float((x**2).sum())


def test_batched_and_jitted():
    """The batch half (the port does not trace): two planted atoms, one a
    row, found first in each row."""
    batch = _t(np.stack([2.0 * _atom(256, 2, 60), 1.5 * _atom(256, 4, 200)]))
    res = vt.matching_pursuit(batch, MP_SCALES, "mexh", steps=3)
    assert tuple(res.coeffs.shape) == (2, 3)
    assert int(res.scale_indices[0, 0]) == 2 and int(res.scale_indices[1, 0]) == 4
    assert abs(int(res.shifts[0, 0]) - 60) <= 1
    assert float(res.atom_scales()[0, 0]) == pytest.approx(8.0)


def test_validation():
    with pytest.raises(InvalidArgumentError):
        vt.matching_pursuit(torch.zeros(64, dtype=F64), MP_SCALES, "cmor")
    with pytest.raises(InvalidArgumentError):
        vt.matching_pursuit(torch.zeros(64, dtype=F64), MP_SCALES, "mexh", steps=0)
    with pytest.raises(InvalidArgumentError):
        vt.matching_pursuit(torch.zeros(1, dtype=F64), MP_SCALES, "mexh")


# --- tests/test_variance_xwt.py: the cross-wavelet toolkit -----------------------------

XWT_N = 1024
XWT_SCALES = vt.scales_log(2, 64, 24)


def _tone_pair(lag=np.pi / 3, noise=0.0, seed=0, f0=0.05):
    rng = np.random.default_rng(seed)
    t = np.arange(XWT_N)
    x = np.sin(2 * np.pi * f0 * t) + noise * rng.standard_normal(XWT_N)
    y = np.sin(2 * np.pi * f0 * t - lag) + noise * rng.standard_normal(XWT_N)
    return x, y


def _chirp():
    t = np.arange(XWT_N)
    return np.sin(2 * np.pi * (0.01 * t + 0.00005 * t**2))


def _dominant_scale(coeffs):
    return int(np.argmax(_np(coeffs.abs()).mean(axis=-1)))


def test_cross_wavelet_recovers_phase_lag():
    x, y = _tone_pair()
    wxy = vt.cross_wavelet(_t(x), _t(y), XWT_SCALES, "morl")
    assert wxy.coeffs.is_complex() and tuple(wxy.coeffs.shape) == (24, XWT_N)
    si = _dominant_scale(wxy.coeffs)
    interior = np.angle(_np(wxy.coeffs)[si, XWT_N // 4: -XWT_N // 4])
    assert abs(np.median(interior) - np.pi / 3) < 0.15


def test_coherence_separates_locked_from_independent():
    x, y = (_t(a) for a in _tone_pair(noise=0.3))
    indep = _t(np.random.default_rng(9).standard_normal(XWT_N))
    coh = vt.wavelet_coherence(x, y, XWT_SCALES, "morl")
    si = _dominant_scale(vt.cross_wavelet(x, y, XWT_SCALES, "morl").coeffs)
    locked = float(coh.mean_coherence()[si])
    rand = float(vt.wavelet_coherence(x, indep, XWT_SCALES, "morl").mean_coherence()[si])
    assert locked > 0.9 and rand < 0.7 and locked > rand + 0.25
    assert bool(((coh.coherence >= 0.0) & (coh.coherence <= 1.0)).all())


def test_phase_synchronization_plv():
    x, y = (_t(a) for a in _tone_pair(noise=0.3))
    indep = _t(np.random.default_rng(10).standard_normal(XWT_N))
    si = _dominant_scale(vt.cross_wavelet(x, y, XWT_SCALES, "morl").coeffs)
    assert float(vt.phase_synchronization(x, y, XWT_SCALES, "morl")[si]) > 0.95
    assert float(vt.phase_synchronization(x, indep, XWT_SCALES, "morl")[si]) < 0.6


def test_instantaneous_frequency_of_tone():
    x = _t(_tone_pair()[0])
    r = vt.cwt(x, XWT_SCALES, "morl", analytic=True)
    si = _dominant_scale(r.coeffs)
    inst = _np(vt.instantaneous_frequency(r))[si, XWT_N // 4: -XWT_N // 4]
    assert abs(np.median(inst) - 0.05) < 0.002
    with pytest.raises(InvalidArgumentError):
        vt.instantaneous_frequency(vt.cwt(x, XWT_SCALES, "morl"))


def test_ridge_tracks_chirp():
    r = vt.cwt(_t(_chirp()), XWT_SCALES, "morl", analytic=True)
    ridge = vt.extract_ridge(r, smoothness=2.0)
    idx = _np(ridge.indices).astype(float)
    assert idx[0] > idx[-1]
    assert np.all(np.diff(idx) <= 1e-9) or np.mean(np.diff(idx) <= 0) > 0.95
    assert tuple(ridge.scales.shape) == (XWT_N,) and tuple(ridge.amplitude.shape) == (XWT_N,)
    ridge0 = vt.extract_ridge(r, smoothness=0.0)
    np.testing.assert_array_equal(_np(ridge0.indices), _np(r.coeffs.abs().argmax(dim=-2)))
    with pytest.raises(InvalidArgumentError):
        vt.extract_ridge(r, smoothness=-1.0)


def test_xwt_batch_and_jit():
    """The batch half (the port does not trace): two pairs, and two ridges,
    in one call each."""
    x, y = (_t(a) for a in _tone_pair(noise=0.2))
    xb, yb = torch.stack([x, y]), torch.stack([y, x])
    wb = vt.cross_wavelet(xb, yb, XWT_SCALES, "morl")
    assert tuple(wb.coeffs.shape) == (2, 24, XWT_N)
    single = vt.cross_wavelet(x, y, XWT_SCALES, "morl").coeffs
    assert float((wb.coeffs[0] - single).abs().max()) <= 1e-10 * float(single.abs().max())
    ridge_b = vt.extract_ridge(vt.cwt(xb, XWT_SCALES, "morl", analytic=True))
    assert tuple(ridge_b.indices.shape) == (2, XWT_N)
    assert tuple(vt.wavelet_coherence(x, y, XWT_SCALES, "morl").coherence.shape) == (24, XWT_N)


def test_cross_wavelet_length_mismatch():
    with pytest.raises(InvalidArgumentError):
        vt.cross_wavelet(torch.ones(64, dtype=F64), torch.ones(128, dtype=F64), (2.0, 4.0),
                         "morl")


@pytest.mark.slow
def test_ridge_blocked_matches_sequential():
    """The port's blocked max-plus Viterbi against its sequential pass, at
    the JAX test's draw (equal indices, float64), and the public call's
    blocked route on 2048 samples."""
    rng = np.random.default_rng(21)
    log_scales = np.log2(np.geomspace(2, 64, 12))
    pen = torch.as_tensor(1.5 * (log_scales[:, None] - log_scales[None, :]) ** 2)
    for n in (1025, 1153, 2048):
        obs = torch.as_tensor(rng.standard_normal((n, 3, 12)) * 2)
        seq = txwt._viterbi_indices_scan(obs, pen)
        blk = txwt._viterbi_indices_blocked(obs, pen, 128)
        assert torch.equal(seq, blk)
    coeffs = _t(np.abs(rng.standard_normal((12, 2048))) + 0.01)
    r = vt.extract_ridge(vt.CWTResult(coeffs, tuple(np.geomspace(2, 64, 12)), "zero"))
    assert tuple(r.indices.shape) == (2048,)


# --- tests/test_variance_xwt.py: significance testing ----------------------------------


def test_white_noise_exceedance_calibrated():
    rng = np.random.default_rng(30)
    scales = vt.scales_log(2, 64, 16)
    rates = []
    for _ in range(8):
        x = _t(rng.standard_normal(2048))
        r = vt.cwt(x, scales, "morl", analytic=True, boundary="periodic")
        sig = vt.significant_power(r, x, "morl", lag1=0.0)
        power = _np(r.coeffs.abs() ** 2)
        rates.append((power > _np(sig.levels)[:, None]).mean(axis=-1))
    rates = np.mean(rates, axis=0)
    assert np.all(rates > 0.01) and np.all(rates < 0.12)
    assert abs(float(np.mean(rates)) - 0.05) < 0.025


def test_ar1_estimate_and_red_noise_null():
    rng = np.random.default_rng(31)
    n = 4096
    eps = rng.standard_normal(4 * n)
    ar = np.empty(4 * n)
    ar[0] = eps[0]
    for i in range(1, 4 * n):
        ar[i] = 0.8 * ar[i - 1] + eps[i]
    x = _t(ar[-n:])
    assert abs(float(vt.ar1_coefficient(x)) - 0.8) < 0.05
    r = vt.cwt(x, vt.scales_log(2, 64, 16), "morl", analytic=True, boundary="periodic")
    sig = vt.significant_power(r, x, "morl")
    assert float((_np(r.coeffs.abs() ** 2) > _np(sig.levels)[:, None]).mean()) < 0.12


def test_tone_is_significant_at_its_scale():
    rng = np.random.default_rng(32)
    n = 2048
    x = _t(np.sin(2 * np.pi * 0.05 * np.arange(n)) + 0.5 * rng.standard_normal(n))
    r = vt.cwt(x, vt.scales_log(2, 64, 16), "morl", analytic=True)
    sig = vt.significant_power(r, x, "morl")
    si = _dominant_scale(r.coeffs)
    assert float(sig.mask[si].double().mean()) > 0.8
    assert tuple(sig.coi_scales.shape) == (n,)


def test_cone_of_influence_shape():
    coi = _np(vt.cone_of_influence(101, device="cpu"))
    assert coi[0] == 0.0 and coi[-1] == 0.0
    assert np.argmax(coi) in (50, 51) and np.all(np.diff(coi[:50]) > 0)


def test_significance_errors():
    with pytest.raises(InvalidArgumentError):
        vt.significance_levels((2.0, 4.0), "morl", n=128, lag1=0.0, confidence=1.5,
                               device="cpu")
    with pytest.raises(InvalidArgumentError):
        vt.cone_of_influence(0, device="cpu")


def test_phase_randomized_surrogates_preserve_spectrum():
    """The JAX key's draw is the port's generator's at seed 40 (a
    statistical guarantee: the spectrum kept, the phases new)."""
    x = _t(np.random.default_rng(40).standard_normal(512))
    s = vt.phase_randomized_surrogates(x, 4, generator=torch.Generator().manual_seed(40))
    assert tuple(s.shape) == (4, 512)
    for k in range(4):
        np.testing.assert_allclose(np.abs(np.fft.rfft(_np(s[k]))), np.abs(np.fft.rfft(_np(x))),
                                   atol=1e-9)
    assert float((s[0] - s[1]).abs().max()) > 0.1
    assert float((s[0] - x).abs().max()) > 0.1


@pytest.mark.slow
def test_coherence_significance_monte_carlo():
    """The JAX key's draws are the port's generator's at seed 41."""
    rng = np.random.default_rng(41)
    n = 1024
    t = np.arange(n)
    x = _t(np.sin(2 * np.pi * 0.05 * t) + 0.4 * rng.standard_normal(n))
    y = _t(np.sin(2 * np.pi * 0.05 * t - 1.0) + 0.4 * rng.standard_normal(n))
    indep = _t(rng.standard_normal(n))
    scales = vt.scales_log(2, 64, 16)
    gen = torch.Generator().manual_seed(41)
    lev = vt.coherence_significance(x, y, scales, "morl", n_surrogates=32, generator=gen)
    assert tuple(lev.shape) == (16,) and bool(((lev >= 0) & (lev <= 1)).all())
    obs = vt.wavelet_coherence(x, y, scales, "morl").mean_coherence()
    si = int(obs.argmax())
    assert float(obs[si]) > float(lev[si])
    lev_i = vt.coherence_significance(x, indep, scales, "morl", n_surrogates=32,
                                      generator=gen)
    obs_i = vt.wavelet_coherence(x, indep, scales, "morl").mean_coherence()
    assert float((obs_i <= lev_i).double().mean()) > 0.7
    with pytest.raises(InvalidArgumentError):
        vt.coherence_significance(x, y, scales, "morl", confidence=2.0)
    with pytest.raises(InvalidArgumentError):
        vt.phase_randomized_surrogates(x, 0)
