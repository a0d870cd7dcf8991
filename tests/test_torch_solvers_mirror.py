"""Test mirrors of the JAX package's solver and infrastructure tests, on the port.

Mirrors ``tests/test_sparse.py``, ``tests/test_deconvolve.py``,
``tests/test_infrastructure.py`` and the tick tests of
``tests/test_examples_and_fixtures.py`` test by test, under the JAX tests'
names, at their shapes and seeds; the audit of the eight files of the 2-D
trees, the solvers and the infrastructure is in CHANGES.md.

These JAX tests state properties of the package's output (FISTA's closed-form
prox, BPDN beating the one-shot denoise, inpainting that keeps the observed
samples, compressed sensing, ForWaRD beating the blurred input, the facade's
convolutions equal to the MODWT, a checkpointed stream resumed bit for bit).
Here the port is held to the same property on its own output; the earlier
parity tests (``test_torch_optimize.py``, ``test_torch_infrastructure.py``,
``test_torch_cwt.py``, ``test_torch_streaming.py``) hold it to JAX value by
value.  Each family is anchored to the JAX package once more, at a named
draw of its mirror, through a module-scoped fixture (``anchor_*``), the JAX
side on its jnp path under one ``jax.jit``.  A JAX ``jit``, ``lax.scan`` or
pytree half has no counterpart (the port does not trace); its batch, loop or
tensor half is mirrored.  The port's differences by design stand (ROADMAP):
FISTA runs a Python loop, the streaming counters are Python ints, and
``deconvolve`` builds its kernel's spectrum on the input's device.

Tolerances: the anchors 1e-10 of the largest value (float64 on both sides),
the facade 1e-12; the properties at the JAX tests' own bounds.

The phase 2g cases of the 2-D trees' and these files
(``tools/mirror_cases.solver_cases``) run here on CPU tensors
(``mirror_cases.cpu_problems``).
"""

import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from tools import mirror_cases
from vectorwave_tpu.ops import convolve as jconv
from vectorwave_tpu.ops import facade as jfacade
from vectorwave_tpu_torch import cost_model, finance, observability
from vectorwave_tpu_torch.errors import InvalidArgumentError, InvalidSignalError
from vectorwave_tpu_torch.ops import convolve, facade
from vectorwave_tpu_torch.optimize.deconvolve import _level_responses
from vectorwave_tpu_torch.streaming import modwt_stream_block, streaming_init
from vectorwave_tpu_torch.transforms.modwt import _resolve_discrete
from vectorwave_tpu_torch.wavelets.base import orthogonal_wavelet

from .conftest import composite_sin

torch.set_num_threads(1)

ANCHOR = 1e-10
FACADE = 1e-12
F64 = torch.float64


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _t(a, dtype=F64) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _rms(a, b) -> float:
    return float(np.sqrt(np.mean((_np(a) - _np(b)) ** 2)))


_sines = mirror_cases.sines
_gaussian_kernel = mirror_cases.gaussian_kernel
_blur = mirror_cases.blur
_test_image = mirror_cases.deconvolve_image
_synthetic_ticks = mirror_cases.synthetic_ticks


def _blur2(img, width, taps):
    """(blurred, peak-at-origin psf) of ``tests/test_deconvolve.py::_blur2``."""
    psf0 = mirror_cases.gaussian_psf(width, taps, img.shape)
    return np.fft.ifft2(np.fft.fft2(img) * np.fft.fft2(psf0)).real, psf0


# --- the anchors: each family against the JAX package once ---------------------------


@pytest.fixture(scope="module")
def anchor_sparse():
    """JAX's inpaint (db8, the default depth, 60 steps) at
    test_inpaint_ignores_nan_at_missing_positions's draw (256 samples, mask
    seed 7), zero-encoded, in float64 (ANCHOR_SPARSE)."""
    clean, _ = _sines(n=256)
    mask = (np.random.default_rng(7).random(256) > 0.4).astype(np.float64)
    out = jax.jit(lambda y, m: vw.inpaint(y, m, "db8", steps=60))(jnp.asarray(clean * mask),
                                                                    jnp.asarray(mask))
    return clean, mask, np.asarray(out)


def test_anchor_sparse_matches_jax(anchor_sparse):
    """The port given NaN at the missing samples, JAX given zeros."""
    clean, mask, want = anchor_sparse
    y = _t(np.where(mask > 0, clean, np.nan))
    got = vt.inpaint(y, _t(mask), "db8", steps=60)
    assert _rel(got, want) <= ANCHOR


@pytest.fixture(scope="module")
def anchor_deconvolve():
    """JAX's deconvolve (db4 J=3) at test_batched_and_jitted's draw (2 x 512)
    and deconvolve2 (db4 J=2) at test_deconvolve2_batched_jit's (2 x 32 x 32),
    in float64 (ANCHOR_DECONVOLVE)."""
    rng = np.random.default_rng(42)
    n = 512
    clean = np.stack([composite_sin(n), composite_sin(n, seed=9)])
    kernel = _gaussian_kernel(3.0, 17)
    noisy = np.stack([_blur(c, kernel) for c in clean]) + 0.05 * rng.standard_normal((2, n))
    rng = np.random.default_rng(42)
    blurred, psf0 = _blur2(_test_image(32, 32), 1.2, 7)
    noisy2 = np.stack([blurred, blurred]) + 0.03 * rng.standard_normal((2, 32, 32))

    def ref(y, y2):
        r1 = vw.deconvolve(y, kernel, "db4", levels=3)
        r2 = vw.deconvolve2(y2, psf0, "db4", levels=2)
        return r1.signal, r1.wiener, r2.signal, r2.wiener

    out = [np.asarray(a) for a in jax.jit(ref)(jnp.asarray(noisy), jnp.asarray(noisy2))]
    return (noisy, kernel, noisy2, psf0), out


def test_anchor_deconvolve_matches_jax(anchor_deconvolve):
    (noisy, kernel, noisy2, psf0), (signal, wiener, signal2, wiener2) = anchor_deconvolve
    got = vt.deconvolve(_t(noisy), kernel, "db4", levels=3)
    assert _rel(got.signal, signal) <= ANCHOR and _rel(got.wiener, wiener) <= ANCHOR
    got2 = vt.deconvolve2(_t(noisy2), psf0, "db4", levels=2)
    assert _rel(got2.signal, signal2) <= ANCHOR and _rel(got2.wiener, wiener2) <= ANCHOR


#: the facade's draws: (wavelet, n, spacing); dmey at spacing 32 spans 1953
#: samples, past N = 1024; db4 at spacing 64, 449 past 256
FACADE_DRAWS = (("db4", 256, 1), ("db4", 256, 4), ("db4", 256, 64), ("dmey", 1024, 1),
                ("dmey", 1024, 4), ("dmey", 1024, 32))


@pytest.fixture(scope="module")
def anchor_facade():
    """The JAX facade's three convolutions and ``fft_circular_convolve``
    (``sign`` -1 and +1) on composite_sin at each of :data:`FACADE_DRAWS`,
    in float64, under one jit (ANCHOR_FACADE)."""
    filters = {name: vw.wavelet(name).dec_lo / np.sqrt(2.0) for name in ("db4", "dmey")}

    def ref(xs):
        out = {}
        for name, n, spacing in FACADE_DRAWS:
            x, f = xs[n], filters[name]
            out[name, n, spacing] = (
                jfacade.circular_convolve_modwt(x, f, spacing=spacing),
                jfacade.zero_padding_convolve_modwt(x, f, spacing=spacing),
                jfacade.symmetric_convolve_modwt(x, f, spacing=spacing),
                jconv.fft_circular_convolve(x, f, spacing=spacing, sign=-1),
                jconv.fft_circular_convolve(x, f, spacing=spacing, sign=1))
        return out

    xs = {n: composite_sin(n) for n in (256, 1024)}
    out = jax.jit(ref)({n: jnp.asarray(x) for n, x in xs.items()})
    return xs, filters, jax.tree_util.tree_map(np.asarray, out)


def _port_facade(x, f, spacing):
    return (facade.circular_convolve_modwt(x, f, spacing=spacing),
            facade.zero_padding_convolve_modwt(x, f, spacing=spacing),
            facade.symmetric_convolve_modwt(x, f, spacing=spacing),
            convolve.fft_circular_convolve(x, f, spacing=spacing, sign=-1),
            convolve.fft_circular_convolve(x, f, spacing=spacing, sign=1))


@pytest.mark.parametrize("draw", FACADE_DRAWS, ids=lambda d: f"{d[0]}-{d[1]}-s{d[2]}")
def test_anchor_facade_matches_jax(anchor_facade, draw):
    """The three entry points and ``fft_circular_convolve`` (analysis and
    adjoint) equal the JAX functions within 1e-12 in float64."""
    xs, filters, out = anchor_facade
    name, n, spacing = draw
    got = _port_facade(_t(xs[n]), filters[name], spacing)
    for g, w in zip(got, out[name, n, spacing]):
        assert g.dtype == F64
        assert float(np.abs(_np(g) - w).max()) <= FACADE


@pytest.mark.parametrize("n, taps", [(1024, 80), (1023, 80), (4096, 62), (2048, 8)])
def test_circular_convolve_modwt_routes_by_should_use_fft(monkeypatch, n, taps):
    """A CPU tensor takes the FFT route exactly where ``should_use_fft``
    (the JAX thresholds, 64 taps and 1024 samples) says, and both routes
    give the rolled convolution."""
    calls = []
    real = facade.fft_circular_convolve
    monkeypatch.setattr(facade, "fft_circular_convolve",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    f = np.random.default_rng(taps).standard_normal(taps)
    x = _t(composite_sin(n))
    got = facade.circular_convolve_modwt(x, f, spacing=2)
    assert bool(calls) == facade.should_use_fft(n, taps, device=x.device) == (
        jfacade.should_use_fft(n, taps))
    want = convolve.atrous_convolve(x, f, spacing=2, boundary="periodic")
    assert float((got - want).abs().max()) <= 1e-12


# --- test_sparse.py ---------------------------------------------------------------------


def test_fista_matches_closed_form_prox():
    """min 0.5||c-b||^2 + lam||c||_1 has the exact solution soft(b, lam)."""
    b = torch.tensor([3.0, -0.5, 0.2, -2.0, 0.05])
    lam = 0.4
    grad = torch.func.grad(lambda c: 0.5 * ((c - b) ** 2).sum())

    def prox(c, i):
        return torch.sign(c) * torch.clamp(c.abs() - lam, min=0.0)

    c = vt.fista(grad, prox, torch.zeros_like(b), steps=200)
    expect = torch.sign(b) * torch.clamp(b.abs() - lam, min=0.0)
    np.testing.assert_allclose(_np(c), _np(expect), atol=1e-5)


def test_fista_rejects_bad_steps():
    with pytest.raises(InvalidArgumentError):
        vt.fista(lambda c: c, lambda c, i: c, torch.zeros(4), steps=0)


@pytest.mark.slow
def test_bpdn_denoises_and_beats_one_shot():
    clean, noisy = _sines(noise=0.3)
    y = _t(noisy, torch.float32)
    r = vt.bpdn(y, "db8", steps=100)
    mse_in = np.mean((noisy - clean) ** 2)
    mse_out = np.mean((_np(r.signal) - clean) ** 2)
    assert 10 * np.log10(mse_in / mse_out) > 2.5  # JAX measured 3.84 dB
    one_shot = _np(vt.denoise(y, "db8"))
    assert mse_out < np.mean((one_shot - clean) ** 2)


@pytest.mark.slow
def test_bpdn_batched_equals_individual():
    """Leading batch axis separable: the default lam is per signal."""
    _, n0 = _sines(noise=0.3, seed=1)
    _, n1 = _sines(noise=0.5, seed=2)
    rb = vt.bpdn(_t(np.stack([n0, n1]), torch.float32), "db4", levels=4, steps=40)
    for k, sig in enumerate([n0, n1]):
        ri = vt.bpdn(_t(sig, torch.float32), "db4", levels=4, steps=40)
        np.testing.assert_allclose(_np(rb.signal[k]), _np(ri.signal), atol=2e-5)


def test_inpaint_fills_missing_and_keeps_observed():
    clean, _ = _sines()
    mask = (np.random.default_rng(3).random(512) > 0.4).astype(np.float32)
    y = _t(clean * mask, torch.float32)
    out = _np(vt.inpaint(y, _t(mask, torch.float32), "db8", steps=200))
    miss = mask == 0
    rel = np.sqrt(np.mean((out[miss] - clean[miss]) ** 2)) / np.std(clean)
    assert rel < 0.1  # JAX measured 0.051
    np.testing.assert_array_equal(out[~miss], _np(y)[~miss])


@pytest.mark.slow
def test_inpaint_no_enforce_stays_close_on_observed():
    clean, _ = _sines(n=256)
    mask = (np.random.default_rng(4).random(256) > 0.3).astype(np.float32)
    y = _t(clean * mask, torch.float32)
    out = _np(vt.inpaint(y, _t(mask, torch.float32), "db4", steps=150, enforce_data=False))
    obs = mask == 1
    assert np.sqrt(np.mean((out[obs] - clean[obs]) ** 2)) / np.std(clean) < 0.1


@pytest.mark.slow
def test_inpaint2_fills_missing_pixels():
    img, mask = mirror_cases.inpaint2_problem()
    out = _np(vt.inpaint2(_t(img, torch.float32), _t(mask, torch.float32), "db4", levels=2,
                          steps=80))
    miss = mask == 0
    assert np.sqrt(np.mean((out[miss] - img[miss]) ** 2)) / np.std(img) < 0.1  # JAX 0.043
    np.testing.assert_array_equal(out[~miss], img[~miss].astype(np.float32))


def test_sparse_recover_compressed_sensing():
    """Recover a wavelet-sparse signal from 2x-undersampled projections.
    The JAX test's projection is float64 (a float32 draw over a float64
    square root), which promotes its measurements: the port's ``forward``
    promotes the float32 signal the same way, and the gradient flows back to
    the float32 planes.  The planes are the result's planes (the pytree half
    of the JAX test: ``tree_flatten`` of a MODWT result)."""
    rng = np.random.default_rng(1)
    n, m, w = 256, 128, "db4"
    zero_c = vt.modwt_multilevel(torch.zeros(n, dtype=F64), w, levels=4)
    planes = [*zero_c.details, zero_c.approx]
    sparse = []
    for k in range(len(planes)):
        v = np.zeros(n, np.float32)
        if k < 2:  # a handful of active coefficients in two subbands
            v[rng.choice(n, 3, replace=False)] = 2.0 * rng.standard_normal(3)
        sparse.append(torch.from_numpy(v))
    x_true = vt.imodwt_multilevel(vt.MultiLevelMODWTResult(tuple(sparse[:-1]), sparse[-1]), w)
    a_mat = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32) / np.sqrt(m))

    def forward(x):
        return a_mat @ x.to(a_mat.dtype)

    r = vt.sparse_recover(forward(x_true), forward, w, signal_shape=(n,), lam=1e-4,
                          lam_init=1.0, steps=400, levels=4)
    rel = float(torch.linalg.vector_norm(r.signal - x_true) / torch.linalg.vector_norm(x_true))
    assert rel < 0.15  # JAX measured 0.087


def test_sparse_recover_rejects_bad_ndim():
    with pytest.raises(InvalidArgumentError):
        vt.sparse_recover(torch.zeros(8), lambda x: x, "db4", signal_shape=(8,), lam=0.1,
                          steps=2, levels=1, ndim=3)


def test_inpaint_ignores_nan_at_missing_positions():
    """A NaN-encoded input gives exactly the solve of the zero-encoded one,
    and stays finite."""
    clean, _ = _sines(n=256)
    mask = (np.random.default_rng(7).random(256) > 0.4).astype(np.float32)
    y_nan = _t(np.where(mask > 0, clean, np.nan), torch.float32)
    y_zero = _t(clean * mask, torch.float32)
    out_nan = _np(vt.inpaint(y_nan, _t(mask, torch.float32), "db8", steps=60))
    out_zero = _np(vt.inpaint(y_zero, _t(mask, torch.float32), "db8", steps=60))
    assert np.isfinite(out_nan).all()
    np.testing.assert_array_equal(out_nan, out_zero)


# --- test_deconvolve.py -----------------------------------------------------------------


def test_level_responses_match_impulse_oracle():
    """The DFT-dilation product formula equals the unit-impulse transform."""
    n, levels = 256, 4
    responses = _level_responses(n, _resolve_discrete("db4"), levels)
    impulse = torch.zeros(n, dtype=F64)
    impulse[0] = 1.0
    tree = vt.modwt_multilevel(impulse, "db4", levels=levels, backend="jnp")
    for g_pow, detail in zip(responses, tree.details):
        oracle = np.abs(np.fft.fft(_np(detail))) ** 2
        np.testing.assert_allclose(g_pow, oracle, atol=1e-12)


@pytest.mark.slow
def test_deconvolve_beats_blurred_input(rng):
    n = 2048
    clean = composite_sin(n)
    kernel = _gaussian_kernel(4.0, 33)
    noisy = _blur(clean, kernel) + 0.05 * rng.standard_normal(n)
    res = vt.deconvolve(_t(noisy), kernel, "sym8", levels=4)
    err_out = _rms(res.signal, clean)
    assert err_out < 0.1 * _rms(noisy, clean)
    assert len(res.level_sigmas) == 4
    assert all(float(s.min()) > 0.0 for s in res.level_sigmas)
    assert err_out <= 1.05 * _rms(res.wiener, clean)


@pytest.mark.slow
def test_deconvolve_beats_naive_inverse(rng):
    n = 1024
    clean = composite_sin(n)
    kernel = _gaussian_kernel(6.0, 65)  # strong blur: tiny |H| tail
    noisy = _blur(clean, kernel) + 0.05 * rng.standard_normal(n)
    naive = np.fft.ifft(np.fft.fft(noisy) / np.fft.fft(kernel, n=n)).real
    res = vt.deconvolve(_t(noisy), kernel, "sym8", sigma=0.05)
    assert _rms(res.signal, clean) < 0.1 * _rms(naive, clean)  # the naive inverse explodes


def test_noiseless_recovery_is_tight():
    n = 1024
    clean = composite_sin(n)
    kernel = _gaussian_kernel(2.0, 17)
    res = vt.deconvolve(_t(_blur(clean, kernel)), kernel, "sym8", sigma=1e-8)
    assert np.linalg.norm(_np(res.signal) - clean) / np.linalg.norm(clean) < 1e-3


def test_identity_kernel_reduces_to_denoising(rng):
    n = 1024
    clean = composite_sin(n)
    noisy = clean + 0.3 * rng.standard_normal(n)
    res = vt.deconvolve(_t(noisy), np.array([1.0]), "sym8")
    assert _rms(res.signal, clean) < _rms(noisy, clean)


def test_batched_and_jitted(rng):
    """The batch half (the port does not trace): each row of a 2 x 512
    batch ends nearer its clean signal than its input."""
    n = 512
    clean = np.stack([composite_sin(n), composite_sin(n, seed=9)])
    kernel = _gaussian_kernel(3.0, 17)
    noisy = np.stack([_blur(c, kernel) for c in clean])
    noisy += 0.05 * rng.standard_normal(noisy.shape)
    out = _np(vt.deconvolve(_t(noisy), kernel, "db4", levels=3).signal)
    assert out.shape == noisy.shape
    for i in range(2):
        assert _rms(out[i], clean[i]) < _rms(noisy[i], clean[i])


def test_kernel_validation():
    y = torch.zeros(128, dtype=F64)
    with pytest.raises(InvalidArgumentError):
        vt.deconvolve(y, np.zeros(5))  # all-zero kernel
    with pytest.raises(InvalidArgumentError):
        vt.deconvolve(y, np.ones((3, 3)))  # not 1-D
    with pytest.raises(InvalidArgumentError):
        vt.deconvolve(y, np.ones(256))  # longer than signal


def test_deconvolve2_beats_blurred_input(rng):
    clean = _test_image()
    blurred, psf0 = _blur2(clean, 1.8, 11)
    noisy = blurred + 0.05 * rng.standard_normal(clean.shape)
    res = vt.deconvolve2(_t(noisy), psf0, "sym4", levels=3)
    assert _rms(res.signal, clean) < 0.5 * _rms(noisy, clean)
    assert len(res.level_sigmas) == 3
    assert all(len(t) == 3 for t in res.level_sigmas)  # (lh, hl, hh)


@pytest.mark.slow
def test_deconvolve2_batched_jit(rng):
    """The batch half (the port does not trace)."""
    clean = _test_image(32, 32)
    blurred, psf0 = _blur2(clean, 1.2, 7)
    noisy = np.stack([blurred, blurred]) + 0.03 * rng.standard_normal((2, 32, 32))
    out = _np(vt.deconvolve2(_t(noisy), psf0, "db4", levels=2).signal)
    assert out.shape == (2, 32, 32)
    for i in range(2):
        assert _rms(out[i], clean) < _rms(noisy[i], clean)


def test_deconvolve2_kernel_validation():
    y = torch.zeros(32, 32, dtype=F64)
    with pytest.raises(InvalidArgumentError):
        vt.deconvolve2(y, np.zeros((3, 3)))  # all-zero psf
    with pytest.raises(InvalidArgumentError):
        vt.deconvolve2(y, np.ones(5))  # 1-D psf
    with pytest.raises(InvalidArgumentError):
        vt.deconvolve2(y, np.ones((64, 64)))  # larger than image
    with pytest.raises(InvalidArgumentError):
        vt.deconvolve2(torch.zeros(32, dtype=F64), np.ones((3, 3)))  # 1-D input


# --- test_infrastructure.py -------------------------------------------------------------


def test_facade_convolutions_match_ops():
    x = _t(composite_sin(256))
    filt = vt.wavelet("db4").dec_lo / np.sqrt(2.0)
    a = facade.circular_convolve_modwt(x, filt)
    np.testing.assert_allclose(_np(a), _np(vt.modwt(x, "db4").approx), atol=1e-12)
    z = facade.zero_padding_convolve_modwt(x, filt)
    s = facade.symmetric_convolve_modwt(x, filt)
    assert z.shape == s.shape == x.shape


def test_facade_fft_routing():
    assert not facade.should_use_fft(512, 64)  # small N
    assert not facade.should_use_fft(2048, 8)  # short filter
    assert facade.should_use_fft(1024, 256)  # long filter vs N
    # the FFT path equals the direct path for the periodic convolution
    x = _t(composite_sin(1024))
    filt = vt.wavelet("dmey").dec_lo / np.sqrt(2.0)
    direct = convolve.atrous_convolve(x, filt, boundary="periodic")
    via_fft = convolve.fft_circular_convolve(x, filt)
    np.testing.assert_allclose(_np(direct), _np(via_fft), atol=1e-9)


def test_performance_info():
    info = facade.get_performance_info(device="cpu")
    assert info.platform in ("cpu", "cuda")
    assert info.device_count >= 1
    assert "compute tier" in info.description


def test_cost_model_estimate_and_calibration(tmp_path, monkeypatch):
    monkeypatch.setenv("VECTORWAVE_TPU_TORCH_CACHE", str(tmp_path))
    pred = cost_model.estimate_processing_time(65536, levels=6, batch=8, device="cpu")
    assert pred.estimated_seconds > 0
    assert pred.lower_seconds < pred.estimated_seconds < pred.upper_seconds
    assert not pred.calibrated
    rate = cost_model.calibrate(sizes=(1024,), batch=2, levels=3, persist=True, device="cpu")
    assert rate > 0
    pred2 = cost_model.estimate_processing_time(65536, levels=6, batch=8, device="cpu")
    assert pred2.calibrated
    assert (pred2.upper_seconds / pred2.lower_seconds
            < pred.upper_seconds / pred.lower_seconds)


def test_observability_stats_and_meter():
    observability.stats.reset()
    with observability.throughput_meter("unit", samples=1000):
        pass
    snap = observability.stats.snapshot()
    assert snap["unit.samples"] == 1000
    assert snap["unit.seconds"] >= 0
    observability.stats.reset()
    assert observability.stats.get("unit.samples") == 0


def test_modwt_based_icwt():
    from vectorwave_tpu_torch.transforms.cwt_modwt_inverse import modwt_based_icwt

    n = 1024
    t = np.arange(n)
    x = np.sin(2 * np.pi * t / 32) + 0.5 * np.sin(2 * np.pi * t / 128)
    res = vt.cwt(_t(x), vt.scales_log(2, 256, 48), "morl", boundary="periodic")
    ref = vt.modwt_multilevel(_t(x), "sym4", levels=5)
    xr = _np(modwt_based_icwt(res, "morl", approx=ref.approx))
    nrmse = np.sqrt(np.mean((xr - x) ** 2)) / np.std(x)
    assert nrmse < 0.15, nrmse  # the reference documents 3-10% for this route


def test_transform_config_dataclass():
    cfg = vt.TransformConfig(boundary="zero", backend="jnp")
    assert cfg.boundary == "zero"
    assert cfg.max_decomposition_levels == 20


def test_fft_routing_is_wired_into_modwt(monkeypatch):
    """``modwt`` routes a long-filter periodic transform through
    ``fft_analysis_pair`` (64 base taps and more on a CPU tensor) and
    matches the rolled form."""
    assert not facade.should_use_fft(65536, 62)  # dmey stays on the roll path
    assert facade.should_use_fft(65536, 64)
    rng = np.random.default_rng(0)
    taps = rng.standard_normal(80)
    taps /= np.sqrt((taps**2).sum()) / np.sqrt(2)
    w = orthogonal_wavelet("test_long80", "custom", taps, 0)
    x = _t(composite_sin(4096, noise_std=0.2))
    from vectorwave_tpu_torch.transforms import modwt as modwt_mod

    calls = []
    real = modwt_mod.fft_analysis_pair
    monkeypatch.setattr(modwt_mod, "fft_analysis_pair",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    res_fft = vt.modwt(x, w, boundary="periodic")
    assert calls == [1]
    a, d = convolve.atrous_analysis_pair(x, w.dec_lo / np.sqrt(2), w.dec_hi / np.sqrt(2),
                                         spacing=1, boundary="periodic")
    np.testing.assert_allclose(_np(res_fft.approx), _np(a), atol=1e-9)
    np.testing.assert_allclose(_np(res_fft.detail), _np(d), atol=1e-9)


def test_validation_edge_cases():
    """Structured errors for degenerate inputs."""
    with pytest.raises(InvalidArgumentError):
        vt.cwt(torch.ones(64), (), "morl")  # no scales
    with pytest.raises(InvalidSignalError):
        vt.cwt(torch.zeros(0), (2.0,), "morl")  # empty signal
    with pytest.raises(InvalidArgumentError):
        streaming_init("db4", 0, device="cpu")  # levels < 1
    with pytest.raises(InvalidArgumentError):
        streaming_init("db4", -3, device="cpu")


# --- test_examples_and_fixtures.py ------------------------------------------------------


@pytest.mark.slow
def test_tick_data_denoising_recovers_mid_price():
    price = _synthetic_ticks()
    mid_est = _np(vt.denoise_multilevel(_t(price), "sym8", levels=5, method="universal"))
    # microstructure noise (5e-4 relative) should shrink substantially
    raw_noise = np.std(np.diff(np.log(price)))
    den_noise = np.std(np.diff(np.log(np.maximum(mid_est, 1e-9))))
    assert den_noise < 0.5 * raw_noise


def test_tick_data_incremental_stream():
    """The loop half of the JAX ``lax.scan``: 2000 ticks, one update each."""
    price = _synthetic_ticks(2000)
    state = finance.incremental_init(F64, device="cpu")
    vols = []
    for p in _t(price):
        state, metrics = finance.incremental_update(state, p)
        vols.append(metrics.volatility)
    assert torch.isfinite(torch.stack(vols)).all()
    assert float(state.max_drawdown) < 0.2  # a calm synthetic series


def test_streaming_state_checkpoint_roundtrip(tmp_path):
    """The streaming carry saved as plain arrays and restored resumes bit
    for bit; its block counter is a Python int (a difference by design)."""
    x = _synthetic_ticks(1024)
    state = streaming_init("db4", 3, dtype=F64, device="cpu")
    state, _ = modwt_stream_block(state, _t(x[:512]), "db4")
    np.savez(tmp_path / "ckpt.npz", *[_np(h) for h in state.histories],
             blocks=np.asarray(state.blocks_processed))
    loaded = np.load(tmp_path / "ckpt.npz")
    restored = type(state)(
        histories=tuple(_t(loaded[f"arr_{i}"]) for i in range(len(state.histories))),
        blocks_processed=int(loaded["blocks"]))
    assert type(state.blocks_processed) is int
    _, out1 = modwt_stream_block(state, _t(x[512:]), "db4")
    _, out2 = modwt_stream_block(restored, _t(x[512:]), "db4")
    for a, b in zip((*out1.details, out1.approx), (*out2.details, out2.approx)):
        np.testing.assert_array_equal(_np(a), _np(b))


# --- the phase 2g cases ----------------------------------------------------------------


@pytest.mark.parametrize("label", mirror_cases.solver_labels("solvers"))
def test_solver_case_runs_its_plain_versions_on_the_cpu(label):
    """Each phase 2g case on CPU tensors: no launch, no refusal, the plain
    route's result within the case's bounds (and the JAX test's checks)."""
    assert not mirror_cases.cpu_problems(label)


def test_solver_cases_are_the_jax_tests_shapes():
    """Every phase 2g case names a JAX test that exists and whose source
    names the case's wavelet, and its input helpers equal the JAX tests'
    own on the same arguments."""
    cases = mirror_cases.solver_cases()
    assert len({c.label for c in cases}) == len(cases)
    for case in cases:
        module, name = case.source.split("::")
        mod = importlib.import_module(f"tests.{module[:-3]}")
        src = inspect.getsource(getattr(mod, name))
        assert f'"{case.wavelet}"' in src or case.kind == "calibrate", case.label
        assert mirror_cases.case_input(case).shape == case.shape
    dc = importlib.import_module("tests.test_deconvolve")
    np.testing.assert_array_equal(_gaussian_kernel(4.0, 33), dc._gaussian_kernel(4.0, 33))
    np.testing.assert_array_equal(_test_image(32, 32), dc._test_image(32, 32))
    img = _test_image()
    blurred, psf0 = dc._blur2(img, dc._gaussian_psf(1.8, 11))
    np.testing.assert_allclose(_blur2(img, 1.8, 11)[0], blurred, atol=1e-12)
    np.testing.assert_allclose(_blur2(img, 1.8, 11)[1], psf0, atol=1e-15)
    np.testing.assert_allclose(_blur(composite_sin(512), _gaussian_kernel(3.0, 17)),
                               dc._blur(composite_sin(512), _gaussian_kernel(3.0, 17), 512),
                               atol=1e-15)
    sp = importlib.import_module("tests.test_sparse")
    for args in ((512, 0.3, 1), (256, 0.0, 0)):
        np.testing.assert_array_equal(_sines(*args)[1], sp._sines(*args)[1])
    ef = importlib.import_module("tests.test_examples_and_fixtures")
    np.testing.assert_array_equal(_synthetic_ticks(1024), ef._synthetic_ticks(1024)[0])
    assert {c.source.split("::")[0] for c in cases} == {
        "test_sparse.py", "test_deconvolve.py", "test_infrastructure.py",
        "test_examples_and_fixtures.py", "test_packets2d.py"}
