"""Both sides of the MODWT routing gates that were re-derived on the card.

The cascade kernels' floor (``multilevel.KERNEL_MIN_N``), the symmetric
synthesis kernel's floor on a call's samples
(``multilevel.SYMMETRIC_SYNTHESIS_MIN_SAMPLES``), the fused denoise (which
reads the cascade's gate) and the FFT crossover of the plain periodic
MODWT for CUDA tensors (``facade.CUDA_FFT_MIN_TAPS`` and
``CUDA_FFT_MIN_SIGNAL``; CPU tensors keep the JAX package's thresholds).
The gates are asked on faked card tensors (a device, a dtype and a shape)
with the kernels said to be there, and under ``set_backend('kernel')`` on
CPU tensors, which asks the gates alone.

Golden oracle: on both sides of the floor the port's plain float64
``modwt_multilevel`` equals ``tests/golden.py`` (the numpy port of the
reference's ScalarOps) within 1e-12, for the wavelets and boundaries of the
oracle's own callers; ``imodwt_multilevel`` of the golden planes gives the
signal back within 1e-12 (periodic) or equals the JAX package's inverse of
them within 1e-12 (zero and symmetric, which the reference does not invert
exactly); at one level ``modwt`` and ``imodwt`` equal the oracle's
single-level pair within 1e-12.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from vectorwave_tpu_torch.denoise import denoiser
from vectorwave_tpu_torch.kernels import modwt_composite as mc
from vectorwave_tpu_torch.kernels import modwt_fused
from vectorwave_tpu_torch.ops import convolve, facade
from vectorwave_tpu_torch.transforms import multilevel as ml

from .golden import imodwt_golden, modwt_golden, modwt_multilevel_golden

CASES = [("db4", 6), ("sym8", 4), ("db4", 2)]
TOL_GOLDEN = 1e-12


def card(batch, n):
    """A float32 CUDA tensor as the gates see it."""
    return SimpleNamespace(device=torch.device("cuda"), dtype=torch.float32,
                           shape=(batch, n))


def floor_of(name, levels, boundary, synthesis):
    """The shortest signal the gate admits: the floor, or the shortest N
    whose windows the kernels serve, whichever is longer."""
    w = vt.wavelet(name)
    if boundary != "symmetric":
        halo = -(-modwt_fused.total_halo(w.filter_length, levels) // 128) * 128
        return max(ml.KERNEL_MIN_N, halo)
    from vectorwave_tpu_torch.kernels.modwt_symmetric import route_fits

    return next(n for n in range(ml.KERNEL_MIN_N, 1 << 16)
                if route_fits(w, levels, n, synthesis))


@pytest.fixture
def on_a_card(monkeypatch):
    monkeypatch.setattr(modwt_fused, "kernel_available", lambda: True)


@pytest.mark.parametrize("synthesis", [False, True], ids=["analysis", "synthesis"])
@pytest.mark.parametrize("boundary", ["periodic", "zero", "symmetric"])
@pytest.mark.parametrize("name,levels", CASES)
def test_cascade_gate_on_both_sides_of_its_floor(on_a_card, name, levels, boundary,
                                                 synthesis):
    w = vt.wavelet(name)
    floor = floor_of(name, levels, boundary, synthesis)
    batch = -(-ml.SYMMETRIC_SYNTHESIS_MIN_SAMPLES // (floor - 1))
    assert ml._kernel_eligible(card(batch, floor), w, levels, boundary, synthesis)
    assert not ml._kernel_eligible(card(batch, floor - 1), w, levels, boundary, synthesis)


@pytest.mark.parametrize("boundary", ["periodic", "zero", "symmetric"])
def test_the_constant_binds_where_the_windows_would_admit_less(on_a_card, boundary):
    """haar at 2 levels: its halo (1, then 128 rounded) and its mirror reach
    (2) admit shorter signals than the floor, which declines them."""
    w = vt.wavelet("haar")
    n = ml.KERNEL_MIN_N
    batch = -(-ml.SYMMETRIC_SYNTHESIS_MIN_SAMPLES // (n - 1))
    for synthesis in (False, True):
        assert ml._kernel_eligible(card(batch, n), w, 2, boundary, synthesis)
        assert not ml._kernel_eligible(card(batch, n - 1), w, 2, boundary, synthesis)


@pytest.mark.parametrize("name,levels", CASES)
def test_symmetric_synthesis_gate_on_both_sides_of_its_samples(on_a_card, name, levels):
    """The symmetric synthesis asks for a call of at least
    SYMMETRIC_SYNTHESIS_MIN_SAMPLES samples; its analysis does not."""
    w = vt.wavelet(name)
    n = 65536
    rows = ml.SYMMETRIC_SYNTHESIS_MIN_SAMPLES // n
    assert ml._kernel_eligible(card(rows, n), w, levels, "symmetric", synthesis=True)
    assert not ml._kernel_eligible(card(rows - 1, n), w, levels, "symmetric", synthesis=True)
    assert ml._kernel_eligible(card(1, n), w, levels, "symmetric", synthesis=False)
    assert ml._kernel_eligible(card(1, n), w, levels, "periodic", synthesis=True)


@pytest.mark.parametrize("name,levels", CASES[:2])
def test_kernel_backend_asks_the_same_floor_of_cpu_tensors(name, levels):
    """Under set_backend('kernel') the gates apply whatever the device."""
    w = vt.wavelet(name)
    try:
        vt.set_backend("kernel")
        for boundary in ("periodic", "zero", "symmetric"):
            floor = floor_of(name, levels, boundary, False)
            assert ml._kernel_eligible(torch.zeros(1, floor), w, levels, boundary)
            assert not ml._kernel_eligible(torch.zeros(1, floor - 1), w, levels, boundary)
    finally:
        vt.set_backend("auto")


@pytest.mark.parametrize("name,levels,boundary", [
    ("db4", 2, "periodic"), ("db4", 6, "periodic"), ("sym8", 4, "zero")])
def test_fused_denoise_gate_on_both_sides_of_the_floor(name, levels, boundary):
    """The fused denoise reads the cascade's gate: at the floor it runs (the
    kernel's plain version on the CPU), one sample shorter it declines and
    the three-call path serves the call."""
    floor = floor_of(name, levels, boundary, False)
    gen = torch.Generator().manual_seed(0)
    try:
        vt.set_backend("kernel")
        for n, fused in ((floor, True), (floor - 1, False)):
            x = torch.randn(2, n, generator=gen)
            got = denoiser._try_fused_denoise(x, name, levels, "universal", "soft", boundary)
            assert (got is not None) == fused, n
            if fused:
                want = vt.denoise_multilevel(x, name, levels=levels, boundary=boundary,
                                             precision="float32")
                assert float((got - want).abs().max()) <= 1e-4
    finally:
        vt.set_backend("auto")


def test_fft_gate_on_both_sides_of_each_threshold():
    """CUDA tensors take the crossover measured on the card; CPU tensors,
    and calls that name no device, the JAX package's thresholds."""
    taps, n = facade.CUDA_FFT_MIN_TAPS, facade.CUDA_FFT_MIN_SIGNAL
    for dev in ("cuda", torch.device("cuda", 0)):
        assert facade.should_use_fft(n, taps, dev)
        assert not facade.should_use_fft(n - 1, taps, dev)
        assert not facade.should_use_fft(n, taps - 1, dev)
    taps, n = facade.FFT_MIN_TAPS, facade.FFT_MIN_SIGNAL
    assert (taps, n) == (64, 1024)
    for dev in (None, "cpu", torch.device("cpu")):
        assert facade.should_use_fft(n, taps, dev)
        assert not facade.should_use_fft(n - 1, taps, dev)
        assert not facade.should_use_fft(n, taps - 1, dev)


def test_cpu_tensors_keep_the_jax_route(monkeypatch):
    """A CPU tensor of db38 (76 taps) takes the FFT from 1024 samples and
    db4 never does, as in the JAX package."""
    calls = []
    real = ml.fft_analysis_pair
    monkeypatch.setattr(ml, "fft_analysis_pair",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = torch.randn(1, 1024, dtype=torch.float64)
    vt.modwt_multilevel(x, "db4", levels=2)
    assert not calls
    vt.modwt_multilevel(x, "db38", levels=2)
    assert len(calls) == 2
    vt.modwt_multilevel(x[..., :1023], "db38", levels=2)
    assert len(calls) == 2


def _wrapped_spectrum_numpy(taps, spacing, n):
    """The upsampled filter wrapped circularly into length n, then its rfft."""
    h_up = np.zeros((len(taps) - 1) * spacing + 1)
    h_up[::spacing] = taps
    h = np.zeros(n)
    for start in range(0, len(h_up), n):
        chunk = h_up[start:start + n]
        h[:len(chunk)] += chunk
    return np.fft.rfft(h)


@pytest.mark.parametrize("taps,spacing,n", [(8, 1, 256), (8, 16, 256), (40, 64, 4096),
                                            (8, 64, 256), (76, 512, 1000), (16, 8, 37),
                                            (40, 256, 4096)])
def test_filter_spectrum_is_the_wrapped_filters_fft(taps, spacing, n):
    """The FFT route's spectra, built from the L wrapped taps, equal the
    numpy FFT of the upsampled filter wrapped into n, spacings past n
    included."""
    f = tuple(np.random.default_rng(taps + spacing).standard_normal(taps).tolist())
    got = convolve._filter_spectrum(f, spacing, n, torch.complex128, torch.device("cpu"))
    np.testing.assert_allclose(got.numpy(), _wrapped_spectrum_numpy(f, spacing, n),
                               rtol=0, atol=1e-12)


def test_filter_spectra_cache_holds_its_byte_bound(monkeypatch):
    """The spectra held never pass ``SPECTRUM_CACHE_BYTES``; the least
    recently used go first, and a hit moves a spectrum to the back."""
    monkeypatch.setattr(convolve, "_SPECTRA", type(convolve._SPECTRA)())
    one = 513 * 16  # complex128 spectrum of 1024 samples
    monkeypatch.setattr(convolve, "SPECTRUM_CACHE_BYTES", 3 * one)
    cpu = torch.device("cpu")
    for spacing in (1, 2, 4):
        convolve._filter_spectrum((1.0, -1.0), spacing, 1024, torch.complex128, cpu)
    convolve._filter_spectrum((1.0, -1.0), 1, 1024, torch.complex128, cpu)
    convolve._filter_spectrum((1.0, -1.0), 8, 1024, torch.complex128, cpu)
    held = [key[1] for key in convolve._SPECTRA]
    assert held == [4, 1, 8]
    assert sum(s.numel() * s.element_size() for s in convolve._SPECTRA.values()) <= 3 * one


@pytest.mark.parametrize("boundary", ["periodic", "symmetric", "zero"])
@pytest.mark.parametrize("name,levels", [("db4", 3), ("sym8", 2), ("haar", 1), ("db4", 1)])
def test_plain_cascade_matches_the_golden_oracle_across_the_floor(name, levels, boundary):
    """The golden oracle's own callers' wavelets and boundaries: haar and db4
    single-level forward and inverse (``tests/test_modwt.py``), db4 J=3
    (``tests/test_multilevel.py``), and sym8 J=2, each on both sides of the
    floor."""
    w = vt.wavelet(name)
    floor = floor_of(name, levels, boundary, False)
    rng = np.random.default_rng(20)
    for n in (floor - 1, floor):
        x = rng.standard_normal(n)
        res = vt.modwt_multilevel(torch.as_tensor(x), name, levels=levels,
                                  boundary=boundary)
        g_details, g_approx = modwt_multilevel_golden(x, w, levels, boundary)
        for got, want in zip((*res.details, res.approx), (*g_details, g_approx)):
            assert np.abs(got.numpy() - want).max() <= TOL_GOLDEN, n
        if levels == 1:  # the single-level pair against its own oracle
            one = vt.modwt(torch.as_tensor(x), name, boundary=boundary)
            g_a, g_d = modwt_golden(x, w, boundary)
            assert np.abs(one.approx.numpy() - g_a).max() <= TOL_GOLDEN, n
            assert np.abs(one.detail.numpy() - g_d).max() <= TOL_GOLDEN, n
            back = vt.imodwt(one._replace(approx=torch.as_tensor(g_a),
                                          detail=torch.as_tensor(g_d)), name,
                             boundary=boundary).numpy()
            assert np.abs(back - imodwt_golden(g_a, g_d, w, boundary)).max() <= TOL_GOLDEN, n
        golden = res._replace(details=tuple(torch.as_tensor(d) for d in g_details),
                              approx=torch.as_tensor(g_approx))
        back = vt.imodwt_multilevel(golden, name, boundary=boundary).numpy()
        if boundary == "periodic":  # the periodic MODWT inverts exactly
            want = x
        else:  # the zero and symmetric inverses are the reference's, not exact ones
            want = np.asarray(vw.imodwt_multilevel(vw.MultiLevelMODWTResult(
                tuple(jnp.asarray(d) for d in g_details), jnp.asarray(g_approx)),
                name, boundary=boundary, backend="jnp"))
        assert np.abs(back - want).max() <= TOL_GOLDEN, n
    assert mc.kernels_fit(w.filter_length, levels)
