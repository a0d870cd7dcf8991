"""Port parity: the continuous wavelets and the CWT (``transforms/cwt.py``,
``transforms/cwt_modwt_inverse.py``), mirroring ``tests/test_cwt.py``.

The same numpy inputs go through the JAX functions and the port's.  In
float64 both run the FFT path (or the direct path) on the CPU and agree
within 1e-10 of the largest coefficient; ``icwt``, the band
reconstructions and ``modwt_based_icwt`` read the same coefficients (carried
over with ``convert.cwt_result_from_arrays``) and agree as closely; the
wavelets' ``psi`` and the scale tools are the same numpy code and agree to
1e-14.  The kernel-direct tier has its own file
(``tests/test_torch_cwt_kernel_direct.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from vectorwave_tpu.transforms import cwt as jcwt
from vectorwave_tpu.transforms.cwt_modwt_inverse import modwt_based_icwt as j_modwt_icwt
from vectorwave_tpu_torch import convert
from vectorwave_tpu_torch.errors import InvalidArgumentError
from vectorwave_tpu_torch.transforms import cwt as tcwt

torch.set_num_threads(1)

TOL = 1e-10
#: every continuous wavelet of the JAX registry, aliases aside
CONTINUOUS = sorted(n for n in vw.available_wavelets()
                    if isinstance(vw.wavelet(n), vw.ContinuousWavelet))


@pytest.fixture(autouse=True)
def jnp_reference():
    """The JAX side on its jnp path (no Pallas tier, no banded inverse)."""
    vw.set_backend("jnp")
    try:
        yield
    finally:
        vw.set_backend("auto")


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


def _two_tone(n=1024):
    t = np.arange(n)
    return np.sin(2 * np.pi * t / 32) + 0.5 * np.sin(2 * np.pi * t / 128)


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300))


# (wavelet, method, analytic, boundary, shape, scales)
CWT_CASES = [
    ("morl", "fft", False, "zero", (1024,), vw.scales_log(2, 64, 8)),
    ("morl", "fft", False, "periodic", (2, 1024), vw.scales_log(2, 64, 8)),
    ("morl", "direct", False, "zero", (3, 512), vw.scales_log(2, 16, 6)),
    ("morl", "fft", True, "zero", (2, 512), vw.scales_log(2, 32, 5)),
    ("morl", "fft", True, "periodic", (512,), vw.scales_log(2, 32, 5)),
    ("morl", "direct", True, "zero", (512,), (4.0, 8.0)),
    ("cmor", "fft", False, "zero", (2, 1024), vw.scales_log(2, 64, 8)),
    ("cmor", "fft", False, "periodic", (1024,), vw.scales_log(2, 64, 8)),
    ("cmor", "direct", False, "zero", (2, 256), (2.0, 3.0, 5.0)),
    ("mexh", "fft", False, "periodic", (3, 512), vw.scales_log(1, 32, 7)),
    ("paul4", "fft", False, "zero", (512,), vw.scales_log(2, 32, 4)),
    ("gaus2", "direct", False, "zero", (2, 300), (1.5, 4.0)),
    ("meyr", "fft", False, "periodic", (1000,), vw.scales_log(2, 32, 5)),
    ("morse", "fft", False, "zero", (512,), (2.0, 8.0, 24.0)),
    ("shan", "fft", False, "periodic", (512,), (2.0, 6.0)),
    # batched over two leading axes
    ("morl", "fft", False, "zero", (2, 3, 256), (4.0, 8.0)),
    # a periodic span past N: the bank wraps onto itself
    ("morl", "fft", False, "periodic", (2, 300), (16.0, 64.0)),
    # FFT sizes past 2^16: the bank assembled on the device from its taps
    ("morl", "fft", False, "periodic", (66000,), (2.0, 8.0)),
    ("cmor", "fft", False, "zero", (40000,), (4096.0,)),
]


@pytest.mark.parametrize("name,method,analytic,boundary,shape,scales", CWT_CASES)
def test_cwt_matches_jax(name, method, analytic, boundary, shape, scales):
    x = _x(shape)
    ref = vw.cwt(jnp.asarray(x), scales, name, method=method, analytic=analytic,
                 boundary=boundary)
    got = vt.cwt(torch.from_numpy(x), scales, name, method=method, analytic=analytic,
                 boundary=boundary)
    assert got.coeffs.dtype == (torch.complex128 if np.iscomplexobj(ref.coeffs)
                                else torch.float64)
    assert got.scales == ref.scales and got.boundary == ref.boundary
    assert _rel(got.coeffs, ref.coeffs) <= TOL
    for part in ("magnitude", "power", "scalogram"):
        assert _rel(getattr(got, part)(), getattr(ref, part)()) <= TOL, part
    # the phase of a nearly real coefficient flips between -pi and pi, so it
    # is held through the coefficient it rebuilds
    if got.coeffs.is_complex():
        assert _rel(got.magnitude() * torch.exp(1j * got.phase()), ref.coeffs) <= TOL
    else:
        assert not got.phase().any() and not np.asarray(ref.phase()).any()
    assert got.n_scales == ref.n_scales


def test_cwt_config_matches_jax():
    x = _two_tone()
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    cases = [
        (vt.CWTConfig(boundary="zero", method="auto", fft_threshold=64), (4.0, 8.0)),
        (vt.CWTConfig(method="auto", fft_threshold=10**9), (2.0,)),  # auto: direct
        (vt.CWTConfig(fft_size=4096), (4.0, 8.0)),  # above the minimum
        (vt.CWTConfig(boundary="periodic", analytic=True), (8.0,)),
    ]
    for cfg, scales in cases:
        ref = vw.cwt(xj, scales, "morl", config=vw.CWTConfig(*cfg))
        got = vt.cwt(xt, scales, "morl", config=cfg)
        assert _rel(got.coeffs, ref.coeffs) <= TOL, cfg
        assert cfg.resolve_method(1024) == vw.CWTConfig(*cfg).resolve_method(1024)
    with pytest.raises(InvalidArgumentError):
        vt.cwt(xt, (4.0, 8.0), "morl", config=vt.CWTConfig(fft_size=8))
    with pytest.raises(vw.InvalidArgumentError):
        vw.cwt(xj, (4.0, 8.0), "morl", config=vw.CWTConfig(fft_size=8))
    assert vt.CWTConfig()._asdict() == vw.CWTConfig()._asdict()


def test_invalid_inputs_raise_as_in_jax():
    with pytest.raises(InvalidArgumentError):
        vt.cwt(torch.zeros(64), (2.0,), "db4")  # a discrete wavelet
    with pytest.raises(InvalidArgumentError):
        vt.cwt(torch.zeros(64), (0.0,), "morl")
    with pytest.raises(InvalidArgumentError):
        vt.cwt(torch.zeros(64), (), "morl")
    with pytest.raises(InvalidArgumentError):
        vt.cwt(torch.zeros(64), (2.0,), "morl", method="nope")
    with pytest.raises(vt.InvalidSignalError):
        vt.cwt(torch.zeros(2, 0), (2.0,), "morl")
    with pytest.raises(InvalidArgumentError):
        vt.modwt(torch.zeros(64), "morl")  # a continuous wavelet
    with pytest.raises(InvalidArgumentError):
        vt.icwt(vt.cwt(torch.zeros(64), (2.0,), "morl"), "db4")


def test_float32_input_stays_float32_and_int_input_computes_in_float32():
    x = _two_tone(512)
    got = vt.cwt(torch.from_numpy(x).float(), (4.0, 8.0), "morl")
    ref = vw.cwt(jnp.asarray(x, jnp.float32), (4.0, 8.0), "morl")
    assert got.coeffs.dtype == torch.float32
    assert _rel(got.coeffs.double(), np.asarray(ref.coeffs, np.float64)) <= 1e-5
    assert vt.cwt(torch.arange(64), (2.0,), "morl").coeffs.dtype == torch.float32
    assert vt.cwt(torch.from_numpy(x).float(), (4.0,), "cmor").coeffs.dtype == torch.complex64


def _carry(res):
    return convert.cwt_result_from_arrays(np.asarray(res.coeffs), res.scales, res.boundary,
                                          device="cpu")


# (wavelet, boundary, shape): the JAX package's inverse tests and a batch
INVERSE_CASES = [
    ("morl", "periodic", (1024,)),
    ("morl", "zero", (2, 1024)),
    ("mexh", "zero", (1024,)),
    ("cmor", "periodic", (1024,)),
    ("paul4", "periodic", (2, 512)),
    ("morse", "periodic", (1024,)),
]


@pytest.mark.parametrize("name,boundary,shape", INVERSE_CASES)
def test_inverse_and_band_reconstruction_match_jax(name, boundary, shape):
    x = np.broadcast_to(_two_tone(shape[-1]), shape) + 0.1 * _x(shape, seed=4)
    scales = vw.scales_log(2, 256, 48)
    ref = vw.cwt(jnp.asarray(x), scales, name, boundary=boundary)
    res = _carry(ref)
    fc = vw.wavelet(name).center_frequency
    pairs = [
        (vt.icwt(res, name), vw.icwt(ref, name)),
        (vt.icwt(res, name, equalize=False), vw.icwt(ref, name, equalize=False)),
        (vt.reconstruct_band(res, name, fc * 16, fc * 64),
         vw.reconstruct_band(ref, name, fc * 16, fc * 64)),
        (vt.reconstruct_frequency_band(res, name, 1 / 48, 1 / 22, dt=1.0),
         vw.reconstruct_frequency_band(ref, name, 1 / 48, 1 / 22, dt=1.0)),
    ]
    for i, (got, want) in enumerate(pairs):
        assert got.dtype == torch.float64
        assert _rel(got, want) <= TOL, i


@pytest.mark.parametrize("name", ["morl", "mexh", "paul4", "cmor", "morse"])
def test_icwt_periodic_near_exact(name):
    """The port's own round trip, as the JAX package's test holds its own."""
    x = _two_tone()
    scales = vt.scales_log(2, 256, 60)
    res = vt.cwt(torch.from_numpy(x), scales, name, boundary="periodic")
    xr = vt.icwt(res, name).numpy()
    assert np.sqrt(np.mean((xr - x) ** 2)) / np.std(x) < 1e-8


@pytest.mark.parametrize("name,approx", [("morl", True), ("morl", False), ("cmor", True)])
def test_modwt_based_icwt_matches_jax(name, approx):
    x = _two_tone() + 0.05 * _x(1024, seed=5)
    scales = vw.scales_log(2, 256, 48)
    ref = vw.cwt(jnp.asarray(x), scales, name, boundary="periodic")
    kw_j, kw_t = {}, {}
    if approx:
        kw_j["approx"] = vw.modwt_multilevel(jnp.asarray(x), "sym4", levels=5).approx
        kw_t["approx"] = torch.from_numpy(np.array(kw_j["approx"]))
    want = j_modwt_icwt(ref, name, **kw_j)
    got = vt.modwt_based_icwt(_carry(ref), name, **kw_t)
    assert _rel(got, want) <= TOL
    if approx and name == "morl":
        assert np.sqrt(np.mean((got.numpy() - x) ** 2)) / np.std(x) < 0.15


def test_scale_tools_match_jax():
    np.testing.assert_array_equal(vt.scales_linear(1, 10, 10), vw.scales_linear(1, 10, 10))
    np.testing.assert_array_equal(vt.scales_log(1, 16, 5), vw.scales_log(1, 16, 5))
    np.testing.assert_array_equal(vt.scales_dyadic(3), vw.scales_dyadic(3))
    np.testing.assert_array_equal(vt.scales_dyadic(4, voices_per_octave=3),
                                  vw.scales_dyadic(4, voices_per_octave=3))
    for name in ("morl", "cmor", "mexh"):
        for dt in (1.0, 0.01):
            np.testing.assert_allclose(vt.scale_to_frequency([2.0, 5.0], name, dt=dt),
                                       vw.scale_to_frequency([2.0, 5.0], name, dt=dt),
                                       rtol=1e-15)
            np.testing.assert_allclose(vt.frequency_to_scale(0.1, name, dt=dt),
                                       vw.frequency_to_scale(0.1, name, dt=dt), rtol=1e-15)
        assert vt.select_scales_optimal(1024, name) == vw.select_scales_optimal(1024, name)
        assert (vt.select_scales_optimal(4096, name, voices_per_octave=4, dt=0.5)
                == vw.select_scales_optimal(4096, name, voices_per_octave=4, dt=0.5))
    assert vt.estimate_scale_count(2.0, 40.0) == vw.estimate_scale_count(2.0, 40.0)
    assert (vt.estimate_scale_count(1.0, 3.0, scales_per_octave=7)
            == vw.estimate_scale_count(1.0, 3.0, scales_per_octave=7))
    with pytest.raises(InvalidArgumentError):
        vt.estimate_scale_count(10.0, 5.0)
    scales = vt.scales_log(2, 64, 9)
    assert (vt.frequency_range_of_scales(scales, "morl", 1000.0)
            == vw.frequency_range_of_scales(scales, "morl", 1000.0))
    assert vt.frequency_range_of_scales([], "morl", 1.0) == (0.0, 0.0)


@pytest.mark.parametrize("kind", ["two_tone", "noise", "constant"])
def test_signal_adaptive_selectors_match_jax(kind):
    fs = 1000.0
    t = np.arange(2048) / fs
    x = {"two_tone": np.sin(2 * np.pi * 50 * t) + 0.5 * np.sin(2 * np.pi * 120 * t),
         "noise": _x(2048, seed=6), "constant": np.ones(2048)}[kind]
    # a tensor on the host, as a caller of the port holds it
    xt = torch.from_numpy(x).float()
    x32 = xt.double().numpy()
    assert (vt.select_scales_signal_adaptive(xt, "morl", n_scales=16)
            == vw.select_scales_signal_adaptive(x32, "morl", n_scales=16))
    configs = [vt.ScaleSelectionConfig(sampling_rate=fs),
               vt.ScaleSelectionConfig(sampling_rate=fs, max_scales=16),
               vt.ScaleSelectionConfig(sampling_rate=fs, min_frequency=2.0,
                                       max_frequency=40.0, use_signal_adaptation=False)]
    configs += [cfg._replace(spacing=s) for cfg in configs[-1:] for s in ("linear", "dyadic")]
    for cfg in configs:
        got = vt.select_scales_adaptive(xt, "morl", cfg)
        want = vw.select_scales_adaptive(x32, "morl", vw.ScaleSelectionConfig(*cfg))
        assert got == want, cfg
    with pytest.raises(InvalidArgumentError):
        vt.select_scales_adaptive(xt, "morl", vt.ScaleSelectionConfig(fs, spacing="weird"))
    with pytest.raises(InvalidArgumentError):
        vt.select_scales_adaptive(xt, "morl", vt.ScaleSelectionConfig(0.0))


# (wavelet, method, boundary, analytic)
GRAD_CASES = [("morl", "fft", "periodic", False), ("morl", "fft", "zero", False),
              ("cmor", "fft", "zero", False), ("morl", "direct", "zero", True)]


@pytest.mark.parametrize("name,method,boundary,analytic", GRAD_CASES)
def test_gradient_matches_jax_grad(name, method, boundary, analytic):
    x = _x((2, 256), seed=7)
    scales = (2.0, 5.0, 12.0)
    wts = _x((2, 3, 256), seed=8)

    def loss_j(v):
        c = vw.cwt(v, scales, name, method=method, boundary=boundary,
                   analytic=analytic).coeffs
        return jnp.sum(wts * jnp.real(c)) + jnp.sum(wts * jnp.imag(c) ** 2)

    want = jax.grad(loss_j)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    c = vt.cwt(xt, scales, name, method=method, boundary=boundary, analytic=analytic).coeffs
    w_t = torch.from_numpy(wts)
    loss = (w_t * c.real).sum() + ((w_t * c.imag ** 2).sum() if c.is_complex() else 0.0)
    (got,) = torch.autograd.grad(loss, xt)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("name", CONTINUOUS)
def test_continuous_wavelets_match_jax(name):
    ours, ref = vt.wavelet(name), vw.wavelet(name)
    assert isinstance(ours, vt.ContinuousWavelet)
    assert (ours.name, ours.family, ours.center_frequency, ours.bandwidth, ours.is_complex,
            ours.description, ours.wavelet_type.value) == (
        ref.name, ref.family, ref.center_frequency, ref.bandwidth, ref.is_complex,
        ref.description, ref.wavelet_type.value)
    t = np.linspace(-12, 12, 2001)
    np.testing.assert_allclose(ours.psi(t), ref.psi(t), rtol=0, atol=1e-14)
    assert vt.supported_transforms(name) == (vt.TransformType.CWT,)
    assert vt.recommended_transform(name) is vt.TransformType.CWT
    assert vt.is_compatible(name, vt.TransformType.CWT)
    assert not vt.is_compatible(name, vt.TransformType.MODWT)


def test_continuous_aliases_and_types_match_jax():
    for alias in ("mexican_hat", "morlet", "paul", "dog", "gaussian", "ricker"):
        assert vt.wavelet(alias).name == vw.wavelet(alias).name
    for wtype in (vt.WaveletType.CONTINUOUS, vt.WaveletType.COMPLEX_CONTINUOUS):
        assert vt.wavelets_of_type(wtype) == vw.wavelets_of_type(vw.WaveletType(wtype.value))
    for family in ("Morlet", "ComplexGaussian", "Paul", "Hermitian", "Shannon"):
        assert vt.wavelets_in_family(family) == vw.wavelets_in_family(family)
    assert vt.as_wavelet(vt.wavelet("morl")) is vt.wavelet("morl")


def test_result_converter_checks_its_input():
    res = convert.cwt_result_from_arrays(np.zeros((2, 3, 8), np.complex64), (1, 2, 3),
                                         "periodic", device="cpu")
    assert res.coeffs.dtype == torch.complex64 and res.scales == (1.0, 2.0, 3.0)
    with pytest.raises(InvalidArgumentError):
        convert.cwt_result_from_arrays(np.zeros((2, 8)), (1, 2, 3), device="cpu")
    with pytest.raises(InvalidArgumentError):
        convert.cwt_result_from_arrays(np.zeros((3, 8)), (1, 2, 3), "edge", device="cpu")
    with pytest.raises(InvalidArgumentError):
        convert.cwt_result_from_arrays(np.zeros((1, 8)), (0,), device="cpu")


def test_bank_spectrum_is_computed_once():
    """The FFT path keeps each bank's spectrum per (wavelet, scales, FFT
    size, dtype, device): a second call reuses the same tensor."""
    w = vt.wavelet("morl")
    a = tcwt._bank_spectrum(w, (2.0, 4.0), 512, True, torch.complex64, torch.device("cpu"))
    b = tcwt._bank_spectrum(w, (2.0, 4.0), 512, True, torch.complex64, torch.device("cpu"))
    assert a is b and a.shape == (2, 257)
    ref = np.conj(np.fft.rfft(jcwt._sample_bank(vw.wavelet("morl"), (2.0, 4.0), 512)[0].real))
    assert _rel(a.to(torch.complex128), ref) <= 1e-7
