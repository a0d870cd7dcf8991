"""Port parity: the 2-D CWT (``transforms.cwt2``) and 2-D scattering
(``transforms.scattering2d``), mirroring ``tests/test_cwt2.py`` and
``tests/test_scattering2d.py``.

The same seeded numpy images go through the JAX package and the port in
float64.  Tolerances, with their reasons:

* the L2 norm of each wavelet: 1e-12 relative (the same float64 host sum);
* ``cwt2``, ``icwt2`` and the scattering coefficients: 1e-10 of the
  largest value (the same FFT products in another FFT library; the port
  transforms one scale at a time, the same operations per scale);
* the round trips: as ``tests/test_cwt2.py`` bounds them (1e-5 of the
  image's largest value periodic, 1e-4 on the real path).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from vectorwave_tpu.transforms import cwt2 as jc
from vectorwave_tpu_torch.errors import VectorWaveError
from vectorwave_tpu_torch.transforms import cwt2 as tc

torch.set_num_threads(1)

TOL = 1e-10


def _rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _t(a):
    return torch.from_numpy(np.array(a))


def _code(exc_info) -> str:
    return exc_info.value.code.value


def _bandlimited(shape, lo, hi, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal(shape)
    ky, kx = np.meshgrid(np.fft.fftfreq(shape[-2]), np.fft.fftfreq(shape[-1]), indexing="ij")
    r = np.hypot(ky, kx)
    img = np.real(np.fft.ifft2(np.fft.fft2(img) * ((r > lo) & (r < hi))))
    return img - img.mean(axis=(-2, -1), keepdims=True)


#: (port wavelet, JAX wavelet, angles) of each family
WAVELETS = {
    "morl2": (vt.morlet2(), vw.morlet2(), (0.0, math.pi / 5, 2.0)),
    "morl2-aniso": (vt.morlet2(6.0, aniso=2.0), vw.morlet2(6.0, aniso=2.0), (0.3,)),
    "mexh2": (vt.mexican_hat2(), vw.mexican_hat2(), (0.0,)),
    "gaus3d": (vt.gaussian2(3, directional=True), vw.gaussian2(3, directional=True),
               (0.0, 1.0)),
    "gaus2": (vt.gaussian2(2), vw.gaussian2(2), (0.0,)),
}


@pytest.mark.parametrize("key", sorted(WAVELETS))
def test_wavelet_definitions_match_jax(key):
    tw, jw, _ = WAVELETS[key]
    assert (tw.name, tw.is_complex, tw.isotropic, tw.peak_freq) == (
        jw.name, jw.is_complex, jw.isotropic, jw.peak_freq)
    assert tc._l2_norm(tw) == pytest.approx(jc._l2_norm(jw), rel=1e-12)
    k = np.linspace(-6, 6, 41)
    kx, ky = np.meshgrid(k, k, indexing="ij")
    assert _rel(tw.psi_hat(_t(kx), _t(ky)), jw.psi_hat(kx, ky)) <= 1e-14


@pytest.mark.parametrize("key,boundary,shape", [
    ("morl2", "periodic", (48, 40)), ("mexh2", "periodic", (2, 32, 32)),
    ("gaus3d", "zero", (24, 20)), ("gaus2", "zero", (2, 20, 24)),
    ("morl2-aniso", "periodic", (3, 16, 16))])
def test_cwt2_and_icwt2_match_jax(key, boundary, shape):
    tw, jw, angles = WAVELETS[key]
    img = _bandlimited(shape, 0.03, 0.35)
    scales = (1.5, 3.0) if boundary == "zero" else (1.5, 3.0, 6.0)
    # the JAX calls under one jit each (their eager form compiles op by op)
    coeffs = jax.jit(lambda z: vw.cwt2(z, scales, jw, angles=angles,
                                       boundary=boundary).coeffs)(jnp.asarray(img))
    want = vw.CWT2Result(coeffs, scales, tuple(angles), boundary)
    got = vt.cwt2(_t(img), scales, tw, angles=angles, boundary=boundary)
    assert got.coeffs.is_complex() == bool(jnp.iscomplexobj(coeffs))
    assert got.coeffs.dtype == (torch.complex128 if tw.is_complex else torch.float64)
    assert (got.scales, got.angles, got.boundary) == (want.scales, want.angles, want.boundary)
    assert _rel(got.coeffs, coeffs) <= TOL
    power = np.abs(np.asarray(coeffs)) ** 2
    assert _rel(got.scalogram(), power.sum(axis=(-2, -1))) <= TOL
    assert _rel(got.magnitude(), np.sqrt(power)) <= TOL
    orient = np.asarray(angles, np.float32)[power.max(axis=-4).argmax(axis=-3)]
    assert torch.equal(got.dominant_orientation(), _t(orient))
    rec = vt.icwt2(got, tw, mean=0.25, floor=2e-3)
    want_rec = jax.jit(lambda c: vw.icwt2(vw.CWT2Result(c, scales, tuple(angles), boundary),
                                          jw, mean=0.25, floor=2e-3))(coeffs)
    assert _rel(rec, want_rec) <= TOL


def test_float32_keeps_complex64_and_the_jax_numbers():
    img = _bandlimited((2, 32, 32), 0.03, 0.3).astype(np.float32)
    got = vt.cwt2(_t(img), (2.0, 4.0), "morl2", angles=(0.0, math.pi / 2))
    want = jax.jit(lambda z: vw.cwt2(z, (2.0, 4.0), "morl2", angles=(0.0, math.pi / 2)).coeffs)(
        jnp.asarray(img))
    assert got.coeffs.dtype == torch.complex64 and _rel(got.coeffs, want) <= 1e-5
    assert vt.icwt2(got, "morl2").dtype == torch.float32


@pytest.mark.parametrize("chunk_scales", [1, 2])
def test_chunks_of_scales_give_the_whole_call(monkeypatch, chunk_scales):
    """Scales taken a chunk at a time (a byte budget of one or two scales'
    products, as at 1024^2 on the card) give the one-chunk call's
    coefficients and inverse."""
    img = _t(_bandlimited((2, 24, 20), 0.03, 0.35))
    for name, angles, boundary in (("morl2", (0.0, 1.0), "periodic"),
                                   ("morl2", (0.0, 1.0), "zero"), ("mexh2", (0.0,), "zero")):
        whole = vt.cwt2(img, (1.5, 3.0, 6.0), name, angles=angles, boundary=boundary)
        rec = vt.icwt2(whole, name)
        per_scale = whole.coeffs[..., 0, :, :, :].numel() * 16  # complex128, periodic
        monkeypatch.setattr(tc, "_CHUNK_BYTES", chunk_scales * per_scale)
        got = vt.cwt2(img, (1.5, 3.0, 6.0), name, angles=angles, boundary=boundary)
        assert (got.coeffs - whole.coeffs).abs().max().item() <= 1e-12
        assert (vt.icwt2(got, name) - rec).abs().max().item() <= 1e-12
        monkeypatch.undo()


@pytest.mark.parametrize("angles_mode", ["half", "full"])
def test_icwt2_morlet_in_band_round_trip(angles_mode):
    """As ``tests/test_cwt2.py``: a band-limited image back within 1e-5 of
    its largest value, the angles over [0, pi) or the full circle."""
    img = _bandlimited((64, 64), 0.03, 0.3)
    scales = tuple(np.geomspace(2.5, 30, 12))
    stop = math.pi if angles_mode == "half" else 2 * math.pi
    angles = tuple(np.linspace(0, stop, 8 if angles_mode == "half" else 16, endpoint=False))
    rec = vt.icwt2(vt.cwt2(_t(img), scales, "morl2", angles=angles), "morl2")
    assert (rec - _t(img)).abs().max().item() < 1e-5 * np.abs(img).max()


def test_icwt2_mexh_real_path_and_mean():
    img = _bandlimited((48, 48), 0.05, 0.3) + 2.5
    res = vt.cwt2(_t(img), tuple(np.geomspace(0.8, 6, 24)), "mexh2")
    assert not res.coeffs.is_complex()
    rec = vt.icwt2(res, "mexh2", mean=float(img.mean()))
    assert (rec - _t(img)).abs().max().item() < 1e-4 * np.abs(img - img.mean()).max()


def test_oriented_stripes_peak_at_the_expected_scale_and_angle():
    h = w = 64
    theta0, f0 = math.pi / 3, 0.09
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.cos(2 * np.pi * f0 * (math.cos(theta0) * xx + math.sin(theta0) * yy))
    scales = tuple(np.geomspace(3, 30, 16))
    angles = tuple(np.linspace(0, np.pi, 12, endpoint=False))
    res = vt.cwt2(_t(img), scales, "morl2", angles=angles)
    si, ai = np.unravel_index(int(res.scalogram().argmax()), (16, 12))
    assert abs(math.log(scales[si] / (vt.morlet2().peak_freq / (2 * np.pi * f0)))) \
        < math.log(1.3)
    assert abs(angles[ai] - theta0) <= np.pi / 12 + 1e-9


def test_scale_helpers_and_rotation_invariance():
    for f in (0.02, 0.1, 0.3):
        (s,) = vt.scales_for_frequencies2("mexh2", [f])
        assert vt.scale_to_frequency2("mexh2", s) == pytest.approx(f)
        assert s == vw.scales_for_frequencies2("mexh2", [f])[0]
    img = _t(_bandlimited((32, 32), 0.05, 0.3))
    base = vt.cwt2(img, (3.0,), "mexh2")
    rot = vt.ContinuousWavelet2D("mexh2", vt.mexican_hat2().psi_hat, False, False,
                                 math.sqrt(2.0))
    got = vt.cwt2(img, (3.0,), rot, angles=(1.1,))
    assert (got.coeffs - base.coeffs).abs().max().item() < 1e-5


@pytest.mark.parametrize("call,code", [
    (lambda img: vt.cwt2(img, (), "morl2"), "VAL_002"),
    (lambda img: vt.cwt2(img, (-1.0,), "morl2"), "CFG_003"),
    (lambda img: vt.cwt2(img, (2.0,), "mexh2", angles=(0.0, 1.0)), "CFG_003"),
    (lambda img: vt.cwt2(img[0], (2.0,), "morl2"), "VAL_007"),  # 1-D input
    (lambda img: vt.cwt2(img[:1, :1], (2.0,), "morl2"), "VAL_004"),
    (lambda img: vt.cwt2(img, (2.0,), "nosuch2"), "CFG_001"),
    (lambda img: vt.cwt2(img, (2.0,), 3), "CFG_001"),
    (lambda img: vt.cwt2(img, (2.0,), "morl2", boundary="reflect"), "CFG_002"),
    (lambda img: vt.morlet2(omega0=1.0), "CFG_003"),
    (lambda img: vt.gaussian2(0), "CFG_003"),
    (lambda img: vt.scales_for_frequencies2("morl2", [0.0]), "CFG_003"),
])
def test_cwt2_validation(call, code):
    with pytest.raises(VectorWaveError) as got:
        call(torch.zeros(16, 16))
    assert _code(got) == code


# --- 2-D scattering ---------------------------------------------------------------------


def _jax_scattering(x, kwargs):
    """The JAX package's 2-D scattering under one jit (its eager form
    compiles op by op)."""
    return jax.jit(lambda z: (lambda r: (r.s0, r.s1, r.s2, r.feature_vector()))(
        vw.scattering2d(z, **kwargs)))(jnp.asarray(x))


@pytest.mark.parametrize("shape,kwargs", [
    ((32, 32), {"J": 3, "L": 4}), ((2, 32, 48), {"J": 2, "L": 3, "aniso": 1.0}),
    ((16, 16), {"J": 2, "L": 4, "order": 1}), ((16, 16), {"J": 1, "L": 2, "stride": 1})])
def test_scattering2d_matches_jax(shape, kwargs):
    """Orders 1 and 2, a batch, full rate, and J = 1 (no second-order path:
    the pairs need j2 > j1)."""
    x = np.random.default_rng(2).standard_normal(shape)
    s0, s1, s2, feats = _jax_scattering(x, kwargs)
    got = vt.scattering2d(_t(x), **kwargs)
    J, L = kwargs["J"], kwargs["L"]
    assert got.meta1 == tuple((j, i) for j in range(J) for i in range(L))
    assert _rel(got.s0, s0) <= TOL and _rel(got.s1, s1) <= TOL
    if s2 is None:
        assert got.s2 is None and got.pairs == ()
    else:
        assert len(got.pairs) == s2.shape[-3]
        if s2.size:
            assert _rel(got.s2, s2) <= TOL
        else:
            assert got.s2.shape == s2.shape
    assert _rel(got.feature_vector(), feats) <= TOL
    assert float(got.s1.min()) >= 0.0
    np.testing.assert_allclose(got.angle_energy(0).numpy(),
                               (got.s1[..., :L, :, :] ** 2).sum(dim=(-2, -1)).numpy())


def test_scattering2d_angle_profile_follows_the_texture():
    n = 64
    yy, xx = np.mgrid[0:n, 0:n]
    for deg, expected in ((0, 0), (45, 2), (90, 4), (135, 6)):
        th = np.deg2rad(deg)
        img = np.cos(2 * np.pi * 0.12 * (np.cos(th) * xx + np.sin(th) * yy))
        res = vt.scattering2d(_t(img), J=3, L=8, order=1)
        energies = torch.stack([res.angle_energy(j) for j in range(3)])
        j = int(energies.sum(dim=1).argmax())
        assert int(energies[j].argmax()) == expected, (deg, energies[j])


@pytest.mark.parametrize("call,code", [
    (lambda: vt.scattering2d(torch.zeros(64), J=2), "VAL_007"),
    (lambda: vt.scattering2d(torch.zeros(60, 64), J=3), "VAL_007"),  # stride must divide
    (lambda: vt.scattering2d(torch.zeros(64, 64), J=3, order=5), "CFG_003"),
    (lambda: vt.scattering2d(torch.zeros(8, 8), J=4, stride=1), "VAL_004"),
])
def test_scattering2d_validation(call, code):
    with pytest.raises(VectorWaveError) as got:
        call()
    assert _code(got) == code
