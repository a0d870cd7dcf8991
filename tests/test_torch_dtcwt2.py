"""Port parity: the 2-D dual-tree complex wavelet transform
(``transforms/dtcwt2.py``) and ``dtcwt2_denoise``, mirroring
``tests/test_dtcwt2.py``.

The same seeded numpy images go through the JAX functions and the port's:
within 1e-10 in float64 (complex128 subbands); the port's float32
(complex64) within 1e-5 of the JAX float64 values.  The JAX references run
eagerly on one image shape with db2 at level 1 and 2 levels, so their ops
compile once for the whole file (their jitted form takes 5-20 s a
compile).  The behavioural checks of the JAX tests
(perfect reconstruction, the energy identity, quadrant localization,
orientation discrimination, shift robustness, validation) run on the port.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu_torch as vt
from vectorwave_tpu.denoise.dtcwt_shrink import dtcwt2_denoise as jax_dtcwt2_denoise
from vectorwave_tpu.transforms import dtcwt2 as jd2
from vectorwave_tpu_torch import convert
from vectorwave_tpu_torch.errors import VectorWaveError

torch.set_num_threads(1)

TOL, TOL_F32 = 1e-10, 1e-5


def _x(shape, seed=0, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, np.abs(want).max()))


SHAPE, WAVELET, LEVELS = (2, 16, 32), "db2", 2


@functools.lru_cache(maxsize=None)
def _jax_reference():
    img = _x(SHAPE, seed=1)
    res = jd2.dtcwt2(jnp.asarray(img), WAVELET, levels=LEVELS)
    return img, res, jd2.idtcwt2(res, WAVELET)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dtcwt2_and_inverse_match_jax(dtype):
    img, want, want_rec = _jax_reference()
    tol = TOL if dtype == np.float64 else TOL_F32
    got = vt.dtcwt2(torch.from_numpy(img.astype(dtype)), WAVELET, levels=LEVELS)
    assert got.levels == LEVELS
    cdtype = torch.complex128 if dtype == np.float64 else torch.complex64
    for g, w in zip(got.highpasses, want.highpasses):
        assert g.dtype == cdtype
        _close(g.to(torch.complex128), w, tol)
    _close(got.lowpasses.double(), want.lowpasses, tol)
    for level in (1, LEVELS):
        _close(got.orientation_energy(level).double(), want.orientation_energy(level), tol)
    _close(got.magnitudes()[1].double(), want.magnitudes()[1], tol)
    _close(vt.idtcwt2(got, WAVELET).double(), want_rec, tol)
    if dtype == np.float64:  # the JAX coefficients carried across, inverted by the port
        carried = convert.dtcwt2_result_from_arrays([np.asarray(z) for z in want.highpasses],
                                                    np.asarray(want.lowpasses), device="cpu")
        _close(vt.idtcwt2(carried, WAVELET), want_rec)


@pytest.mark.parametrize("noise_sigma", [None, 0.3])
def test_dtcwt2_denoise_matches_jax(noise_sigma):
    yy, xx = np.mgrid[0:SHAPE[-2], 0:SHAPE[-1]]
    clean = np.sin(2 * np.pi * (3 * xx + 2 * yy) / 16)
    noisy = clean + 0.3 * _x(SHAPE, seed=4)
    got = vt.dtcwt2_denoise(torch.from_numpy(noisy), WAVELET, levels=LEVELS,
                            noise_sigma=noise_sigma)
    want = jax_dtcwt2_denoise(jnp.asarray(noisy), WAVELET, levels=LEVELS, noise_sigma=noise_sigma)
    _close(got, want)
    assert np.mean((got.numpy() - clean) ** 2) < np.mean((noisy - clean) ** 2)


def test_dtcwt2_denoise_median_is_over_each_band_plane():
    """An even count of samples per band: the MAD is the mean of the two
    middle values over the whole plane, per image and orientation."""
    from vectorwave_tpu_torch.denoise.packet import _median_last

    finest = vt.dtcwt2(torch.from_numpy(_x((2, 16, 16), seed=6)), levels=2).highpasses[0].real
    flat = finest.reshape(2, 6, -1)
    got = _median_last((flat - _median_last(flat)).abs())
    re = finest.numpy()
    want = jnp.median(jnp.abs(re - jnp.median(re, axis=(-2, -1), keepdims=True)),
                      axis=(-2, -1), keepdims=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[..., 0])


@pytest.mark.parametrize("shape", [(64, 64), (2, 64, 96)])
def test_perfect_reconstruction(shape):
    img = torch.from_numpy(_x(shape, dtype=np.float32))
    res = vt.dtcwt2(img, levels=3)
    assert float((vt.idtcwt2(res) - img).abs().max()) < 2e-5
    assert tuple(res.highpasses[0].shape) == shape[:-2] + (6, shape[-2] // 2, shape[-1] // 2)
    assert tuple(res.lowpasses.shape) == shape[:-2] + (4, shape[-2] // 8, shape[-1] // 8)


def test_energy_identity():
    img = torch.from_numpy(_x((64, 64), seed=1))
    res = vt.dtcwt2(img, levels=3)
    hp = sum(float((z.abs() ** 2).sum()) for z in res.highpasses)
    lp = float((res.lowpasses**2).sum())
    # four orthonormal trees; complex bands carry half the 4-tree energy
    assert (2 * hp + lp) / 4 == pytest.approx(float((img**2).sum()), rel=1e-10)


def _effective_wavelet_spectrum(band, level=3, n=128):
    """|FFT|^2 of the band's effective complex wavelet (two inversions)."""
    res0 = vt.dtcwt2(torch.zeros(n, n, dtype=torch.float64), levels=level)
    out = []
    for val in (1.0, 1j):
        hp = [torch.zeros_like(z) for z in res0.highpasses]
        hp[level - 1][band, 8, 8] = val
        out.append(vt.idtcwt2(vt.DTCWT2Result(tuple(hp), torch.zeros_like(res0.lowpasses)))
                   .numpy())
    return np.abs(np.fft.fft2(out[0] - 1j * out[1])) ** 2


@pytest.mark.parametrize("band", range(6))
def test_quadrant_localization(band):
    n = 128
    fy = np.fft.fftfreq(n)[:, None]
    fx = np.fft.fftfreq(n)[None, :]
    quads = [(fy < 0) & (fx > 0), (fy > 0) & (fx > 0), (fy > 0) & (fx < 0),
             (fy < 0) & (fx < 0), (fy > 0) & (fx > 0), (fy < 0) & (fx > 0)]
    energy = _effective_wavelet_spectrum(band)
    frac = energy[quads[band]].sum() / energy.sum()
    # HH bands are near-perfect; LH / HL keep the construction's mirror leakage
    assert frac > (0.97 if band >= 4 else 0.75), (band, frac)


@pytest.mark.parametrize("deg, f0, expected", [
    (-15, 0.09, 0), (15, 0.09, 1), (-75, 0.09, 2), (75, 0.09, 3), (45, 0.13, 4), (-45, 0.13, 5),
])
def test_oriented_gratings_pick_their_band(deg, f0, expected):
    n = 128
    yy, xx = np.mgrid[0:n, 0:n]
    th = np.deg2rad(deg)
    gr = np.cos(2 * np.pi * f0 * (np.cos(th) * xx + np.sin(th) * yy)).astype(np.float32)
    oe = vt.dtcwt2(torch.from_numpy(gr), levels=3).orientation_energy(3).numpy()
    assert int(np.argmax(oe)) == expected, (deg, oe / oe.sum())
    assert oe[expected] / oe.sum() > 0.45, (deg, oe / oe.sum())


def test_magnitude_shift_robustness():
    img = _x((128, 128), seed=2, dtype=np.float32)
    base = vt.dtcwt2(torch.from_numpy(img), levels=3).highpasses[2].abs().numpy()
    devs = []
    for sy, sx in ((4, 0), (0, 4), (4, 4)):
        shifted = np.roll(img, (sy, sx), axis=(0, 1))
        mag = vt.dtcwt2(torch.from_numpy(shifted), levels=3).highpasses[2].abs().numpy()
        e0, e1 = base.reshape(6, -1).sum(axis=1), mag.reshape(6, -1).sum(axis=1)
        devs.append(np.max(np.abs(e1 - e0) / e0))
    assert max(devs) < 0.06, devs


def test_validation():
    with pytest.raises(VectorWaveError):
        vt.dtcwt2(torch.zeros(64), levels=2)  # 1-D input
    with pytest.raises(VectorWaveError):
        vt.dtcwt2(torch.zeros(60, 64), levels=3)  # 60 % 8 != 0
    with pytest.raises(VectorWaveError):
        vt.dtcwt2(torch.zeros(64, 64), levels=0)
    with pytest.raises(VectorWaveError):
        vt.dtcwt2(torch.zeros(64, 64), "bior2.2", levels=2)  # level 1 must be orthogonal
    with pytest.raises(VectorWaveError):  # real highpasses
        convert.dtcwt2_result_from_arrays([np.zeros((6, 8, 8))], np.zeros((4, 8, 8)), device="cpu")
