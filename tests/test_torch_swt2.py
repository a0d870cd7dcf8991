"""Port parity: the 2-D SWT facade (transforms/swt2.py).

Mirrors ``tests/test_swt2.py``.  The same seeded float64 image goes through
vectorwave_tpu (its jnp path on the CPU) and vectorwave_tpu_torch (the
plain cascade on the CPU); each port result is held to the JAX package's at
1e-12 max abs (the same float64 arithmetic in another order, values of
order 1), ``swt2_denoise``, whose MAD sigma passes through a sort, at 1e-10.
The JAX test's own property (round trip, additivity, noise reduction) is
checked as well.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from vectorwave_tpu_torch.errors import InvalidArgumentError

torch.set_num_threads(1)

TOL = 1e-12


@pytest.fixture
def img():
    return np.random.default_rng(0).standard_normal((64, 96))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


def test_swt2_roundtrip_periodic(img):
    res = vt.swt2(torch.from_numpy(img), "db4", levels=3)
    want = vw.swt2(jnp.asarray(img), "db4", levels=3)
    for g3, w3 in zip(res.details, want.details):
        for g, w in zip(g3, w3):
            _close(g, w)
    _close(res.approx, want.approx)
    xr = vt.iswt2(res, "db4")
    _close(xr, vw.iswt2(want, "db4"))
    _close(xr, img, 1e-10)


def test_swt2_equals_modwt2(img):
    a = vt.swt2(torch.from_numpy(img), "sym4", levels=2, boundary="zero")
    b = vt.modwt2_multilevel(torch.from_numpy(img), "sym4", levels=2, boundary="zero")
    assert torch.equal(a.approx, b.approx)
    assert vt.SWT2Result is vt.MultiLevelMODWT2Result
    _close(a.approx, vw.swt2(jnp.asarray(img), "sym4", levels=2, boundary="zero").approx)


@pytest.mark.parametrize("boundary", ["periodic", "symmetric"])
def test_mra2_additivity(img, boundary):
    bands = vt.mra2(torch.from_numpy(img), "db4", levels=3, boundary=boundary)
    want = vw.mra2(jnp.asarray(img), "db4", levels=3, boundary=boundary)
    assert len(bands) == len(want) == 4  # 3 detail scales + smooth
    for g, w in zip(bands, want):
        _close(g, w)
    if boundary == "periodic":
        _close(sum(bands), img, 1e-10)


def test_extract_level2_bands_sum(img):
    parts = [vt.extract_level2(torch.from_numpy(img), "haar", 2, t) for t in (0, 1, 2)]
    for t, p in zip((0, 1, 2), parts):
        _close(p, vw.extract_level2(jnp.asarray(img), "haar", 2, t))
    _close(sum(parts), img, 1e-10)
    with pytest.raises(InvalidArgumentError):
        vt.extract_level2(torch.from_numpy(img), "haar", 2, 3)


@pytest.mark.parametrize("boundary", ["periodic", "zero", "symmetric"])
def test_swt2_denoise_reduces_noise(boundary):
    rng = np.random.default_rng(1)
    yy, xx = np.meshgrid(np.linspace(0, 4 * np.pi, 64), np.linspace(0, 4 * np.pi, 64))
    clean = np.sin(xx) * np.cos(yy)
    noisy = clean + 0.3 * rng.standard_normal((64, 64))
    out = vt.swt2_denoise(torch.from_numpy(noisy), "db4", levels=3, boundary=boundary)
    _close(out, vw.swt2_denoise(jnp.asarray(noisy), "db4", levels=3, boundary=boundary),
           1e-10)
    if boundary != "symmetric":  # the symmetric inverse is approximate by design
        assert np.mean((out.numpy() - clean) ** 2) < np.mean((noisy - clean) ** 2)
