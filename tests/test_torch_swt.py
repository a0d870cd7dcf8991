"""Port parity: SWT, decimated DWT, padding and single-level denoising.

Mirrors ``tests/test_denoise_swt.py``, ``tests/test_dwt.py`` and config #3
of ``tests/test_baseline_configs.py``.  The same seeded float64 inputs go
through vectorwave_tpu (jnp) and vectorwave_tpu_torch (plain PyTorch on the
CPU); each port result is held to the JAX package's at 1e-12 max abs (the
same float64 arithmetic in another order, values of order 1), and the
symmetric config #3 denoise, whose MAD sigma and universal threshold pass
through a sort, at 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from vectorwave_tpu_torch import convert
from vectorwave_tpu_torch.errors import InvalidArgumentError

from .conftest import composite_sin

torch.set_num_threads(1)

TOL = 1e-12


def _noisy(n=512, noise=0.5, seed=3):
    rng = np.random.default_rng(seed)
    clean = composite_sin(n)
    return clean, clean + rng.normal(0, noise, n)


def _port_wavelet(name):
    if name.startswith("bior"):
        w = vw.wavelet(name)
        return convert.wavelet_from_arrays(name, w.dec_lo, w.dec_hi, w.rec_lo, w.rec_hi)
    return name


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


# --- SWT ----------------------------------------------------------------------------


@pytest.mark.parametrize("boundary", ["periodic", "symmetric"])
def test_swt_roundtrip_and_threshold(boundary):
    clean, noisy = _noisy(noise=1.0)
    res = vt.swt(_t(noisy), "sym8", levels=4, boundary=boundary)
    ref = vw.swt(jnp.asarray(noisy), "sym8", levels=4, boundary=boundary)
    for g, w in zip((*res.details, res.approx), (*ref.details, ref.approx)):
        _close(g, w)
    back = vt.iswt(res, "sym8", boundary=boundary)
    _close(back, vw.iswt(ref, "sym8", boundary=boundary))
    if boundary == "periodic":
        _close(back, noisy, 1e-9)
    den = vt.iswt(vt.apply_universal_threshold(res), "sym8", boundary=boundary)
    _close(den, vw.iswt(vw.apply_universal_threshold(ref), "sym8", boundary=boundary))
    assert np.mean((den.numpy() - clean) ** 2) < np.mean((noisy - clean) ** 2)
    res2 = vt.threshold_level(res, 1, 10.0)
    assert not torch.allclose(res2.details[0], res.details[0])
    _close(res2.details[0], vw.threshold_level(ref, 1, 10.0).details[0])
    assert isinstance(res, vt.SWTResult)


@pytest.mark.parametrize("threshold", [None, 0.8, -1.0])
@pytest.mark.parametrize("mode", ["soft", "hard"])
def test_swt_denoise_convenience(threshold, mode):
    clean, noisy = _noisy(noise=1.0)
    den = vt.swt_denoise(_t(noisy), "db4", levels=4, threshold=threshold, mode=mode)
    _close(den, vw.swt_denoise(jnp.asarray(noisy), "db4", levels=4, threshold=threshold,
                               mode=mode))
    if threshold is None:
        assert np.mean((den.numpy() - clean) ** 2) < np.mean((noisy - clean) ** 2)


def test_extract_level_bands_sum_to_signal():
    x = composite_sin(256, noise_std=0.1)
    levels = 3
    bands = [vt.extract_level(_t(x), "db4", levels, target) for target in range(levels + 1)]
    _close(sum(b.numpy() for b in bands), x, 1e-10)
    for target, band in enumerate(bands):
        _close(band, vw.extract_level(jnp.asarray(x), "db4", levels, target))
    with pytest.raises(InvalidArgumentError):
        vt.extract_level(_t(x), "db4", levels, levels + 1)


@pytest.mark.parametrize("boundary", ["periodic", "symmetric"])
def test_mra_bands_sum_to_signal(boundary):
    x = composite_sin(256, noise_std=0.1)
    bands = vt.mra(_t(x), "db4", levels=3, boundary=boundary)
    ref = vw.mra(jnp.asarray(x), "db4", levels=3, boundary=boundary)
    assert len(bands) == len(ref) == 4
    for g, w in zip(bands, ref):
        _close(g, w)
    if boundary == "periodic":
        _close(sum(b.numpy() for b in bands), x, 1e-10)


# --- padding --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "strategy",
    [
        "zero", "constant", "periodic", "symmetric", "reflect", "antisymmetric",
        "linear_extrapolation", "polynomial_extrapolation", "statistical", "composite",
    ],
)
def test_padding_strategies(strategy):
    x = composite_sin(50)
    for align in ("right", "left", "symmetric"):
        out = vt.pad_signal(_t(x), 64, strategy, align=align)
        assert out.shape == (64,)
        _close(out, vw.pad_signal(jnp.asarray(x), 64, strategy, align=align))
    _close(vt.pad_signal(_t(x), 64, strategy)[:50], x)
    _close(vt.pad_signal(_t(x), 64, strategy, align="symmetric")[7:57], x)


def test_padding_options_and_batches():
    x = np.stack([composite_sin(40, seed=s, noise_std=0.2) for s in range(3)])
    for strategy, options in (("statistical", {"method": "median"}),
                              ("polynomial_extrapolation", {"order": 2, "window": 10}),
                              ("composite", {"left": "zero", "right": "reflect"})):
        got = vt.pad_signal(_t(x), 57, strategy, align="symmetric", **options)
        _close(got, vw.pad_signal(jnp.asarray(x), 57, strategy, align="symmetric",
                                  **options))
    assert vt.pad_signal(_t(x), 40, "zero") is not None


def test_padding_semantics():
    x = _t([1.0, 2.0, 3.0])
    _close(vt.pad_signal(x, 5, "zero"), [1, 2, 3, 0, 0])
    _close(vt.pad_signal(x, 5, "constant"), [1, 2, 3, 3, 3])
    _close(vt.pad_signal(x, 5, "periodic"), [1, 2, 3, 1, 2])
    _close(vt.pad_signal(x, 5, "symmetric"), [1, 2, 3, 3, 2])
    _close(vt.pad_signal(x, 5, "reflect"), [1, 2, 3, 2, 1])
    _close(vt.pad_signal(x, 5, "linear_extrapolation"), [1, 2, 3, 4, 5])
    with pytest.raises(InvalidArgumentError):
        vt.pad_signal(x, 5, "mirror")
    with pytest.raises(InvalidArgumentError):
        vt.pad_signal(x, 5, "zero", align="middle")
    with pytest.raises(InvalidArgumentError):
        vt.pad_signal(x, 5, "statistical", method="mode")
    assert set(vt.PADDING_STRATEGIES) == set(vw.PADDING_STRATEGIES)


def test_adaptive_padding_chooser():
    t = np.arange(128)
    periodic = np.sin(2 * np.pi * t / 16)
    assert vt.adaptive_strategy(periodic) == "periodic"
    assert vt.adaptive_strategy(torch.from_numpy(periodic)) == "periodic"
    trend = 0.5 * t + np.random.default_rng(0).normal(0, 0.1, 128)
    assert vt.adaptive_strategy(trend) == "linear_extrapolation"
    rough = np.random.default_rng(0).standard_normal(128)
    assert vt.adaptive_strategy(rough) == "symmetric"
    for x in (periodic, trend, rough, np.linspace(0, 1, 128) ** 3, np.ones(5)):
        assert vt.adaptive_strategy(x) == vw.adaptive_strategy(x)
    _close(vt.pad_signal(_t(trend), 150, "adaptive"),
           vw.pad_signal(jnp.asarray(trend), 150, "adaptive"))
    with pytest.raises(InvalidArgumentError):
        vt.pad_signal(torch.zeros(10), 5, "zero")


# --- denoising --------------------------------------------------------------------------


def test_batched_denoise():
    _, noisy = _noisy()
    batch = np.stack([noisy, noisy * 0.5])
    den = vt.denoise_multilevel(_t(batch), "db4", levels=3)
    assert den.shape == (2, 512)
    single = vt.denoise_multilevel(_t(noisy), "db4", levels=3)
    _close(den[0], single, 1e-10)
    _close(den, vw.denoise_multilevel(jnp.asarray(batch), "db4", levels=3))


@pytest.mark.parametrize("method", ["universal", "sure", "minimax", "bayes"])
@pytest.mark.parametrize("boundary", ["periodic", "symmetric"])
def test_denoise_single_level(method, boundary):
    clean, noisy = _noisy(noise=0.3)
    den = vt.denoise(_t(noisy), "db4", method=method, boundary=boundary)
    _close(den, vw.denoise(jnp.asarray(noisy), "db4", method=method, boundary=boundary))
    if method == "universal" and boundary == "periodic":
        assert np.mean((den.numpy() - clean) ** 2) < np.mean((noisy - clean) ** 2)


def test_denoise_fixed_zero_threshold_is_identity():
    _, noisy = _noisy()
    _close(vt.denoise_fixed(_t(noisy), "db4", 0.0), noisy, 1e-10)


@pytest.mark.parametrize("mode", ["soft", "hard"])
def test_denoise_fixed_matches_jax(mode):
    _, noisy = _noisy()
    _close(vt.denoise_fixed(_t(noisy), "sym8", 0.4, mode=mode),
           vw.denoise_fixed(jnp.asarray(noisy), "sym8", 0.4, mode=mode))


# --- decimated DWT ------------------------------------------------------------------


def _oracle_down(x, f, boundary, offset=0):
    n = len(x)
    out = np.zeros(n // 2)
    for i in range(n // 2):
        for j, fj in enumerate(f):
            idx = 2 * i + j + offset
            if boundary == "periodic":
                out[i] += x[idx % n] * fj
            elif idx < n:
                out[i] += x[idx] * fj
    return out


def _oracle_up(c, f, n_out):
    out = np.zeros(n_out)
    for i, ci in enumerate(c):
        for j, fj in enumerate(f):
            out[(2 * i + j) % n_out] += ci * fj
    return out


@pytest.mark.parametrize("boundary", ["periodic", "zero"])
@pytest.mark.parametrize("name", ["haar", "db4", "sym8", "bior2.2"])
def test_dwt_matches_oracle_and_jax(name, boundary):
    from vectorwave_tpu_torch.ops.dwt import _bior_parities

    x = composite_sin(128, noise_std=0.3)
    w = vw.wavelet(name)
    pw = _port_wavelet(name)
    p_h, p_g = _bior_parities(vt.as_wavelet(pw))
    res = vt.dwt(_t(x), pw, boundary=boundary)
    _close(res.approx, _oracle_down(x, w.dec_lo, boundary, p_h))
    _close(res.detail, _oracle_down(x, w.dec_hi, boundary, p_g))
    ref = vw.dwt(jnp.asarray(x), name, boundary=boundary)
    _close(res.approx, ref.approx)
    _close(res.detail, ref.detail)
    _close(vt.idwt(res.approx, res.detail, pw, boundary=boundary),
           vw.idwt(ref.approx, ref.detail, name, boundary=boundary))


def test_idwt_matches_oracle():
    x = composite_sin(64, seed=2)
    w = vw.wavelet("db4")
    res = vt.dwt(_t(x), "db4")
    rec = vt.idwt(res.approx, res.detail, "db4")
    expected = _oracle_up(res.approx.numpy(), w.rec_lo, 64) + _oracle_up(
        res.detail.numpy(), w.rec_hi, 64)
    _close(rec, expected)


def test_haar_closed_form():
    x = composite_sin(32, seed=4)
    res = vt.dwt(_t(x), "haar")
    s = 1.0 / np.sqrt(2.0)
    _close(res.approx, s * (x[0::2] + x[1::2]))
    _close(res.detail, s * (x[0::2] - x[1::2]))


@pytest.mark.parametrize("name", ["haar", "db2", "db4", "sym8", "bior2.2"])
def test_perfect_reconstruction_periodic(name):
    x = composite_sin(256, noise_std=0.5)
    pw = _port_wavelet(name)
    res = vt.dwt(_t(x), pw)
    _close(vt.idwt(res.approx, res.detail, pw), x, 1e-10)


@pytest.mark.parametrize("name", ["haar", "db4", "sym8"])
def test_energy_preservation_orthogonal(name):
    x = _t(composite_sin(512, noise_std=0.4))
    res = vt.dwt(x, name)
    e_coeffs = float((res.approx**2).sum() + (res.detail**2).sum())
    e_signal = float((x**2).sum())
    assert abs(e_coeffs - e_signal) / e_signal < 1e-12


def test_wavedec_waverec_roundtrip():
    x = composite_sin(256, noise_std=0.2)
    res = vt.wavedec(_t(x), "db4", levels=4)
    assert res.levels == 4 and isinstance(res, vt.WavedecResult)
    assert res.details[0].shape == (128,) and res.details[3].shape == (16,)
    assert res.approx.shape == (16,)
    ref = vw.wavedec(jnp.asarray(x), "db4", levels=4)
    for g, w in zip((*res.details, res.approx), (*ref.details, ref.approx)):
        _close(g, w)
    _close(vt.waverec(res, "db4"), x, 1e-10)


@pytest.mark.parametrize("boundary", ["periodic", "zero"])
def test_wavedec_default_levels_and_batch(boundary):
    x = np.stack([composite_sin(128, seed=s) for s in range(3)])
    res = vt.wavedec(_t(x), "db4", boundary=boundary)
    assert res.levels == vt.max_dwt_levels(128, "db4") == vw.max_dwt_levels(128, "db4") == 4
    ref = vw.wavedec(jnp.asarray(x), "db4", boundary=boundary)
    _close(vt.waverec(res, "db4", boundary=boundary),
           vw.waverec(ref, "db4", boundary=boundary))
    if boundary == "periodic":
        _close(vt.waverec(res, "db4"), x, 1e-10)


def test_zero_boundary_interior_parity():
    x = np.zeros(128)
    x[32:96] = composite_sin(64, noise_std=0.2)
    a_per = vt.dwt(_t(x), "db4", boundary="periodic")
    a_zero = vt.dwt(_t(x), "db4", boundary="zero")
    _close(a_per.detail, a_zero.detail)


def test_dwt_validation():
    with pytest.raises(InvalidArgumentError):
        vt.dwt(torch.zeros(33), "db4")  # odd length
    with pytest.raises(InvalidArgumentError):
        vt.dwt(torch.zeros(64), "db4", boundary="symmetric")
    with pytest.raises(InvalidArgumentError):
        vt.wavedec(torch.zeros(72), "db4", levels=4)  # 72 % 16 != 0
    with pytest.raises(InvalidArgumentError):
        vt.wavedec(torch.zeros(64), "db4", levels=0)
    assert isinstance(vt.dwt(torch.zeros(8), "haar"), vt.DWTResult)


# --- config #3 ------------------------------------------------------------------------


def test_config3_swt_sym8_4level_symmetric_denoise_roundtrip():
    rng = np.random.default_rng(0)
    clean = composite_sin(2048)
    noisy = clean + rng.normal(0, 1.0, 2048)
    res = vt.swt(_t(noisy), "sym8", levels=4, boundary="symmetric")
    back = vt.iswt(res, "sym8", boundary="symmetric").numpy()
    sl = slice(512, 1536)
    nrmse = np.sqrt(np.mean((noisy[sl] - back[sl]) ** 2)) / np.std(noisy[sl])
    assert nrmse < 1.2
    den = vt.swt_denoise(_t(noisy), "sym8", levels=4, boundary="symmetric").numpy()
    assert np.mean((den[sl] - clean[sl]) ** 2) < np.mean((noisy[sl] - clean[sl]) ** 2)
    want = vw.swt_denoise(jnp.asarray(noisy), "sym8", levels=4, boundary="symmetric")
    _close(den, want, 1e-10)


def test_config3_on_the_kernel_tier_matches_the_plain_path():
    """Config #3 at the TPU bench's length (16384) through the kernel tier's
    plain versions (what the card runs), against the plain cascade."""
    rng = np.random.default_rng(1)
    noisy = composite_sin(16384) + rng.normal(0, 1.0, 16384)
    want = vt.swt_denoise(_t(noisy), "sym8", levels=4, boundary="symmetric")
    try:
        vt.set_backend("kernel")
        got = vt.swt_denoise(_t(noisy), "sym8", levels=4, boundary="symmetric")
    finally:
        vt.set_backend("auto")
    _close(got, want)
