"""Test mirrors of the JAX package's decimated 1-D analysis tests, on the port.

Mirrors ``tests/test_dwt.py``, ``tests/test_lifting.py``,
``tests/test_longmemory.py``, ``tests/test_multifractal.py`` and
``tests/test_block_fdr.py`` test by test, under the JAX tests' names, at
their shapes and seeds; the audit of the eight files of the 1-D analysis
modules is in CHANGES.md.

These JAX tests state properties of the package's output (the DWT against
an independent numpy oracle, perfect reconstruction, the Hurst exponent of
white noise, a multifractal cascade, FDR's false discoveries, the block
denoise's SNR gain).  Here the port is held to the same property on its own
output; the earlier parity tests (``test_torch_swt.py``,
``test_torch_multifractal_lifting.py``, ``test_torch_variance.py``,
``test_torch_denoise.py``, ``test_torch_optimize.py``) hold it to JAX value
by value.  Each family is anchored to the JAX package once more, at a named
draw of its mirror, through a module-scoped fixture (``anchor_*``); the JAX
side runs its jnp path, never a Pallas kernel.  A JAX ``jit`` or ``vmap``
half has no counterpart (the port does not trace); its batch or loop half
is mirrored, and ``test_jit_vmap_grad`` holds the port's autograd gradient
and batch to ``jax.grad``'s and ``vmap``'s values.

Tolerances: the anchors 1e-10 of the largest value (float64 on both
sides); the DWT oracles 1e-12 in float64; the properties at the JAX tests'
own bounds.

The phase 2f cases of these files (``tools/mirror_cases.decimated_cases``)
run here on CPU tensors (``mirror_cases.cpu_problems``).
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
from vectorwave_tpu.ops import thresholds as jth
from vectorwave_tpu.ops.dwt import _bior_parities as j_bior_parities
from vectorwave_tpu.transforms import lifting as jl
from vectorwave_tpu_torch.errors import InvalidArgumentError, VectorWaveError
from vectorwave_tpu_torch.ops.dwt import _bior_parities
from vectorwave_tpu_torch.ops.thresholds import (block_shrink, fdr_threshold, mad_sigma,
                                                 universal_threshold)
from vectorwave_tpu_torch.transforms import lifting as tl
from vectorwave_tpu_torch.transforms.longmemory import kolmogorov_critical_value

from .conftest import composite_sin

torch.set_num_threads(1)

ANCHOR = 1e-10
F64 = torch.float64
SCHEMES = sorted(tl.LIFTING_SCHEMES)


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _t(a, dtype=F64) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def fbm(n, hurst, seed):
    """``tests/test_multifractal.py::fbm``: exact fBm by circulant embedding."""
    rng = np.random.default_rng(seed)
    k = np.arange(n)
    gamma = 0.5 * (np.abs(k - 1) ** (2 * hurst) - 2 * np.abs(k) ** (2 * hurst)
                   + np.abs(k + 1) ** (2 * hurst))
    row = np.concatenate([gamma, gamma[1:-1][::-1]])
    lam = np.maximum(np.fft.fft(row).real, 0)
    m = len(row)
    z = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    return np.cumsum(np.real(np.fft.fft(np.sqrt(lam / (2 * m)) * z))[:n])


def lognormal_cascade(n_levels, seed, sigma=0.35):
    """``tests/test_multifractal.py::lognormal_cascade``: an integrated
    Mandelbrot multiplicative cascade."""
    rng = np.random.default_rng(seed)
    m = np.ones(1)
    for _ in range(n_levels):
        w = np.exp(rng.normal(-sigma**2 / 2, sigma, 2 * len(m)))
        m = np.repeat(m, 2) * w
    return np.cumsum(m)


def _snr(clean, est):
    return 10 * np.log10(np.sum(clean**2) / np.sum((est - clean) ** 2))


# --- the anchors: each family against the JAX package once ---------------------------


@pytest.fixture(scope="module")
def anchor_dwt():
    """JAX's db4 and bior2.2 DWT (both boundaries) at test_dwt_matches_oracle's
    draw, and its db4 wavedec at test_wavedec_waverec_roundtrip's
    (ANCHOR_DWT)."""
    x = composite_sin(128, noise_std=0.3)
    y = composite_sin(256, noise_std=0.2)

    def ref(x, y):
        dwts = {(name, b): tuple(vw.dwt(x, name, boundary=b)[:2])
                for name in ("db4", "bior2.2") for b in ("periodic", "zero")}
        dec = vw.wavedec(y, "db4", levels=4)
        return dwts, (list(dec.details), dec.approx)

    dwts, dec = jax.tree_util.tree_map(np.asarray, jax.jit(ref)(jnp.asarray(x),
                                                                 jnp.asarray(y)))
    return x, dwts, y, dec


def test_anchor_dwt_matches_jax(anchor_dwt):
    x, dwts, y, (details, approx) = anchor_dwt
    for (name, b), (a, d) in dwts.items():
        got = vt.dwt(_t(x), name, boundary=b)
        assert _rel(got.approx, a) <= ANCHOR and _rel(got.detail, d) <= ANCHOR, (name, b)
        assert _bior_parities(vt.wavelet(name)) == j_bior_parities(vw.wavelet(name))
    got = vt.wavedec(_t(y), "db4", levels=4)
    for g, w in zip(got.details, details):
        assert _rel(g, w) <= ANCHOR
    assert _rel(got.approx, approx) <= ANCHOR


@pytest.fixture(scope="module")
def anchor_lifting():
    """JAX's cdf97 lifting DWT at test_perfect_reconstruction's draw (the
    conftest's ``rng``, seed 42, 3 x 64) and its legall53 integer wavedec
    at test_integer_multilevel_lossless's (ANCHOR_LIFTING)."""
    x = np.random.default_rng(42).standard_normal((3, 64))
    xi = np.random.default_rng(42).integers(-(2**15), 2**15, size=512).astype(np.int32)

    def ref(x, xi):
        res = jl.lifting_dwt(x, "cdf97")
        dec = jl.lifting_wavedec_int(xi, "legall53", levels=5)
        return (res.approx, res.detail), (list(dec.details), dec.approx)

    dwt, dec = jax.tree_util.tree_map(np.asarray, jax.jit(ref)(jnp.asarray(x),
                                                                jnp.asarray(xi)))
    return x, dwt, xi, dec


def test_anchor_lifting_matches_jax(anchor_lifting):
    x, (approx, detail), xi, (details_i, approx_i) = anchor_lifting
    res = tl.lifting_dwt(_t(x), "cdf97")
    assert _rel(res.approx, approx) <= ANCHOR and _rel(res.detail, detail) <= ANCHOR
    dec = tl.lifting_wavedec_int(torch.from_numpy(xi), "legall53", levels=5)
    for g, w in zip((*dec.details, dec.approx), (*details_i, approx_i)):
        np.testing.assert_array_equal(_np(g), w)


@pytest.fixture(scope="module")
def anchor_longmemory():
    """JAX's Hurst fit at test_hurst_white_noise_is_half's draw (db4 J=8,
    2^15) and its change-point test at test_variance_change_detects_break's
    (ANCHOR_LONGMEMORY)."""
    x = np.random.default_rng(0).standard_normal(2**15)
    y = np.random.default_rng(5).standard_normal(4096)
    y[2048:] *= 3.0

    def ref(x, y):
        h = vw.hurst_exponent(x, "db4", 8, model="fgn")
        c = vw.variance_change_test(y, "db4", level=1)
        return (h.hurst, h.variance), (c.statistic, c.location, c.reject)

    (hurst, variance), (statistic, location, reject) = jax.jit(ref)(jnp.asarray(x),
                                                                    jnp.asarray(y))
    return x, (float(hurst), np.asarray(variance)), y, (
        float(statistic), int(location), bool(reject))


def test_anchor_longmemory_matches_jax(anchor_longmemory):
    x, (hurst, variance), y, (statistic, location, reject) = anchor_longmemory
    h = vt.hurst_exponent(_t(x), "db4", 8, model="fgn")
    assert abs(float(h.hurst) - hurst) <= ANCHOR * abs(hurst)
    assert _rel(h.variance, variance) <= ANCHOR
    c = vt.variance_change_test(_t(y), "db4", level=1)
    assert abs(float(c.statistic) - statistic) <= ANCHOR * abs(statistic)
    assert (int(c.location), bool(c.reject)) == (location, reject)


@pytest.fixture(scope="module")
def anchor_multifractal():
    """JAX's wavelet leaders at test_leaders_match_brute_force's draw (db2,
    4 levels, 256) (ANCHOR_MULTIFRACTAL)."""
    x = np.random.default_rng(3).standard_normal(256)
    leaders = jax.jit(lambda z: vw.wavelet_leaders(z, "db2", levels=4))(jnp.asarray(x))
    return x, [np.asarray(v) for v in leaders]


def test_anchor_leaders_match_jax(anchor_multifractal):
    x, leaders = anchor_multifractal
    got = vt.wavelet_leaders(_t(x), "db2", levels=4)
    assert len(got) == len(leaders)
    for g, w in zip(got, leaders):
        assert _rel(g, w) <= ANCHOR


@pytest.fixture(scope="module")
def anchor_block_fdr():
    """JAX's FDR threshold at test_fdr_adapts_below_universal_when_signal_is_dense's
    draw, its block shrinkage of test_block_shrink_preserves_strong_blocks'
    noise and its block denoise at test_denoise_block_beats_universal_on_doppler's
    first draw (sym8 J=5, 1000), all in float64 (ANCHOR_BLOCK_FDR)."""
    coeffs = _dense_spikes().astype(np.float64)
    noise = np.random.default_rng(3).standard_normal(1024)
    noisy = mirror_cases.doppler(1000) + 0.3 * np.random.default_rng(5).standard_normal(1000)

    def ref(c, v, y):
        return (jth.fdr_threshold(c, 1.0), jth.block_shrink(v, 1.0),
                vw.denoise_block(y, "sym8", levels=5))

    t_fdr, shrunk, denoised = jax.jit(ref)(jnp.asarray(coeffs), jnp.asarray(noise),
                                           jnp.asarray(noisy))
    return coeffs, float(np.asarray(t_fdr).item()), noise, np.asarray(shrunk), noisy, \
        np.asarray(denoised)


def test_anchor_block_fdr_matches_jax(anchor_block_fdr):
    coeffs, t_fdr, noise, shrunk, noisy, denoised = anchor_block_fdr
    assert abs(float(fdr_threshold(_t(coeffs), 1.0)) - t_fdr) <= ANCHOR * t_fdr
    assert _rel(block_shrink(_t(noise), 1.0), shrunk) <= ANCHOR
    assert _rel(vt.denoise_block(_t(noisy), "sym8", levels=5), denoised) <= ANCHOR


# --- tests/test_dwt.py -----------------------------------------------------------------


def oracle_down(x, f, boundary, offset=0):
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


def oracle_up(c, f, n_out, boundary):
    out = np.zeros(n_out)
    for i, ci in enumerate(c):
        for j, fj in enumerate(f):
            idx = 2 * i + j
            if boundary == "periodic":
                out[idx % n_out] += ci * fj
            elif idx < n_out:
                out[idx] += ci * fj
    return out


@pytest.mark.parametrize("boundary", ["periodic", "zero"])
@pytest.mark.parametrize("name", ["haar", "db4", "sym8", "bior2.2"])
def test_dwt_matches_oracle(name, boundary):
    x = composite_sin(128, noise_std=0.3)
    w = vt.wavelet(name)
    p_h, p_g = _bior_parities(w)  # (0, 0) for orthogonal = reference indexing
    res = vt.dwt(_t(x), name, boundary=boundary)
    np.testing.assert_allclose(_np(res.approx), oracle_down(x, w.dec_lo, boundary, p_h),
                               atol=1e-12)
    np.testing.assert_allclose(_np(res.detail), oracle_down(x, w.dec_hi, boundary, p_g),
                               atol=1e-12)


@pytest.mark.parametrize("name", ["bior1.3", "bior2.4", "bior3.1", "bior4.4",
                                  "bior6.8", "rbio2.2", "rbio4.4"])
def test_perfect_reconstruction_biorthogonal(name):
    x = _t(composite_sin(256, noise_std=0.5, seed=9))
    res = vt.dwt(x, name)
    rec = vt.idwt(res.approx, res.detail, name)
    np.testing.assert_allclose(_np(rec), _np(x), atol=1e-10)


def test_idwt_matches_oracle():
    x = composite_sin(64, seed=2)
    w = vt.wavelet("db4")
    res = vt.dwt(_t(x), "db4")
    rec = vt.idwt(res.approx, res.detail, "db4")
    expected = (oracle_up(_np(res.approx), w.rec_lo, 64, "periodic")
                + oracle_up(_np(res.detail), w.rec_hi, 64, "periodic"))
    np.testing.assert_allclose(_np(rec), expected, atol=1e-12)


def test_haar_closed_form():
    x = composite_sin(32, seed=4)
    res = vt.dwt(_t(x), "haar")
    s = 1.0 / np.sqrt(2.0)
    np.testing.assert_allclose(_np(res.approx), s * (x[0::2] + x[1::2]), atol=1e-12)
    np.testing.assert_allclose(_np(res.detail), s * (x[0::2] - x[1::2]), atol=1e-12)


@pytest.mark.parametrize("name", ["haar", "db2", "db4", "sym8", "coif2", "bior2.2"])
def test_perfect_reconstruction_periodic(name):
    x = _t(composite_sin(256, noise_std=0.5))
    res = vt.dwt(x, name)
    rec = vt.idwt(res.approx, res.detail, name)
    np.testing.assert_allclose(_np(rec), _np(x), atol=1e-10)


@pytest.mark.parametrize("name", ["haar", "db4", "sym8"])
def test_energy_preservation_orthogonal(name):
    x = _t(composite_sin(512, noise_std=0.4))
    res = vt.dwt(x, name)
    e_coeffs = float((res.approx**2).sum() + (res.detail**2).sum())
    e_signal = float((x**2).sum())
    assert abs(e_coeffs - e_signal) / e_signal < 1e-12


def test_wavedec_waverec_roundtrip():
    x = _t(composite_sin(256, noise_std=0.2))
    res = vt.wavedec(x, "db4", levels=4)
    assert res.levels == 4
    assert res.details[0].shape == (128,)
    assert res.details[3].shape == (16,)
    assert res.approx.shape == (16,)
    np.testing.assert_allclose(_np(vt.waverec(res, "db4")), _np(x), atol=1e-10)


def test_wavedec_default_levels_and_batch():
    x = _t(np.stack([composite_sin(128, seed=s) for s in range(3)]))
    res = vt.wavedec(x, "db4")
    assert res.levels == vt.max_dwt_levels(128, "db4") == 4
    np.testing.assert_allclose(_np(vt.waverec(res, "db4")), _np(x), atol=1e-10)


def test_zero_boundary_interior_parity():
    """A signal with quiet tails: zero and periodic agree everywhere."""
    x = np.zeros(128)
    x[32:96] = composite_sin(64, noise_std=0.2)
    a_per = vt.dwt(_t(x), "db4", boundary="periodic")
    a_zero = vt.dwt(_t(x), "db4", boundary="zero")
    np.testing.assert_allclose(_np(a_per.detail), _np(a_zero.detail), atol=1e-12)


def test_dwt_validation():
    with pytest.raises(InvalidArgumentError):
        vt.dwt(torch.zeros(33), "db4")  # odd length
    with pytest.raises(InvalidArgumentError):
        vt.dwt(torch.zeros(64), "db4", boundary="symmetric")
    with pytest.raises(InvalidArgumentError):
        vt.wavedec(torch.zeros(72), "db4", levels=4)  # 72 % 16 != 0
    with pytest.raises(InvalidArgumentError):
        vt.wavedec(torch.zeros(64), "db4", levels=0)


# --- tests/test_lifting.py -------------------------------------------------------------


@pytest.mark.parametrize("scheme", SCHEMES)
def test_perfect_reconstruction(scheme, rng):
    x = _t(rng.standard_normal((3, 64)))
    res = tl.lifting_dwt(x, scheme)
    rec = tl.lifting_idwt(res.approx, res.detail, scheme)
    np.testing.assert_allclose(_np(rec), _np(x), atol=1e-12)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_multilevel_roundtrip(scheme, rng):
    x = _t(rng.standard_normal(128))
    dec = tl.lifting_wavedec(x, scheme, levels=4)
    assert dec.levels == 4
    assert dec.approx.shape[-1] == 8
    assert [d.shape[-1] for d in dec.details] == [64, 32, 16, 8]
    np.testing.assert_allclose(_np(tl.lifting_waverec(dec, scheme)), _np(x), atol=1e-12)


def _best_row_alignment(eff: np.ndarray, filt: np.ndarray) -> float:
    """min over circular shift and sign of ||roll(eff, s)*sgn - row(filt)||_inf."""
    n = len(eff)
    row = np.zeros(n)
    row[: len(filt)] = filt
    best = np.inf
    for s in range(n):
        shifted = np.roll(eff, s)
        for sgn in (1.0, -1.0):
            best = min(best, float(np.max(np.abs(sgn * shifted - row))))
    return best


@pytest.mark.parametrize("scheme,wavelet,tol",
                         [("haar", "haar", 1e-12), ("db2", "db2", 1e-10),
                          ("cdf97", "bior4.4", 1e-6)])
def test_equivalent_to_convolution_filters(scheme, wavelet, tol):
    """The lifting cascade IS the named wavelet's analysis bank (up to shift/sign)."""
    lo, hi = tl.effective_filters(scheme, n=64)
    w = vt.as_wavelet(wavelet)
    assert _best_row_alignment(lo, np.asarray(w.dec_lo)) < tol
    assert _best_row_alignment(hi, np.asarray(w.dec_hi)) < tol


@pytest.mark.parametrize("scheme", ["haar", "db2"])
def test_orthonormal_energy_preserved(scheme, rng):
    x = _t(rng.standard_normal(256))
    res = tl.lifting_dwt(x, scheme)
    e = float((res.approx**2).sum() + (res.detail**2).sum())
    np.testing.assert_allclose(e, float((x**2).sum()), rtol=1e-12)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_integer_roundtrip_bit_exact(scheme, rng):
    x = torch.from_numpy(rng.integers(-30000, 30000, size=(2, 128)).astype(np.int32))
    res = tl.lifting_dwt_int(x, scheme)
    assert res.approx.dtype == torch.int32
    rec = tl.lifting_idwt_int(res.approx, res.detail, scheme)
    assert torch.equal(rec, x)


def test_integer_multilevel_lossless(rng):
    x = torch.from_numpy(rng.integers(-(2**15), 2**15, size=512).astype(np.int32))
    dec = tl.lifting_wavedec_int(x, "legall53", levels=5)
    assert torch.equal(tl.lifting_waverec_int(dec, "legall53"), x)


def test_integer_legall53_is_near_lossy_float_path(rng):
    """Unnormalised integer 5/3 approx tracks the float approx / sqrt(2)."""
    x = torch.from_numpy(rng.integers(0, 255, size=256).astype(np.int32))
    res_i = tl.lifting_dwt_int(x, "legall53")
    res_f = tl.lifting_dwt(x.to(F64), "legall53")
    np.testing.assert_allclose(_np(res_i.approx), _np(res_f.approx) / np.sqrt(2.0),
                               atol=1.0)  # rounding of each lifting step


def test_jit_vmap_grad():
    """The ``jit`` and ``vmap`` halves have no counterpart (the port does
    not trace); the port's autograd gradient of the cdf97 detail energy
    equals ``jax.grad``'s, and its batch of x and 2x equals ``vmap``'s,
    within 1e-12 of the largest value."""
    x = np.linspace(-1.0, 1.0, 64)

    def detail_energy(sig):
        return (jl.lifting_dwt(sig, "cdf97").detail ** 2).sum()

    want = np.asarray(jax.grad(detail_energy)(jnp.asarray(x)))
    xt = _t(x).requires_grad_(True)
    (g,) = torch.autograd.grad((tl.lifting_dwt(xt, "cdf97").detail ** 2).sum(), xt)
    assert np.isfinite(_np(g)).all() and _rel(g, want) <= 1e-12
    batch = np.stack([x, 2.0 * x])
    vb = np.asarray(jax.vmap(lambda s: jl.lifting_dwt(s, "db2").approx)(jnp.asarray(batch)))
    got = tl.lifting_dwt(_t(batch), "db2").approx
    assert _rel(got, vb) <= 1e-12
    np.testing.assert_allclose(_np(got[1]), 2.0 * _np(got[0]), atol=1e-12)


def test_validation_errors():
    with pytest.raises(InvalidArgumentError):
        tl.lifting_dwt(torch.zeros(63, dtype=F64), "haar")  # odd length
    with pytest.raises(InvalidArgumentError):
        tl.lifting_dwt(torch.zeros(64, dtype=F64), "nosuch")
    with pytest.raises(InvalidArgumentError):
        tl.lifting_dwt(torch.zeros(64, dtype=F64), "haar", boundary="symmetric")
    with pytest.raises(InvalidArgumentError):
        tl.lifting_dwt_int(torch.zeros(64, dtype=F64), "haar")  # float input to int path
    with pytest.raises(InvalidArgumentError):
        tl.lifting_wavedec(torch.zeros(40, dtype=F64), levels=4)  # 40 % 16 != 0


def test_aliases_resolve():
    assert tl.get_lifting_scheme("bior4.4").name == "cdf97"
    assert tl.get_lifting_scheme("jpeg2000").name == "cdf97"
    assert tl.get_lifting_scheme("bior2.2").name == "legall53"
    s = tl.get_lifting_scheme("haar")
    assert tl.get_lifting_scheme(s) is s


# --- tests/test_longmemory.py ----------------------------------------------------------


def test_hurst_white_noise_is_half():
    x = _t(np.random.default_rng(0).standard_normal(2**15))
    r = vt.hurst_exponent(x, "db4", 8, model="fgn")
    assert abs(float(r.hurst) - 0.5) < 0.03
    assert abs(float(r.spectral_exponent)) < 0.06  # alpha = 0 for white noise
    assert float(r.stderr) < 0.05


def test_hurst_random_walk_is_half_fbm():
    x = _t(np.cumsum(np.random.default_rng(1).standard_normal(2**15)))
    r = vt.hurst_exponent(x, "db4", 8, model="fbm", min_level=3)
    assert abs(float(r.hurst) - 0.5) < 0.05
    biased = vt.hurst_exponent(x, "db4", 8, model="fbm")
    assert abs(float(r.hurst) - 0.5) < abs(float(biased.hurst) - 0.5)


def test_hurst_recovers_synthesized_fgn():
    for h in (0.65, 0.85):
        r = vt.hurst_exponent(_t(mirror_cases.fgn(h, 2**15, seed=int(h * 100))), "db4", 8, model="fgn")
        assert abs(float(r.hurst) - h) < 0.07, (h, float(r.hurst))


def test_hurst_batched_and_jittable():
    """The batch half, in float32 (the ``jax.jit`` half: no counterpart)."""
    rng = np.random.default_rng(3)
    x = _t(rng.standard_normal((4, 4096)), torch.float32)
    r = vt.hurst_exponent(x, "haar", 6)
    assert r.hurst.shape == (4,) and r.variance.shape == (4, 6)
    assert r.hurst.dtype == torch.float32
    assert np.all(np.abs(_np(r.hurst) - 0.5) < 0.15)
    for i in range(4):
        assert abs(float(vt.hurst_exponent(x[i], "haar", 6).hurst) - float(r.hurst[i])) <= 1e-6


def test_hurst_level_window_and_validation():
    x = _t(np.random.default_rng(4).standard_normal(8192))
    full = vt.hurst_exponent(x, "db4", 6)
    windowed = vt.hurst_exponent(x, "db4", 6, min_level=2, max_level=5)
    assert abs(float(windowed.hurst) - 0.5) < 0.1
    assert full.variance.shape == windowed.variance.shape  # full table kept
    for kwargs in ({"model": "arfima"}, {"min_level": 6}, {"min_level": 0}):
        with pytest.raises(InvalidArgumentError):
            vt.hurst_exponent(x, "db4", 6, **kwargs)


def test_variance_change_detects_break():
    rng = np.random.default_rng(5)
    n = 4096
    x = rng.standard_normal(n)
    x[n // 2:] *= 3.0
    r = vt.variance_change_test(_t(x), "db4", level=1)
    assert bool(r.reject)
    assert abs(int(r.location) - n // 2) < n // 10
    assert float(r.statistic) > r.critical_value


def test_variance_change_size_on_homogeneous_noise():
    """The 5% test rejects at most 12% of 256 homogeneous series (float32)."""
    x = _t(np.random.default_rng(6).standard_normal((256, 1024)), torch.float32)
    r = vt.variance_change_test(x, "db4", level=1, confidence=0.95)
    assert r.statistic.shape == (256,)
    rate = float(r.reject.float().mean())
    assert rate <= 0.12, rate


def test_variance_change_validation_and_kolmogorov():
    assert abs(kolmogorov_critical_value(0.95) - 1.358) < 2e-3
    assert abs(kolmogorov_critical_value(0.99) - 1.628) < 2e-3
    with pytest.raises(InvalidArgumentError):
        kolmogorov_critical_value(1.5)
    with pytest.raises(InvalidArgumentError):
        vt.variance_change_test(torch.zeros(32, dtype=F64), "db8", level=2)  # M too small
    with pytest.raises(InvalidArgumentError):
        vt.variance_change_test(torch.zeros(1024, dtype=F64), "db4", level=0)


# --- tests/test_multifractal.py --------------------------------------------------------


def brute_force_leaders(x, wavelet, levels):
    """The definition evaluated directly on the port's DWT: the sup of
    L1-normalized |c| over the dyadic descendants of the 3-neighbourhood."""
    dec = vt.wavedec(_t(x), wavelet, levels=levels)
    cs = [np.abs(_np(d)) * 2.0 ** (-(j + 1) / 2.0) for j, d in enumerate(dec.details)]
    out = []
    for j in range(1, levels + 1):
        n_j = cs[j - 1].shape[-1]
        lam = np.zeros(n_j)
        for k in range(n_j):
            sup = 0.0
            for nb in (k - 1, k, k + 1):  # periodic 3-neighborhood
                nbw = nb % n_j
                for jp in range(j, 0, -1):
                    width = 2 ** (j - jp)
                    block = cs[jp - 1][nbw * width: nbw * width + width]
                    if block.size:
                        sup = max(sup, float(block.max()))
            lam[k] = sup
        out.append(lam)
    return out


def test_leaders_match_brute_force():
    x = np.random.default_rng(3).standard_normal(256)
    got = vt.wavelet_leaders(_t(x), "db2", levels=4)
    for g, e in zip(got, brute_force_leaders(x, "db2", 4)):
        np.testing.assert_allclose(_np(g), e, rtol=1e-6)


@pytest.mark.slow
@pytest.mark.parametrize("hurst", [0.3, 0.7])
def test_fbm_is_monofractal_with_c1_near_h(hurst):
    x = _t(np.stack([fbm(2**14, hurst, s) for s in range(8)]))
    res = vt.multifractal_spectrum(x, "db3", min_level=3)
    c1 = float(res.c1.mean())
    c2 = float(res.c2.mean())
    assert abs(c1 - hurst) < 0.1
    assert abs(c2) < 0.03  # no multifractality
    assert float(res.spectrum_width().mean()) < 0.15
    zeta = _np(res.zeta).mean(axis=0)
    qs = np.asarray(res.qs)
    slope = np.polyfit(qs, zeta, 1)[0]
    assert abs(slope - hurst) < 0.12
    resid = np.max(np.abs(zeta - np.polyval(np.polyfit(qs, zeta, 1), qs)))
    assert resid < 0.25


def test_cascade_is_multifractal():
    x = _t(np.stack([lognormal_cascade(14, s) for s in range(8)]))
    res = vt.multifractal_spectrum(x, "db3", min_level=3)
    assert float(res.c2.mean()) < -0.08  # strong multifractality, correct sign
    assert float(res.spectrum_width().mean()) > 0.5
    h_mean = _np(res.h).mean(axis=0)
    assert np.all(np.diff(h_mean) < 1e-6)  # h(q) decreasing in q
    assert float(res.D.max()) <= 1.0 + 0.1


@pytest.mark.slow
def test_batch_axes_shapes():
    x = _t(np.random.default_rng(0).standard_normal((2, 3, 4096)))
    res = vt.multifractal_spectrum(x, "db2", qs=(-2, -1, 1, 2))
    assert res.zeta.shape == (2, 3, 4)
    assert res.h.shape == (2, 3, 4)
    assert res.c1.shape == (2, 3)
    assert res.spectrum_width().shape == (2, 3)
    assert res.levels[0] == 2


@pytest.mark.slow
def test_non_dyadic_length_default_levels():
    x = _t(np.random.default_rng(0).standard_normal(1000))
    res = vt.multifractal_spectrum(x, "db2", min_level=1)
    assert res.levels[-1] <= 3
    assert np.all(np.isfinite(_np(res.zeta)))


@pytest.mark.slow
def test_flat_segments_do_not_produce_nan():
    rng = np.random.default_rng(1)
    x = np.zeros(4096, np.float32)
    x[:1024] = rng.standard_normal(1024)
    res = vt.multifractal_spectrum(torch.from_numpy(x), "db3", min_level=2)
    for leaf in (res.zeta, res.h, res.D, res.c1, res.c2):
        assert np.all(np.isfinite(_np(leaf))), leaf


def test_validation():
    x = _t(np.random.default_rng(0).standard_normal(4096))
    with pytest.raises(VectorWaveError):
        vt.multifractal_spectrum(x, qs=())
    with pytest.raises(VectorWaveError):
        vt.multifractal_spectrum(x, qs=(0.0, 1.0))
    with pytest.raises(VectorWaveError):
        vt.multifractal_spectrum(torch.zeros(32, dtype=F64), min_level=2)  # too short


# --- tests/test_block_fdr.py -----------------------------------------------------------


def _dense_spikes() -> np.ndarray:
    """test_fdr_adapts_below_universal_when_signal_is_dense's draw: a
    quarter of 4096 samples spikes of +-6 in unit noise, float32."""
    rng = np.random.default_rng(1)
    n = 4096
    clean = np.zeros(n)
    idx = rng.choice(n, size=n // 4, replace=False)
    clean[idx] = 6.0 * rng.choice([-1.0, 1.0], size=n // 4)
    return (clean + rng.standard_normal(n)).astype(np.float32)


def test_fdr_pure_noise_kills_everything():
    noise = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    t = fdr_threshold(noise, 1.0, q=0.05)
    assert int((noise.abs() > t).sum()) <= 8  # at most a handful of 4096


def test_fdr_adapts_below_universal_when_signal_is_dense():
    coeffs = torch.from_numpy(_dense_spikes())
    n = coeffs.shape[-1]
    t_fdr = float(fdr_threshold(coeffs, 1.0))
    t_uni = float(universal_threshold(n, 1.0))
    assert t_fdr < 0.75 * t_uni  # keeps far more of a dense signal
    assert int((coeffs.abs() > t_fdr).sum()) >= n // 4 * 0.9


def test_fdr_batch_shapes_and_dispatch():
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 512)).astype(np.float32))
    t = fdr_threshold(x, mad_sigma(x))
    assert t.shape == (3, 1)
    den = vt.denoise_multilevel(x, "db4", levels=3, method="fdr")
    assert den.shape == x.shape and bool(torch.isfinite(den).all())


def test_block_shrink_preserves_strong_blocks_and_kills_noise():
    n = 1024
    c = torch.zeros(n)
    c[100:116] = 10.0  # one strong feature
    out = block_shrink(c, 1.0)
    assert float(out[100:116].norm()) > 0.9 * float(c[100:116].norm())
    noise = torch.from_numpy(np.random.default_rng(3).standard_normal(n).astype(np.float32))
    assert float((block_shrink(noise, 1.0) ** 2).sum()) < 0.05 * float((noise**2).sum())


def test_block_shrink_tiny_sigma_is_identity_like():
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(300).astype(np.float32))
    assert torch.allclose(block_shrink(x, 1e-6), x, atol=1e-5)


@pytest.mark.parametrize("n", [1000, 1024])  # non-pow2 exercises the tail block
def test_denoise_block_beats_universal_on_doppler(n):
    clean = mirror_cases.doppler(n)
    noisy = (clean + 0.3 * np.random.default_rng(5).standard_normal(n)).astype(np.float32)
    den_block = _np(vt.denoise_block(torch.from_numpy(noisy), "sym8", levels=5))
    den_uni = _np(vt.denoise_multilevel(torch.from_numpy(noisy), "sym8", levels=5))
    assert _snr(clean, den_block) > _snr(clean, noisy) + 6
    assert _snr(clean, den_block) > _snr(clean, den_uni)


def test_denoise_block_batched():
    clean = np.stack([mirror_cases.doppler(512), -mirror_cases.doppler(512)])
    noisy = (clean + 0.25 * np.random.default_rng(6).standard_normal((2, 512))).astype(
        np.float32)
    den = _np(vt.denoise_block(torch.from_numpy(noisy), "db4", levels=4))
    assert den.shape == (2, 512)
    for i in range(2):
        assert _snr(clean[i], den[i]) > _snr(clean[i], noisy[i]) + 4


def test_fdr_exceeds_universal_for_nonsignificant_outlier():
    """A lone coefficient above VisuShrink whose p-value fails the BH
    step-up dies: the FDR threshold is not capped at the universal one."""
    noise = (np.random.default_rng(0).standard_normal(4096) * 0.999).astype(np.float32)
    noise[0] = 4.2  # p = 2.7e-5 > q/n = 1.2e-5: not a discovery
    t = float(fdr_threshold(torch.from_numpy(noise), 1.0, q=0.05))
    assert t >= 4.2 - 1e-6
    assert t > float(universal_threshold(4096, 1.0))


# --- the phase 2f cases ----------------------------------------------------------------


@pytest.mark.parametrize("label", mirror_cases.decimated_labels("decimated"))
def test_decimated_case_runs_its_plain_versions_on_the_cpu(label):
    """Each phase 2f case on CPU tensors: no launch, no refusal, the plain
    route's result within the case's bounds."""
    assert not mirror_cases.cpu_problems(label)


def test_decimated_cases_are_the_jax_tests_shapes():
    """Every phase 2f case names a JAX test that exists and whose source (or
    its module's) names the case's wavelet and every extent of its shape;
    its input equals the one the JAX test makes (float32 cast)."""
    cases = mirror_cases.decimated_cases()
    assert len({c.label for c in cases}) == len(cases)
    for case in cases:
        module, name = case.source.split("::")
        mod = importlib.import_module(f"tests.{module[:-3]}")
        src, module_src = inspect.getsource(getattr(mod, name)), inspect.getsource(mod)
        assert f'"{case.wavelet}"' in src, case.label
        for extent in case.shape:
            forms = {str(extent)} | ({f"2**{extent.bit_length() - 1}"}
                                     if extent & (extent - 1) == 0 else set())
            assert any(f in src or f in module_src for f in forms), (case.label, extent)
        kind, n = case.data[0], case.shape[-1]
        if kind == "fgn":
            want = mod._fgn(case.data[1], n, seed=case.data[2])
        elif kind == "doppler":
            _, seed, noise = case.data
            clean = mod._doppler(n) if len(case.shape) == 1 else np.stack(
                [mod._doppler(n), -mod._doppler(n)])
            want = clean + noise * np.random.default_rng(seed).standard_normal(case.shape)
            assert f"default_rng({seed})" in src and f"{noise} *" in src, case.label
        else:
            assert f"default_rng({case.data[1]})" in src, case.label
            want = np.random.default_rng(case.data[1]).standard_normal(case.shape)
            if kind == "walk":
                assert "np.cumsum(steps)" in src
                want = np.cumsum(want, axis=-1)
        np.testing.assert_array_equal(mirror_cases.case_input(case), want.astype(case.dtype))
    assert {c.source.split("::")[0] for c in cases} == {"test_longmemory.py",
                                                       "test_block_fdr.py"}
