"""Port parity: the sparse solvers (``optimize/sparse.py``), ForWaRD
deconvolution (``optimize/deconvolve.py``), ``denoise_block`` and
``block_shrink``, mirroring ``tests/test_sparse.py``,
``tests/test_deconvolve.py`` and the block cases of
``tests/test_block_fdr.py``.

The same seeded numpy inputs go through the JAX functions and the port's.
The FISTA solvers agree within 1e-9 in float64 at up to 20 steps: the port
keeps the reference's float32 momentum and its float32 λ schedule.  The
deconvolutions and the block shrinkage agree within 1e-10 in float64; the
port's float32 within 1e-5 of the JAX float64 values, 3e-5 where
``block_shrink``'s prefix-sum energies cancel in float32 (the JAX package's
algorithm too).  The parity solves and transforms use db2 at 2-3 levels:
the JAX solvers compile their loop at every call, 1.5 s at db2 J=3 against
4-6 s at db4 J=4 (15 s for a jitted sym8 deconvolution).  The default
wavelets and depths run in the quality checks and on the card.
The quality checks of the JAX tests run on the port at their step counts
where N <= 512 (at their own sizes for the one-pass deconvolutions).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from vectorwave_tpu.ops.thresholds import block_shrink as jax_block_shrink
from vectorwave_tpu.optimize.deconvolve import _level_responses as jax_level_responses
from vectorwave_tpu_torch import convert
from vectorwave_tpu_torch.errors import InvalidArgumentError
from vectorwave_tpu_torch.optimize.deconvolve import _level_responses
from vectorwave_tpu_torch.optimize.sparse import _momentum, _thresholds

torch.set_num_threads(1)

TOL, TOL_FISTA, TOL_F32 = 1e-10, 1e-9, 1e-5
#: block shrinkage in float32 against float64, of the largest coefficient: the
#: window energies are differences of a float32 prefix sum, which cancel on
#: long rows (at n = 1000-1024 the port strays 7e-6-1.3e-5, the JAX package's
#: own float32 shrink 9.5e-6-1.5e-5)
TOL_BLOCK_F32 = 3e-5


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, np.abs(want).max()))


def _sines(n=512, noise=0.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, n, endpoint=False)
    clean = np.sin(2 * np.pi * 5 * t) + 0.5 * np.sin(2 * np.pi * 13 * t + 0.7)
    return clean, clean + noise * rng.standard_normal(n)


# ---------------------------------------------------------------------------
# FISTA and the solvers
# ---------------------------------------------------------------------------


def test_float32_scalars_equal_the_reference():
    """FISTA's momentum and the continuation schedule, as the JAX loop
    computes them in float32 (its compiled form multiplies by the float32
    reciprocal of K - 1)."""
    from vectorwave_tpu.optimize.sparse import _lam_schedule

    t = jnp.asarray(1.0, jnp.float32)
    betas = []
    for _ in range(300):
        t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
        betas.append(float((t - 1.0) / t_new))
        t = t_new
    assert _momentum(300) == betas
    for steps, lam, lam0 in ((15, 1.7e-3, 1.7), (200, 1e-4, 1.0), (8, 0.3, 0.31)):
        sch = _lam_schedule(jnp.asarray(lam), jnp.asarray(lam0), steps)
        want = np.asarray(jax.jit(lambda: jax.lax.fori_loop(
            0, steps, lambda i, acc: acc.at[i].set(sch(i)), jnp.zeros(steps, jnp.float32)))())
        got = _thresholds(torch.tensor(lam), torch.tensor(lam0), steps, 1.0,
                          torch.zeros(1, dtype=torch.float32)).numpy()
        np.testing.assert_array_equal(got, want)


def test_fista_matches_closed_form_prox():
    """min 0.5||c-b||^2 + lam||c||_1 has the exact solution soft(b, lam)."""
    b = torch.tensor([3.0, -0.5, 0.2, -2.0, 0.05])
    lam = 0.4
    prox = lambda c, i: torch.sign(c) * torch.clamp(c.abs() - lam, min=0.0)  # noqa: E731
    c = vt.fista(lambda c: c - b, prox, torch.zeros_like(b), steps=200)
    _close(c, (torch.sign(b) * torch.clamp(b.abs() - lam, min=0.0)).numpy(), 1e-5)
    # a NamedTuple of tuples of tensors, as the solvers' coefficients are
    tree = vt.MultiLevelMODWTResult((torch.zeros(5),), torch.zeros(5))
    out = vt.fista(lambda c: vt.MultiLevelMODWTResult((c.details[0] - b,), c.approx - b),
                   lambda c, i: c, tree, steps=50)
    assert isinstance(out, vt.MultiLevelMODWTResult)
    _close(out.approx, b.numpy(), 1e-5)
    with pytest.raises(InvalidArgumentError):
        vt.fista(lambda c: c, lambda c, i: c, torch.zeros(4), steps=0)


def test_bpdn_matches_jax_and_batches():
    _, n0 = _sines(256, noise=0.3, seed=1)
    _, n1 = _sines(256, noise=0.5, seed=2)
    y = np.stack([n0, n1])
    got = vt.bpdn(torch.from_numpy(y), "db2", levels=2, steps=20)
    want = vw.bpdn(jnp.asarray(y), "db2", levels=2, steps=20)
    _close(got.signal, want.signal, TOL_FISTA)
    for g, w in zip((*got.coeffs.details, got.coeffs.approx),
                    (*want.coeffs.details, want.coeffs.approx)):
        _close(g, w, TOL_FISTA)
    # the JAX coefficients carried across and synthesised by the port
    carried = convert.multilevel_result_from_arrays(
        [np.asarray(d) for d in want.coeffs.details], np.asarray(want.coeffs.approx), device="cpu")
    _close(vt.imodwt_multilevel(carried, "db2"), want.signal, TOL_FISTA)
    # a batched solve equals the stacked single solves (the default lam is per signal)
    for k in range(2):
        single = vt.bpdn(torch.from_numpy(y[k]), "db2", levels=2, steps=20)
        _close(got.signal[k], single.signal.numpy(), 1e-12)


def test_inpaint_matches_jax():
    """The port given NaN at the missing samples, JAX given zeros: the
    values there are ignored, so the solves agree."""
    clean = np.stack([_sines(256)[0], _sines(256, noise=0.2, seed=3)[1]])
    mask = (np.random.default_rng(7).random((2, 256)) > 0.4).astype(np.float64)
    y = torch.from_numpy(np.where(mask > 0, clean, np.nan))
    got = vt.inpaint(y, torch.from_numpy(mask), "db2", levels=3, steps=20, enforce_data=False)
    want = vw.inpaint(jnp.asarray(clean * mask), jnp.asarray(mask), "db2", levels=3, steps=20,
                      enforce_data=False)
    assert bool(torch.isfinite(got).all())
    _close(got, want, TOL_FISTA)
    enforced = vt.inpaint(y, torch.from_numpy(mask), "db2", levels=3, steps=20)
    np.testing.assert_array_equal(enforced.numpy(), np.where(mask > 0, clean, got.numpy()))
    zeros = vt.inpaint(torch.from_numpy(clean * mask), torch.from_numpy(mask), "db2", levels=3,
                       steps=20)
    np.testing.assert_array_equal(enforced.numpy(), zeros.numpy())


def test_inpaint2_matches_jax():
    yy, xx = np.meshgrid(np.linspace(0, 1, 16), np.linspace(0, 1, 16), indexing="ij")
    img = np.sin(2 * np.pi * 2 * xx) * np.cos(2 * np.pi * yy) + 0.5 * np.sin(2 * np.pi * (xx + yy))
    mask = (np.random.default_rng(1).random((16, 16)) > 0.3).astype(np.float64)
    got = vt.inpaint2(torch.from_numpy(np.where(mask > 0, img, np.nan)), torch.from_numpy(mask),
                      "db2", levels=2, steps=15)
    want = vw.inpaint2(jnp.asarray(img * mask), jnp.asarray(mask), "db2", levels=2, steps=15)
    _close(got, want, TOL_FISTA)


def test_sparse_recover_matches_jax():
    rng = np.random.default_rng(3)
    a_mat = rng.standard_normal((64, 128)) / 8.0
    x = np.zeros(128)
    x[[10, 40, 90]] = (1.0, -2.0, 0.5)
    meas = a_mat @ x
    a_t = torch.from_numpy(a_mat)
    kw = dict(signal_shape=(128,), lam=1e-3, lam_init=1.0, steps=20, levels=2)
    got = vt.sparse_recover(torch.from_numpy(meas), lambda v: a_t @ v, "db2",
                            dtype=torch.float64, **kw)
    want = vw.sparse_recover(jnp.asarray(meas), lambda v: jnp.asarray(a_mat) @ v, "db2",
                             dtype=jnp.float64, **kw)
    _close(got.signal, want.signal, TOL_FISTA)
    with pytest.raises(InvalidArgumentError):
        vt.sparse_recover(torch.zeros(8), lambda v: v, "db4", signal_shape=(8,), lam=0.1,
                          steps=2, levels=1, ndim=3)


@pytest.mark.parametrize("case", ["bpdn", "inpaint", "inpaint_no_enforce", "inpaint2",
                                  "compressed_sensing"])
def test_solver_quality(case):
    """The quality checks of ``tests/test_sparse.py`` on the port (float32,
    the JAX tests' step counts)."""
    if case == "bpdn":
        clean, noisy = _sines(noise=0.3)
        y = torch.from_numpy(noisy.astype(np.float32))
        out = vt.bpdn(y, "db8", steps=100).signal.numpy()
        mse_out = np.mean((out - clean) ** 2)
        assert 10 * np.log10(np.mean((noisy - clean) ** 2) / mse_out) > 2.5
        assert mse_out < np.mean((vt.denoise(y, "db8").numpy() - clean) ** 2)
    elif case in ("inpaint", "inpaint_no_enforce"):
        n = 512 if case == "inpaint" else 256
        clean, _ = _sines(n)
        mask = (np.random.default_rng(3 if n == 512 else 4).random(n)
                > (0.4 if n == 512 else 0.3)).astype(np.float32)
        y = torch.from_numpy((clean * mask).astype(np.float32))
        enforce = case == "inpaint"
        out = vt.inpaint(y, torch.from_numpy(mask), "db8" if enforce else "db4",
                         steps=200 if enforce else 150, enforce_data=enforce).numpy()
        sel = mask == 0 if enforce else mask == 1
        assert np.sqrt(np.mean((out[sel] - clean[sel]) ** 2)) / np.std(clean) < 0.1
        if enforce:
            np.testing.assert_array_equal(out[mask == 1], y.numpy()[mask == 1])
    elif case == "inpaint2":
        yy, xx = np.meshgrid(np.linspace(0, 1, 32), np.linspace(0, 1, 32), indexing="ij")
        img = (np.sin(2 * np.pi * 2 * xx) * np.cos(2 * np.pi * yy)
               + 0.5 * np.sin(2 * np.pi * (xx + yy)))
        mask = (np.random.default_rng(1).random((32, 32)) > 0.3).astype(np.float32)
        out = vt.inpaint2(torch.from_numpy(img.astype(np.float32)), torch.from_numpy(mask),
                          "db4", levels=2, steps=80).numpy()
        miss = mask == 0
        assert np.sqrt(np.mean((out[miss] - img[miss]) ** 2)) / np.std(img) < 0.1
        np.testing.assert_array_equal(out[~miss], img[~miss].astype(np.float32))
    else:
        rng = np.random.default_rng(1)
        n, m = 256, 128
        zero = vt.modwt_multilevel(torch.zeros(n), "db4", levels=4)
        planes = []
        for k in range(5):
            v = np.zeros(n, np.float32)
            if k < 2:
                v[rng.choice(n, 3, replace=False)] = 2.0 * rng.standard_normal(3)
            planes.append(torch.from_numpy(v))
        x_true = vt.imodwt_multilevel(vt.MultiLevelMODWTResult(tuple(planes[:4]), planes[4]),
                                      "db4")
        assert zero.levels == 4
        a_mat = torch.from_numpy((rng.standard_normal((m, n)) / np.sqrt(m)).astype(np.float32))
        r = vt.sparse_recover(a_mat @ x_true, lambda v: a_mat @ v, "db4", signal_shape=(n,),
                              lam=1e-4, lam_init=1.0, steps=400, levels=4)
        assert float(torch.linalg.norm(r.signal - x_true) / torch.linalg.norm(x_true)) < 0.15


# ---------------------------------------------------------------------------
# ForWaRD deconvolution
# ---------------------------------------------------------------------------


def _gaussian_kernel(width, taps):
    t = np.arange(taps) - taps // 2
    k = np.exp(-0.5 * (t / width) ** 2)
    return np.fft.ifftshift(k / k.sum())


def _blur(x, kernel, n):
    return np.fft.ifft(np.fft.fft(x) * np.fft.fft(kernel, n=n)).real


def _composite(n, seed=7):
    t = np.arange(n)
    return (np.sin(2 * np.pi * t / 32.0) + 0.5 * np.sin(2 * np.pi * t / 8.0)
            + 0.25 * np.sin(2 * np.pi * t / 128.0 + 0.6))


def _gaussian_psf(width, taps):
    t = np.arange(taps) - taps // 2
    g = np.exp(-0.5 * (t / width) ** 2)
    psf = np.outer(g, g)
    return psf / psf.sum()


def _blur2(img, psf):
    h, w = img.shape
    pad = np.zeros((h, w))
    pad[: psf.shape[0], : psf.shape[1]] = psf
    pad = np.roll(pad, (-(psf.shape[0] // 2), -(psf.shape[1] // 2)), axis=(0, 1))
    return np.fft.ifft2(np.fft.fft2(img) * np.fft.fft2(pad)).real, pad


def _test_image(h=32, w=32):
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.sin(2 * np.pi * yy / 16) + 0.7 * np.cos(2 * np.pi * xx / 10)
    img[h // 2 :, :] += 1.2
    return img


def test_level_responses_equal_jax_and_the_impulse_oracle():
    w = vt.wavelet("db4")
    got = _level_responses(256, w, 4)
    want = jax_level_responses(256, vw.wavelet("db4"), 4)
    for g, o in zip(got, want):
        np.testing.assert_allclose(g, o, rtol=0, atol=1e-14)
    impulse = torch.zeros(256, dtype=torch.float64)
    impulse[0] = 1.0
    tree = vt.modwt_multilevel(impulse, "db4", levels=4, backend="torch")
    for g_pow, detail in zip(got, tree.details):
        np.testing.assert_allclose(g_pow, np.abs(np.fft.fft(detail.numpy())) ** 2, atol=1e-12)


def test_deconvolve_matches_jax():
    n = 512
    kernel = _gaussian_kernel(3.0, 17)
    rng = np.random.default_rng(5)
    noisy = np.stack([_blur(_composite(n), kernel, n), _blur(-_composite(n), kernel, n)])
    noisy += 0.05 * rng.standard_normal(noisy.shape)
    want = jax.jit(lambda y: (vw.deconvolve(y, kernel, "db2", levels=3),
                              vw.deconvolve(y, kernel, "db2", levels=2, sigma=0.05,
                                            method="sure", mode="soft")))(jnp.asarray(noisy))
    got = (vt.deconvolve(torch.from_numpy(noisy), kernel, "db2", levels=3),
           vt.deconvolve(torch.from_numpy(noisy), kernel, "db2", levels=2, sigma=0.05,
                         method="sure", mode="soft"))
    for g, w in zip(got, want):
        for field in ("signal", "wiener", "sigma"):
            _close(getattr(g, field), getattr(w, field))
        assert len(g.level_sigmas) == len(w.level_sigmas)
        for gs, ws in zip(g.level_sigmas, w.level_sigmas):
            _close(gs, ws)
    # float32: complex64 Fourier step, held to the float64 reference
    f32 = vt.deconvolve(torch.from_numpy(noisy.astype(np.float32)), kernel, "db2", levels=3)
    assert f32.signal.dtype == torch.float32
    _close(f32.signal.double(), want[0].signal, TOL_F32)


def test_deconvolve2_matches_jax():
    clean = _test_image()
    blurred, psf0 = _blur2(clean, _gaussian_psf(1.2, 7))
    noisy = np.stack([blurred, blurred]) + 0.03 * np.random.default_rng(2).standard_normal(
        (2, 32, 32))
    want = jax.jit(lambda y: vw.deconvolve2(y, psf0, "db2", levels=2))(jnp.asarray(noisy))
    got = vt.deconvolve2(torch.from_numpy(noisy), psf0, "db2", levels=2)
    for field in ("signal", "wiener", "sigma"):
        _close(getattr(got, field), getattr(want, field))
    for gt, wt in zip(got.level_sigmas, want.level_sigmas):
        assert len(gt) == 3
        for gs, ws in zip(gt, wt):
            _close(gs, ws)
    f32 = vt.deconvolve2(torch.from_numpy(noisy.astype(np.float32)), psf0, "db2", levels=2)
    _close(f32.signal.double(), want.signal, TOL_F32)


@pytest.mark.parametrize("case", ["beats_blurred", "beats_naive", "noiseless", "identity",
                                  "batched", "image", "image_batched"])
def test_deconvolve_quality(case):
    """The quality checks of ``tests/test_deconvolve.py`` on the port."""
    rng = np.random.default_rng(42)
    rms = lambda a, b: float(np.sqrt(np.mean((a - b) ** 2)))  # noqa: E731
    if case == "beats_blurred":
        n = 2048
        clean = _composite(n)
        noisy = _blur(clean, _gaussian_kernel(4.0, 33), n) + 0.05 * rng.standard_normal(n)
        res = vt.deconvolve(torch.from_numpy(noisy), _gaussian_kernel(4.0, 33), "sym8", levels=4)
        err = rms(res.signal.numpy(), clean)
        assert err < 0.1 * rms(noisy, clean)
        assert len(res.level_sigmas) == 4 and all(float(s.min()) > 0 for s in res.level_sigmas)
        assert err <= 1.05 * rms(res.wiener.numpy(), clean)
    elif case == "beats_naive":
        n = 1024
        clean, kernel = _composite(n), _gaussian_kernel(6.0, 65)
        noisy = _blur(clean, kernel, n) + 0.05 * rng.standard_normal(n)
        naive = np.fft.ifft(np.fft.fft(noisy) / np.fft.fft(kernel, n=n)).real
        res = vt.deconvolve(torch.from_numpy(noisy), kernel, "sym8", sigma=0.05)
        assert rms(res.signal.numpy(), clean) < 0.1 * rms(naive, clean)
    elif case == "noiseless":
        n = 1024
        clean, kernel = _composite(n), _gaussian_kernel(2.0, 17)
        res = vt.deconvolve(torch.from_numpy(_blur(clean, kernel, n)), kernel, "sym8", sigma=1e-8)
        assert np.linalg.norm(res.signal.numpy() - clean) / np.linalg.norm(clean) < 1e-3
    elif case == "identity":
        clean = _composite(1024)
        noisy = clean + 0.3 * rng.standard_normal(1024)
        res = vt.deconvolve(torch.from_numpy(noisy), np.array([1.0]), "sym8")
        assert rms(res.signal.numpy(), clean) < rms(noisy, clean)
    elif case == "batched":
        n, kernel = 512, _gaussian_kernel(3.0, 17)
        clean = np.stack([_composite(n), np.roll(_composite(n), 37)])
        noisy = np.stack([_blur(c, kernel, n) for c in clean]) + 0.05 * rng.standard_normal((2, n))
        out = vt.deconvolve(torch.from_numpy(noisy), kernel, "db4", levels=3).signal.numpy()
        assert out.shape == noisy.shape
        assert all(rms(out[i], clean[i]) < rms(noisy[i], clean[i]) for i in range(2))
    elif case == "image":
        clean = _test_image(64, 64)
        blurred, psf0 = _blur2(clean, _gaussian_psf(1.8, 11))
        noisy = blurred + 0.05 * rng.standard_normal(clean.shape)
        res = vt.deconvolve2(torch.from_numpy(noisy), psf0, "sym4", levels=3)
        assert rms(res.signal.numpy(), clean) < 0.5 * rms(noisy, clean)
        assert len(res.level_sigmas) == 3 and all(len(t) == 3 for t in res.level_sigmas)
    else:
        clean = _test_image()
        blurred, psf0 = _blur2(clean, _gaussian_psf(1.2, 7))
        noisy = np.stack([blurred, blurred]) + 0.03 * rng.standard_normal((2, 32, 32))
        out = vt.deconvolve2(torch.from_numpy(noisy), psf0, "db4", levels=2).signal.numpy()
        assert out.shape == (2, 32, 32)
        assert all(rms(out[i], clean) < rms(noisy[i], clean) for i in range(2))


def test_deconvolve_kernel_validation():
    y = torch.zeros(128)
    for kernel in (np.zeros(5), np.ones((3, 3)), np.ones(256), np.array([np.nan])):
        with pytest.raises(InvalidArgumentError):
            vt.deconvolve(y, kernel)
    y2 = torch.zeros(32, 32)
    for img, psf in ((y2, np.zeros((3, 3))), (y2, np.ones(5)), (y2, np.ones((64, 64))),
                     (torch.zeros(32), np.ones((3, 3)))):
        with pytest.raises(InvalidArgumentError):
            vt.deconvolve2(img, psf)


# ---------------------------------------------------------------------------
# Block shrinkage
# ---------------------------------------------------------------------------


def _doppler(n):
    t = np.linspace(1e-3, 1, n)
    x = np.sqrt(t * (1 - t)) * np.sin(2.1 * np.pi / (t + 0.05))
    return x / x.std()


def _snr(clean, est):
    return 10 * np.log10(np.sum(clean**2) / np.sum((est - clean) ** 2))


@pytest.mark.parametrize("n, block_size", [(1000, None)])
def test_block_shrink_matches_jax(n, block_size):
    c = 1.5 * np.random.default_rng(n).standard_normal((2, n))
    sigma = np.array([[0.8], [1.1]])
    want = jax_block_shrink(jnp.asarray(c), jnp.asarray(sigma), block_size=block_size)
    got = vt.block_shrink(torch.from_numpy(c), torch.from_numpy(sigma), block_size=block_size)
    _close(got, want)
    f32 = vt.block_shrink(torch.from_numpy(c.astype(np.float32)), 0.9)
    _close(f32.double(), jax_block_shrink(jnp.asarray(c), 0.9), TOL_BLOCK_F32)
    assert vt.BLOCK_LAMBDA == 4.50524


def test_denoise_block_matches_jax():
    rng = np.random.default_rng(6)
    noisy = np.stack([_doppler(512), -_doppler(512)]) + 0.25 * rng.standard_normal((2, 512))
    want = jax.jit(lambda y: vw.denoise_block(y, "db2", levels=3))(jnp.asarray(noisy))
    _close(vt.denoise_block(torch.from_numpy(noisy), "db2", levels=3), want)
    f32 = vt.denoise_block(torch.from_numpy(noisy.astype(np.float32)), "db2", levels=3)
    assert f32.dtype == torch.float32
    _close(f32.double(), want, TOL_BLOCK_F32)


@pytest.mark.parametrize("case", ["strong_blocks", "tiny_sigma", "doppler_1000", "doppler_1024",
                                  "batched"])
def test_block_quality(case):
    """The block cases of ``tests/test_block_fdr.py`` on the port."""
    if case == "strong_blocks":
        c = np.zeros(1024, dtype=np.float32)
        c[100:116] = 10.0
        out = vt.block_shrink(torch.from_numpy(c), 1.0).numpy()
        assert np.linalg.norm(out[100:116]) > 0.9 * np.linalg.norm(c[100:116])
        noise = np.random.default_rng(3).standard_normal(1024).astype(np.float32)
        out = vt.block_shrink(torch.from_numpy(noise), 1.0).numpy()
        assert np.sum(out**2) < 0.05 * np.sum(noise**2)
    elif case == "tiny_sigma":
        x = np.random.default_rng(4).standard_normal(300).astype(np.float32)
        assert np.allclose(vt.block_shrink(torch.from_numpy(x), 1e-6).numpy(), x, atol=1e-5)
    elif case.startswith("doppler"):
        n = int(case.split("_")[1])
        clean = _doppler(n)
        noisy = torch.from_numpy((clean + 0.3 * np.random.default_rng(5).standard_normal(n))
                                 .astype(np.float32))
        den_block = vt.denoise_block(noisy, "sym8", levels=5).numpy()
        den_uni = vt.denoise_multilevel(noisy, "sym8", levels=5).numpy()
        assert _snr(clean, den_block) > _snr(clean, noisy.numpy()) + 6
        assert _snr(clean, den_block) > _snr(clean, den_uni)
    else:
        clean = np.stack([_doppler(512), -_doppler(512)])
        noisy = (clean + 0.25 * np.random.default_rng(6).standard_normal((2, 512))).astype(
            np.float32)
        den = vt.denoise_block(torch.from_numpy(noisy), "db4", levels=4).numpy()
        assert den.shape == (2, 512)
        assert all(_snr(clean[i], den[i]) > _snr(clean[i], noisy[i]) + 4 for i in range(2))
