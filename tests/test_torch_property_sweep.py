"""Mirror of the JAX package's seeded property sweep
(``tests/test_property_sweep.py``) on the port, in tier 1.

Every test of the sweep, at the sweep's own draws (same generators, seeds,
wavelets, lengths, depths, boundaries and batch ranks), checks the sweep's
invariants on the port, and holds the port to a reference:

* the 24 seeded MODWT configurations (the draw is
  ``tools/mirror_cases.sweep_configs``, checked equal to the JAX sweep's):
  shapes, finiteness, periodic reconstruction within 1e-8, the zero
  boundary's interior within 1e-8, and every plane of every batch row
  against ``tests/golden.py``'s numpy oracle at 1e-12 in float64.  Six of
  them are also held to ``vw.modwt_multilevel(..., backend='jnp')`` and its
  inverse at 1e-12 of the largest value (:data:`MODWT_AGAINST_JAX`: one a
  boundary, bior2.4, rbio3.1 and db7, which bounds the JAX compile cost);
* the DWT pyramid, the denoise across ranks and the SWT editing against the
  JAX jnp path in float64 at 1e-12 (the denoise at 1e-10: its thresholds
  pass through a sort and a log);
* the dual tree (1-D and 2-D), the 2-D CWT, scattering and the multifractal
  spectrum: the sweep's invariants on every draw, in float32 as the sweep
  runs them, and the JAX package's result in float64 on the draws named in
  each test (their JAX references compile per shape, 2-20 s each on the
  CPU): 1e-12 for the dual tree, 1e-10 of the largest value for the 2-D
  dual tree, the 2-D CWT and scattering, 1e-9 for the spectrum's fits.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from tools.mirror_cases import sweep_configs, sweep_input

from .golden import modwt_multilevel_golden

torch.set_num_threads(1)

TOL_GOLDEN = 1e-12
#: sweep indices held to the JAX package too: periodic db4, zero db2,
#: symmetric haar, symmetric bior2.4 at a batch of (2, 2), zero rbio3.1,
#: periodic db7
MODWT_AGAINST_JAX = (1, 16, 6, 13, 8, 15)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _rel(got, want) -> float:
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


@partial(jax.jit, static_argnames=("name", "levels", "boundary"))
def _jax_modwt_roundtrip(x, name, levels, boundary):
    res = vw.modwt_multilevel(x, name, levels=levels, boundary=boundary, backend="jnp")
    return res, vw.imodwt_multilevel(res, name, boundary=boundary, backend="jnp")


def _params():
    return [pytest.param(w, n, b, batch, i, id=f"{i}-{w}-{n}-{b}-{batch}")
            for w, n, b, batch, i in sweep_configs()]


@pytest.mark.parametrize("wavelet,n,boundary,batch,seed", _params())
def test_modwt_multilevel_properties(wavelet, n, boundary, batch, seed):
    x, levels = sweep_input(wavelet, n, batch, seed)
    res = vt.modwt_multilevel(_t(x), wavelet, levels=levels, boundary=boundary)
    assert res.approx.shape == x.shape
    assert all(d.shape == x.shape for d in res.details)
    assert bool(torch.isfinite(res.approx).all())
    xr = vt.imodwt_multilevel(res, wavelet, boundary=boundary)
    assert xr.shape == x.shape
    if boundary == "periodic":
        assert float((xr - _t(x)).abs().max()) < 1e-8
    elif boundary == "zero":
        halo = (vt.wavelet(wavelet).filter_length - 1) * (2 ** levels - 1)
        if n - 2 * halo > 8:
            assert float((xr - _t(x)).abs()[..., halo:-halo].max()) < 1e-8
    w = vt.wavelet(wavelet)
    rows = x.reshape(-1, n)
    planes = [_np(p).reshape(-1, n) for p in (*res.details, res.approx)]
    for r, row in enumerate(rows):
        g_details, g_approx = modwt_multilevel_golden(row, w, levels, boundary)
        for got, want in zip(planes, (*g_details, g_approx)):
            assert np.abs(got[r] - want).max() <= TOL_GOLDEN, r
    if seed in MODWT_AGAINST_JAX:
        want, want_xr = _jax_modwt_roundtrip(jnp.asarray(x), wavelet, levels, boundary)
        for got, ref in zip((*res.details, res.approx, xr),
                            (*want.details, want.approx, want_xr)):
            assert _rel(got, ref) <= TOL_GOLDEN


@pytest.mark.parametrize(
    "wavelet,n,seed",
    [("haar", 128, 0), ("db3", 250, 1), ("sym4", 96, 2), ("bior3.3", 64, 3)],
)
def test_dwt_pyramid_properties(wavelet, n, seed):
    """waverec(wavedec(x)) within 1e-8 of x; both within 1e-12 of JAX's."""
    x = np.random.default_rng(seed).standard_normal(n)
    levels = min(3, vt.max_dwt_levels(n, wavelet))
    assert levels == min(3, vw.max_dwt_levels(n, wavelet))
    dec = vt.wavedec(_t(x), wavelet, levels=levels)
    rec = vt.waverec(dec, wavelet)
    assert float((rec - _t(x)).abs().max()) < 1e-8
    jdec, jrec = jax.jit(lambda z: (lambda d: (d, vw.waverec(d, wavelet)))(
        vw.wavedec(z, wavelet, levels=levels)))(jnp.asarray(x))
    for got, want in zip(jax.tree_util.tree_leaves(tuple(dec)),
                         jax.tree_util.tree_leaves(tuple(jdec))):
        assert _rel(got, want) <= TOL_GOLDEN
    assert _rel(rec, jrec) <= TOL_GOLDEN


def test_denoise_shapes_across_ranks():
    """Every method keeps the shape and stays finite over three batch ranks;
    the 1-D draw within 1e-10 of the JAX denoise for each method."""
    rng = np.random.default_rng(7)
    methods = ("universal", "sure", "minimax", "bayes")
    jax_denoise = jax.jit(lambda z: tuple(
        vw.denoise_multilevel(z, "sym4", levels=3, method=m) for m in methods))
    for shape in [(256,), (3, 256), (2, 2, 128)]:
        x = rng.standard_normal(shape)
        outs = [vt.denoise_multilevel(_t(x), "sym4", levels=3, method=m) for m in methods]
        for out in outs:
            assert out.shape == shape
            assert bool(torch.isfinite(out).all())
        if shape == (256,):
            for got, want in zip(outs, jax_denoise(jnp.asarray(x))):
                assert _rel(got, want) <= 1e-10


def test_swt_editing_across_ranks():
    """swt -> universal threshold -> iswt on a [2, 200] batch: finite, of the
    input's shape, within 1e-12 of JAX's."""
    x = np.random.default_rng(8).standard_normal((2, 200))
    res = vt.swt(_t(x), "db4", levels=3)
    back = vt.iswt(vt.apply_universal_threshold(res, mode="hard"), "db4")
    assert back.shape == x.shape
    assert bool(torch.isfinite(back).all())
    want = jax.jit(lambda z: vw.iswt(vw.apply_universal_threshold(
        vw.swt(z, "db4", levels=3), mode="hard"), "db4"))(jnp.asarray(x))
    assert _rel(back, want) <= TOL_GOLDEN


# --- the new-transform sweeps ------------------------------------------------------


def _dyadic_configs(n_cases=10, seed=77):
    rng = np.random.default_rng(seed)
    for i in range(n_cases):
        levels = int(rng.integers(1, 5))
        n = (1 << levels) * int(rng.integers(4, 40))
        batch = () if rng.random() < 0.5 else (int(rng.integers(1, 4)),)
        yield pytest.param(n, levels, batch, i, id=f"{i}-n{n}-J{levels}-{batch}")


#: dual-tree draws held to JAX: the shortest (14 samples), a batch of two at
#: J=2, and the deepest (J=3)
DTCWT_AGAINST_JAX = (3, 2, 5)


@pytest.mark.parametrize("n,levels,batch,seed", _dyadic_configs())
def test_dtcwt_properties(n, levels, batch, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(batch + (n,)).astype(np.float32)
    res = vt.dtcwt(_t(x), levels=levels)
    xr = vt.idtcwt(res)
    assert xr.shape == x.shape
    assert float((xr - _t(x)).abs().max()) < 1e-4
    total = sum(float((z.abs() ** 2).sum()) for z in res.highpasses)
    total += 0.5 * float((res.lowpass_a ** 2).sum() + (res.lowpass_b ** 2).sum())
    assert total == pytest.approx(float((_t(x) ** 2).sum()), rel=1e-4)
    if seed in DTCWT_AGAINST_JAX:
        x64 = x.astype(np.float64)
        got = vt.dtcwt(_t(x64), levels=levels)
        want = jax.jit(lambda z: vw.dtcwt(z, levels=levels))(jnp.asarray(x64))
        for g, w in zip((*got.highpasses, got.lowpass_a, got.lowpass_b),
                        (*want.highpasses, want.lowpass_a, want.lowpass_b)):
            assert _rel(g, w) <= TOL_GOLDEN


def _dyadic2d_configs(n_cases=6, seed=78):
    rng = np.random.default_rng(seed)
    for i in range(n_cases):
        levels = int(rng.integers(1, 4))
        h = (1 << levels) * int(rng.integers(4, 12))
        w = (1 << levels) * int(rng.integers(4, 12))
        yield pytest.param(h, w, levels, i, id=f"{i}-{h}x{w}-J{levels}")


#: the 2-D dual-tree draw held to JAX: the smallest (18x16, J=1)
DTCWT2_AGAINST_JAX = (5,)


@pytest.mark.parametrize("h,w,levels,seed", _dyadic2d_configs())
def test_dtcwt2_properties(h, w, levels, seed):
    img = np.random.default_rng(seed).standard_normal((h, w)).astype(np.float32)
    res = vt.dtcwt2(_t(img), levels=levels)
    rec = vt.idtcwt2(res)
    assert float((rec - _t(img)).abs().max()) < 2e-4
    hp = sum(float((z.abs() ** 2).sum()) for z in res.highpasses)
    lp = float((res.lowpasses ** 2).sum())
    assert (2 * hp + lp) / 4 == pytest.approx(float((_t(img) ** 2).sum()), rel=1e-4)
    if seed in DTCWT2_AGAINST_JAX:
        img64 = img.astype(np.float64)
        got = vt.dtcwt2(_t(img64), levels=levels)
        want = jax.jit(lambda z: vw.dtcwt2(z, levels=levels))(jnp.asarray(img64))
        for g, wv in zip((*got.highpasses, got.lowpasses), (*want.highpasses, want.lowpasses)):
            assert _rel(g, wv) <= 1e-10
        assert _rel(vt.idtcwt2(got), vw.idtcwt2(want)) <= 1e-10


def _cwt2_configs(n_cases=6, seed=79):
    rng = np.random.default_rng(seed)
    wavelets = ["morl2", "mexh2", "gaus2"]
    for i in range(n_cases):
        h = int(rng.integers(24, 96))
        w = int(rng.integers(24, 96))
        n_scales = int(rng.integers(1, 6))
        wname = wavelets[rng.integers(3)]
        yield pytest.param(h, w, n_scales, wname, i, id=f"{i}-{h}x{w}-{wname}")


def _wavelet2(package, wname):
    return (package.morlet2() if wname == "morl2" else
            package.mexican_hat2() if wname == "mexh2" else package.gaussian2(2))


#: 2-D CWT draws held to JAX: a Morlet with two angles, a Mexican hat
CWT2_AGAINST_JAX = (0, 3)


@pytest.mark.parametrize("h,w,n_scales,wname,seed", _cwt2_configs())
def test_cwt2_properties(h, w, n_scales, wname, seed):
    img = np.random.default_rng(seed).standard_normal((h, w)).astype(np.float32)
    scales = tuple(np.geomspace(1.5, 8, n_scales))
    wav = _wavelet2(vt, wname)
    angles = (0.0,) if wav.isotropic else (0.0, np.pi / 3)
    res = vt.cwt2(_t(img), scales, wav, angles=angles)
    assert res.coeffs.shape == (n_scales, len(angles), h, w)
    assert bool(torch.isfinite(res.coeffs.abs()).all())
    rec = vt.icwt2(res, wav)
    assert rec.shape == (h, w)
    assert bool(torch.isfinite(rec).all())
    if seed in CWT2_AGAINST_JAX:
        img64 = img.astype(np.float64)
        jwav = _wavelet2(vw, wname)
        got = vt.cwt2(_t(img64), scales, wav, angles=angles)
        coeffs, jrec = jax.jit(lambda z: (lambda r: (r.coeffs, vw.icwt2(r, jwav)))(
            vw.cwt2(z, scales, jwav, angles=angles)))(jnp.asarray(img64))
        assert _rel(got.coeffs, coeffs) <= 1e-10
        assert _rel(vt.icwt2(got, wav), jrec) <= 1e-10


def _scatter_configs(n_cases=6, seed=80):
    rng = np.random.default_rng(seed)
    for i in range(n_cases):
        J = int(rng.integers(3, 8))
        Q = int(rng.integers(1, 9))
        n = (1 << J) * int(rng.integers(2, 20))
        order = int(rng.integers(1, 3))
        yield pytest.param(n, J, Q, order, i, id=f"{i}-n{n}-J{J}-Q{Q}-o{order}")


#: scattering draws held to JAX: order 1 at 64 samples, order 2 at 128
SCATTERING_AGAINST_JAX = (4, 3)


@pytest.mark.parametrize("n,J,Q,order,seed", _scatter_configs())
def test_scattering_properties(n, J, Q, order, seed):
    x = np.random.default_rng(seed).standard_normal((2, n)).astype(np.float32)
    res = vt.scattering1d(_t(x), J=J, Q=Q, order=order)
    t = n // (1 << J)
    assert res.s0.shape == (2, t)
    assert res.s1.shape[0] == 2 and res.s1.shape[-1] == t
    assert float(res.s1.min()) >= 0
    assert bool(torch.isfinite(res.feature_vector()).all())
    if order == 2:
        assert res.s2.shape[-1] == t
        if res.s2.shape[-2]:
            assert float(res.s2.min()) >= 0
    if seed in SCATTERING_AGAINST_JAX:
        x64 = x.astype(np.float64)
        got = vt.scattering1d(_t(x64), J=J, Q=Q, order=order)
        want = jax.jit(lambda z: vw.scattering1d(z, J=J, Q=Q, order=order).feature_vector())(
            jnp.asarray(x64))
        assert _rel(got.feature_vector(), want) <= 1e-10


def test_multifractal_random_lengths_finite():
    """Every field finite at 1000, 1536, 4096 and 5000 samples; at 1000 the
    fields within 1e-9 of the JAX spectrum (one jit)."""
    rng = np.random.default_rng(81)
    for n in (1000, 1536, 4096, 5000):
        x = np.cumsum(rng.standard_normal(n)).astype(np.float32)
        res = vt.multifractal_spectrum(_t(x), "db2", min_level=1)
        for leaf in (res.zeta, res.h, res.D, res.c1, res.c2):
            assert bool(torch.isfinite(torch.as_tensor(leaf)).all()), n
        if n == 1000:
            x64 = x.astype(np.float64)
            got = vt.multifractal_spectrum(_t(x64), "db2", min_level=1)
            want = jax.jit(lambda z: tuple(vw.multifractal_spectrum(z, "db2", min_level=1)[1:6]))(
                jnp.asarray(x64))
            for g, w in zip((got.zeta, got.h, got.D, got.c1, got.c2), want):
                assert np.abs(_np(g) - np.asarray(w)).max() <= 1e-9
