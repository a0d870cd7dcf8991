"""Port parity: thresholds, noise estimation and multi-level denoising.

Same seeded numpy input to both packages.  In float64 the port must agree
with vectorwave_tpu to 1e-10: the median and the decimated sigma reproduce
the JAX package's float32 semantics (including its summation order), so
they agree bit for bit.  So must ``denoise_packet`` (named and callable
costs: both packages must pick the same basis) and ``dtcwt_denoise``, which
mirror ``tests/test_packets.py`` and ``tests/test_dtcwt_shrink.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from vectorwave_tpu.denoise.denoiser import _fused_sigma as jax_fused_sigma
from vectorwave_tpu.ops import thresholds as jth
from vectorwave_tpu_torch.denoise.denoiser import _fused_sigma, threshold_coeffs
from vectorwave_tpu_torch.errors import InvalidArgumentError

torch.set_num_threads(1)

TOL = 1e-10


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


def _noisy(b, n, seed=0, noise=0.4):
    t = np.arange(n)
    clean = np.sin(2 * np.pi * t / 256.0) + 0.5 * np.sin(2 * np.pi * t / 1024.0 + 0.3)
    return clean + np.random.default_rng(seed).normal(0.0, noise, (b, n))


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", [1000, 1001, 2, 1])
def test_mad_sigma_matches_jax_even_and_odd(n, dtype):
    d = (_x((3, n), seed=n) * 2.5).astype(dtype)
    got = vt.mad_sigma(torch.from_numpy(d))
    want = jth.mad_sigma(d)
    assert got.dtype == torch.from_numpy(d).dtype and got.shape == (3, 1)
    _close(got, want)


def test_median_magnitude_averages_the_middle_pair_in_float32():
    v = torch.tensor([[1.0, 2.0, 4.0, 8.0]], dtype=torch.float64)
    assert float(vt.median_magnitude(v)) == 3.0  # torch.median would give 2.0
    assert float(vt.median_magnitude(v[:, :3])) == 2.0


def _jax_and_port_grad(fn_jax, fn_port, v):
    want = np.asarray(jax.grad(lambda a: jnp.sum(fn_jax(a)))(jnp.asarray(v)))
    t = torch.from_numpy(np.array(v)).requires_grad_(True)
    (got,) = torch.autograd.grad(fn_port(t).sum(), t)
    return got.numpy(), want


@pytest.mark.parametrize("v", [
    [[3.0, -1.0, 1.0, 1.0, 5.0, -1.0, 7.0]],        # odd count, four ties at the median
    [[3.0, -1.0, 1.0, 2.0, 5.0, -2.0, 7.0, 2.0]],   # even count, ties at both middles
    [[0.5, -0.5, 0.5, 2.0], [1.0, -3.0, 3.0, 3.0]],  # rows: a tie across the pair
], ids=["odd", "even", "rows"])
def test_median_magnitude_gradient_matches_jax_on_ties(v):
    """The JAX rule: each middle order statistic's subgradient is shared by
    every position whose float32 |v| equals it (the toy case: -1.4826 / 4
    on each of the four tied entries), and the middles are averaged; the
    second derivative is zero."""
    got, want = _jax_and_port_grad(jth.mad_sigma, vt.mad_sigma, v)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())
    if len(v) == 1 and len(v[0]) == 7:
        assert (np.abs(want[0, [1, 2, 3, 5]]) == np.abs(want).max()).all()
        np.testing.assert_allclose(np.abs(want).max(), 1 / (4 * 0.6745), rtol=1e-6)
    t = torch.tensor(v, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(vt.median_magnitude(t).sum(), t, create_graph=True)
    (gg,) = torch.autograd.grad((g * torch.arange(g.numel()).reshape(g.shape)).sum(), t,
                                allow_unused=True, materialize_grads=True)
    assert not gg.any()


@pytest.mark.parametrize("wavelet", ["haar", "db4"], ids=["ties", "no_ties"])
def test_denoise_gradient_on_a_quantized_walk_matches_jax_grad(wavelet):
    """d/dx sum(denoise_multilevel(x, levels=4)^2) on a random walk in
    quarter ticks, as prices come: with haar 154 level-1 coefficients tie at
    the median of |d1| (a gradient through the sort put the whole
    subgradient on one of them, 9.5 times JAX's largest entry off); with db4
    none does.  Float64 on the CPU, within 1e-10 of JAX's largest entry."""
    x = np.round(4 * np.cumsum(np.random.default_rng(0).standard_normal((1, 1024)),
                               axis=-1)) / 4
    d1 = np.abs(np.asarray(vw.modwt(jnp.asarray(x), wavelet).detail)).astype(np.float32)
    ties = int((d1 == np.sort(d1[0])[511]).sum())
    assert (ties == 154) if wavelet == "haar" else (ties == 1)
    got, want = _jax_and_port_grad(lambda a: vw.denoise_multilevel(a, wavelet, levels=4) ** 2,
                                   lambda a: vt.denoise_multilevel(a, wavelet, levels=4) ** 2,
                                   x)
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


@pytest.mark.parametrize("method", ["universal", "minimax", "sure", "bayes", "fdr"])
def test_threshold_rules_match_jax(method):
    d = _x((2, 777), seed=11) * 0.7
    sigma = jth.mad_sigma(d)
    got = vt.select_threshold(torch.from_numpy(d), torch.tensor(np.asarray(sigma)),
                              method)
    want = jth.select_threshold(d, sigma, method)
    _close(got, want)


@pytest.mark.parametrize("n", [16, 48, 100])
def test_minimax_branches_match_jax(n):
    sigma = np.array([[0.3], [1.7]])
    _close(vt.minimax_threshold(n, torch.from_numpy(sigma)),
           jth.minimax_threshold(n, sigma))
    _close(vt.universal_threshold(n, torch.from_numpy(sigma)),
           jth.universal_threshold(n, sigma))


@pytest.mark.parametrize("mode", ["soft", "hard"])
def test_apply_threshold_matches_jax(mode):
    c = _x((2, 300), seed=12)
    t = np.array([[0.5], [1.1]])
    _close(vt.apply_threshold(torch.from_numpy(c), torch.from_numpy(t), mode),
           jth.apply_threshold(c, t, mode))


def test_unknown_threshold_names_raise():
    c = torch.zeros(1, 8)
    with pytest.raises(InvalidArgumentError):
        vt.apply_threshold(c, 0.1, "garrote")
    with pytest.raises(InvalidArgumentError):
        vt.select_threshold(c, torch.ones(1, 1), "oracle")


@pytest.mark.parametrize("boundary", ["periodic", "zero"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fused_sigma_matches_jax_decimated(dtype, boundary):
    x = (_noisy(2, 32768, seed=13) * 3.0).astype(dtype)
    got = _fused_sigma(torch.from_numpy(x), vt.wavelet("db4"), boundary)
    want = jax_fused_sigma(x, vw.wavelet("db4"), boundary)
    assert got.shape == (2, 1)
    _close(got, want)


@pytest.mark.parametrize("estimator", ["exact", "decimated"])
def test_fused_sigma_estimator_knob_matches_jax(estimator):
    from vectorwave_tpu import config as jconfig

    x = _x((2, 8192), seed=14)
    try:
        vt.set_sigma_estimator(estimator)
        jconfig.set_sigma_estimator(estimator)
        got = _fused_sigma(torch.from_numpy(x), vt.wavelet("sym8"), "periodic")
        want = jax_fused_sigma(x, vw.wavelet("sym8"), "periodic")
    finally:
        vt.set_sigma_estimator("auto")
        jconfig.set_sigma_estimator("auto")
    _close(got, want)


@pytest.mark.parametrize("method", ["universal", "sure"])
def test_threshold_coeffs_matches_jax(method):
    x = _noisy(2, 2048, seed=15)
    got_res = vt.modwt_multilevel(torch.from_numpy(x), "db4", levels=4)
    want_res = vw.modwt_multilevel(x, "db4", levels=4, backend="jnp")
    sigma = np.asarray(jth.mad_sigma(want_res.details[0]))
    got = threshold_coeffs(got_res, torch.from_numpy(sigma), method=method)
    want = vw.threshold_coeffs(want_res, sigma, method=method)
    for g, w in zip(got.details, want.details):
        _close(g, w)


@pytest.mark.parametrize("boundary", ["periodic", "zero", "symmetric"])
@pytest.mark.parametrize("method,mode", [("universal", "soft"), ("minimax", "hard"),
                                         ("sure", "soft"), ("bayes", "hard")])
def test_denoise_multilevel_matches_jax(method, mode, boundary):
    x = _noisy(2, 4096, seed=16)
    got = vt.denoise_multilevel(torch.from_numpy(x), "db4", levels=5, method=method,
                                mode=mode, boundary=boundary)
    want = vw.denoise_multilevel(x, "db4", levels=5, method=method, mode=mode,
                                 boundary=boundary)
    _close(got, want)


def test_slice_end_to_end_float32_matches_jax():
    """The main path's shape, cut to 2 signals: analysis, synthesis, round
    trip and denoise, float32 on both sides."""
    x = _noisy(2, 65536, seed=17).astype(np.float32)
    xt = torch.from_numpy(x)
    got = vt.modwt_multilevel(xt, "db4", levels=6)
    want = vw.modwt_multilevel(x, "db4", levels=6, backend="jnp")
    for g, w in zip((*got.details, got.approx), (*want.details, want.approx)):
        _close(g, w, tol=1e-5)
    y = vt.imodwt_multilevel(got, "db4")
    _close(y, vw.imodwt_multilevel(want, "db4", backend="jnp"), tol=1e-5)
    assert float((y - xt).abs().max()) < 3e-6
    _close(vt.denoise_multilevel(xt, "db4", levels=6),
           vw.denoise_multilevel(x, "db4", levels=6), tol=1e-5)


def test_fused_denoise_route_matches_jax_semantics():
    """With the kernel tier forced, denoise_multilevel takes the fused route
    (decimated sigma, one analysis-threshold-synthesis pass); on the CPU the
    kernel wrapper runs its plain version.  It equals the JAX package's jnp
    pipeline fed the same thresholds, in float32 (the route's dtypes)."""
    x = _noisy(2, 32768, seed=18).astype(np.float32)
    w = vw.wavelet("db4")
    sigma = jax_fused_sigma(x, w, "periodic")
    ths = [np.asarray(jth.universal_threshold(32768, sigma / jnp.sqrt(2.0**j)),
                      np.float32) for j in range(1, 7)]
    res = vw.modwt_multilevel(x, w, levels=6, backend="jnp")
    shrunk = vw.MultiLevelMODWTResult(
        tuple(jth.apply_threshold(d, t, "soft") for d, t in zip(res.details, ths)),
        res.approx)
    want = vw.imodwt_multilevel(shrunk, w, backend="jnp")
    try:
        vt.set_backend("kernel")
        got = vt.denoise_multilevel(torch.from_numpy(x), "db4", levels=6)
    finally:
        vt.set_backend("auto")
    full_mad = vt.denoise_multilevel(torch.from_numpy(x), "db4", levels=6)
    assert float((got - full_mad).abs().max()) > 1e-4  # the route was taken
    _close(got, want, tol=1e-5)


def test_denoise_exact_precision_raises_and_tolerance_clamps():
    x = torch.from_numpy(_noisy(1, 2048, seed=19))
    with pytest.raises(InvalidArgumentError):
        vt.denoise_multilevel(x, "db4", levels=4, precision="exact")
    got = vt.denoise_multilevel(x, "db4", levels=4, tolerance=1e-12)
    _close(got, vw.denoise_multilevel(x.numpy(), "db4", levels=4))


def test_fused_denoise_gradients_match_jax_grad():
    """On the CPU the fused denoise differentiates through its plain version,
    in x and in the thresholds (soft: -sign(d) where |d| > t)."""
    x = _noisy(2, 1024, seed=20)
    th = np.array([[0.3, 0.2, 0.1, 0.05], [0.25, 0.15, 0.12, 0.02]])
    wts = _x((2, 1024), seed=21)

    def jloss(xx, tt):
        res = vw.modwt_multilevel(xx, "db4", levels=4, backend="jnp")
        dets = tuple(jth.apply_threshold(d, tt[:, j : j + 1], "soft")
                     for j, d in enumerate(res.details))
        y = vw.imodwt_multilevel(vw.MultiLevelMODWTResult(dets, res.approx), "db4",
                                 backend="jnp")
        return jnp.sum(y * wts)

    want_x, want_t = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(th))
    xt = torch.from_numpy(x).requires_grad_(True)
    tt = torch.from_numpy(th).requires_grad_(True)
    from vectorwave_tpu_torch.kernels import modwt_composite as mc
    from vectorwave_tpu_torch.kernels.modwt_fused import _kernel_filters

    wv = vt.wavelet("db4")
    y = mc.denoise(xt, tt, 4, _kernel_filters(wv, False), _kernel_filters(wv, True),
                   True, "soft")
    gx, gt = torch.autograd.grad((y * torch.from_numpy(wts)).sum(), (xt, tt))
    _close(gx, want_x)
    _close(gt, want_t)
    assert math.isfinite(float(gt.abs().sum()))


# --- the fused denoise's gradient (torch.autograd.Function) -------------------------
#
# Tolerances are the JAX tests' (tests/test_fused_denoise.py,
# tests/test_fused_roundtrip.py): 3e-6 and 5e-6 of the largest gradient for
# float32 gradients that pass through a data-dependent shrink mask and a
# median, 2e-2 for the round trip against its identity approximation; the
# float64 comparisons with plain autograd are the same arithmetic in another
# order (1e-10).


def _port_thresholds(res, n, levels):
    sigma = vt.mad_sigma(res.details[0])
    return torch.cat([vt.universal_threshold(n, sigma / math.sqrt(2.0**j))
                      for j in range(1, levels + 1)], dim=-1)


def _jax_thresholds(res, n, levels):
    sigma = jth.mad_sigma(res.details[0])
    return jnp.concatenate([jth.universal_threshold(n, sigma / jnp.sqrt(2.0**j))
                            for j in range(1, levels + 1)], axis=-1)


def test_fused_denoise_function_gradient_matches_jax_fused_kernel():
    """Mirror of test_fused_denoise.py::test_fused_denoise_gradients_match_jnp_path:
    the port's Function (plain versions on the CPU) against jax.grad of the
    JAX fused kernel in interpret mode, and against plain autograd of the
    three-call path, in x and through the thresholds' own dependence on x."""
    from vectorwave_tpu.kernels.modwt_pallas import fused_denoise_multilevel as jfused

    n, levels = 2048, 3
    x = np.random.default_rng(5).standard_normal((2, n)).astype(np.float32)
    wts = np.arange(n, dtype=np.float32)

    def jloss(y):
        res = vw.modwt_multilevel(y, "db4", levels=levels, backend="jnp")
        out = jfused(y, "db4", levels=levels, thresholds=_jax_thresholds(res, n, levels),
                     mode="soft", interpret=True, precision="float32")
        return jnp.sum(out**2 * wts)

    def tloss(y, fused):
        res = vt.modwt_multilevel(y, "db4", levels=levels, backend="torch")
        ths = _port_thresholds(res, n, levels)
        if fused:
            out = vt.fused_denoise_multilevel(y, "db4", levels=levels, thresholds=ths,
                                              mode="soft")
        else:
            dets = tuple(vt.apply_threshold(d, ths[..., j : j + 1], "soft")
                         for j, d in enumerate(res.details))
            out = vt.imodwt_multilevel(vt.MultiLevelMODWTResult(dets, res.approx), "db4",
                                       backend="torch")
        return (out**2 * torch.from_numpy(wts)).sum()

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    got, plain = (torch.autograd.grad(tloss(xt, fused), xt)[0]
                  for fused in (True, False)
                  for xt in (torch.from_numpy(x).requires_grad_(True),))
    scale = float(np.abs(want).max())
    _close(got, want, tol=3e-6 * scale)
    _close(got, plain.numpy(), tol=3e-6 * scale)


def test_public_denoise_multilevel_gradient_through_the_fused_route():
    """Mirror of test_fused_denoise.py::test_public_denoise_grad_end_to_end: the
    kernel backend routes denoise_multilevel to the fused denoise (N >= 4096
    in the port's router), whose gradient matches the JAX package's fused
    route and the port's three-call plain path."""
    x = np.random.default_rng(6).standard_normal(4096).astype(np.float32)

    def tloss(y):
        return (vt.denoise_multilevel(y, "db4", levels=3, method="universal",
                                      mode="soft") ** 2).sum()

    def jloss(y):
        return jnp.sum(vw.denoise_multilevel(y, "db4", levels=3, method="universal",
                                             mode="soft") ** 2)

    grads = {}
    for backend in ("kernel", "torch"):
        xt = torch.from_numpy(x).requires_grad_(True)
        vt.set_backend(backend)
        try:
            grads[backend] = torch.autograd.grad(tloss(xt), xt)[0]
        finally:
            vt.set_backend("auto")
    vw.set_backend("pallas")
    vw.set_fused_precision("float32")
    try:
        want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    finally:
        vw.set_backend("auto")
        vw.set_fused_precision("bf16_3x")
    scale = float(np.abs(want).max())
    _close(grads["kernel"], want, tol=5e-6 * scale)
    _close(grads["kernel"], grads["torch"].numpy(), tol=5e-6 * scale)


def test_roundtrip_fused_gradient_matches_jax():
    """Mirror of test_fused_roundtrip.py::test_roundtrip_fused_1d_and_grad: a
    1-D input, the gradient of the fused round trip (no shrink mask) against
    jax.grad of the JAX fused round trip and its identity approximation."""
    x = np.random.default_rng(2).standard_normal(2048).astype(np.float32)
    wts = np.arange(2048, dtype=np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = vt.modwt_roundtrip_fused(xt, "db4", levels=3)
    got = torch.autograd.grad((out**2 * torch.from_numpy(wts)).sum(), xt)[0]
    want = jax.grad(lambda y: jnp.sum(vw.modwt_roundtrip_fused(
        y, "db4", levels=3, interpret=True, precision="float32") ** 2 * wts))(
        jnp.asarray(x))
    scale = float(np.abs(np.asarray(want)).max())
    _close(got, want, tol=3e-6 * scale)
    _close(got, 2 * wts * x, tol=2e-2)


@pytest.mark.parametrize("boundary", ["periodic", "zero"])
@pytest.mark.parametrize("mode", ["soft", "hard", "none"])
def test_fused_denoise_function_matches_plain_autograd_in_float64(mode, boundary):
    """d/dx and d/dthreshold of the Function against native autograd of the
    plain version in float64: the soft threshold's gradient is
    -sum sign(d) (S^T g) over |d| > t, the hard one's and the round trip's 0."""
    from vectorwave_tpu_torch.kernels import modwt_composite as mc
    from vectorwave_tpu_torch.kernels.modwt_fused import _kernel_filters

    x = _noisy(3, 1024, seed=22)
    th = np.abs(_x((3, 4), seed=23)) * 0.2
    wts = torch.from_numpy(_x((3, 1024), seed=24))
    wv = vt.wavelet("db4")
    fd, fr = _kernel_filters(wv, False), _kernel_filters(wv, True)
    grads = []
    for fused in (True, False):
        xt = torch.from_numpy(x).requires_grad_(True)
        tt = torch.from_numpy(th).requires_grad_(True)
        if fused:
            y = vt.fused_denoise_multilevel(xt, wv, levels=4, thresholds=tt,
                                            boundary=boundary, mode=mode)
        else:
            y = mc.denoise_plain(xt, tt, 4, fd, fr, boundary == "periodic", mode)
        grads.append(torch.autograd.grad((y * wts).sum(), (xt, tt), allow_unused=True))
    (gx, gt), (px, pt) = grads
    _close(gx, px.numpy())
    if mode == "soft":
        _close(gt, pt.numpy())
        assert float(gt.abs().max()) > 1e-3
    else:
        assert float(gt.abs().max()) == 0.0


@pytest.mark.parametrize("mode,analyses", [("soft", 2), ("hard", 2), ("none", 1)])
def test_fused_denoise_backward_runs_through_the_kernel_wrappers(monkeypatch, mode,
                                                                 analyses):
    """The backward calls the kernel wrappers (which launch the kernels on a
    CUDA tensor): analysis on the reconstruction taps, once more on the
    decomposition taps for the mask, and synthesis once."""
    from vectorwave_tpu_torch.kernels import modwt_composite as mc

    calls = {"analysis": 0, "synthesis": 0}
    for name in calls:
        orig = getattr(mc, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(mc, name, spy)
    xt = torch.from_numpy(_noisy(2, 512, seed=25)).requires_grad_(True)
    y = vt.fused_denoise_multilevel(xt, "db4", levels=3, thresholds=torch.full(
        (2, 3), 0.1, dtype=torch.float64), mode=mode)
    assert calls == {"analysis": 0, "synthesis": 0}
    y.sum().backward()
    assert calls == {"analysis": analyses, "synthesis": 1}


# --- best-basis packet denoising and the dual tree's bivariate shrinkage ------------------


def _two_tones(b, n, seed=14, noise=0.5):
    t = np.arange(n)
    clean = np.sin(2 * np.pi * 0.41 * t) + np.sin(2 * np.pi * 0.02 * t)
    return clean, clean + np.random.default_rng(seed).normal(0.0, noise, (b, n))


@pytest.mark.parametrize("cost", ["threshold", "risk", "shannon", "log_energy", "l1"])
def test_denoise_packet_matches_jax_for_every_named_cost(cost):
    _, x = _two_tones(2, 512)
    want = vw.denoise_packet(jnp.asarray(x), "sym8", 3, cost=cost)
    _close(vt.denoise_packet(torch.from_numpy(x), "sym8", 3, cost=cost), want)


@pytest.mark.parametrize("method,mode,boundary", [
    ("universal", "soft", "periodic"), ("sure", "hard", "periodic"),
    ("bayes", "soft", "zero"), ("minimax", "soft", "periodic"),
])
def test_denoise_packet_matches_jax_for_methods_modes_and_boundaries(method, mode, boundary):
    _, x = _two_tones(2, 512, seed=15)
    kwargs = dict(method=method, mode=mode, boundary=boundary)
    want = vw.denoise_packet(jnp.asarray(x), "db4", 3, **kwargs)
    _close(vt.denoise_packet(torch.from_numpy(x), "db4", 3, **kwargs), want)


def test_denoise_packet_with_a_callable_cost_matches_jax():
    _, x = _two_tones(1, 512, seed=16)
    want = vw.denoise_packet(jnp.asarray(x[0]), "db4", 3,
                             cost=lambda node: jnp.abs(node).sum())
    got = vt.denoise_packet(torch.from_numpy(x[0]), "db4", 3,
                            cost=lambda node: node.abs().sum())
    _close(got, want)
    _close(got, vw.denoise_packet(jnp.asarray(x[0]), "db4", 3, cost="l1"))


def test_denoise_packet_keeps_a_high_band_tone_the_modwt_denoiser_loses():
    clean, x = _two_tones(1, 2048)
    xt = torch.from_numpy(x[0])

    def mse(a):
        return float(((a.numpy() - clean) ** 2).mean())

    assert mse(vt.denoise_packet(xt, "sym8", 4)) < 0.75 * mse(
        vt.denoise_multilevel(xt, "sym8", levels=4))
    tone = torch.from_numpy(np.sin(2 * np.pi * 0.01 * np.arange(1024)))
    assert float((vt.denoise_packet(tone, "db4", 3) - tone).abs().max()) < 0.05


def test_denoise_packet_through_the_bank_matches_the_plain_route():
    _, x = _two_tones(2, 1024, seed=17)
    x32 = torch.from_numpy(x.astype(np.float32))
    want = vt.denoise_packet(x32, "sym8", 3)
    try:
        vt.set_backend("kernel")
        got = vt.denoise_packet(x32, "sym8", 3)
    finally:
        vt.set_backend("auto")
    assert float((got - want).abs().max()) <= 1e-4


def _doppler(n):
    t = np.linspace(1e-3, 1, n)
    x = np.sqrt(t * (1 - t)) * np.sin(2.1 * np.pi / (t + 0.05))
    return x / x.std()


@pytest.mark.parametrize("levels,window,noise_sigma", [(5, 7, None), (5, 7, 0.3), (3, 5, None),
                                                       (1, 7, 0.2)])
def test_dtcwt_denoise_matches_jax(levels, window, noise_sigma):
    from vectorwave_tpu.denoise import dtcwt_denoise as jax_dtcwt_denoise

    clean = np.stack([_doppler(1024), -_doppler(1024)])
    x = clean + 0.3 * np.random.default_rng(2).standard_normal(clean.shape)
    kwargs = dict(levels=levels, window=window, noise_sigma=noise_sigma)
    want = jax_dtcwt_denoise(jnp.asarray(x), **kwargs)
    got = vt.dtcwt_denoise(torch.from_numpy(x), **kwargs)
    _close(got, want)
    if levels == 5:
        for b in range(2):
            snr = lambda est: 10 * np.log10(np.sum(clean[b] ** 2)
                                            / np.sum((est - clean[b]) ** 2))
            assert snr(got[b].numpy()) > snr(x[b]) + 6


def test_dtcwt_denoise_helpers_match_jax():
    from vectorwave_tpu.denoise import dtcwt_shrink as jshrink
    from vectorwave_tpu_torch.denoise import dtcwt_shrink as tshrink

    delta = np.zeros(32)
    delta[16] = 7.0
    out = tshrink._local_power(torch.from_numpy(delta), 7, (0,))
    _close(out, jshrink._local_power(jnp.asarray(delta), 7, (0,)))
    assert out[12] == 0 and out[20] == 0 and float(out[16]) == pytest.approx(1.0)
    mag2 = _x((2, 5), seed=3) ** 2
    _close(tshrink._upsample_parent(torch.from_numpy(mag2), (2, 9), (1,)),
           jshrink._upsample_parent(jnp.asarray(mag2), (2, 9), (1,)))
    z = _x((2, 64), seed=4) + 1j * _x((2, 64), seed=5)
    parent = _x((2, 64), seed=6) ** 2
    sigma2 = np.full((2, 1), 0.09)
    _close(tshrink._bivariate(torch.from_numpy(z), torch.from_numpy(parent),
                              torch.from_numpy(sigma2), 7, (1,)),
           jshrink._bivariate(jnp.asarray(z), jnp.asarray(parent), jnp.asarray(sigma2), 7, (1,)))


def test_dtcwt_denoise_through_the_bank_matches_the_plain_route():
    x = (_doppler(1024) + 0.3 * np.random.default_rng(7).standard_normal((2, 1024)))
    x32 = torch.from_numpy(x.astype(np.float32))
    want = vt.dtcwt_denoise(x32, levels=4)
    try:
        vt.set_backend("kernel")
        got = vt.dtcwt_denoise(x32, levels=4)
    finally:
        vt.set_backend("auto")
    assert float((got - want).abs().max()) <= 1e-4
