"""Mirrors of the JAX package's kernel-tier tests on the port.

``tests/test_pallas_kernels.py``, ``tests/test_fused_denoise.py``,
``tests/test_fused_roundtrip.py``, what ``tests/test_differentiability.py``
holds beyond the gradient mirrors of ``tests/test_torch_kernels.py`` and
``tests/test_torch_denoise.py``, and the zero-boundary cases of
``tests/test_streaming_kernel.py``: the same names, seeds, shapes, wavelets
and boundaries, and the JAX test's own assertions and bounds, run on the
port.  On the CPU the port's kernel tier runs its kernels' plain versions;
the JAX side runs as its own tests run it: ``backend='jnp'`` as the
reference, and the Pallas kernel in interpret mode only where the kernel is
the test's point, one case per kernel mode (periodic, zero, the symmetric
mirror).  Tolerances are the JAX tests' own (2e-6 for the analysis planes,
5e-6 for an inverse or a round trip, 2e-4 for bf16_3x, 2e-5 across the
families), else 1e-10 for float64 gradients.  The JAX package's ``tile=``
and ``interpret=`` have no counterpart in the port (a difference by design).

The JAX references come from one module-scoped fixture (``jax_refs``), each
jitted and made once per shape.  The cases of these tests that reach a CUDA
kernel on the card (``tools/mirror_cases.py``) run here too, on the CPU,
where nothing launches and nothing is refused.
"""

import importlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from tools import mirror_cases
from vectorwave_tpu.kernels import fused_analysis as jax_fused_analysis
from vectorwave_tpu.kernels.modwt_pallas import fused_denoise_multilevel as jax_fused_denoise
from vectorwave_tpu.kernels.modwt_pallas import total_halo as jax_total_halo
from vectorwave_tpu.ops import thresholds as jth
from vectorwave_tpu_torch import streaming as st
from vectorwave_tpu_torch.denoise import denoiser
from vectorwave_tpu_torch.denoise.denoiser import _fused_sigma
from vectorwave_tpu_torch.errors import InvalidArgumentError, InvalidConfigurationError
from vectorwave_tpu_torch.kernels import modwt_composite as mc
from vectorwave_tpu_torch.kernels.modwt_fused import total_halo
from vectorwave_tpu_torch.ops.thresholds import mad_sigma, median_magnitude
from vectorwave_tpu_torch.transforms.modwt import modwt

from .conftest import composite_sin

torch.set_num_threads(1)


def _x32(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(t):
    return t.detach().double().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float64)


def _maxdiff(got, want):
    return float(np.max(np.abs(_np(got) - _np(want))))


@partial(jax.jit, static_argnames=("name", "levels", "boundary"))
def _jax_decompose(x, name, levels, boundary):
    return vw.modwt_multilevel(x, name, levels=levels, boundary=boundary, backend="jnp")


@partial(jax.jit, static_argnames=("name", "boundary"))
def _jax_reconstruct(res, name, boundary):
    return vw.imodwt_multilevel(res, name, boundary=boundary, backend="jnp")


@partial(jax.jit, static_argnames=("name", "levels", "method", "mode"))
def _jax_denoise(x, name, levels, method="universal", mode="soft"):
    return vw.denoise_multilevel(x, name, levels=levels, method=method, mode=mode)


_jax_median = jax.jit(jth.median_magnitude)


@partial(jax.jit, static_argnames=("mode",))
def _jax_shrink(res, ths, mode):
    return tuple(jth.apply_threshold(d, ths[..., j:j + 1], mode)
                 for j, d in enumerate(res.details))


class JaxRefs:
    """The JAX package's jnp results, each made once per input."""

    def __init__(self):
        self._memo = {}

    def _once(self, key, make):
        if key not in self._memo:
            self._memo[key] = make()
        return self._memo[key]

    def decompose(self, x, name, levels, boundary="periodic"):
        return self._once(("dec", x.tobytes(), x.shape, x.dtype.str, name, levels, boundary),
                          lambda: _jax_decompose(jnp.asarray(x), name, levels, boundary))

    def roundtrip(self, x, name, levels, boundary="periodic"):
        return self._once(("rt", x.tobytes(), x.shape, x.dtype.str, name, levels, boundary),
                          lambda: _jax_reconstruct(self.decompose(x, name, levels, boundary),
                                                   name, boundary))

    def three_call(self, x, name, levels, boundary, mode):
        """``tests/test_fused_denoise.py``'s oracle: its thresholds
        (``_thresholds``), the shrinkage and the jnp inverse."""
        def make():
            res = self.decompose(x, name, levels, boundary)
            sigma = jth.mad_sigma(res.details[0])
            ths = jnp.concatenate([jth.universal_threshold(x.shape[-1],
                                                           sigma / jnp.sqrt(2.0 ** j))
                                   for j in range(1, levels + 1)], axis=-1)
            nd = _jax_shrink(res, ths, mode)
            out = _jax_reconstruct(vw.MultiLevelMODWTResult(nd, res.approx), name, boundary)
            return np.asarray(ths), np.asarray(out)
        return self._once(("3call", x.tobytes(), x.shape, name, levels, boundary, mode), make)


@pytest.fixture(scope="module")
def jax_refs():
    return JaxRefs()


def _t(x):
    return torch.from_numpy(np.array(x))


# --- tests/test_pallas_kernels.py ------------------------------------------------------


@pytest.mark.parametrize("boundary", ["periodic", "zero"])
@pytest.mark.parametrize("name,levels", [("haar", 4), ("db4", 6), ("sym8", 3)])
def test_fused_analysis_matches_jnp(jax_refs, name, levels, boundary):
    """The port's fused analysis against the jnp path within 2e-6; at haar
    J=4 (one case a mode) also against the JAX Pallas kernel in interpret
    mode."""
    x = _x32((4, 2048))
    details, approx = vt.fused_analysis(_t(x), name, levels=levels, boundary=boundary,
                                        precision="float32")
    ref = jax_refs.decompose(x, name, levels, boundary)
    for got, want in zip((*details, approx), (*ref.details, ref.approx)):
        assert _maxdiff(got, want) <= 2e-6
    if name == "haar":
        kd, ka = jax_fused_analysis(x, name, levels=levels, boundary=boundary, tile=1024,
                                    interpret=True, precision="float32")
        for got, want in zip((*details, approx), (*kd, ka)):
            assert _maxdiff(got, want) <= 2e-6


def test_fused_roundtrip(jax_refs):
    """db4 J=6 at 2x4096: the round trip within 5e-6 of x, the planes within
    2e-6 of the jnp path."""
    x = _x32((2, 4096), seed=1)
    details, approx = vt.fused_analysis(_t(x), "db4", levels=6, precision="float32")
    xr = vt.fused_synthesis(details, approx, "db4", precision="float32")
    assert float((xr - _t(x)).abs().max()) < 5e-6
    assert _maxdiff(approx, jax_refs.decompose(x, "db4", 6).approx) <= 2e-6


def test_fused_synthesis_matches_jnp_inverse(jax_refs):
    """The JAX jnp planes through the port's fused synthesis: within 5e-6 of
    the jnp inverse."""
    x = _x32((2, 2048), seed=2)
    res = jax_refs.decompose(x, "db4", 4)
    got = vt.fused_synthesis([_t(np.asarray(d)) for d in res.details],
                             _t(np.asarray(res.approx)), "db4", boundary="periodic",
                             precision="float32")
    assert _maxdiff(got, jax_refs.roundtrip(x, "db4", 4)) <= 5e-6


def test_fused_1d_input(jax_refs):
    x = _x32(1024, seed=3)
    details, approx = vt.fused_analysis(_t(x), "haar", levels=3, precision="float32")
    assert details[0].shape == (1024,)
    assert _maxdiff(details[2], jax_refs.decompose(x, "haar", 3).details[2]) <= 2e-6


@pytest.mark.parametrize("name,levels,n", [("db4", 4, 2048), ("sym8", 3, 1000),
                                           ("haar", 5, 4096)])
def test_fused_symmetric_analysis_matches_jnp(jax_refs, name, levels, n):
    """The symmetric analysis (the per-level mirror) against the jnp
    symmetric cascade within 2e-6; at sym8 J=3 also against the JAX Pallas
    kernel's mirror mode in interpret mode."""
    x = _x32((3, n), seed=13)
    details, approx = vt.fused_analysis(_t(x), name, levels=levels, boundary="symmetric",
                                        precision="float32")
    ref = jax_refs.decompose(x, name, levels, "symmetric")
    for got, want in zip((*details, approx), (*ref.details, ref.approx)):
        assert _maxdiff(got, want) <= 2e-6
    if name == "sym8":
        kd, ka = jax_fused_analysis(x, name, levels=levels, boundary="symmetric", tile=1024,
                                    interpret=True, precision="float32")
        for got, want in zip((*details, approx), (*kd, ka)):
            assert _maxdiff(got, want) <= 2e-6


def test_fused_bogus_boundary_rejected():
    with pytest.raises(InvalidArgumentError):
        vt.fused_analysis(_t(_x32((2, 512))), "db4", levels=3, boundary="nope")
    with pytest.raises(vw.InvalidArgumentError):
        jax_fused_analysis(_x32((2, 512)), "db4", levels=3, boundary="nope", interpret=True)


def test_fused_synthesis_unknown_boundary_rejected(jax_refs):
    """'reflect' raises on both packages; symmetric is served, within 1e-5 of
    the jnp symmetric inverse."""
    from vectorwave_tpu.kernels import fused_synthesis as jax_fused_synthesis

    x = _x32((2, 512), seed=7)
    res = jax_refs.decompose(x, "db4", 3)
    details = [_t(np.asarray(d)) for d in res.details]
    approx = _t(np.asarray(res.approx))
    with pytest.raises(InvalidArgumentError):
        vt.fused_synthesis(details, approx, "db4", boundary="reflect")
    with pytest.raises(vw.InvalidArgumentError):
        jax_fused_synthesis(res.details, res.approx, "db4", boundary="reflect",
                            interpret=True)
    xr = vt.fused_synthesis(details, approx, "db4", boundary="symmetric", precision="float32")
    want = _jax_reconstruct(res, "db4", "symmetric")
    assert _maxdiff(xr, want) <= 1e-5


@pytest.mark.parametrize("n", [1000, 97 * 64, 4097])
def test_fused_arbitrary_n(jax_refs, n):
    """Any N: planes within 2e-6 of the jnp path, the inverse within 1e-5 of x."""
    x = _x32((2, n), seed=11)
    details, approx = vt.fused_analysis(_t(x), "db4", levels=3, precision="float32")
    assert approx.shape == (2, n)
    ref = jax_refs.decompose(x, "db4", 3)
    for got, want in zip((*details, approx), (*ref.details, ref.approx)):
        assert _maxdiff(got, want) <= 2e-6
    xr = vt.fused_synthesis(details, approx, "db4", precision="float32")
    assert xr.shape == (2, n)
    assert float((xr - _t(x)).abs().max()) <= 1e-5


def test_invalid_backend_param_rejected():
    """An unknown backend raises on both packages: InvalidConfigurationError
    in the port, InvalidArgumentError in JAX (a difference by design)."""
    x = composite_sin(256).astype(np.float32)
    with pytest.raises(InvalidConfigurationError):
        vt.modwt_multilevel(_t(x), "db4", levels=3, backend="palas")
    res = vt.modwt_multilevel(_t(x), "db4", levels=3, backend="jnp")
    with pytest.raises(InvalidConfigurationError):
        vt.imodwt_multilevel(res, "db4", backend="cuda")
    with pytest.raises(vw.InvalidArgumentError):
        vw.modwt_multilevel(jnp.asarray(x), "db4", levels=3, backend="palas")


def test_explicit_auto_backend_param(jax_refs):
    """'auto' routes as None does (equal arrays), within 2e-6 of the jnp path."""
    x = composite_sin(256).astype(np.float32)
    a = vt.modwt_multilevel(_t(x), "db4", levels=3, backend="auto")
    b = vt.modwt_multilevel(_t(x), "db4", levels=3)
    assert torch.equal(a.approx, b.approx)
    assert vt.imodwt_multilevel(a, "db4", backend="auto").shape == x.shape
    assert _maxdiff(a.approx, jax_refs.decompose(x, "db4", 3).approx) <= 2e-6


def test_total_halo():
    assert total_halo(8, 6) == jax_total_halo(8, 6) == 7 * 63
    assert total_halo(2, 3) == jax_total_halo(2, 3) == 7


def test_backend_config():
    """set_backend takes the JAX names (aliases) and raises on 'cuda', as JAX
    does; a call under 'jnp' runs."""
    assert vt.get_backend() in ("auto", "torch", "kernel")
    vt.set_backend("jnp")
    try:
        assert vt.get_backend() == "torch"
        x = composite_sin(256).astype(np.float32)
        assert vt.modwt_multilevel(_t(x), "db4", levels=3).levels == 3
    finally:
        vt.set_backend("auto")
    with pytest.raises(InvalidConfigurationError):
        vt.set_backend("cuda")
    with pytest.raises(vw.InvalidConfigurationError):
        vw.set_backend("cuda")


def test_explicit_jnp_backend_param(jax_refs):
    x = composite_sin(256).astype(np.float32)
    a = vt.modwt_multilevel(_t(x), "db4", levels=3, backend="jnp")
    b = vt.modwt_multilevel(_t(x), "db4", levels=3)
    assert torch.equal(a.approx, b.approx)
    assert _maxdiff(a.approx, jax_refs.decompose(x, "db4", 3).approx) <= 2e-6


@pytest.mark.parametrize("precision,tol", [("float32", 5e-6), ("bf16_3x", 2e-4)])
def test_fused_precision_modes(jax_refs, precision, tol):
    """Each tier's round trip within its bound (float32 5e-6, bf16_3x 2e-4);
    the planes within the same bound of the jnp path."""
    x = _x32((2, 2048), seed=21)
    details, approx = vt.fused_analysis(_t(x), "db4", levels=4, precision=precision)
    xr = vt.fused_synthesis(details, approx, "db4", precision=precision)
    assert float((xr - _t(x)).abs().max()) < tol
    assert _maxdiff(approx, jax_refs.decompose(x, "db4", 4).approx) <= tol


def test_fused_precision_config_default():
    assert vt.get_fused_precision() in ("float32", "bf16_3x", "bf16")
    vt.set_fused_precision("float32")
    try:
        assert vt.get_fused_precision() == "float32"
    finally:
        vt.set_fused_precision("bf16_3x")
    with pytest.raises(InvalidConfigurationError):
        vt.set_fused_precision("fp8")
    with pytest.raises(vw.InvalidConfigurationError):
        vw.set_fused_precision("fp8")


# --- tests/test_fused_denoise.py -------------------------------------------------------

DENOISE_GRID = [
    (2, 2048, "db4", 4, "periodic", "soft"),
    (1, 4096, "sym8", 3, "zero", "soft"),
    (1, 4096, "sym8", 3, "zero", "hard"),
    (3, 4096, "haar", 5, "periodic", "soft"),
    (2, 2048, "bior2.2", 3, "periodic", "soft"),
]


@pytest.mark.parametrize("b,n,name,levels,boundary,mode", DENOISE_GRID)
def test_fused_denoise_matches_three_call_path(jax_refs, b, n, name, levels, boundary,
                                               mode):
    """The port's fused denoise, given the JAX test's thresholds, within
    5e-6 of the JAX three-call path (jnp analysis, shrinkage, jnp inverse)."""
    x = _x32((b, n))
    ths, want = jax_refs.three_call(x, name, levels, boundary, mode)
    got = vt.fused_denoise_multilevel(_t(x), name, levels=levels, thresholds=_t(ths),
                                      boundary=boundary, mode=mode, precision="float32")
    assert got is not None
    assert _maxdiff(got, want) <= 5e-6


def test_fused_denoise_short_signal_falls_back():
    """Below its tile floor the JAX kernel returns None (the public API then
    takes the three-call path); the port's fused denoise serves any N (a
    difference by design), here equal to the three-call path."""
    x = np.zeros((1, 512), np.float32)
    ths = np.ones((1, 5), np.float32)
    assert jax_fused_denoise(x, "haar", levels=5, thresholds=ths, interpret=True,
                             precision="float32") is None
    got = vt.fused_denoise_multilevel(_t(x), "haar", levels=5, thresholds=_t(ths),
                                      precision="float32")
    assert got is not None and torch.equal(got, torch.zeros(1, 512))


def test_fused_denoise_symmetric_falls_back():
    """No fused symmetric denoise on either package: both return None."""
    x = np.zeros((1, 4096), np.float32)
    ths = np.ones((1, 3), np.float32)
    assert jax_fused_denoise(x, "db4", levels=3, thresholds=ths, boundary="symmetric",
                             interpret=True, precision="float32") is None
    assert vt.fused_denoise_multilevel(_t(x), "db4", levels=3, thresholds=_t(ths),
                                       boundary="symmetric", precision="float32") is None


def test_public_api_routes_and_matches(monkeypatch):
    """Under backend 'kernel' (the JAX test's 'pallas') the public denoise
    takes the fused route (on the CPU its plain version) and agrees with the
    JAX public denoise within 2e-4 end to end."""
    x = _x32((2, 4096), seed=1)
    want = _jax_denoise(jnp.asarray(x), "db4", 4)
    called = {}
    orig = denoiser._try_fused_denoise

    def spy(*a, **k):
        out = orig(*a, **k)
        called["fused"] = out is not None
        return out

    monkeypatch.setattr(denoiser, "_try_fused_denoise", spy)
    vt.set_backend("pallas")
    try:
        got = vt.denoise_multilevel(_t(x), "db4", levels=4, method="universal", mode="soft")
    finally:
        vt.set_backend("auto")
    assert called.get("fused"), "the kernel backend did not route to the fused denoise"
    assert _maxdiff(got, want) <= 2e-4


def test_median_magnitude_matches_jnp_median_bitexact():
    """The median of |v| (the MAD's core) equals numpy's median (the JAX
    test's ``jnp.median``, which numpy's equals in float32) and the JAX
    package's ``median_magnitude`` bit for bit, zeros included."""
    rng = np.random.default_rng(3)
    for shape in [(3, 1024), (1, 65536), (5, 999), (2, 7), (4, 2), (1, 1)]:
        v = (rng.standard_normal(shape) * rng.lognormal(0, 3, shape)).astype(np.float32)
        got = median_magnitude(_t(v)).numpy()
        np.testing.assert_array_equal(got, np.asarray(_jax_median(jnp.asarray(v))))
        np.testing.assert_array_equal(got, np.median(np.abs(v), axis=-1, keepdims=True))
    np.testing.assert_array_equal(median_magnitude(torch.zeros(2, 8)).numpy(), np.zeros((2, 1)))


def test_sure_method_keeps_materializing_path(monkeypatch):
    """SURE needs the planes: under the kernel backend the router does not
    take the fused route, and the output is within 2e-5 of JAX's SURE denoise."""
    x = _x32(2048, seed=2)
    routed = []
    orig = denoiser._try_fused_denoise
    monkeypatch.setattr(denoiser, "_try_fused_denoise",
                        lambda *a, **k: routed.append(orig(*a, **k)) or routed[-1])
    vt.set_backend("pallas")
    try:
        out = vt.denoise_multilevel(_t(x), "db4", levels=3, method="sure", mode="soft")
    finally:
        vt.set_backend("auto")
    assert routed == [None]
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    want = _jax_denoise(jnp.asarray(x), "db4", 3, "sure")
    assert _maxdiff(out, want) <= 2e-5


FAMILY_CASES = [
    ("db2", "periodic", "soft"), ("db8", "zero", "hard"),
    ("sym12", "periodic", "hard"), ("coif3", "zero", "soft"),
    ("bior4.4", "periodic", "soft"), ("rbio2.2", "periodic", "hard"),
    ("db16", "periodic", "soft"), ("coif5", "periodic", "soft"),
]
#: the families held to the JAX three-call path as well: a JAX reference
#: compiles per filter, 3-15 s a family on the CPU, so the sweep holds three
#: (both boundaries, both modes, a biorthogonal pair) and every family to the
#: port's own three-call path
FAMILIES_AGAINST_JAX = ("db2", "coif3", "rbio2.2")


def test_fused_denoise_property_sweep_across_families(jax_refs):
    """The JAX sweep across the registry (marked slow there for its
    interpret-mode kernel; here in tier 1), one generator drawn in order:
    the port's fused denoise within 2e-5 of its own three-call path with the
    same thresholds, and for :data:`FAMILIES_AGAINST_JAX` within 2e-5 of the
    JAX three-call path given the JAX thresholds."""
    rng = np.random.default_rng(9)
    for name, boundary, mode in FAMILY_CASES:
        x = rng.standard_normal((1, 4096)).astype(np.float32)
        ths, want = mirror_cases.plain_three_call(_t(x), vt.wavelet(name), 3, boundary, mode)
        got = vt.fused_denoise_multilevel(_t(x), name, levels=3, thresholds=ths,
                                          boundary=boundary, mode=mode, precision="float32")
        assert got is not None, name
        assert _maxdiff(got, want) <= 2e-5, (name, boundary, mode)
        if name in FAMILIES_AGAINST_JAX:
            ths, want = jax_refs.three_call(x, name, 3, boundary, mode)
            got = vt.fused_denoise_multilevel(_t(x), name, levels=3, thresholds=_t(ths),
                                              boundary=boundary, mode=mode,
                                              precision="float32")
            assert _maxdiff(got, want) <= 2e-5, (name, boundary, mode)


# --- tests/test_fused_roundtrip.py -----------------------------------------------------


@pytest.mark.parametrize("b,n,name,levels,boundary", [
    (2, 2048, "db4", 4, "periodic"),
    (1, 4096, "sym8", 3, "zero"),
    (3, 4096, "haar", 5, "periodic"),
    (2, 2048, "bior2.2", 3, "periodic"),
])
def test_roundtrip_fused_reconstructs(jax_refs, b, n, name, levels, boundary):
    """Within 5e-6 of the JAX jnp round trip, and of x where periodic."""
    x = _x32((b, n))
    got = vt.modwt_roundtrip_fused(_t(x), name, levels=levels, boundary=boundary,
                                   precision="float32")
    assert _maxdiff(got, jax_refs.roundtrip(x, name, levels, boundary)) <= 5e-6
    if boundary == "periodic":
        assert _maxdiff(got, x) <= 5e-6


def test_roundtrip_fused_short_signal_falls_back(jax_refs):
    """1x512 (below the JAX kernel's floor) reconstructs within 5e-6."""
    x = _x32((1, 512), seed=1)
    got = vt.modwt_roundtrip_fused(_t(x), "db4", levels=3, precision="float32")
    assert _maxdiff(got, x) <= 5e-6
    assert _maxdiff(got, jax_refs.roundtrip(x, "db4", 3)) <= 5e-6


def test_roundtrip_fused_1d_and_grad():
    """A 1-D input; the gradient of sum(out^2 w) is about 2 w x (2e-2), and
    within 2e-2 of jax.grad of the JAX jnp round trip."""
    x = _x32(2048, seed=2)
    w = np.arange(2048, dtype=np.float32)
    xt = _t(x).requires_grad_(True)
    out = vt.modwt_roundtrip_fused(xt, "db4", levels=3, precision="float32")
    assert out.shape == (2048,)
    (g,) = torch.autograd.grad((out ** 2 * _t(w)).sum(), xt)
    np.testing.assert_allclose(g.numpy(), 2 * w * x, rtol=0, atol=2e-2)

    def loss(y):
        res = vw.modwt_multilevel(y, "db4", levels=3, backend="jnp")
        return jnp.sum(vw.imodwt_multilevel(res, "db4", backend="jnp") ** 2 * w)

    np.testing.assert_allclose(g.numpy(), np.asarray(jax.grad(loss)(jnp.asarray(x))), rtol=0,
                               atol=2e-2)


def test_decimated_sigma_tracks_exact():
    """At 2x65536 the decimated MAD sigma lies within 10% of the full-sample
    one, and equals the JAX package's ``_fused_sigma`` (1e-6 relative: the
    same samples in float32)."""
    from vectorwave_tpu.denoise.denoiser import _fused_sigma as jax_fused_sigma

    x = _x32((2, 65536), seed=3)
    w = vt.wavelet("db4")
    dec = _fused_sigma(_t(x), w, "periodic")
    exact = mad_sigma(modwt(_t(x), w, boundary="periodic").detail)
    np.testing.assert_allclose(dec.numpy(), exact.numpy(), rtol=0.1)
    assert dec.shape == exact.shape
    np.testing.assert_allclose(dec.numpy(), np.asarray(jax_fused_sigma(
        jnp.asarray(x), vw.wavelet("db4"), "periodic")), rtol=1e-6)


def test_decimated_sigma_zero_boundary_and_config():
    """sigma_estimator='exact' forces the full-sample MAD bit for bit; the
    decimated one lies within 10% of it; both within 1e-6 of JAX's."""
    from vectorwave_tpu import config as jconfig
    from vectorwave_tpu.denoise.denoiser import _fused_sigma as jax_fused_sigma

    x = _x32((1, 65536), seed=4)
    w = vt.wavelet("sym8")
    dec = _fused_sigma(_t(x), w, "zero")
    vt.set_sigma_estimator("exact")
    jconfig.set_sigma_estimator("exact")
    try:
        forced = _fused_sigma(_t(x), w, "zero")
        jax_forced = jax_fused_sigma(jnp.asarray(x), vw.wavelet("sym8"), "zero")
    finally:
        vt.set_sigma_estimator("auto")
        jconfig.set_sigma_estimator("auto")
    exact = mad_sigma(modwt(_t(x), w, boundary="zero").detail)
    assert torch.equal(forced, exact)
    np.testing.assert_allclose(dec.numpy(), exact.numpy(), rtol=0.1)
    np.testing.assert_allclose(forced.numpy(), np.asarray(jax_forced), rtol=1e-6)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jax_fused_sigma(
        jnp.asarray(x), vw.wavelet("sym8"), "zero")), rtol=1e-6)


def test_small_signals_keep_exact_sigma():
    """Below the decimation floor the estimator is the full-sample MAD, bit
    for bit, within 1e-6 of JAX's."""
    from vectorwave_tpu.denoise.denoiser import _fused_sigma as jax_fused_sigma

    x = _x32((2, 4096), seed=5)
    w = vt.wavelet("db4")
    got = _fused_sigma(_t(x), w, "periodic")
    assert torch.equal(got, mad_sigma(modwt(_t(x), w, boundary="periodic").detail))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_fused_sigma(
        jnp.asarray(x), vw.wavelet("db4"), "periodic")), rtol=1e-6)


def test_denoise_decimated_output_close_to_exact_sigma_output():
    """At 65536 the fused route's decimated sigma (the kernel backend sends
    CPU tensors there) moves the denoised signal by under 2% relative RMS
    from the exact-sigma one; the exact-sigma output within 1e-4 of JAX's."""
    rng = np.random.default_rng(6)
    t = np.linspace(0, 1, 65536, dtype=np.float32)
    clean = np.sin(2 * np.pi * 5 * t) + 0.5 * np.sign(np.sin(2 * np.pi * 11 * t))
    x = (clean + 0.3 * rng.standard_normal(65536)).astype(np.float32)[None]
    vt.set_backend("kernel")
    try:
        auto = vt.denoise_multilevel(_t(x), "db4", levels=5, method="universal", mode="soft")
        vt.set_sigma_estimator("exact")
        exact = vt.denoise_multilevel(_t(x), "db4", levels=5, method="universal", mode="soft")
    finally:
        vt.set_sigma_estimator("auto")
        vt.set_backend("auto")
    rel = float(((auto - exact) ** 2).mean().sqrt() / (exact ** 2).mean().sqrt())
    assert rel < 0.02, rel
    want = _jax_denoise(jnp.asarray(x), "db4", 5)
    assert _maxdiff(exact, want) <= 1e-4


# --- tests/test_differentiability.py, beyond the gradient mirrors of test_torch_kernels.py


def test_grad_through_jnp_modwt():
    """The plain path's gradient: a central difference at sample 100 within
    1e-4, and jax.grad of the jnp path within 1e-10 (float64)."""
    x = composite_sin(256)

    def loss_t(y):
        res = vt.modwt_multilevel(y, "db4", levels=3)
        return sum((d ** 2).sum() for d in res.details)

    def loss_j(y):
        res = vw.modwt_multilevel(y, "db4", levels=3)
        return sum((d ** 2).sum() for d in res.details)

    xt = _t(x).requires_grad_(True)
    (g,) = torch.autograd.grad(loss_t(xt), xt)
    assert bool(torch.isfinite(g).all())
    eps, i = 1e-6, 100
    plus, minus = x.copy(), x.copy()
    plus[i] += eps
    minus[i] -= eps
    fd = (float(loss_t(_t(plus))) - float(loss_t(_t(minus)))) / (2 * eps)
    assert abs(float(g[i]) - fd) < 1e-4
    np.testing.assert_allclose(g.numpy(), np.asarray(jax.grad(loss_j)(jnp.asarray(x))),
                               rtol=0, atol=1e-10)


def test_biorthogonal_pallas_vjp_finite_difference():
    """dec != rec (bior2.2): the fused analysis's gradient in float32 against
    central differences (eps 1e-2, within 5e-3), and in float64 against
    jax.grad of the jnp path within 1e-10."""
    x = _x32((1, 512), seed=2)

    def loss(d, a):
        return (d[0] ** 2).sum() + (d[1] * 2).sum() + (a ** 2).sum()

    def loss_t(y):
        return loss(*vt.fused_analysis(y, "bior2.2", levels=2))

    xt = _t(x).requires_grad_(True)
    (g,) = torch.autograd.grad(loss_t(xt), xt)
    eps = 1e-2
    for i in (37, 137, 400):
        plus, minus = x.copy(), x.copy()
        plus[0, i] += eps
        minus[0, i] -= eps
        fd = (float(loss_t(_t(plus))) - float(loss_t(_t(minus)))) / (2 * eps)
        assert abs(float(g[0, i]) - fd) < 5e-3
    x64 = x.astype(np.float64)
    xt = _t(x64).requires_grad_(True)
    (g64,) = torch.autograd.grad(loss_t(xt), xt)

    def loss_j(y):
        res = vw.modwt_multilevel(y, "bior2.2", levels=2, backend="jnp")
        return loss(res.details, res.approx)

    np.testing.assert_allclose(g64.numpy(), np.asarray(jax.grad(loss_j)(jnp.asarray(x64))),
                               rtol=0, atol=1e-10)


def test_grad_through_denoiser():
    """The gradient of a denoising loss is finite and not zero and agrees
    with central differences (float64, eps 1e-7, within 1e-6 of the largest
    entry); the denoised signal within 1e-10 of the JAX denoise."""
    x = composite_sin(256, noise_std=0.3)

    def loss(y):
        return ((vt.denoise_multilevel(y, "db4", levels=3, method="universal") - y) ** 2).mean()

    xt = _t(x).requires_grad_(True)
    (g,) = torch.autograd.grad(loss(xt), xt)
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    eps, scale = 1e-7, float(g.abs().max())
    for i in (17, 100, 201):
        plus, minus = x.copy(), x.copy()
        plus[i] += eps
        minus[i] -= eps
        fd = (float(loss(_t(plus))) - float(loss(_t(minus)))) / (2 * eps)
        assert abs(float(g[i]) - fd) <= 1e-6 * scale, i
    got = vt.denoise_multilevel(_t(x), "db4", levels=3, method="universal")
    np.testing.assert_allclose(got.numpy(), np.asarray(_jax_denoise(jnp.asarray(x), "db4", 3)),
                               rtol=0, atol=1e-10)


# --- tests/test_streaming_kernel.py: the zero-boundary cases -------------------------


@pytest.mark.parametrize("block_size", [512, 1024])
@pytest.mark.parametrize("name,levels", [("haar", 3), ("db4", 3), ("sym8", 2)])
def test_kernel_streaming_matches_whole_signal_zero(jax_refs, name, levels, block_size):
    """The port's kernel-tier block stream (its plain versions on the CPU),
    concatenated, within 2e-5 of the JAX whole-signal jnp transform."""
    x = _x32((2, 4096))
    state = st.kernel_streaming_init(name, levels, batch_shape=(2,), device="cpu")
    outs = []
    for s in range(0, 4096, block_size):
        state, res = st.modwt_stream_block_kernel(state, _t(x[:, s:s + block_size]), name,
                                                  levels=levels, boundary="zero",
                                                  backend="kernel")
        outs.append(res)
    whole = jax_refs.decompose(x, name, levels, "zero")
    for j in range(levels):
        got = torch.cat([o.details[j] for o in outs], -1)
        assert _maxdiff(got, whole.details[j]) <= 2e-5
    assert _maxdiff(torch.cat([o.approx for o in outs], -1), whole.approx) <= 2e-5


# --- the mirrors' kernel-reaching cases, run on the CPU ------------------------------


@pytest.mark.parametrize("label", [c.label for c in mirror_cases.cases()])
def test_mirror_case_runs_its_plain_versions_on_the_cpu(label):
    """Each case ``chip_smoke.py`` phase 2b runs on the card, here on CPU
    tensors: no launch, no refusal under ``backend='kernel'``, and each
    result within its bound of the plain route."""
    case = next(c for c in mirror_cases.cases() if c.label == label)
    before = dict(mc.LAUNCHES)
    out = mirror_cases.run_case(case, "cpu")
    assert out.ok, out.faults
    assert "raised" not in out.routes.values()
    assert mc.LAUNCHES == before


def test_mirror_cases_are_the_jax_tests_shapes():
    """The sweep's 24 configurations are the JAX sweep's own draw, and every
    case names a JAX test that exists."""
    import tests.test_property_sweep as jax_sweep

    drawn = [p.values for p in jax_sweep._configs()]
    assert [tuple(c) for c in drawn] == [tuple(c) for c in mirror_cases.sweep_configs()]
    for case in mirror_cases.cases():
        module, name = case.source.split("::")
        jax_test = importlib.import_module(f"tests.{module[:-3]}")
        assert hasattr(jax_test, name), case.source
