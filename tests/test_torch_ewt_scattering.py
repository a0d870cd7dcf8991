"""Port parity: the empirical wavelet transform (``transforms.ewt``) and the
1-D scattering network (``transforms.scattering``), mirroring
``tests/test_ewt.py`` and ``tests/test_scattering.py``.

The same seeded numpy signals go through the JAX package and the port in
float64.  Tolerances, with their reasons:

* ``ewt_boundaries``: equal floats (the same host peak search on the same
  float64 spectrum);
* the filter banks, ``ewt``, ``iewt``, ``ewt_hilbert`` and the scattering
  coefficients: 1e-10 of the largest value (the same FFT products in
  another FFT library).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from vectorwave_tpu.transforms import ewt as je
from vectorwave_tpu.transforms import scattering as js
from vectorwave_tpu_torch.errors import VectorWaveError
from vectorwave_tpu_torch.transforms import ewt as te
from vectorwave_tpu_torch.transforms import scattering as ts

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


def _three_tone(n=2048, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    parts = [np.sin(2 * np.pi * 0.03 * t), 0.8 * np.sin(2 * np.pi * 0.11 * t),
             0.6 * np.sin(2 * np.pi * 0.3 * t)]
    return sum(parts) + 0.05 * rng.standard_normal(n), parts


# --- EWT --------------------------------------------------------------------------------


@pytest.mark.parametrize("n_bands,smooth,batch", [(3, 9, ()), (2, 3, (2,)), (4, 1, (3,))])
def test_ewt_boundaries_match_jax(n_bands, smooth, batch):
    x, _ = _three_tone()
    x = np.broadcast_to(x, batch + x.shape) + 0.01 * np.random.default_rng(1).standard_normal(
        batch + x.shape)
    want = vw.ewt_boundaries(x, n_bands, smooth=smooth)
    assert te.ewt_boundaries(_t(x), n_bands, smooth=smooth) == want
    assert te.ewt_boundaries(x, n_bands, smooth=smooth) == want  # numpy input


def test_ewt_boundaries_rank_by_prominence_not_height():
    """AM sidebands on a dominant carrier are taller than a genuine weak
    band; prominence keeps the real band."""
    rng = np.random.default_rng(0)
    t = np.arange(4096)
    sig = ((1 + 0.35 * np.cos(2 * np.pi * 0.004 * t)) * np.sin(2 * np.pi * 0.10 * t)
           + 0.18 * np.sin(2 * np.pi * 0.35 * t) + 0.01 * rng.standard_normal(4096))
    (bound,) = vt.ewt_boundaries(_t(sig), 2, smooth=3)
    assert 0.11 < bound < 0.34 and (bound,) == vw.ewt_boundaries(sig, 2, smooth=3)


@pytest.mark.parametrize("bounds", [(0.05, 0.2), (0.01, 0.02, 0.4), (0.25,)])
def test_filterbank_is_jax_s_tight_frame(bounds):
    bank = te.ewt_filterbank(2048, bounds, np.float64)
    assert _rel(bank, je.ewt_filterbank(2048, bounds, np.float64)) <= TOL
    np.testing.assert_allclose((bank**2).sum(axis=0), 1.0, atol=1e-12)
    assert te.ewt_filterbank(2049, bounds).dtype == np.float32


@pytest.mark.parametrize("bounds,shape", [((0.05, 0.2), (2048,)), ((0.05, 0.15, 0.35), (2, 1001)),
                                          ((0.25,), (3, 512))])
def test_ewt_iewt_hilbert_match_jax(bounds, shape):
    x = np.random.default_rng(2).standard_normal(shape)
    want = vw.ewt(jnp.asarray(x), bounds)
    got = vt.ewt(_t(x), bounds)
    assert _rel(got, want) <= TOL
    assert _rel(vt.iewt(got, bounds), vw.iewt(want, bounds)) <= TOL
    assert (vt.iewt(got, bounds) - _t(x)).abs().max().item() <= 1e-12
    assert _rel(vt.ewt_hilbert(_t(x), bounds), vw.ewt_hilbert(jnp.asarray(x), bounds)) <= TOL


def test_tensor_boundaries_match_the_tuple_and_differentiate():
    """A tensor of boundaries builds the bank from the tensor (the JAX
    traced path): the same windows as the tuple, gradients in the
    boundaries."""
    x = _t(np.random.default_rng(9).standard_normal(2048))
    bounds = (0.05, 0.15, 0.35)
    a = vt.ewt(x, bounds)
    bt = torch.tensor(bounds, dtype=torch.float64, requires_grad=True)
    b = vt.ewt(x, bt)
    assert (a - b).abs().max().item() <= 1e-12
    want = jax.jit(lambda z, bd: vw.ewt(z, bd))(jnp.asarray(x.numpy()), jnp.asarray(bounds))
    assert _rel(b.detach(), want) <= TOL
    (g,) = torch.autograd.grad((b[0] ** 2).sum(), bt)
    jg = jax.grad(lambda bd: jnp.sum(vw.ewt(jnp.asarray(x.numpy()), bd)[0] ** 2))(
        jnp.asarray(bounds))
    assert _rel(g, jg) <= 1e-8


def test_modes_match_their_sources_and_hilbert_amplitude():
    x, parts = _three_tone(4096)
    xt = _t(x)
    bounds = vt.ewt_boundaries(xt, 3)
    comps = vt.ewt(xt, bounds).numpy()
    for band, src in enumerate(parts):
        assert np.corrcoef(comps[band], src)[0, 1] > 0.98
    analytic = vt.ewt_hilbert(xt, bounds).abs().numpy()
    for band, amp in enumerate((1.0, 0.8, 0.6)):  # near-constant envelopes
        env = analytic[band, 64:-64]
        assert abs(env.mean() - amp) < 0.08 and env.std() < 0.1


def test_hilbert_keeps_the_nyquist_bin_of_an_even_length():
    t = np.arange(512)
    x = _t(np.sin(2 * np.pi * 0.45 * t) + np.sin(2 * np.pi * 0.08 * t))
    np.testing.assert_allclose(vt.ewt_hilbert(x, (0.25,)).real.numpy(),
                               vt.ewt(x, (0.25,)).numpy(), atol=1e-12)


@pytest.mark.parametrize("call,code", [
    (lambda: vt.ewt(torch.zeros(1024), (0.3, 0.1)), "CFG_003"),  # not increasing
    (lambda: vt.ewt(torch.zeros(1024), (0.7,)), "CFG_003"),  # outside (0, 0.5)
    (lambda: vt.ewt(torch.zeros(1024), (0.0, 0.2)), "CFG_003"),
    (lambda: vt.ewt(torch.zeros(1024), torch.tensor([0.3, 0.1])), "CFG_003"),
    (lambda: vt.ewt(torch.zeros(1024), torch.tensor([0.5])), "CFG_003"),
    (lambda: vt.ewt_boundaries(np.ones(64), 1), "CFG_003"),
    (lambda: vt.ewt_boundaries(np.ones(64), 5), "VAL_007"),  # too few peaks
])
def test_ewt_validation(call, code):
    with pytest.raises(VectorWaveError) as got:
        call()
    assert _code(got) == code


# --- scattering -------------------------------------------------------------------------


@pytest.mark.parametrize("n,J,Q", [(2048, 6, 8), (1000, 3, 1), (4096, 8, 4)])
def test_scattering_filterbank_is_jax_s(n, J, Q):
    for got, want in zip(ts.scattering_filterbank(n, J, Q), js.scattering_filterbank(n, J, Q)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,kwargs", [
    ((2048,), {"J": 6, "Q": 8}), ((2, 3, 512), {"J": 5, "Q": 4}),
    ((2, 1024), {"J": 4, "Q": 2, "order": 1}), ((1024,), {"J": 5, "Q": 4, "Q2": 2, "stride": 1}),
    ((64,), {"J": 6, "Q": 1})])
def test_scattering1d_matches_jax(shape, kwargs):
    """Orders 1 and 2, batches, full rate, and a path set left empty (J = 6
    at 64 samples: one wavelet, no second-order path below half of it)."""
    x = np.random.default_rng(3).standard_normal(shape)
    want = jax.jit(lambda z: (lambda r: (r.s0, r.s1, r.s2, r.feature_vector()))(
        vw.scattering1d(z, **kwargs)))(jnp.asarray(x))
    got = vt.scattering1d(_t(x), **kwargs)
    _, xi1, _ = js.scattering_filterbank(shape[-1], kwargs["J"], kwargs["Q"])
    _, xi2, _ = js.scattering_filterbank(shape[-1], kwargs["J"], kwargs.get("Q2", 1))
    assert got.xi1 == tuple(float(v) for v in xi1)
    if kwargs.get("order", 2) == 2:
        assert got.xi2 == tuple(float(v) for v in xi2)
        assert got.pairs == tuple((i1, i2) for i1 in range(len(xi1)) for i2 in range(len(xi2))
                                  if xi2[i2] < 0.5 * xi1[i1])
    assert _rel(got.s0, want[0]) <= TOL and _rel(got.s1, want[1]) <= TOL
    if want[2] is None:
        assert got.s2 is None
    elif want[2].size:
        assert _rel(got.s2, want[2]) <= TOL
    else:
        assert got.s2.shape == want[2].shape
    assert _rel(got.feature_vector(), want[3]) <= TOL
    assert float(got.s1.min()) >= 0.0


def test_scattering_float32_keeps_complex64():
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 512)).astype(np.float32))
    res = vt.scattering1d(x, J=5, Q=4)
    want = vw.scattering1d(jnp.asarray(x.numpy()), J=5, Q=4)
    assert res.s1.dtype == torch.float32 and res.s2.dtype == torch.float32
    assert _rel(res.s1, want.s1) <= 1e-5 and _rel(res.s2, want.s2) <= 1e-5


def test_scattering_invariance_localization_and_modulation():
    """Translation-invariant features, a tone's peak at its frequency, and
    the second order seeing an amplitude modulation."""
    t = np.arange(4096)
    rng = np.random.default_rng(0)
    x = (np.sin(2 * np.pi * 0.05 * t) * np.exp(-0.5 * ((t - 2000) / 300) ** 2)
         + 0.1 * rng.standard_normal(4096))
    f0 = vt.scattering1d(_t(x), J=7, Q=8).feature_vector()
    fs = vt.scattering1d(_t(np.roll(x, 64)), J=7, Q=8).feature_vector()
    assert ((fs - f0).norm() / f0.norm()).item() < 0.02
    res = vt.scattering1d(_t(np.cos(2 * np.pi * 0.1 * t)), J=6, Q=8)
    peak = res.xi1[int(res.s1.mean(-1).argmax())]
    assert abs(np.log2(peak / 0.1)) < 1.0 / 8 + 1e-6
    carrier = np.cos(2 * np.pi * 0.1 * t)
    r_am = vt.scattering1d(_t(carrier * (1 + 0.8 * np.cos(2 * np.pi * 0.004 * t))), J=8, Q=8)
    r_pu = vt.scattering1d(_t(carrier), J=8, Q=8)
    diff = (r_am.s2.mean(-1) - r_pu.s2.mean(-1)).numpy()
    i1, i2 = r_am.pairs[int(np.argmax(diff))]
    assert abs(np.log2(r_am.xi1[i1] / 0.1)) < 0.3 and r_am.xi2[i2] < 0.02


@pytest.mark.parametrize("call,code", [
    (lambda: vt.scattering1d(torch.zeros(32), J=6), "VAL_004"),  # too short
    (lambda: vt.scattering1d(torch.zeros(1024), J=5, order=3), "CFG_003"),
    (lambda: vt.scattering1d(torch.zeros(1000), J=5), "VAL_007"),  # stride must divide n
    (lambda: ts.scattering_filterbank(16, 1, 1), "CFG_003"),  # no band above 1/2
])
def test_scattering_validation(call, code):
    with pytest.raises(VectorWaveError) as got:
        call()
    assert _code(got) == code
