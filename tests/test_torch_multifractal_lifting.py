"""Port parity: multifractal leaders (``transforms.multifractal``) and the
lifting DWT (``transforms.lifting``), mirroring ``tests/test_multifractal.py``
and ``tests/test_lifting.py``.

The same seeded numpy signals go through the JAX package and the port in
float64 (int32 for the integer lifting).  Tolerances, with their reasons:

* the leaders, the float lifting transforms and the effective filters:
  1e-10 of the largest value (the same DWT and lifting steps);
* the spectrum's zeta, h, D, c1 and c2: 1e-9 absolute (weighted fits of
  logs and powers of those leaders);
* the integer lifting: equal (``torch.equal``), forward and round trip,
  also past 2^24 where a float32 prediction would round.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from vectorwave_tpu.transforms import lifting as jl
from vectorwave_tpu_torch.errors import InvalidArgumentError, VectorWaveError
from vectorwave_tpu_torch.transforms import lifting as tl

torch.set_num_threads(1)

TOL = 1e-10
TOL_FIT = 1e-9
SCHEMES = sorted(tl.LIFTING_SCHEMES)


def _rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _t(a):
    return torch.from_numpy(np.array(a))


def _code(exc_info) -> str:
    return exc_info.value.code.value


def _cascade(n_levels, seed, sigma=0.35):
    """Mandelbrot multiplicative cascade (the integrated measure)."""
    rng = np.random.default_rng(seed)
    m = np.ones(1)
    for _ in range(n_levels):
        m = np.repeat(m, 2) * np.exp(rng.normal(-sigma**2 / 2, sigma, 2 * len(m)))
    return np.cumsum(m)


# --- multifractal ----------------------------------------------------------------------


@pytest.mark.parametrize("name,levels,shape,boundary", [
    ("db2", 4, (256,), "periodic"), ("db3", 5, (2, 1024), "periodic"),
    ("db2", 3, (2, 1000), "zero")])
def test_wavelet_leaders_match_jax(name, levels, shape, boundary):
    """Periodic at two depths, and N = 1000 (levels of 500, 250 and 125)
    with the zero boundary."""
    x = np.random.default_rng(3).standard_normal(shape)
    want = jax.jit(lambda z: vw.wavelet_leaders(z, name, levels=levels, boundary=boundary))(
        jnp.asarray(x))
    got = vt.wavelet_leaders(_t(x), name, levels=levels, boundary=boundary)
    assert len(got) == len(want) == levels
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL


def test_odd_length_level_folds_into_the_last_parent(monkeypatch):
    """The decimated pyramid keeps every level but the last even, so the
    odd-carry branch is reached with details of other lengths: both
    packages are handed the same details (125, 63 and 32 long), where the
    level-1 carry's leftover folds into the last parent and level 2's
    pooled carry (31 + 1 < 32) is padded."""
    from vectorwave_tpu.ops.dwt import WavedecResult as JaxWavedec
    from vectorwave_tpu.transforms import multifractal as jm
    from vectorwave_tpu_torch.ops.dwt import WavedecResult
    from vectorwave_tpu_torch.transforms import multifractal as tm

    rng = np.random.default_rng(4)
    details = [rng.standard_normal((2, n)) for n in (125, 63, 32)]
    approx = rng.standard_normal((2, 32))
    monkeypatch.setattr(jm, "wavedec", lambda *a, **k: JaxWavedec(
        tuple(jnp.asarray(d) for d in details), jnp.asarray(approx)))
    monkeypatch.setattr(tm, "wavedec", lambda *a, **k: WavedecResult(
        tuple(_t(d) for d in details), _t(approx)))
    want = jm.wavelet_leaders(jnp.zeros((2, 250)), "db2", levels=3)
    got = tm.wavelet_leaders(torch.zeros(2, 250), "db2", levels=3)
    for g, w in zip(got, want):
        assert torch.equal(g, _t(w))
    # the fold by hand: level 2's first leader row takes the last pair and
    # the leftover of level 1's carry
    c1 = np.abs(details[0]) * 2.0**-0.5
    c2 = np.abs(details[1]) * 2.0**-1.0
    carry2 = np.maximum(c2[..., :62], np.maximum(c1[..., 0:124:2], c1[..., 1:124:2]))
    assert np.array_equal(carry2[..., 61], np.maximum(
        c2[..., 61], np.maximum(np.maximum(c1[..., 122], c1[..., 123]), c1[..., 124])))


def _jax_spectrum(x, name, kwargs):
    """The JAX package's spectrum under one jit (its eager form compiles op
    by op; the numbers are the same program's)."""
    fields = jax.jit(lambda z: tuple(vw.multifractal_spectrum(z, name, **kwargs)[1:6]))(
        jnp.asarray(x))
    return dict(zip(("zeta", "h", "D", "c1", "c2"), fields))


@pytest.mark.parametrize("signal,name,kwargs", [
    ("cascade", "db3", {"min_level": 3}),
    ("noise", "db2", {"qs": (-2, -1, 1, 2), "boundary": "zero", "max_level": 6}),
    ("flat", "db3", {"min_level": 2}),
    ("noise1000", "db2", {"min_level": 1})])
def test_multifractal_spectrum_matches_jax(signal, name, kwargs):
    if signal == "cascade":
        x = np.stack([_cascade(11, s) for s in range(2)])
    elif signal == "noise":
        x = np.random.default_rng(0).standard_normal((2, 3, 1024))
    elif signal == "flat":  # exactly-zero leaders: the relative floor keeps them finite
        x = np.zeros(2048)
        x[:512] = np.random.default_rng(1).standard_normal(512)
    else:  # N = 1000: only 3 dyadic levels divide it
        x = np.random.default_rng(0).standard_normal(1000)
    want = _jax_spectrum(x, name, kwargs)
    got = vt.multifractal_spectrum(_t(x), name, **kwargs)
    assert got.qs == tuple(float(q) for q in kwargs.get("qs", got.qs))
    for field, w in want.items():
        g, w = getattr(got, field), np.asarray(w)
        assert g.shape == w.shape and bool(torch.isfinite(g).all()), field
        assert np.abs(g.numpy() - w).max() <= TOL_FIT, field
    width = np.asarray(want["h"]).max(axis=-1) - np.asarray(want["h"]).min(axis=-1)
    assert np.abs(got.spectrum_width().numpy() - width).max() <= TOL_FIT


def test_cascade_is_multifractal():
    x = _t(np.stack([_cascade(12, s) for s in range(4)]))
    res = vt.multifractal_spectrum(x, "db3", min_level=3)
    assert res.c2.mean().item() < -0.08 and res.spectrum_width().mean().item() > 0.5
    assert bool((torch.diff(res.h.mean(dim=0)) < 1e-6).all())  # h(q) decreasing
    assert res.D.max().item() <= 1.1


@pytest.mark.parametrize("call,code", [
    (lambda x: vt.multifractal_spectrum(x, qs=()), "VAL_002"),
    (lambda x: vt.multifractal_spectrum(x, qs=(0.0, 1.0)), "CFG_003"),
    (lambda x: vt.multifractal_spectrum(x[:32], min_level=2), "VAL_004"),
])
def test_multifractal_validation(call, code):
    with pytest.raises(VectorWaveError) as got:
        call(torch.zeros(4096, dtype=torch.float64))
    assert _code(got) == code


# --- lifting --------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", SCHEMES)
def test_lifting_dwt_and_inverse_match_jax(scheme):
    x = np.random.default_rng(42).standard_normal((3, 64))
    want = jl.lifting_dwt(jnp.asarray(x), scheme)
    got = tl.lifting_dwt(_t(x), scheme)
    assert _rel(got.approx, want.approx) <= TOL and _rel(got.detail, want.detail) <= TOL
    rec = tl.lifting_idwt(got.approx, got.detail, scheme)
    assert _rel(rec, jl.lifting_idwt(want.approx, want.detail, scheme)) <= TOL
    assert (rec - _t(x)).abs().max().item() <= 1e-12
    assert tl.get_lifting_scheme(scheme) == jl.get_lifting_scheme(scheme)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_lifting_wavedec_waverec_match_jax(scheme):
    x = np.random.default_rng(43).standard_normal((2, 128))
    want = jax.jit(lambda z: jl.lifting_wavedec(z, scheme, levels=4))(jnp.asarray(x))
    got = tl.lifting_wavedec(_t(x), scheme, levels=4)
    assert got.levels == 4 and got.approx.shape[-1] == 8
    assert [d.shape[-1] for d in got.details] == [64, 32, 16, 8]
    for g, w in zip((*got.details, got.approx), (*want.details, want.approx)):
        assert _rel(g, w) <= TOL
    assert (tl.lifting_waverec(got, scheme) - _t(x)).abs().max().item() <= 1e-12
    assert tl.lifting_wavedec(_t(x), scheme).levels == 6  # default: halve to 2 samples


@pytest.mark.parametrize("scheme,wavelet", [("haar", "haar"), ("db2", "db2"),
                                            ("cdf97", "bior4.4")])
def test_effective_filters_match_jax_and_the_registry(scheme, wavelet):
    """The cascade is the named wavelet's analysis bank up to shift and sign."""
    lo, hi = tl.effective_filters(scheme, n=64)
    jlo, jhi = jl.effective_filters(scheme, n=64)
    assert _rel(lo, jlo) <= TOL and _rel(hi, jhi) <= TOL
    w = vt.wavelet(wavelet)
    for eff, filt in ((lo, w.dec_lo), (hi, w.dec_hi)):
        row = np.zeros(64)
        row[: len(filt)] = filt
        best = min(np.abs(sgn * np.roll(eff, s) - row).max()
                   for s in range(64) for sgn in (1.0, -1.0))
        assert best < 1e-6


@pytest.mark.parametrize("scheme", ["haar", "db2"])
def test_orthonormal_energy_preserved(scheme):
    x = _t(np.random.default_rng(44).standard_normal(256))
    res = tl.lifting_dwt(x, scheme)
    e = ((res.approx**2).sum() + (res.detail**2).sum()).item()
    assert e == pytest.approx((x**2).sum().item(), rel=1e-12)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("dtype,high", [(torch.int32, 30000), (torch.int64, 2**40)])
def test_integer_lifting_matches_jax_bit_for_bit(scheme, dtype, high):
    """Forward equal to JAX's (float64 rounding, as the tests run it) and
    the round trip exact, also for |x| past 2^24 in int64."""
    rng = np.random.default_rng(45)
    x = rng.integers(-high, high, size=(2, 128))
    xt = _t(x).to(dtype)
    got = tl.lifting_dwt_int(xt, scheme)
    assert got.approx.dtype == dtype
    want = jl.lifting_dwt_int(jnp.asarray(x, dtype=jnp.int32 if dtype == torch.int32
                                          else jnp.int64), scheme)
    assert torch.equal(got.approx, _t(want.approx).to(dtype))
    assert torch.equal(got.detail, _t(want.detail).to(dtype))
    assert torch.equal(tl.lifting_idwt_int(got.approx, got.detail, scheme), xt)


@pytest.mark.parametrize("scheme", ["legall53", "cdf97"])
def test_integer_multilevel_lossless(scheme):
    x = np.random.default_rng(46).integers(-(2**15), 2**15, size=(3, 512))
    xt = _t(x).to(torch.int32)
    got = tl.lifting_wavedec_int(xt, scheme, levels=5)
    want = jax.jit(lambda z: jl.lifting_wavedec_int(z, scheme, levels=5))(
        jnp.asarray(x, dtype=jnp.int32))
    for g, w in zip((*got.details, got.approx), (*want.details, want.approx)):
        assert torch.equal(g, _t(w).to(torch.int32))
    assert torch.equal(tl.lifting_waverec_int(got, scheme), xt)


def test_negative_predictions_floor_not_truncate():
    """floor(pred + 1/2) on negatives (torch's integer division would
    differ): -3 / 2 -> floor(-1.5 + 0.5) = -1; 3 / 2 -> 2."""
    x = torch.tensor([0, 0, -3, 0, 0, 0, 3, 0], dtype=torch.int32)
    got = tl.lifting_dwt_int(x, "legall53")
    want = jl.lifting_dwt_int(jnp.asarray(x.numpy()), "legall53")
    assert torch.equal(got.detail, _t(want.detail))
    assert torch.equal(tl.lifting_idwt_int(got.approx, got.detail, "legall53"), x)


def test_integer_legall53_tracks_the_float_path():
    x = torch.from_numpy(np.random.default_rng(47).integers(0, 255, size=256)).to(torch.int32)
    res_i = tl.lifting_dwt_int(x, "legall53")
    res_f = tl.lifting_dwt(x.double(), "legall53")
    assert (res_i.approx.double() - res_f.approx / np.sqrt(2.0)).abs().max().item() <= 1.0


def test_lifting_gradient():
    x = torch.linspace(-1.0, 1.0, 64, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad((tl.lifting_dwt(x, "cdf97").detail ** 2).sum(), x)
    assert bool(torch.isfinite(g).all())


@pytest.mark.parametrize("call,code", [
    (lambda: tl.lifting_dwt(torch.zeros(63), "haar"), "VAL_007"),  # odd length
    (lambda: tl.lifting_dwt(torch.zeros(64), "nosuch"), "CFG_001"),
    (lambda: tl.lifting_dwt(torch.zeros(64), "haar", boundary="symmetric"), "CFG_002"),
    (lambda: tl.lifting_dwt_int(torch.zeros(64), "haar"), "VAL_007"),  # float input
    (lambda: tl.lifting_wavedec(torch.zeros(40), levels=4), "VAL_007"),  # 40 % 16 != 0
    (lambda: tl.lifting_wavedec_int(torch.zeros(64, dtype=torch.int32), levels=0), "VAL_006"),
])
def test_lifting_validation(call, code):
    with pytest.raises(InvalidArgumentError) as got:
        call()
    assert _code(got) == code


def test_odd_length_code_matches_jax():
    with pytest.raises(vw.InvalidArgumentError) as want:
        jl.lifting_dwt(jnp.zeros(63), "haar")
    with pytest.raises(InvalidArgumentError) as got:
        tl.lifting_dwt(torch.zeros(63), "haar")
    assert _code(got) == want.value.code.value


def test_aliases_resolve():
    assert tl.get_lifting_scheme("bior4.4").name == "cdf97"
    assert tl.get_lifting_scheme("jpeg2000").name == "cdf97"
    assert tl.get_lifting_scheme("bior2.2").name == "legall53"
    s = tl.get_lifting_scheme("haar")
    assert tl.get_lifting_scheme(s) is s
    assert vt.LIFTING_SCHEMES is tl.LIFTING_SCHEMES
