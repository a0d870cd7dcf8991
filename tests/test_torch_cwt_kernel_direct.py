"""Port parity: the CWT's kernel-direct tier, mirroring
``tests/test_cwt_kernel_direct.py``.

The port's tier runs under ``backend='kernel'`` on the CPU, where the
filter bank's plain version computes what the CUDA kernel computes on the
card.  It is held against the JAX tier (``_cwt_kernel_direct`` through the
Pallas bank kernel in interpret mode, float32) and against the FFT path
within 2e-5 of the largest coefficient, the JAX package's own bound; the
gradient against ``jax.grad`` of the JAX FFT path in float64 within 2e-5 of
its largest entry; the split and the chunks against their rules on both
sides of each cap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from vectorwave_tpu.transforms import cwt as jcwt
from vectorwave_tpu_torch.kernels import modwt_bank as mb
from vectorwave_tpu_torch.kernels import modwt_fused
from vectorwave_tpu_torch.transforms import cwt as tcwt

from . import cwt_periodic

torch.set_num_threads(1)

TOL = 2e-5


@pytest.fixture
def kernel_backend():
    vt.set_backend("kernel")
    try:
        yield
    finally:
        vt.set_backend("auto")


@pytest.fixture
def jax_pallas():
    vw.set_backend("pallas")
    vw.set_fused_precision("float32")
    try:
        yield
    finally:
        vw.set_backend("auto")
        vw.set_fused_precision("bf16_3x")


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _err(got, want):
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _fft_path(x, scales, name="morl"):
    """The port's own FFT path on the same input (backend 'torch')."""
    vt.set_backend("torch")
    try:
        return vt.cwt(torch.from_numpy(x), scales, name, boundary="periodic").coeffs
    finally:
        vt.set_backend("kernel")


# (wavelet, shape, scales): the JAX tests' grid at CPU sizes, a ragged row,
# a row shorter than the span (64: a span of 512 on 300 samples),
# and mexh, whose taps hold exact zeros (1 - t^2 at t = 1)
TIER_CASES = [
    ("morl", (1, 4096), tuple(np.geomspace(2.0, 64.0, 8).tolist())),
    ("morl", (3, 1000), (2.0, 4.0, 8.0)),
    ("morl", (2, 300), (16.0, 64.0)),
    ("mexh", (2, 2048), (1.0, 2.0, 5.0, 9.0)),
]


@pytest.mark.parametrize("name,shape,scales", TIER_CASES)
def test_tier_matches_the_jax_pallas_tier_and_the_fft_path(kernel_backend, jax_pallas, name,
                                                           shape, scales):
    x = _x(shape)
    want = jcwt._cwt_kernel_direct(jnp.asarray(x), jcwt._resolve_continuous(name), scales,
                                   jnp.float32)
    tier = torch.cat(tcwt._cwt_kernel_direct(torch.from_numpy(x), vt.wavelet(name), scales),
                     dim=-2)
    assert _err(tier, want) <= TOL
    res = vt.cwt(torch.from_numpy(x), scales, name, boundary="periodic")
    assert res.coeffs.dtype == torch.float32 and res.coeffs.shape == shape[:1] + (
        len(scales), shape[1])
    # past N too: both routes sum the taps that wrap onto one slot
    assert _err(res.coeffs, _fft_path(x, scales, name).numpy()) <= TOL


def _correlation(x, scales) -> np.ndarray:
    """The morl rows ``[..., S, N]`` of the periodic correlation, float64."""
    return np.stack([cwt_periodic.periodic_correlation(x, "morl", s) for s in scales], -2)


def test_span_past_n_is_the_periodic_correlation(kernel_backend):
    """The bank wraps modulo N as often as the span needs, so the tier on a
    span longer than the row gives out[t] = sum_k x[(t + k) mod N] c_k;
    ``cwt`` sends these scales to it, and the FFT path's bank sums the
    wrapped taps too, so both routes give the correlation."""
    x = _x((2, 300), seed=1)
    scales = (40.0, 64.0, 100.0)
    w = vt.wavelet("morl")
    assert all(2 * tcwt._half_support(s, w.bandwidth) + 1 > 300 for s in scales)
    assert tcwt._kernel_direct_split(torch.device("cpu"), w, scales, "periodic",
                                     torch.float32) == 3
    want = _correlation(x, scales)
    got = torch.cat(tcwt._cwt_kernel_direct(torch.from_numpy(x), w, scales), dim=-2)
    assert _err(got, want) <= TOL
    assert _err(vt.cwt(torch.from_numpy(x), scales, "morl", boundary="periodic").coeffs,
                want) <= TOL
    assert _err(_fft_path(x, scales), want) <= TOL


@pytest.mark.parametrize("scales,n_small,n", [
    ((4.0, 16.0, 2048.0), 2, 4096),     # the last past the cap of 2048
    ((64.0, 8.0, 2.0), 0, 4096),        # descending: the FFT path keeps them all
    ((2.0, 8.0, 4.0, 16.0), 0, 4096),   # unsorted
    ((4.0, 512.0, 513.0), 2, 8192),     # 512 is h = 2048 exactly, 513 past it
    ((4.0, 512.0, 513.0), 2, 4096),     # 512's span of 4097 wraps past N: the tier's
])
def test_hybrid_split_lines_up_the_rows(kernel_backend, jax_pallas, scales, n_small, n):
    """The rows whose support fits in N against the JAX jnp path's, those
    that wrap past it (past the FFT size's N, JAX's bank keeps one tap a
    slot) against the periodic correlation."""
    w = vt.wavelet("morl")
    assert tcwt._kernel_direct_split(torch.device("cpu"), w, scales, "periodic",
                                     torch.float32) == n_small
    x = _x((1, n), seed=2)
    got = vt.cwt(torch.from_numpy(x), scales, "morl", boundary="periodic").coeffs
    vw.set_backend("jnp")
    want = np.array(vw.cwt(jnp.asarray(x), scales, "morl", boundary="periodic").coeffs,
                    np.float64)
    for i in (i for i, s in enumerate(scales) if cwt_periodic.wraps("morl", s, n)):
        want[..., i, :] = cwt_periodic.periodic_correlation(x, "morl", scales[i])
    assert _err(got, want) <= TOL


def test_split_conditions_and_the_two_caps(monkeypatch):
    """``torch`` never takes the tier; ``kernel`` to h = 2048 on any device;
    ``auto`` only on a card the kernels are built for, and only when every
    scale is within AUTO_KERNEL_DIRECT_MAX_HALF and they make one bank call;
    a periodic boundary and float32 only; a support longer than the row is
    no bar."""
    w = vt.wavelet("morl")
    cpu, card = torch.device("cpu"), torch.device("cuda")
    cap = tcwt.AUTO_KERNEL_DIRECT_MAX_HALF
    assert 8 <= cap <= tcwt.KERNEL_DIRECT_MAX_HALF == 2048
    # scales of half-support exactly cap and one past it (morl: h = ceil(4 s))
    at, past = cap / 4.0, cap / 4.0 + 0.25
    assert tcwt._half_support(at, 1.0) == cap and tcwt._half_support(past, 1.0) == cap + 1
    top, over = 512.0, 512.25
    split = tcwt._kernel_direct_split
    try:
        vt.set_backend("kernel")
        for dev in (cpu, card):
            assert split(dev, w, (2.0, at, past, top, over), "periodic", torch.float32) == 4
        assert split(cpu, w, (2.0, at), "zero", torch.float32) == 0
        assert split(cpu, w, (2.0, at), "symmetric", torch.float32) == 0
        assert split(cpu, w, (2.0, at), "periodic", torch.float64) == 0
        vt.set_backend("auto")
        monkeypatch.setattr(modwt_fused, "kernel_available", lambda: True)
        assert split(card, w, (2.0, at), "periodic", torch.float32) == 2
        assert split(card, w, (2.0, at, past, top), "periodic", torch.float32) == 0
        assert split(card, w, (past,), "periodic", torch.float32) == 0
        # every scale within the cap, but more than one bank call's planes
        many = tuple(np.geomspace(1.0, at, mb.MAX_PLANES + 1).tolist())
        assert split(card, w, many[:-1], "periodic", torch.float32) == mb.MAX_PLANES
        assert split(card, w, many, "periodic", torch.float32) == 0
        assert split(cpu, w, (2.0, at), "periodic", torch.float32) == 0
        assert split(card, w, (2.0, at), "periodic", torch.float64) == 0
        monkeypatch.setattr(modwt_fused, "kernel_available", lambda: False)
        assert split(card, w, (2.0, at), "periodic", torch.float32) == 0
        vt.set_backend("torch")
        monkeypatch.setattr(modwt_fused, "kernel_available", lambda: True)
        assert split(card, w, (2.0, at), "periodic", torch.float32) == 0
    finally:
        vt.set_backend("auto")


def test_auto_on_the_cpu_takes_the_fft_path(monkeypatch):
    calls = []
    monkeypatch.setattr(tcwt, "_cwt_kernel_direct",
                        lambda *a: calls.append(a) or pytest.fail("tier taken"))
    vt.cwt(torch.from_numpy(_x((1, 512))), (2.0, 4.0), "morl", boundary="periodic")
    assert calls == []


def test_chunks_hold_the_planes_and_the_window(monkeypatch):
    """At most MAX_PLANES scales a bank call, cut where the window stops
    fitting shared memory; each chunk's taps are built once and passed as the
    same tuple on every call, so the bank finds its tables by identity."""
    w = vt.wavelet("morl")
    scales = tuple(np.geomspace(2.0, 512.0, 70).tolist())
    chunks = tcwt._kernel_direct_chunks(w, scales)
    assert [len(d) for _, d in chunks] == [64, 6]
    halves = [tcwt._half_support(s, 1.0) for s in scales]
    assert [m for m, _ in chunks] == [max(halves[:64]), max(halves[64:])]
    assert tcwt._kernel_direct_chunks(w, scales) is chunks
    maxhalf, dense = chunks[0]
    taps = mb.bank_taps(dense)
    assert taps is mb.bank_taps(dense)
    # each plane costs its own 2h + 1 taps, not the chunk's 2 maxhalf + 1
    assert [taps.starts[p + 1] - taps.starts[p] for p in range(3)] == [
        2 * h + 1 for h in halves[:3]]
    assert taps.span == 2 * maxhalf
    # a window that does not fit begins a chunk; alone it stays one
    monkeypatch.setattr(mb, "span_fits", lambda span: span <= 2 * 100)
    try:  # halves 8, 80, 100, 160, 320
        cut = tcwt._kernel_direct_chunks(w, (2.0, 20.0, 25.0, 40.0, 80.0))
    finally:
        tcwt._kernel_direct_chunks.cache_clear()
    assert [len(d) for _, d in cut] == [3, 1, 1]


def test_tier_calls_the_bank_once_a_chunk_on_x_rolled_once(kernel_backend, monkeypatch):
    calls = []
    real = mb.bank_analysis_stacked
    monkeypatch.setattr(mb, "bank_analysis_stacked",
                        lambda x, dense, per: (calls.append((len(dense), per)),
                                               real(x, dense, per))[1])
    x = torch.from_numpy(_x((2, 700), seed=3))
    scales = tuple(np.geomspace(2.0, 8.0, 66).tolist())
    vt.cwt(x, scales, "morl", boundary="periodic")
    assert calls == [(64, True), (2, True)]


@pytest.mark.parametrize("scales", [(2.0, 5.0, 12.0), (4.0, 16.0, 2048.0)])
def test_gradient_matches_jax_grad(kernel_backend, scales):
    """d/dx of a weighted sum of the coefficients: on the tier the bank's
    backward (its synthesis with the same taps), on the FFT rows autograd.
    A row whose support wraps past N (scale 2048's 16385 taps on 4096
    samples) is the periodic correlation, whose adjoint is
    ``sum_k c_k w[(m - k) mod N]``; the other rows' gradient is JAX's."""
    n = 4096
    x = _x((2, n), seed=4)
    wts = np.random.default_rng(5).standard_normal((2, len(scales), n))
    wraps = [cwt_periodic.wraps("morl", s, n) for s in scales]
    fits = np.array([0.0 if wrap else 1.0 for wrap in wraps])[:, None]
    vw.set_backend("jnp")
    try:
        want = np.asarray(jax.grad(lambda v: jnp.sum(
            wts * fits * vw.cwt(v, scales, "morl", boundary="periodic").coeffs))(
            jnp.asarray(x, jnp.float64)))
    finally:
        vw.set_backend("auto")
    for i in (i for i, wrap in enumerate(wraps) if wrap):
        want = want + (wts[:, i] @ cwt_periodic.correlation_matrix("morl", scales[i], n)).real
    xt = torch.from_numpy(x).requires_grad_(True)
    c = vt.cwt(xt, scales, "morl", boundary="periodic").coeffs
    (got,) = torch.autograd.grad((torch.from_numpy(wts).float() * c).sum(), xt)
    assert _err(got, want) <= TOL


def test_kernel_backend_takes_no_launch_on_the_cpu(kernel_backend):
    from vectorwave_tpu_torch.kernels import modwt_composite as mc

    before = dict(mc.LAUNCHES)
    vt.cwt(torch.from_numpy(_x((1, 512))), (2.0, 4.0), "morl", boundary="periodic")
    assert mc.LAUNCHES == before


@pytest.mark.parametrize("scales,stacked", [
    ((2.0, 4.0, 8.0), True),            # every scale in one bank call
    ((2.0, 4.0, 2048.0), False),        # the hybrid joins FFT rows
])
def test_tier_result_is_the_bank_allocation_seen_as_b_s_n(kernel_backend, monkeypatch,
                                                           scales, stacked):
    """One chunk and no FFT rows: the result is a ``[B, S, N]`` view of the
    bank's ``[S, B, N]`` output, not a copy; gradients reach x through it."""
    outs = []
    real = mb.bank_analysis_stacked
    monkeypatch.setattr(mb, "bank_analysis_stacked",
                        lambda *a: outs.append(real(*a)) or outs[-1])
    x = torch.from_numpy(_x((3, 1024), seed=6)).requires_grad_(True)
    c = vt.cwt(x, scales, "morl", boundary="periodic").coeffs
    assert c.shape == (3, len(scales), 1024)
    assert (c.data_ptr() == outs[0].data_ptr()) == stacked
    if stacked:
        assert c.stride() == (1024, 3 * 1024, 1)
    (g,) = torch.autograd.grad(c.pow(2).sum(), x)
    assert g.shape == x.shape and bool(torch.isfinite(g).all())
