"""Port parity: the per-level cascade pair against vectorwave_tpu's.

The same seeded numpy inputs go through the JAX package's
``run_analysis_mxu`` / ``run_synthesis_mxu`` (their Pallas kernels in
interpret mode) and through the port's wrappers of the same names, which on
the CPU run their plain versions.  Tolerances, with their reasons:

* ``float32`` and ``bf16``: 2e-6 max abs.  Both sides compute in fp32 in
  other summation orders (on the CPU the JAX ``bf16`` dot does not round);
  values of order 1.
* ``bf16_3x``: 2e-4 max abs.  The JAX tier splits each operand into two
  bf16 words and drops the lo*lo product (it strays about 5e-5 from float32
  here); the port runs fp32.
* bfloat16 input: one bfloat16 ulp of the largest output, 2^-7 of it.  The
  JAX kernel rounds each level's approximation to bfloat16; the port keeps
  it in fp32 and rounds the stored planes.
* The mirror mode (``symmetric=True``) against the jnp symmetric cascade in
  float64: 1e-12 (the same arithmetic in another order), short signals
  included.  Below N = (L-1) 2^(J-1) the JAX kernel reads its zero padding
  where the cascade reflects again; the port matches the cascade there (on
  the card its kernel route refuses), never the JAX kernel.

The CUDA kernel's mirror mode runs the windows that :func:`_walk_mirror`
walks in numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu_torch as vt
from vectorwave_tpu.kernels.modwt_mxu import run_analysis_mxu as jax_analysis
from vectorwave_tpu.kernels.modwt_mxu import run_synthesis_mxu as jax_synthesis
from vectorwave_tpu.kernels.modwt_symmetric import _jnp_symmetric_cascade_filters
from vectorwave_tpu_torch.errors import InvalidArgumentError
from vectorwave_tpu_torch.kernels import modwt_cascade as mx
from vectorwave_tpu_torch.kernels import modwt_composite as mc
from vectorwave_tpu_torch.kernels import modwt_symmetric as ms
from vectorwave_tpu_torch.kernels.modwt_fused import _kernel_filters

torch.set_num_threads(1)

TOL = {"float32": 2e-6, "bf16": 2e-6, "bf16_3x": 2e-4}
TOL_F64 = 1e-12
BF16_ULP = 2.0**-7


def _filters(name):
    w = vt.wavelet(name)
    return _kernel_filters(w, synthesis=False), _kernel_filters(w, synthesis=True)


def _signal(b, n, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((b, n)).astype(dtype)


def _maxdiff(got, want):
    return max(float(np.max(np.abs(np.asarray(g.detach().double(), np.float64)
                                   - np.asarray(w, np.float64))))
               for g, w in zip(got, want))


# (wavelet, levels, batch, n, periodic, symmetric, precision)
CASES = [
    ("db4", 3, 2, 1100, True, False, "float32"),
    ("db4", 6, 2, 8192, True, False, "float32"),
    ("sym8", 4, 2, 1100, False, False, "float32"),
    ("haar", 5, 2, 300, True, False, "bf16"),
    ("db4", 2, 3, 130, False, False, "float32"),
    ("db4", 5, 2, 130, True, False, "float32"),  # n shorter than the span (217)
    ("sym8", 3, 2, 300, True, True, "float32"),  # symmetric wins over periodic
    ("db4", 6, 2, 1100, False, True, "float32"),
    ("haar", 6, 2, 300, False, True, "bf16"),
    ("db4", 6, 2, 8192, True, False, "bf16_3x"),
    ("sym8", 2, 2, 8192, False, True, "bf16_3x"),
]


@pytest.mark.parametrize("name,levels,b,n,periodic,symmetric,precision", CASES)
def test_pair_matches_the_jax_pair(name, levels, b, n, periodic, symmetric, precision):
    fd, fr = _filters(name)
    x = _signal(b, n)
    want = jax_analysis(jnp.asarray(x), levels, fd, periodic, 2048, precision, True,
                        symmetric=symmetric)
    before = dict(mc.LAUNCHES)
    got = mx.run_analysis_mxu(torch.from_numpy(x), levels, fd, periodic, 2048, precision,
                              True, symmetric=symmetric)
    assert len(got) == levels + 1 and all(g.shape == (b, n) for g in got)
    assert _maxdiff(got, want) <= TOL[precision]
    planes = [np.array(p) for p in want]
    y_want = jax_synthesis(tuple(jnp.asarray(p) for p in planes), levels, fr, periodic,
                           2048, precision, True)
    y_got = mx.run_synthesis_mxu([torch.from_numpy(p) for p in planes], levels, fr,
                                 periodic, 2048, precision, True)
    assert _maxdiff((y_got,), (y_want,)) <= TOL[precision]
    if periodic and not symmetric:  # the periodic pair is an orthogonal round trip
        assert float((y_got - torch.from_numpy(x)).abs().max()) <= 10 * TOL[precision]
    assert mc.LAUNCHES == before  # CPU tensors run the plain versions


def test_bfloat16_input_matches_the_jax_pair_within_one_ulp():
    fd, fr = _filters("db4")
    x = _signal(2, 1100, seed=1)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    want = jax_analysis(xj, 3, fd, True, 2048, "float32", True)
    got = mx.run_analysis_mxu(xt, 3, fd, True, 2048, "float32", True)
    assert all(g.dtype == torch.bfloat16 for g in got)
    scale = max(float(jnp.max(jnp.abs(w.astype(jnp.float32)))) for w in want)
    assert _maxdiff(got, [w.astype(jnp.float32) for w in want]) <= BF16_ULP * scale
    y_want = jax_synthesis(want, 3, fr, True, 2048, "float32", True).astype(jnp.float32)
    y_got = mx.run_synthesis_mxu(got, 3, fr, True, 2048, "float32", True)
    assert y_got.dtype == torch.bfloat16
    scale = float(jnp.max(jnp.abs(y_want)))
    assert _maxdiff((y_got,), (y_want,)) <= BF16_ULP * scale


# (wavelet, levels, n): the last three are shorter than (L-1) 2^(J-1)
MIRROR_CASES = [("db4", 6, 1100), ("sym8", 4, 300), ("haar", 5, 40), ("sym8", 3, 120),
                ("db4", 6, 150), ("sym8", 4, 100), ("db4", 3, 20)]


@pytest.mark.parametrize("name,levels,n", MIRROR_CASES)
def test_mirror_matches_the_jnp_symmetric_cascade_in_float64(name, levels, n):
    fd, _ = _filters(name)
    x = np.random.default_rng(2).standard_normal((3, n))
    details, approx = _jnp_symmetric_cascade_filters(jnp.asarray(x), np.array(fd[0]),
                                                     np.array(fd[1]), levels)
    want = (*details, approx)
    for periodic in (False, True):
        got = mx.run_analysis_mxu(torch.from_numpy(x), levels, fd, periodic, 2048,
                                  "float32", True, symmetric=True)
        assert all(g.dtype == torch.float64 for g in got)
        assert _maxdiff(got, want) <= TOL_F64
    reach = mc.mirror_reach(len(fd[0]), levels)
    # the card's kernel route takes N >= reach; on the CPU the public
    # symmetric analysis runs the plain cascade at any N
    assert ms.route_fits(vt.wavelet(name), levels, n, synthesis=False) == (n >= reach)
    details, approx = vt.fused_analysis(torch.from_numpy(x), name, levels=levels,
                                        boundary="symmetric")
    assert _maxdiff((*details, approx), want) <= TOL_F64


@pytest.mark.parametrize("name,levels,n,stray", [
    ("db4", 6, 150, 0.05), ("sym8", 4, 100, 0.005), ("db4", 6, 223, 1e-3),
    ("db4", 6, 224, None),  # N = (L-1) 2^(J-1): the JAX kernel is right again
])
def test_the_port_does_not_copy_the_jax_kernels_short_signal_mirror(name, levels, n,
                                                                    stray):
    """Below (L-1) 2^(J-1) the JAX kernel's single reflection reads zero
    padding (on these inputs it strays 0.133, 0.012 and 1.5e-3 from the
    cascade); the port follows the cascade."""
    fd, _ = _filters(name)
    x = _signal(2, n, seed=3)
    jax_kernel = jax_analysis(jnp.asarray(x), levels, fd, False, 2048, "float32", True,
                              symmetric=True)
    details, approx = _jnp_symmetric_cascade_filters(jnp.asarray(x), np.array(fd[0]),
                                                     np.array(fd[1]), levels)
    got = mx.run_analysis_mxu(torch.from_numpy(x), levels, fd, False, 2048, "float32",
                              True, symmetric=True)
    assert _maxdiff(got, (*details, approx)) <= TOL["float32"]
    if stray is None:
        assert _maxdiff(got, jax_kernel) <= TOL["float32"]
    else:
        assert _maxdiff(got, jax_kernel) >= stray


def _walk_mirror(x, filters, levels, tile):
    """The CUDA analysis kernel's mirror mode, walked in numpy block by
    block: the window [t0 - S, t0 + tile) loads x reflected at the start,
    each level j >= 2 first reflects its input over [-(L-1) 2^(j-1), 0) of
    the window, and the level runs from the first window index where its
    input is exact.  Every window sample before the signal start that the
    reflection does not rewrite is poisoned with NaN, so a read of one that
    reached a stored output would show, and so is every sample at or past
    n (the kernel loads zeros there; no stored output may read them).
    Returns the planes and the t0 of each block whose window starts before
    0."""
    lo, hi = np.array(filters[0]), np.array(filters[1])
    taps = len(lo)
    b, n = x.shape
    span = mc.composite_halo_samples(taps, levels)
    width = tile + span
    assert tile >= mc.mirror_reach(taps, levels) and n >= mc.mirror_reach(taps, levels)
    outs = [np.full((b, n), np.nan) for _ in range(levels + 1)]
    early = []
    k = np.arange(taps)
    for t0 in range(0, n, tile):
        before = max(span - t0, 0)
        if before:
            early.append(t0)
        g = t0 - span + np.arange(width)
        src = np.where(g < 0, -1 - g, g)
        cur = np.full((b, width), np.nan)
        inside = src < n
        cur[:, inside] = x[:, src[inside]]
        cur[:, : max(before - (taps - 1), 0)] = np.nan
        valid, m = 0, min(tile, n - t0)
        for j in range(1, levels + 1):
            s = 1 << (j - 1)
            if j > 1 and before:
                cur[:, :before] = np.nan
                q = np.arange(max(before - (taps - 1) * s, 0), before)
                assert (2 * before - 1 - q).max() < width
                cur[:, q] = cur[:, 2 * before - 1 - q]
            first = valid + (taps - 1) * s
            idx = np.arange(first, width)[:, None] - s * k
            assert idx.min() >= valid
            win = cur[:, idx]
            nxt = np.full((b, width), np.nan)
            nxt[:, first:] = win @ lo
            outs[j - 1][:, t0 : t0 + m] = (win @ hi)[:, span - first : span - first + m]
            cur, valid = nxt, first
        outs[levels][:, t0 : t0 + m] = cur[:, span : span + m]
    return outs, early


@pytest.mark.parametrize("name,levels,n", [
    ("db4", 6, 1100),  # block 0 alone, at the mirror tile (2048); S = 441
    ("db4", 6, 300),  # reach 224 <= N < S: block 0's window outlasts the signal
    ("sym8", 4, 150),  # reach 120 <= N < S = 225
    ("sym8", 4, 700),
    ("haar", 5, 40),
    ("db36", 8, 20000),  # the mirror tile (L-1) 2^7 = 9088 < S: t0 = 0, 9088
])
def test_mirror_window_plan_reproduces_the_cascade(name, levels, n):
    fd, _ = _filters(name)
    taps = len(fd[0])
    tile = mc.analysis_tile(taps, levels, mirror=True)
    x = np.random.default_rng(4).standard_normal((2, n))
    got, early = _walk_mirror(x, fd, levels, tile)
    span = mc.composite_halo_samples(taps, levels)
    assert early == list(range(0, min(span, n), tile))
    want = ms._symmetric_cascade(torch.from_numpy(x), fd, levels)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=TOL_F64)


def test_mirror_tile_rule():
    """The mirror tile holds (L-1) 2^(J-1) samples and fits one block."""
    assert mc.analysis_tile(8, 6, mirror=True) == mc.ANALYSIS_TILE  # db4: reach 224
    assert mc.analysis_tile(72, 8, mirror=True) == 71 * 128  # db36 J=8
    assert mc.analysis_tile(72, 8) == mc.ANALYSIS_TILE
    assert mc.analysis_shared_bytes(72, 8, 71 * 128) <= mc.SHARED_LIMIT
    assert mc.analysis_tile(76, 9, mirror=True) is None  # db38 J=9
    assert not ms.analysis_fits(76, 9) and ms.analysis_fits(72, 8)


def test_unknown_precision_raises_a_value_error_on_both_sides():
    fd, _ = _filters("db4")
    x = _signal(1, 256)
    with pytest.raises(ValueError, match="precision"):
        jax_analysis(jnp.asarray(x), 2, fd, True, 2048, "tf32", True)
    with pytest.raises(ValueError, match="precision"):
        mx.run_analysis_mxu(torch.from_numpy(x), 2, fd, True, 2048, "tf32", True)
    with pytest.raises(InvalidArgumentError, match="precision"):
        mx.run_synthesis_mxu([torch.from_numpy(x)] * 3, 2, fd, True, 2048, None, True)


def _graph_nodes(t):
    names, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is not None and type(fn).__name__ not in names:
            names.add(type(fn).__name__)
            todo += [f for f, _ in fn.next_functions]
    return names


def test_symmetric_requires_grad_routing_on_the_cpu():
    """On the CPU the pair's plain path differentiates (the JAX pair has no
    VJP; a CUDA input that requires grad raises, tests/test_torch_cuda.py);
    the public symmetric analysis routes its gradient through the mirror
    route's autograd Function and equals autograd of the plain cascade."""
    fd, _ = _filters("db4")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 1500)))
    wts = [torch.from_numpy(np.random.default_rng(6 + j).standard_normal((2, 1500)))
           for j in range(4)]
    xg = x.clone().requires_grad_(True)
    planes = mx.run_analysis_mxu(xg, 3, fd, False, 2048, "float32", True, symmetric=True)
    (g_pair,) = torch.autograd.grad(sum((p * w).sum() for p, w in zip(planes, wts)), xg)
    xg = x.clone().requires_grad_(True)
    d, a = vt.fused_analysis(xg, "db4", levels=3, boundary="symmetric")
    assert "_SymmetricAnalysisBackward" in _graph_nodes(a)
    (g_route,) = torch.autograd.grad(sum((p * w).sum() for p, w in zip((*d, a), wts)), xg)
    xg = x.clone().requires_grad_(True)
    ref = ms._symmetric_cascade(xg, fd, 3)
    (g_ref,) = torch.autograd.grad(sum((p * w).sum() for p, w in zip(ref, wts)), xg)
    assert float((g_pair - g_ref).abs().max()) <= TOL_F64
    assert float((g_route - g_ref).abs().max()) <= TOL_F64
