"""Port parity: the symmetric kernel tier against vectorwave_tpu's.

On the CPU the port's kernel wrappers run their plain versions; the JAX
symmetric kernel tier runs its Pallas kernels in interpret mode at
``precision='float32'``, as ``tests/test_symmetric_kernel.py`` runs them.
Tolerances, with their reasons:

* port kernel tier against JAX kernel tier, float32: 5e-6 max abs, the JAX
  test's own (both fp32, other summation orders);
* port kernel tier against the JAX jnp cascade, float64: 1e-12 (the same
  arithmetic, another order; values of order 1);
* plain versions against the port's own cascade, float64: 1e-12;
* gradients: 1e-10 against torch autograd through the float64 plain
  cascade; against ``jax.grad`` of the jnp path in float32, 1e-5 (analysis)
  and 2e-6 of the largest gradient (synthesis), the JAX test's limits.

The CUDA kernels run the same windows as :func:`symmetric_plan` describes;
``test_kernel_plan_reproduces_the_definition`` walks those windows in numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from vectorwave_tpu.kernels.modwt_symmetric import (
    fused_symmetric_analysis as jax_sym_analysis,
)
from vectorwave_tpu.kernels.modwt_symmetric import (
    fused_symmetric_synthesis as jax_sym_synthesis,
)
from vectorwave_tpu.kernels.modwt_symmetric import (
    symmetric_synthesis_plane_filters as jax_plane_filters,
)
from vectorwave_tpu.transforms.modwt import _resolve_discrete as jax_wavelet
from vectorwave_tpu_torch import convert
from vectorwave_tpu_torch.errors import InvalidArgumentError
from vectorwave_tpu_torch.kernels import modwt_composite as mc
from vectorwave_tpu_torch.kernels import modwt_symmetric as ms
from vectorwave_tpu_torch.kernels.modwt_fused import _kernel_filters
from vectorwave_tpu_torch.transforms import multilevel

torch.set_num_threads(1)

TOL_KERNEL = 5e-6
TOL_F64 = 1e-12
S = mc.PLAN_STRIDE


def _port_wavelet(name):
    """The port's wavelet; bior2.2 (no biorthogonal family in the port yet)
    is carried across from the JAX package with its four filters."""
    if name.startswith("bior"):
        w = vw.wavelet(name)
        return convert.wavelet_from_arrays(name, w.dec_lo, w.dec_hi, w.rec_lo, w.rec_hi)
    return vt.wavelet(name)


def _planes(res):
    return (*res.details, res.approx)


def _maxdiff(got, want):
    return max(float(np.max(np.abs(np.asarray(g.detach(), np.float64)
                                   - np.asarray(w, np.float64))))
               for g, w in zip(got, want))


def _tensor(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name,levels,b,n", [
    ("db4", 3, 2, 2048), ("sym8", 2, 2, 2048), ("haar", 4, 2, 2048),
    ("bior2.2", 3, 2, 2048), ("sym8", 4, 1, 4096), ("db4", 6, 1, 2048),
])
def test_kernel_tier_matches_jax_kernel_tier(name, levels, b, n):
    x = np.random.default_rng(0).standard_normal((b, n)).astype(np.float32)
    jw, w = jax_wavelet(name), _port_wavelet(name)
    jd, ja = jax_sym_analysis(jnp.asarray(x), jw, levels=levels, interpret=True,
                              precision="float32")
    before = dict(mc.LAUNCHES)
    td, ta = vt.fused_analysis(torch.from_numpy(x), w, levels=levels,
                               boundary="symmetric", precision="float32")
    assert _maxdiff((*td, ta), (*jd, ja)) <= TOL_KERNEL
    ref = vw.modwt_multilevel(jnp.asarray(x), jw, levels=levels, boundary="symmetric",
                              backend="jnp")
    jy = jax_sym_synthesis(ref.details, ref.approx, jw, interpret=True,
                           precision="float32")
    ty = vt.fused_synthesis([_tensor(d) for d in ref.details], _tensor(ref.approx), w,
                            boundary="symmetric", precision="float32")
    assert _maxdiff((ty,), (jy,)) <= TOL_KERNEL
    assert mc.LAUNCHES == before  # CPU tensors run the plain versions


@pytest.mark.parametrize("name,levels,b,n", [
    ("db4", 6, 3, 5000), ("sym8", 4, 2, 4096), ("haar", 4, 2, 1000), ("bior2.2", 3, 2, 3000),
])
def test_public_symmetric_kernel_tier_matches_jax_jnp_float64(name, levels, b, n):
    x = np.random.default_rng(1).standard_normal((b, n))
    jw, w = jax_wavelet(name), _port_wavelet(name)
    want = vw.modwt_multilevel(jnp.asarray(x), jw, levels=levels, boundary="symmetric",
                               backend="jnp")
    got = vt.modwt_multilevel(torch.from_numpy(x), w, levels=levels, boundary="symmetric",
                              backend="kernel")
    assert _maxdiff(_planes(got), _planes(want)) <= TOL_F64
    jy = vw.imodwt_multilevel(want, jw, boundary="symmetric", backend="jnp")
    ty = vt.imodwt_multilevel(
        vt.MultiLevelMODWTResult(tuple(_tensor(d) for d in want.details),
                                 _tensor(want.approx)),
        w, boundary="symmetric", backend="kernel")
    assert _maxdiff((ty,), (jy,)) <= TOL_F64


@pytest.mark.parametrize("name,levels", [("db4", 3), ("sym8", 4), ("bior2.2", 3),
                                         ("haar", 6)])
def test_plane_filters_match_jax(name, levels):
    ours = ms.symmetric_synthesis_plane_filters(_port_wavelet(name), levels)
    ref = jax_plane_filters(jax_wavelet(name), levels)
    assert len(ours) == len(ref) == levels + 1
    for (a, s), (b, t) in zip(ours, ref):
        assert s == t
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-15)
    dense, g, d_max = ms._rebase(ours)
    taps = _port_wavelet(name).filter_length
    assert mc.symmetric_spans(taps, ms.symmetric_level_ops(_port_wavelet(name), levels)) \
        == (g, max(d_max, 0))


@pytest.mark.parametrize("name,levels,n", [
    ("haar", 4, 600), ("db4", 6, 5000), ("sym8", 4, 5000), ("bior2.2", 3, 700),
    ("db2", 5, 1000),
])
def test_plain_symmetric_synthesis_equals_the_cascade(name, levels, n):
    """The composed-filter definition with its head and tail splice equals the
    port's plain per-level symmetric inverse (float64), N not a multiple of
    128; the intermediates of the definition are not clipped to [0, N)."""
    w = _port_wavelet(name)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((3, n)))
    res = vt.modwt_multilevel(x, w, levels=levels, boundary="symmetric", backend="torch")
    want = vt.imodwt_multilevel(res, w, boundary="symmetric", backend="torch")
    filters, ops = _kernel_filters(w, synthesis=True), ms.symmetric_level_ops(w, levels)
    span_l, span_r = mc.symmetric_spans(w.filter_length, ops)
    got = mc.symmetric_synthesis_plain(_planes(res), want[:, :span_l],
                                       want[:, n - span_r:], levels, filters, ops)
    assert float((got - want).abs().max()) <= TOL_F64
    fused = vt.fused_synthesis(res.details, res.approx, w, boundary="symmetric")
    assert float((fused - want).abs().max()) <= TOL_F64


@pytest.mark.parametrize("name,levels", [("db4", 3), ("sym8", 4), ("haar", 5)])
def test_a_wider_splice_window_gives_the_same_values(name, levels):
    w = _port_wavelet(name)
    ops = ms.symmetric_level_ops(w, levels)
    span_l, span_r, w_head, w_tail = ms.synthesis_windows(w.filter_length, ops)
    rng = np.random.default_rng(3)
    planes = [torch.from_numpy(rng.standard_normal((2, 4000))) for _ in range(levels + 1)]
    for extra in (1, 37, 128):
        head = ms._symmetric_inverse([p[:, :w_head] for p in planes], w)[:, :span_l]
        wide = ms._symmetric_inverse([p[:, :w_head + extra] for p in planes], w)[:, :span_l]
        assert float((head - wide).abs().max()) <= TOL_F64
        tail = ms._symmetric_inverse([p[:, -w_tail:] for p in planes], w)[:, w_tail - span_r:]
        wide = ms._symmetric_inverse([p[:, -(w_tail + extra):] for p in planes],
                                     w)[:, w_tail + extra - span_r:]
        assert float((tail - wide).abs().max()) <= TOL_F64


def _walk_plan(planes, head, tail, filters, ops, tile):
    """The CUDA forward kernel's windows, walked in numpy: every block loads
    its plan's windows (zero outside [0, n)) and runs the level ops on them."""
    taps = len(filters[0])
    plan, width = mc.symmetric_plan(taps, ops, tile, False)
    lo, hi = np.array(filters[0]), np.array(filters[1])
    levels = len(ops)
    b, n = planes[0].shape
    span_l, span_r = mc.symmetric_spans(taps, ops)
    k = np.arange(taps)
    out = np.zeros((b, n))

    def window(plane, start, length):
        g = start + np.arange(length)
        inside = (g >= 0) & (g < n)
        vals = np.zeros((b, length))
        vals[:, inside] = plane[:, g[inside]]
        return vals

    for t0 in range(0, n, tile):
        p = plan[S * (levels - 1): S * levels]
        cur = window(planes[levels], t0 + p[0], p[1])
        for j in range(levels, 0, -1):
            length, ed, b_a, st_a, b_d, st_d = plan[S * (j - 1) + 1: S * (j - 1) + 7]
            det = window(planes[j - 1], t0 + ed, length)
            out_len = plan[S * (j - 2) + 1] if j > 1 else tile
            r = np.arange(out_len)[:, None]
            ia, id_ = r + b_a + st_a * k, r + b_d + st_d * k
            assert ia.min() >= 0 and ia.max() < cur.shape[1] <= width
            assert id_.min() >= 0 and id_.max() < length <= width
            cur = (cur[:, ia] * lo).sum(-1) + (det[:, id_] * hi).sum(-1)
        m = min(tile, n - t0)
        out[:, t0:t0 + m] = cur[:, :m]
    out[:, :span_l] = head
    out[:, n - span_r:] = tail
    return out


def _walk_adjoint_plan(c, filters, ops, tile):
    taps = len(filters[0])
    plan, width = mc.symmetric_plan(taps, ops, tile, True)
    lo, hi = np.array(filters[0]), np.array(filters[1])
    levels = len(ops)
    b, n = c.shape
    k = np.arange(taps)
    outs = [np.zeros((b, n)) for _ in range(levels + 1)]
    for t0 in range(0, n, tile):
        g = t0 + plan[0] + np.arange(plan[1])
        inside = (g >= 0) & (g < n)
        cur = np.zeros((b, plan[1]))
        cur[:, inside] = c[:, g[inside]]
        m = min(tile, n - t0)
        for j in range(1, levels + 1):
            b_a, st_a, b_d, st_d = plan[S * (j - 1) + 2: S * (j - 1) + 6]
            q = np.arange(m)[:, None]
            id_ = q + b_d + st_d * k
            assert id_.min() >= 0 and id_.max() < cur.shape[1] <= width
            outs[j - 1][:, t0:t0 + m] = (cur[:, id_] * hi).sum(-1)
            out_len = plan[S * j + 1] if j < levels else tile
            ia = np.arange(out_len)[:, None] + b_a + st_a * k
            assert ia.min() >= 0 and ia.max() < cur.shape[1]
            cur = (cur[:, ia] * lo).sum(-1)
        outs[levels][:, t0:t0 + m] = cur[:, :m]
    return outs


@pytest.mark.parametrize("name,levels,n,tile", [
    ("haar", 4, 300, 128), ("db4", 3, 700, 256), ("sym8", 2, 900, 256),
    ("bior2.2", 3, 513, 128), ("db4", 6, 1500, 512),
])
def test_kernel_plan_reproduces_the_definition(name, levels, n, tile):
    w = _port_wavelet(name)
    filters, ops = _kernel_filters(w, synthesis=True), ms.symmetric_level_ops(w, levels)
    span_l, span_r = mc.symmetric_spans(w.filter_length, ops)
    rng = np.random.default_rng(4)
    planes = [rng.standard_normal((2, n)) for _ in range(levels + 1)]
    head, tail = rng.standard_normal((2, span_l)), rng.standard_normal((2, span_r))
    want = mc.symmetric_synthesis_plain([torch.from_numpy(p) for p in planes],
                                        torch.from_numpy(head), torch.from_numpy(tail),
                                        levels, filters, ops)
    got = _walk_plan(planes, head, tail, filters, ops, tile)
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=TOL_F64)
    c = rng.standard_normal((2, n))
    want = mc.symmetric_adjoint_plain(torch.from_numpy(c), levels, filters, ops)
    for g, wt in zip(_walk_adjoint_plan(c, filters, ops, tile), want):
        np.testing.assert_allclose(g, wt.numpy(), rtol=0, atol=TOL_F64)


@pytest.mark.parametrize("name,levels", [("db4", 6), ("sym8", 4), ("bior2.2", 3)])
def test_adjoint_is_the_transpose_of_the_body(name, levels):
    """<S p, y> == <p, S^T y> for y zero on the spliced outputs."""
    w = _port_wavelet(name)
    filters, ops = _kernel_filters(w, synthesis=True), ms.symmetric_level_ops(w, levels)
    span_l, span_r = mc.symmetric_spans(w.filter_length, ops)
    n = 3000
    rng = np.random.default_rng(5)
    planes = [torch.from_numpy(rng.standard_normal((2, n))) for _ in range(levels + 1)]
    y = torch.from_numpy(rng.standard_normal((2, n)))
    y[:, :span_l] = 0
    y[:, n - span_r:] = 0
    s = mc.symmetric_synthesis_plain(planes, torch.zeros(2, span_l, dtype=torch.float64),
                                     torch.zeros(2, span_r, dtype=torch.float64),
                                     levels, filters, ops)
    st = mc.symmetric_adjoint_plain(y, levels, filters, ops)
    lhs = float((s * y).sum())
    rhs = float(sum((p * g).sum() for p, g in zip(planes, st)))
    assert abs(lhs - rhs) <= TOL_F64 * max(1.0, abs(lhs))


def test_analysis_head_splice_plain_version():
    w = vt.wavelet("db4")
    filters = _kernel_filters(w, synthesis=False)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 1000)))
    head = torch.from_numpy(np.random.default_rng(7).standard_normal((4, 2, 37)))
    planes = mc.analysis(x, 3, filters, False, head)
    body = mc.analysis(x, 3, filters, False)
    for p, b, h in zip(planes, body, head):
        assert torch.equal(p[:, :37], h) and torch.equal(p[:, 37:], b[:, 37:])


@pytest.mark.parametrize("name,levels", [("db4", 3), ("sym8", 4), ("bior2.2", 3)])
def test_symmetric_gradients_match_plain_autograd(name, levels):
    w = _port_wavelet(name)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((2, 1500)))
    wts = [torch.from_numpy(rng.standard_normal((2, 1500))) for _ in range(levels + 1)]
    grads = []
    for backend in ("kernel", "torch"):
        xg = x.clone().requires_grad_(True)
        r = vt.modwt_multilevel(xg, w, levels=levels, boundary="symmetric", backend=backend)
        loss = sum((p * q).sum() for p, q in zip(_planes(r), wts))
        grads.append(torch.autograd.grad(loss, xg)[0])
    assert float((grads[0] - grads[1]).abs().max()) <= 1e-10
    planes = [torch.from_numpy(rng.standard_normal((2, 1500))) for _ in range(levels + 1)]
    grads = []
    for backend in ("kernel", "torch"):
        ps = [p.clone().requires_grad_(True) for p in planes]
        y = vt.imodwt_multilevel(vt.MultiLevelMODWTResult(tuple(ps[:-1]), ps[-1]), w,
                                 boundary="symmetric", backend=backend)
        grads.append(torch.autograd.grad((y * wts[0]).sum(), ps))
    assert max(float((a - b).abs().max()) for a, b in zip(*grads)) <= 1e-10


def test_symmetric_gradients_match_jax_grad():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 2048)).astype(np.float32)

    def jloss(y):
        r = vw.modwt_multilevel(y, "db4", levels=3, boundary="symmetric", backend="jnp")
        return sum(jnp.sum(p**2) for p in r.details) + 0.5 * jnp.sum(r.approx**2)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    d, a = vt.fused_analysis(xt, "db4", levels=3, boundary="symmetric")
    loss = sum((p**2).sum() for p in d) + 0.5 * (a**2).sum()
    (got,) = torch.autograd.grad(loss, xt)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)

    res = vw.modwt_multilevel(jnp.asarray(x), "db4", levels=3, boundary="symmetric",
                              backend="jnp")
    weights = np.arange(x.shape[-1], dtype=np.float32)

    def sloss(ds, a):
        xr = vw.imodwt_multilevel(vw.MultiLevelMODWTResult(ds, a), "db4",
                                  boundary="symmetric", backend="jnp")
        return jnp.sum(xr**2 * weights)

    gj = jax.grad(sloss, argnums=(0, 1))(res.details, res.approx)
    ps = [_tensor(p).requires_grad_(True) for p in _planes(res)]
    xr = vt.fused_synthesis(ps[:-1], ps[-1], "db4", boundary="symmetric")
    gk = torch.autograd.grad((xr**2 * torch.from_numpy(weights)).sum(), ps)
    scale = max(float(jnp.max(jnp.abs(b))) for b in (*gj[0], gj[1]))
    for a, b in zip(gk, (*gj[0], gj[1])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-6 * scale)


def test_symmetric_synthesis_gradient_matches_jax_kernel_tier():
    """The gradient with respect to the planes of the port's kernel-tier
    symmetric synthesis (its backward, the adjoint with the interior spans,
    here the plain version) against ``jax.grad`` of the JAX kernel tier, whose
    backward reaches ``_symsyn_adjoint_kernel`` (interpret mode, float32),
    within 2e-6 of the largest gradient entry, the JAX test's bound."""
    jw, w = jax_wavelet("db4"), _port_wavelet("db4")
    rng = np.random.default_rng(9)
    x = rng.standard_normal((1, 2048)).astype(np.float32)
    res = vw.modwt_multilevel(jnp.asarray(x), jw, levels=3, boundary="symmetric",
                              backend="jnp")
    weights = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(ds, a):
        y = jax_sym_synthesis(ds, a, jw, interpret=True, precision="float32")
        return jnp.sum(y * weights)

    gj = jax.grad(jloss, argnums=(0, 1))(res.details, res.approx)
    ps = [_tensor(p).requires_grad_(True) for p in _planes(res)]
    y = vt.fused_synthesis(ps[:-1], ps[-1], w, boundary="symmetric", precision="float32")
    gk = torch.autograd.grad((y * torch.from_numpy(weights)).sum(), ps)
    want = (*gj[0], gj[1])
    scale = max(float(jnp.max(jnp.abs(b))) for b in want)
    for a, b in zip(gk, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-6 * scale)


def test_route_gates_both_sides():
    w = vt.wavelet("db4")
    reach = mc.mirror_reach(w.filter_length, 6)  # the analysis kernel's mirror
    assert ms.route_fits(w, 6, reach, synthesis=False)
    assert not ms.route_fits(w, 6, reach - 1, synthesis=False)
    ops = ms.symmetric_level_ops(w, 6)
    _, _, w_head, w_tail = ms.synthesis_windows(w.filter_length, ops)
    assert ms.route_fits(w, 6, w_head + w_tail, synthesis=True)
    assert not ms.route_fits(w, 6, w_head + w_tail - 1, synthesis=True)
    # shared memory: db36 J=8 fits at a smaller tile, db38 J=9 at none
    long = vt.wavelet("db36")
    ops = ms.symmetric_level_ops(long, 8)
    assert mc.symmetric_tile(long.filter_length, ops, False) == 1024
    assert ms.route_fits(long, 8, 1 << 17, synthesis=True)
    longer = vt.wavelet("db38")
    ops = ms.symmetric_level_ops(longer, 9)
    assert mc.symmetric_tile(longer.filter_length, ops, False) is None
    assert not ms.route_fits(longer, 9, 1 << 18, synthesis=True)
    assert not ms.route_fits(longer, 9, 1 << 18, synthesis=False)
    assert not ms.analysis_fits(longer.filter_length, 9)


def test_router_admits_symmetric_boundaries(monkeypatch):
    w = vt.wavelet("db4")
    x = torch.zeros(2, 8192)
    assert not multilevel._kernel_eligible(x, w, 6, "symmetric")  # a CPU tensor
    try:
        vt.set_backend("kernel")  # the gates alone, whatever the device
        assert multilevel._kernel_eligible(x, w, 6, "symmetric")
        # the synthesis kernel wants a call of SYMMETRIC_SYNTHESIS_MIN_SAMPLES
        rows = multilevel.SYMMETRIC_SYNTHESIS_MIN_SAMPLES // x.shape[-1]
        assert multilevel._kernel_eligible(x[:1].expand(rows, -1), w, 6, "symmetric",
                                           synthesis=True)
        assert not multilevel._kernel_eligible(x, w, 6, "symmetric", synthesis=True)
        assert not multilevel._kernel_eligible(
            torch.zeros(2, multilevel.KERNEL_MIN_N - 1), w, 6, "symmetric")
        assert not multilevel._kernel_eligible(torch.zeros(2, 1 << 18), vt.wavelet("db38"),
                                               9, "symmetric", synthesis=True)
        assert not multilevel._kernel_eligible(x.double(), w, 6, "symmetric")
    finally:
        vt.set_backend("auto")


def test_kernel_backend_too_long_filter_raises_in_both_directions():
    # the card's gates hold off the CPU only (a meta tensor stands for a CUDA one)
    planes = [torch.zeros(2, 20000, device="meta") for _ in range(10)]
    res = vt.MultiLevelMODWTResult(tuple(planes[:-1]), planes[-1])
    with pytest.raises(InvalidArgumentError, match="symmetric kernel tier"):
        vt.imodwt_multilevel(res, "db38", boundary="symmetric", backend="kernel")
    with pytest.raises(InvalidArgumentError, match="symmetric kernel tier"):
        vt.fused_analysis(planes[0], "db38", levels=9, boundary="symmetric")


def test_wrappers_raise_on_a_device_they_cannot_serve():
    w = vt.wavelet("db4")
    filters, ops = _kernel_filters(w, synthesis=True), ms.symmetric_level_ops(w, 2)
    x = torch.empty(2, 64, device="meta")
    with pytest.raises(InvalidArgumentError, match="CUDA tensor"):
        mc.symmetric_synthesis((x, x, x), x, x, 2, filters, ops)
    with pytest.raises(InvalidArgumentError, match="CUDA tensor"):
        mc.symmetric_adjoint(x, 2, filters, ops)
    with pytest.raises(InvalidArgumentError, match="CUDA tensor"):
        mc.analysis(x, 2, filters, False, torch.empty(3, 2, 8, device="meta"))


def test_symmetric_denoise_takes_the_three_call_path_and_matches_jax():
    rng = np.random.default_rng(9)
    x = np.sin(np.arange(4096) / 20.0)[None] + 0.4 * rng.standard_normal((2, 4096))
    from vectorwave_tpu_torch.denoise import denoiser

    assert denoiser._try_fused_denoise(torch.from_numpy(x), "db4", 4, "universal", "soft",
                                       "symmetric") is None
    got = vt.denoise_multilevel(torch.from_numpy(x), "db4", levels=4, boundary="symmetric")
    want = vw.denoise_multilevel(jnp.asarray(x), "db4", levels=4, boundary="symmetric")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-10)


def test_convert_helpers_default_to_the_card():
    th = np.zeros((2, 3), np.float32)
    a = np.zeros((2, 8), np.float32)
    if torch.cuda.is_available():
        assert convert.thresholds_from_numpy(th).device.type == "cuda"
        assert convert.exact_result_from_arrays([a], a, [a], a).approx.device.type == "cuda"
        return
    with pytest.raises(InvalidArgumentError, match="no CUDA device"):
        convert.thresholds_from_numpy(th)
    with pytest.raises(InvalidArgumentError, match="no CUDA device"):
        convert.exact_result_from_arrays([a], a, [a], a)
    assert convert.thresholds_from_numpy(th, device="cpu").device.type == "cpu"
