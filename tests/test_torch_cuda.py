"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips when ``torch.cuda.is_available()`` is false.
This file imports neither JAX nor vectorwave_tpu, so on a machine without
JAX it runs with the repository's conftest left out:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: float32 kernel against float32 plain version 2e-5 max abs (the
same fp32 arithmetic in another summation order, values of order 1);
bfloat16 one bfloat16 ulp of the largest output (both round the same fp32
values to bfloat16); the exact fp64 kernels against their fp64 plain
versions 1e-13 on hi + lo (the same fp64 arithmetic, which differs only in
fused multiply-adds); the symmetric pair against its plain versions, which
sum in float64, 2e-5 in float32 and one bfloat16 ulp in bfloat16; the
cascade pair in each edge mode (the mirror's plain version is the plain
symmetric cascade) as the analysis and synthesis kernels; the 2-D
kernels against their plain versions 2e-5; the fused denoise's threshold
gradient, a sum over 8192 samples, 1e-3 of its largest value; the
filter-bank pair against its plain versions 2e-5 (the synthesis, a sum over
P planes, P times that), and the packet and dual-tree routes against the
plain route 2e-5 and 3e-5; the analysis kernel's external edge and the
denoise kernel's stream mode against their plain versions 2e-5 (one
bfloat16 ulp in bfloat16), the streaming tier's block outputs against the
whole-signal plain cascade 2e-5, and the multiblock denoise against its
single steps bit for bit; the CWT's kernel-direct tier (the bank kernels on
dense taps) against the bank's plain version, the FFT path and the float64
periodic correlation 2e-5 of the largest coefficient, the JAX package's
bound for its tier.
"""

import pytest
import torch

import vectorwave_tpu_torch as vt
from chip_smoke import gap_thresholds
from tools import mirror_cases
from vectorwave_tpu_torch.errors import InvalidArgumentError
from vectorwave_tpu_torch.kernels import modwt2 as k2
from vectorwave_tpu_torch.kernels import modwt_cascade as mx
from vectorwave_tpu_torch.kernels import modwt_composite as mc
from vectorwave_tpu_torch.kernels import modwt_symmetric as ms
from vectorwave_tpu_torch.kernels.modwt_fused import _kernel_filters

pytestmark = pytest.mark.cuda

LEVELS = 6
TOL_F32 = 2e-5
#: (batch, n, periodic): a row of whole 16-byte pieces, a ragged last tile,
#: a periodic row shorter than the span, and rows not a multiple of 4 long
#: (each row after the first starts off 16 bytes)
SHAPES = [(4, 8192, True), (3, 5000, False), (2, 300, True), (3, 5001, True),
          (3, 5001, False)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def filters():
    w = vt.wavelet("db4")
    return _kernel_filters(w, synthesis=False), _kernel_filters(w, synthesis=True)


def _tol(dtype, want):
    if dtype == torch.float32:
        return TOL_F32
    return 2.0**-7 * max(float(p.float().abs().max()) for p in want)


def _err(got, want):
    return max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))


def _input(cuda, b, n, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn(b, n, device=cuda, generator=g).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,periodic", SHAPES)
def test_analysis_and_synthesis_kernels_match_plain(cuda, filters, b, n, periodic, dtype):
    fd, fr = filters
    x = _input(cuda, b, n, dtype)
    want = mc.analysis_plain(x, LEVELS, fd, periodic)
    got = mc.analysis(x, LEVELS, fd, periodic)
    torch.cuda.synchronize()
    assert all(g.dtype == dtype and g.shape == x.shape for g in got)
    assert _err(got, want) <= _tol(dtype, want)
    y_want = mc.synthesis_plain(want, LEVELS, fr, periodic)
    y_got = mc.synthesis(want, LEVELS, fr, periodic)
    torch.cuda.synchronize()
    assert _err((y_got,), (y_want,)) <= _tol(dtype, (y_want,))


#: (wavelet, levels, batch, n, periodic, stream halo or None): db4 J=6 at
#: SHAPES; haar at J = 1 and 10 (its deepest), db4 at J = 1 and 9 (its
#: deepest), sym8 J=4, db20 J=7 (its deepest); rows shorter than the span
#: (db4 J=6 at 300, haar J=10 at 700); the stream mode with halos shorter
#: than, equal to and longer than the span
DENOISE_CASES = [("db4", LEVELS, b, n, periodic, None) for b, n, periodic in SHAPES] + [
    ("haar", 1, 3, 5001, True, None), ("haar", 10, 2, 3001, False, None),
    ("haar", 10, 2, 700, True, None), ("db4", 1, 2, 1000, False, None),
    ("db4", 9, 2, 9003, True, None), ("sym8", 4, 3, 5000, True, None),
    ("db20", 7, 2, 9000, True, None), ("db4", LEVELS, 3, 5001, False, 100),
    ("db4", LEVELS, 2, 300, False, 441), ("sym8", 4, 2, 3000, False, 700),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["none", "soft", "hard"])
@pytest.mark.parametrize("name,levels,b,n,periodic,h", DENOISE_CASES)
def test_denoise_kernel_matches_plain(cuda, name, levels, b, n, periodic, h, mode, dtype):
    w = vt.wavelet(name)
    fd, fr = _kernel_filters(w, synthesis=False), _kernel_filters(w, synthesis=True)
    x = _input(cuda, b, n, dtype, seed=1)
    halo = None if h is None else _input(cuda, b, h, dtype, seed=3)
    planes = (mc._analysis_cascade(x, levels, fd, periodic) if halo is None
              else mc._external_cascade(x, halo, levels, fd))
    th = gap_thresholds(planes, levels)
    got = mc.denoise(x, th, levels, fd, fr, periodic, mode, halo=halo)
    want = mc.denoise_plain(x, th, levels, fd, fr, periodic, mode, halo=halo)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    assert _err((got,), (want,)) <= _tol(dtype, (want,))


def test_public_entry_points_launch_the_kernels(cuda):
    x = _input(cuda, 4, 8192, torch.float32, seed=2)
    mc.reset_launches()
    res = vt.modwt_multilevel(x, "db4", levels=LEVELS)
    y = vt.imodwt_multilevel(res, "db4")
    z = vt.modwt_roundtrip_fused(x, "db4", levels=LEVELS)
    d = vt.denoise_multilevel(x, "db4", levels=LEVELS)
    torch.cuda.synchronize()
    assert {k: v for k, v in mc.LAUNCHES.items() if v} == {
        "modwt_analysis": 1, "modwt_synthesis": 1, "modwt_denoise": 2}
    assert float((y - x).abs().max()) < 3e-6
    assert float((z - x).abs().max()) < 3e-6
    assert d.shape == x.shape and bool(torch.isfinite(d).all())


@pytest.mark.parametrize("inference_first", [True, False])
def test_fft_route_spectra_serve_inference_and_autograd(cuda, inference_first):
    """The plain periodic route of a CUDA tensor takes the FFT from 8 taps
    and 256 samples; its spectra, kept on the card, are built with inference
    mode off, so a gradient after an inference-mode call (and before one)
    equals the CPU's float64 gradient within 2e-5."""
    from vectorwave_tpu_torch.ops import convolve

    convolve._SPECTRA.clear()
    convolve._TAPS.clear()
    x0 = _input(cuda, 2, 1024, torch.float32, seed=5)
    w = torch.randn(3, 2, 1024, generator=torch.Generator().manual_seed(6), dtype=torch.float64)

    def grad(x):
        x = x.detach().requires_grad_(True)
        res = vt.modwt_multilevel(x, "db4", levels=2, backend="torch")
        (torch.stack([*res.details, res.approx]).double() * w.to(x.device)).sum().backward()
        return x.grad

    def inferred():
        with torch.inference_mode():
            vt.modwt_multilevel(x0, "db4", levels=2, backend="torch")

    if inference_first:
        inferred()
    got = grad(x0)
    if not inference_first:
        inferred()
        assert torch.equal(grad(x0), got)
    want = grad(x0.cpu().double())
    assert all(not s.is_inference() for s in convolve._SPECTRA.values())
    assert float((got.cpu().double() - want).abs().max()) <= TOL_F32


def test_short_signals_and_float64_stay_on_the_plain_path(cuda):
    """db4 J=6's halo, 441 samples, rounded up to 128, is longer than 511."""
    mc.reset_launches()
    vt.modwt_multilevel(_input(cuda, 2, 511, torch.float32), "db4", levels=6)
    vt.modwt_multilevel(_input(cuda, 2, 8192, torch.float64), "db4", levels=6)
    assert mc.LAUNCHES["modwt_analysis"] == 0


def test_wrappers_reject_what_the_kernels_do_not_take(cuda, filters):
    fd, _ = filters
    with pytest.raises(InvalidArgumentError, match="float32 or bfloat16"):
        mc.analysis(_input(cuda, 2, 512, torch.float64), 3, fd, True)
    with pytest.raises(InvalidArgumentError, match="contiguous"):
        mc.analysis(_input(cuda, 512, 2, torch.float32).t(), 3, fd, True)
    with pytest.raises(InvalidArgumentError, match="levels"):
        mc.analysis(_input(cuda, 2, 512, torch.float32), 11, fd, True)
    with pytest.raises(InvalidArgumentError):
        mc.analysis(_input(cuda, 2, 1 << 20, torch.float32), 10,
                    _kernel_filters(vt.wavelet("db38"), False), True)


@pytest.mark.parametrize("mode", ["soft", "hard", "none"])
def test_fused_denoise_gradient_matches_plain_autograd(cuda, filters, mode):
    """The fused denoise's backward on the card (two analysis launches and
    one synthesis launch, one each for the round trip) against native
    autograd of its plain version, in x and in the thresholds."""
    fd, fr = filters
    x = _input(cuda, 3, 8192, torch.float32, seed=4)
    th = gap_thresholds(mc._analysis_cascade(x, LEVELS, fd, True), LEVELS)
    wts = _input(cuda, 3, 8192, torch.float32, seed=5)
    grads = []
    for fused in (True, False):
        xg, tg = x.clone().requires_grad_(True), th.clone().requires_grad_(True)
        if fused:
            y = vt.fused_denoise_multilevel(xg, "db4", levels=LEVELS, thresholds=tg,
                                            mode=mode)
            mc.reset_launches()
        else:
            y = mc.denoise_plain(xg, tg, LEVELS, fd, fr, True, mode)
        grads.append(torch.autograd.grad((y * wts).sum(), (xg, tg), allow_unused=True))
        if fused:
            torch.cuda.synchronize()
            assert mc.LAUNCHES["modwt_analysis"] == (1 if mode == "none" else 2)
            assert mc.LAUNCHES["modwt_synthesis"] == 1
    (gx, gt), (px, pt) = grads
    assert _err((gx,), (px,)) <= TOL_F32
    if mode == "soft":
        assert _err((gt,), (pt,)) <= 1e-3 * float(pt.abs().max())
    else:
        assert float(gt.abs().max()) == 0.0


@pytest.mark.parametrize("periodic", [True, False])
def test_kernel_gradients_match_plain_autograd(cuda, periodic):
    boundary = "periodic" if periodic else "zero"
    x = _input(cuda, 3, 8192, torch.float32, seed=3)
    wts = [_input(cuda, 3, 8192, torch.float32, seed=10 + j) for j in range(LEVELS + 1)]
    grads = []
    for backend in ("kernel", "torch"):
        xg = x.clone().requires_grad_(True)
        res = vt.modwt_multilevel(xg, "db4", levels=LEVELS, boundary=boundary,
                                  backend=backend)
        loss = sum((p * w).sum() for p, w in zip((*res.details, res.approx), wts))
        grads.append(torch.autograd.grad(loss, xg)[0])
    assert _err((grads[0],), (grads[1],)) <= TOL_F32


TOL_EXACT = 1e-13
# (batch, n, periodic, first level, levels, with a lo word)
# (rows not a multiple of the tile; odd rows, each after the first off 16
# bytes; strides of 256 and 512, above kThreads, from levels 9 and 10)
EXACT_CASES = [
    (4, 8192, True, 1, LEVELS, False),
    (3, 5000, False, 1, LEVELS, False),
    (2, 300, True, 1, LEVELS, False),
    (2, 4096, True, 1, LEVELS, True),
    (2, 4096, False, 3, 2, True),
    (3, 5001, True, 1, LEVELS, True),
    (3, 9001, False, 1, LEVELS, False),
    (2, 5001, True, 9, 2, True),
    (2, 4099, False, 10, 1, False),
]


def _pair_err(got, want):
    return max(float((g[0].double() + g[1].double() - w[0].double() - w[1].double())
                     .abs().max()) for g, w in zip(got, want))


@pytest.mark.parametrize("b,n,periodic,first,levels,with_lo", EXACT_CASES)
def test_exact_kernels_match_plain(cuda, filters, b, n, periodic, first, levels, with_lo):
    fd, fr = filters
    x = _input(cuda, b, n, torch.float32, seed=4)
    x_lo = x * 2.0**-26 * _input(cuda, b, n, torch.float32, seed=5) if with_lo else None
    mc.reset_launches()
    want = mc.exact_analysis_plain(x, x_lo, levels, fd, periodic, first)
    got = mc.exact_analysis(x, x_lo, levels, fd, periodic, first)
    y_want = mc.exact_synthesis_plain(want, levels, fr, periodic, first)
    y_got = mc.exact_synthesis(want, levels, fr, periodic, first)
    torch.cuda.synchronize()
    assert mc.LAUNCHES["modwt_exact_analysis"] == mc.LAUNCHES["modwt_exact_synthesis"] == 1
    assert all(h.dtype == l.dtype == torch.float32 and h.shape == x.shape for h, l in got)
    assert _pair_err(got, want) <= TOL_EXACT
    assert _pair_err((y_got,), (y_want,)) <= TOL_EXACT
    assert all(torch.equal(h, (h.double() + l.double()).float()) for h, l in got)


@pytest.mark.parametrize("name,levels,n,periodic,launches", [
    ("sym8", 10, 16384, True, (2, 2)),  # the halo of 10 levels does not fit one block
    ("db38", 9, 32768, False, (3, 4)),  # levels 8-9 run direct, from device memory
])
def test_exact_kernels_split_a_deep_halo_over_launches(cuda, name, levels, n, periodic,
                                                       launches):
    w = vt.wavelet(name)
    fd, fr = _kernel_filters(w, synthesis=False), _kernel_filters(w, synthesis=True)
    x = _input(cuda, 2, n, torch.float32, seed=6)
    mc.reset_launches()
    got = mc.exact_analysis(x, None, levels, fd, periodic)
    y = mc.exact_synthesis(got, levels, fr, periodic)
    torch.cuda.synchronize()
    assert (mc.LAUNCHES["modwt_exact_analysis"], mc.LAUNCHES["modwt_exact_synthesis"]) \
        == launches
    assert _pair_err(got, mc.exact_analysis_plain(x, None, levels, fd, periodic)) <= TOL_EXACT
    assert _pair_err((y,), (mc.exact_synthesis_plain(got, levels, fr, periodic),)) \
        <= TOL_EXACT
    if periodic:
        assert torch.equal(y[0], x)


def test_exact_public_entry_points_launch_the_exact_kernels(cuda):
    x = _input(cuda, 4, 8192, torch.float32, seed=7)
    mc.reset_launches()
    res = vt.modwt_multilevel(x, "db4", levels=LEVELS, precision="exact")
    y = vt.imodwt_multilevel(res, "db4", precision="exact")
    hi, lo = vt.imodwt_multilevel_exact(
        tuple(zip(res.details, res.details_lo)), (res.approx, res.approx_lo), "db4")
    torch.cuda.synchronize()
    assert isinstance(res, vt.ExactMODWTResult) and res.approx.device == x.device
    assert {k: v for k, v in mc.LAUNCHES.items() if v} == {
        "modwt_exact_analysis": 1, "modwt_exact_synthesis": 2}
    assert torch.equal(y, x)
    assert float((hi.double() + lo.double() - x.double()).pow(2).mean().sqrt()) <= 1e-12
    sym = vt.modwt_multilevel_exact(x, "sym8", levels=4, boundary="symmetric")
    ref = vt.modwt_multilevel(x.cpu().double(), "sym8", levels=4, boundary="symmetric",
                              backend="torch")
    err = max(float((h.double().cpu() + l.double().cpu() - r).abs().max())
              for (h, l), r in zip((*sym[0], sym[1]), (*ref.details, ref.approx)))
    assert err <= 1e-12
    with pytest.raises(InvalidArgumentError, match="no gradient"):
        vt.modwt_multilevel(x.clone().requires_grad_(True), "db4", levels=3,
                            precision="exact")


# (wavelet, levels, batch, n): rows not a multiple of the tile, odd rows
# (each after the first off 16 bytes), rows one sample longer than the two
# splices (span_l + span_r: 441 for db4 J=6, 225 for sym8 J=4)
SYMMETRIC_CASES = [("db4", LEVELS, 4, 8192), ("sym8", 4, 3, 5000), ("haar", 4, 2, 4096),
                   ("db36", 8, 1, 65536), ("db4", LEVELS, 3, 5001), ("db4", LEVELS, 3, 9001),
                   ("db4", LEVELS, 2, 442), ("sym8", 4, 2, 226)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,levels,b,n", SYMMETRIC_CASES)
def test_symmetric_kernels_match_plain(cuda, name, levels, b, n, dtype):
    w = vt.wavelet(name)
    fd, fr = _kernel_filters(w, synthesis=False), _kernel_filters(w, synthesis=True)
    ops = ms.symmetric_level_ops(w, levels)
    x = _input(cuda, b, n, dtype, seed=8)
    cut = min(mc.composite_halo_samples(w.filter_length, levels), n)
    head = torch.stack(ms._symmetric_cascade(x[:, :cut].float(), fd, levels)).contiguous()
    mc.reset_launches()
    planes = mc.analysis(x, levels, fd, False, head)
    want = mc.analysis_plain(x, levels, fd, False, head)
    torch.cuda.synchronize()
    assert _err(planes, want) <= _tol(dtype, want)
    span_l, span_r = mc.symmetric_spans(w.filter_length, ops)
    hd = _input(cuda, b, span_l, torch.float32, seed=9)
    tl = _input(cuda, b, span_r, torch.float32, seed=10)
    y = mc.symmetric_synthesis(want, hd, tl, levels, fr, ops)
    y_want = mc.symmetric_synthesis_plain(want, hd, tl, levels, fr, ops)
    c = _input(cuda, b, n, dtype, seed=11)
    g = mc.symmetric_adjoint(c, levels, fr, ops)
    g_want = mc.symmetric_adjoint_plain(c, levels, fr, ops)
    torch.cuda.synchronize()
    assert y.dtype == dtype and all(p.dtype == dtype for p in g)
    assert _err((y,), (y_want,)) <= _tol(dtype, (y_want,))
    assert _err(g, g_want) <= _tol(dtype, g_want)
    assert (mc.LAUNCHES["modwt_analysis"], mc.LAUNCHES["modwt_symmetric_synthesis"],
            mc.LAUNCHES["modwt_symmetric_adjoint"]) == (1, 1, 1)


# (wavelet, levels, batch, n): a ragged last tile, odd rows (each after the
# first off 16 bytes), rows one sample longer than the two splices, haar and
# sym8 at J = 9 and 10 (strides 256 and 512: passes), a long filter, and a
# one-sample last block whose levels take two runs (bior1.3)
ADJOINT_CASES = [("db4", LEVELS, 3, 9001), ("db4", LEVELS, 3, 5001), ("db4", LEVELS, 2, 442),
                 ("sym8", 4, 2, 226), ("sym8", 4, 3, 70001), ("haar", 10, 2, 20001),
                 ("sym8", 9, 2, 16001), ("db20", 3, 3, 4097), ("bior1.3", 3, 2, 4097)]


@pytest.mark.parametrize("interior", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,levels,b,n", ADJOINT_CASES)
def test_symmetric_adjoint_matches_plain(cuda, name, levels, b, n, dtype, interior):
    """The adjoint kernel at its library tile, with and without the interior
    spans it reads the cotangent inside, against its plain version."""
    w = vt.wavelet(name)
    fr = _kernel_filters(w, synthesis=True)
    ops = ms.symmetric_level_ops(w, levels)
    spans = mc.symmetric_spans(w.filter_length, ops) if interior else (0, 0)
    c = _input(cuda, b, n, dtype, seed=30)
    mc.reset_launches()
    got = mc.symmetric_adjoint(c, levels, fr, ops, *spans)
    want = mc.symmetric_adjoint_plain(c, levels, fr, ops, *spans)
    torch.cuda.synchronize()
    assert mc.LAUNCHES["modwt_symmetric_adjoint"] == 1
    assert all(g.dtype == dtype and g.shape == c.shape for g in got)
    assert _err(got, want) <= _tol(dtype, want)


def test_symmetric_public_path_launches_the_kernels(cuda):
    """A call of SYMMETRIC_SYNTHESIS_MIN_SAMPLES samples (1024 x 8192) takes
    both kernels; its first rows are held to the float64 CPU cascade."""
    from vectorwave_tpu_torch.transforms.multilevel import SYMMETRIC_SYNTHESIS_MIN_SAMPLES

    x = _input(cuda, SYMMETRIC_SYNTHESIS_MIN_SAMPLES // 8192, 8192, torch.float32, seed=12)
    mc.reset_launches()
    res = vt.modwt_multilevel(x, "db4", levels=LEVELS, boundary="symmetric")
    y = vt.imodwt_multilevel(res, "db4", boundary="symmetric")
    torch.cuda.synchronize()
    assert {k: v for k, v in mc.LAUNCHES.items() if v} == {
        "modwt_mxu_analysis": 1, "modwt_symmetric_synthesis": 1}
    ref = vt.modwt_multilevel(x[:4].cpu().double(), "db4", levels=LEVELS,
                              boundary="symmetric")
    y_ref = vt.imodwt_multilevel(ref, "db4", boundary="symmetric")
    assert _err(tuple(p[:4] for p in (*res.details, res.approx)),
                tuple(p.to(cuda) for p in (*ref.details, ref.approx))) <= TOL_F32
    assert _err((y[:4],), (y_ref.to(cuda),)) <= TOL_F32
    den = vt.swt_denoise(x, "sym8", levels=4, boundary="symmetric")
    assert den.shape == x.shape and bool(torch.isfinite(den).all())
    assert mc.LAUNCHES["modwt_symmetric_synthesis"] == 2


def test_symmetric_gradients_match_plain_autograd(cuda):
    x = _input(cuda, 2, 8192, torch.float32, seed=13)
    wts = [_input(cuda, 2, 8192, torch.float32, seed=20 + j) for j in range(LEVELS + 1)]
    grads = []
    mc.reset_launches()
    for backend in ("kernel", "torch"):
        xg = x.clone().requires_grad_(True)
        res = vt.modwt_multilevel(xg, "db4", levels=LEVELS, boundary="symmetric",
                                  backend=backend)
        loss = sum((p * w).sum() for p, w in zip((*res.details, res.approx), wts))
        grads.append(torch.autograd.grad(loss, xg)[0])
    # forward: the mirror-mode analysis; backward: the zero-mode synthesis
    assert {k: v for k, v in mc.LAUNCHES.items() if v} == {
        "modwt_mxu_analysis": 1, "modwt_synthesis": 1}
    assert _err((grads[0],), (grads[1],)) <= TOL_F32
    planes = [w.clone() for w in wts]
    grads = []
    mc.reset_launches()
    for backend in ("kernel", "torch"):
        ps = [p.clone().requires_grad_(True) for p in planes]
        y = vt.imodwt_multilevel(vt.MultiLevelMODWTResult(tuple(ps[:-1]), ps[-1]), "db4",
                                 boundary="symmetric", backend=backend)
        grads.append(torch.autograd.grad((y * x).sum(), ps))
    assert mc.LAUNCHES["modwt_symmetric_adjoint"] == 1
    assert _err(grads[0], grads[1]) <= TOL_F32


# --- the cascade pair (run_analysis_mxu / run_synthesis_mxu) ------------------------

# (wavelet, levels, batch, n): signals shorter than the span S but not than
# the mirror's reach (L-1) 2^(J-1) (db4 J=6 at 300, sym8 J=4 at 150), and
# db36 J=8, whose mirror tile (L-1) 2^7 = 9088 leaves the second block's
# window starting before the signal; rows not a multiple of 4 long, J=9
# (stride 256, the block's threads) and J=10 (stride 512, two passes a
# chunk), haar at J=10 (taps padded to a step of 8), and db36 at J=3 (9
# steps of 8 taps)
CASCADE_CASES = [("db4", LEVELS, 4, 8192), ("db4", LEVELS, 3, 5000), ("db4", LEVELS, 2, 300),
                 ("sym8", 4, 2, 4096), ("sym8", 4, 2, 150), ("haar", 5, 2, 300),
                 ("db36", 8, 1, 65536), ("db4", LEVELS, 3, 5001), ("db4", 9, 2, 8195),
                 ("db4", 10, 2, 20003), ("haar", 10, 3, 3001), ("db36", 3, 2, 4099)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,levels,b,n", CASCADE_CASES)
def test_cascade_pair_matches_plain(cuda, name, levels, b, n, dtype):
    """Both wrappers in each edge mode against their plain versions (the
    mirror's is the plain symmetric cascade), one launch each; ``tile`` is
    the TPU kernels' layout hint, which the port ignores."""
    w = vt.wavelet(name)
    fd, fr = _kernel_filters(w, synthesis=False), _kernel_filters(w, synthesis=True)
    x = _input(cuda, b, n, dtype, seed=14)
    mc.reset_launches()
    for periodic, symmetric in ((True, False), (False, False), (False, True)):
        edge = "mirror" if symmetric else ("periodic" if periodic else "zero")
        got = mx.run_analysis_mxu(x, levels, fd, periodic, 2048, "float32", False,
                                  symmetric=symmetric)
        want = mx.analysis_plain(x, levels, fd, edge)
        torch.cuda.synchronize()
        assert all(g.dtype == dtype and g.shape == x.shape for g in got)
        assert _err(got, want) <= _tol(dtype, want), edge
        y = mx.run_synthesis_mxu(want, levels, fr, periodic, 2048, "float32", False)
        y_want = mc.synthesis_plain(want, levels, fr, periodic)
        torch.cuda.synchronize()
        assert _err((y,), (y_want,)) <= _tol(dtype, (y_want,)), edge
    assert {k: v for k, v in mc.LAUNCHES.items() if v} == {
        "modwt_mxu_analysis": 3, "modwt_mxu_synthesis": 3}


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "zero"])
@pytest.mark.parametrize("name,levels,b,n", [("db4", LEVELS, 3, 5001), ("db4", 10, 2, 20003),
                                              ("haar", 10, 2, 3001), ("sym8", 4, 2, 150)])
def test_analysis_and_synthesis_kernels_are_adjoints(cuda, name, levels, b, n, periodic):
    """<A x, y> = <x, S y> with the analysis taps in both kernels: the
    synthesis is the analysis's transpose (its gradient).  fp32 sums of
    about 10^5 products: within 1e-5 of |A x| |y|."""
    fd = _kernel_filters(vt.wavelet(name), synthesis=False)
    x = _input(cuda, b, n, torch.float32, seed=16)
    ys = [_input(cuda, b, n, torch.float32, seed=17 + i) for i in range(levels + 1)]
    ax = mc.analysis(x, levels, fd, periodic)
    sy = mc.synthesis(ys, levels, fd, periodic)
    torch.cuda.synchronize()
    lhs = sum(float((a.double() * y.double()).sum()) for a, y in zip(ax, ys))
    rhs = float((x.double() * sy.double()).sum())
    scale = float(torch.cat([a.flatten() for a in ax]).double().norm()
                  * torch.cat([y.flatten() for y in ys]).double().norm())
    assert abs(lhs - rhs) <= 1e-5 * scale


def test_the_cascade_pair_launches_every_shape_the_gates_send(cuda):
    """The launch tile is the library's: for every filter length 1-128 and
    depth 1-10 it launches whatever the routers' gates (their rule, taps +
    2 or 3 rows of tile + span) send, the mirror at the shortest row it
    serves too; a row shorter than the preferred tile is its own tile, and
    a block's shared memory fits."""
    from vectorwave_tpu_torch.kernels._build import library

    lib = library()
    for taps in range(1, 129):
        for levels in range(1, 11):
            reach = mc.mirror_reach(taps, levels)
            if mc.analysis_tile(taps, levels) is not None:
                for edge in ("zero", "periodic", "external"):
                    tile = lib.vw_modwt_analysis_tile(taps, levels, 1 << 20, mc.ANALYSIS_TILE,
                                                      mc.EDGES[edge])
                    assert tile >= 128, (taps, levels, edge)
                    assert lib.vw_modwt_analysis_shared_bytes(taps, levels, tile) <= (
                        mc.SHARED_LIMIT)
            if mc.analysis_tile(taps, levels, mirror=True) is not None:
                for n in (max(reach, 1), 1 << 20):
                    tile = lib.vw_modwt_analysis_tile(taps, levels, n, mc.ANALYSIS_TILE,
                                                      mc.EDGES["mirror"])
                    assert tile >= reach, (taps, levels, n)
            if mc._fitting_tile(lambda t: mc.synthesis_shared_bytes(taps, levels, t),
                                mc.SYNTHESIS_TILE) is not None:
                tile = lib.vw_modwt_synthesis_tile(taps, levels, 1 << 20, mc.SYNTHESIS_TILE)
                assert tile >= 128, (taps, levels)
                assert lib.vw_modwt_synthesis_shared_bytes(taps, levels, tile) <= (
                    mc.SHARED_LIMIT)
    for n in (1, 300, 1000, 4095):
        assert lib.vw_modwt_analysis_tile(8, LEVELS, n, mc.ANALYSIS_TILE, 1) == n
        assert lib.vw_modwt_synthesis_tile(8, LEVELS, n, mc.SYNTHESIS_TILE) == n
    assert lib.vw_modwt_analysis_tile(8, LEVELS, 65536, mc.ANALYSIS_TILE, 1) == 4096
    assert lib.vw_modwt_analysis_tile(72, 8, 65536, mc.ANALYSIS_TILE, 2) == 9088
    assert lib.vw_modwt_analysis_tile(76, 10, 65536, mc.ANALYSIS_TILE, 1) == 0


def test_denoise_and_exact_synthesis_launch_every_shape_the_gates_send(cuda):
    """The library's launch tile and shared memory of the denoise kernel
    (for every filter length and depth denoise_tile admits) and of the exact
    synthesis (for every window launch of exact_launches' plans, from every
    first level): a tile of at least 128 whose block fits; a short row's
    tile is the row."""
    from vectorwave_tpu_torch.kernels import _build

    lib = _build.library()
    for taps in range(1, 129):
        for levels in range(1, 11):
            if mc.denoise_tile(taps, levels) is not None:
                tile = lib.vw_modwt_denoise_tile(taps, levels, 1 << 20,
                                                  mc.DENOISE_LAUNCH_TILE)
                assert tile >= 128, (taps, levels)
                assert lib.vw_modwt_denoise_shared_bytes(taps, levels, tile) <= (
                    mc.SHARED_LIMIT)
            for first_level in range(1, 12 - levels):
                for first, count, _, direct in mc.exact_launches(
                        mc.exact_synthesis_shared_bytes, taps, levels, first_level):
                    if direct:
                        continue
                    used = lib.vw_modwt_exact_synthesis_tile(
                        taps, first, count, 1 << 20, mc.EXACT_SYNTHESIS_LAUNCH_TILE)
                    assert used >= 128, (taps, first, count)
                    assert lib.vw_modwt_exact_synthesis_shared_bytes(
                        taps, first, count, used) <= mc.SHARED_LIMIT
    assert lib.vw_modwt_denoise_tile(8, LEVELS, 1000, mc.DENOISE_LAUNCH_TILE) == 1000
    assert lib.vw_modwt_denoise_tile(8, LEVELS, 65536, mc.DENOISE_LAUNCH_TILE) == 2048
    assert lib.vw_modwt_denoise_tile(40, 8, 1 << 20, mc.DENOISE_LAUNCH_TILE) == 0
    tile = mc.EXACT_SYNTHESIS_LAUNCH_TILE
    assert lib.vw_modwt_exact_synthesis_tile(8, 1, LEVELS, 1000, tile) == 1000
    assert lib.vw_modwt_exact_synthesis_tile(8, 1, LEVELS, 65536, tile) == 4096


def test_symmetric_and_exact_analysis_launch_every_shape_the_gates_send(cuda):
    """The library's launch tile and shared memory of the symmetric
    synthesis and of its adjoint (for every registered wavelet and depth
    symmetric_tile admits in that direction; the adjoint's widest window
    fits its row) and of the exact analysis (for every window launch of
    exact_launches' plans, from every first level): a tile whose block fits,
    of at least 128 where the block fits at 128 (the exact analysis's padded
    taps and rows take up to 208 bytes more than the gates' rule, so a few
    long filters at levels 9-10 launch at 64); a short row's tile is the
    row."""
    from vectorwave_tpu_torch.kernels import _build

    lib = _build.library()
    served = adjoint_served = 0
    for name in vt.available_wavelets():
        w = vt.wavelet(name)
        if not isinstance(w, vt.DiscreteWavelet) or w.filter_length > 128:
            continue
        taps = w.filter_length
        for levels in range(1, 11):
            ops = ms.symmetric_level_ops(w, levels)
            if mc.symmetric_tile(taps, ops, True) is not None:
                tile = lib.vw_modwt_symmetric_adjoint_tile(taps, levels, 1 << 20,
                                                           mc.SYMMETRIC_ADJOINT_LAUNCH_TILE)
                assert tile >= 128, (name, levels)
                assert lib.vw_modwt_symmetric_adjoint_shared_bytes(
                    taps, levels, tile) <= mc.SHARED_LIMIT
                width = mc.symmetric_plan(taps, ops, tile, True)[1]
                assert width <= tile + mc.composite_halo_samples(taps, levels) + 3
                adjoint_served += 1
            if mc.symmetric_tile(taps, ops, False) is None:
                continue
            tile = lib.vw_modwt_symmetric_synthesis_tile(taps, levels, 1 << 20,
                                                         mc.SYMMETRIC_LAUNCH_TILE)
            assert tile >= 128, (name, levels)
            assert lib.vw_modwt_symmetric_synthesis_shared_bytes(
                taps, levels, tile) <= mc.SHARED_LIMIT
            served += 1
    assert served > 100 and adjoint_served >= served
    assert lib.vw_modwt_symmetric_adjoint_tile(8, LEVELS, 1000,
                                               mc.SYMMETRIC_ADJOINT_LAUNCH_TILE) == 1000
    assert lib.vw_modwt_symmetric_adjoint_tile(8, LEVELS, 65536,
                                               mc.SYMMETRIC_ADJOINT_LAUNCH_TILE) == (
        mc.SYMMETRIC_ADJOINT_LAUNCH_TILE)
    for taps in range(1, 129):
        for levels in range(1, 11):
            for first_level in range(1, 12 - levels):
                for first, count, _, direct in mc.exact_launches(
                        mc.exact_analysis_shared_bytes, taps, levels, first_level):
                    if direct:
                        continue
                    used = lib.vw_modwt_exact_analysis_tile(
                        taps, first, count, 1 << 20, mc.EXACT_ANALYSIS_LAUNCH_TILE)
                    fits = lib.vw_modwt_exact_analysis_shared_bytes(taps, first, count, 128)
                    assert used >= (128 if fits <= mc.SHARED_LIMIT else 64), (
                        taps, first, count)
                    assert lib.vw_modwt_exact_analysis_shared_bytes(
                        taps, first, count, used) <= mc.SHARED_LIMIT
    assert lib.vw_modwt_symmetric_synthesis_tile(8, LEVELS, 1000,
                                                 mc.SYMMETRIC_LAUNCH_TILE) == 1000
    assert lib.vw_modwt_symmetric_synthesis_tile(8, LEVELS, 65536,
                                                 mc.SYMMETRIC_LAUNCH_TILE) == 4096
    tile = mc.EXACT_ANALYSIS_LAUNCH_TILE
    assert lib.vw_modwt_exact_analysis_tile(8, 1, LEVELS, 1000, tile) == 1000
    assert lib.vw_modwt_exact_analysis_tile(8, 1, LEVELS, 65536, tile) == tile


def test_cascade_probe_round_trip_launches_one_kernel_each_way(cuda, filters):
    """The probe's path (tools/perf_probe_mxu.py: db4 J=6 periodic, tile
    8192) at every precision, the float32 rung's round-trip bounds; inputs
    that require grad, and a mirror below (L-1) 2^(J-1) (also through the
    public symmetric analysis), raise."""
    fd, fr = filters
    x = _input(cuda, 4, 8192, torch.float32, seed=15)
    for precision in mx.PRECISIONS:
        mc.reset_launches()
        planes = mx.run_analysis_mxu(x, LEVELS, fd, True, 8192, precision, False)
        y = mx.run_synthesis_mxu(planes, LEVELS, fr, True, 8192, precision, False)
        torch.cuda.synchronize()
        assert {k: v for k, v in mc.LAUNCHES.items() if v} == {
            "modwt_mxu_analysis": 1, "modwt_mxu_synthesis": 1}
        assert float((y - x).pow(2).mean().sqrt()) <= 3e-7
        assert float((y - x).abs().max()) <= 3e-6
    with pytest.raises(InvalidArgumentError, match="no gradient"):
        mx.run_analysis_mxu(x.clone().requires_grad_(True), LEVELS, fd, True, 8192,
                            "float32", False)
    with pytest.raises(InvalidArgumentError, match="no gradient"):
        mx.run_synthesis_mxu([p.clone().requires_grad_(True) for p in planes], LEVELS, fr,
                             True, 8192, "float32", False)
    with torch.no_grad():
        mx.run_analysis_mxu(x.clone().requires_grad_(True), LEVELS, fd, True, 8192,
                            "float32", False)
    with pytest.raises(InvalidArgumentError, match="mirror edge"):
        mx.run_analysis_mxu(x[:, :200].contiguous(), LEVELS, fd, False, 2048, "float32",
                            False, symmetric=True)
    with pytest.raises(InvalidArgumentError, match="mirror's reach"):
        vt.fused_analysis(x[:, :200], "db4", levels=LEVELS, boundary="symmetric")


# --- the 2-D kernels ---------------------------------------------------------------


def _image(cuda, shape, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn(*shape, device=cuda, generator=g)


@pytest.mark.parametrize("edge", ["periodic", "zero", "symmetric"])
@pytest.mark.parametrize("name,level,shape", [
    ("db4", 1, (2, 256, 256)),
    ("db4", 4, (2, 256, 256)),
    ("sym8", 6, (1, 512, 640)),
    ("db4", 3, (3, 200, 328)),
    ("haar", 5, (1, 24, 40)),
    ("db20", 4, (1, 384, 320)),
    # the planners' tiles: every db4 level to 6 on ragged widths (the tile
    # and the W-pass block change with the level), a deep haar level (one
    # output a thread) and db20 at its deepest served level
    ("db4", 1, (2, 300, 301)),
    ("db4", 2, (2, 256, 259)),
    ("db4", 3, (1, 400, 333)),
    ("db4", 4, (1, 300, 517)),
    ("db4", 5, (1, 512, 517)),
    ("db4", 6, (2, 512, 1000)),
    ("sym8", 3, (1, 300, 333)),
    ("haar", 10, (1, 1100, 1030)),
    ("db20", 6, (1, 600, 700)),
])
def test_2d_kernels_match_plain(cuda, name, level, shape, edge):
    """Every band of one analysis level, and one synthesis level with the
    edge's per-filter ops, against the plain versions (2e-5, as above)."""
    w = vt.wavelet(name)
    s = 1 << (level - 1)
    x = _image(cuda, shape, seed=level)
    fa = _kernel_filters(w, synthesis=False)
    want = k2.analysis2_level_plain(x, fa, s, edge)
    got = k2.analysis2_level(x, fa, s, edge)
    torch.cuda.synchronize()
    assert _err(got, want) <= TOL_F32
    fs = _kernel_filters(w, synthesis=True)
    ops = k2.synthesis_ops(w, level, edge)[level - 1]
    planes = [_image(cuda, shape, seed=10 + i) for i in range(4)]
    y_want = k2.synthesis2_level_plain(*planes, fs, s, ops, edge)
    y_got = k2.synthesis2_level(*planes, fs, s, ops, edge)
    torch.cuda.synchronize()
    assert _err((y_got,), (y_want,)) <= TOL_F32


@pytest.mark.parametrize("boundary", ["periodic", "zero", "symmetric"])
def test_2d_public_path_launches_one_kernel_per_level(cuda, boundary):
    x = _image(cuda, (2, 512, 384), seed=3)
    mc.reset_launches()
    res = vt.modwt2_multilevel(x, "db4", levels=4, boundary=boundary)
    y = vt.imodwt2_multilevel(res, "db4", boundary=boundary)
    torch.cuda.synchronize()
    assert {k: v for k, v in mc.LAUNCHES.items() if v} == {
        "modwt2_analysis": 4, "modwt2_synthesis": 4}
    ref = vt.modwt2_multilevel(x, "db4", levels=4, boundary=boundary, backend="torch")
    for g3, r3 in zip(res.details, ref.details):
        assert _err(g3, r3) <= TOL_F32
    y_ref = vt.imodwt2_multilevel(ref, "db4", boundary=boundary, backend="torch")
    assert _err((y,), (y_ref,)) <= TOL_F32
    if boundary == "periodic":
        assert float((y - x).abs().max()) <= 5e-5


def test_2d_routing_on_the_card(cuda):
    """float64 stays on the plain path under auto and raises under kernel;
    an input that requires grad raises and names backend='torch'."""
    x = _image(cuda, (1, 128, 128))
    mc.reset_launches()
    vt.modwt2_multilevel(x.double(), "db4", levels=2)
    assert mc.LAUNCHES["modwt2_analysis"] == 0
    with pytest.raises(InvalidArgumentError, match="float32"):
        vt.modwt2_multilevel(x.double(), "db4", levels=2, backend="kernel")
    with pytest.raises(InvalidArgumentError, match="backend='torch'"):
        vt.modwt2_multilevel(x.clone().requires_grad_(True), "db4", levels=2)
    xg = x.clone().requires_grad_(True)
    res = vt.modwt2_multilevel(xg, "db4", levels=2, backend="torch")
    assert res.approx.requires_grad
    with torch.no_grad():
        vt.modwt2_multilevel(xg, "db4", levels=2)
    assert mc.LAUNCHES["modwt2_analysis"] == 2


# --- the filter-bank pair, packets and the dual tree ------------------------------------


def _bank_cases():
    import math

    import numpy as np

    from vectorwave_tpu_torch.transforms import dtcwt as td
    from vectorwave_tpu_torch.transforms import packets as tp

    rng = np.random.default_rng(0)
    w = vt.wavelet("sym8")
    random_dense = tuple(tuple((rng.standard_normal(k) / math.sqrt(k)).tolist())
                         for k in (1, 37, 300))
    gaps = np.zeros(161)
    gaps[[0, 4, 8, 16, 20, 56, 60, 64, 68, 72, 76, 80, 84, 88, 160]] = (
        rng.standard_normal(15) / math.sqrt(15))
    # the widest span served, where the synthesis holds one window buffer
    widest = np.zeros(55809)
    widest[[0, 3, 55808]] = rng.standard_normal(3) / math.sqrt(3)
    low, high = w.dec_lo / math.sqrt(2.0), w.dec_hi / math.sqrt(2.0)
    return {
        "random": random_dense,
        "pair16": tp._pair_dense(low, high, 16),
        "tree3": tp._tree_dense(w, 3, dec=True),
        "dual4": td._dual_tree_bank(w, 4)[0],
        # the analysis kernel's register blocks: a tree over a ragged last
        # tile, a stride above its widest (zero taps bridge the gaps), runs
        # bridged and cut at gaps with taps left over after the steps of 8
        "tree4": tp._tree_dense(w, 4, dec=True),
        "pair512": tp._pair_dense(low, high, 512),
        "gaps": (tuple(gaps.tolist()), tuple((rng.standard_normal(13) / 4).tolist())),
        "widest": (tuple(widest.tolist()), tuple((rng.standard_normal(13) / 4).tolist())),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "zero"])
@pytest.mark.parametrize("kind,b,n", [("random", 3, 5000), ("random", 2, 301),
                                      ("random", 2, 150), ("pair16", 4, 4096),
                                      ("tree3", 2, 8192), ("dual4", 2, 4096),
                                      ("tree4", 3, 2 * 2304 + 7), ("pair512", 2, 3000),
                                      ("gaps", 2, 1001), ("random", 5, 4617),
                                      ("tree4", 2, 16384), ("tree4", 5, 4617),
                                      ("widest", 2, 3000)])
def test_bank_kernels_match_plain(cuda, kind, b, n, periodic, dtype):
    from vectorwave_tpu_torch.kernels import modwt_bank as mb

    dense = _bank_cases()[kind]
    x = _input(cuda, b, n, dtype, seed=20)
    before = dict(mc.LAUNCHES)
    want = mb.bank_analysis_plain(x, dense, periodic)
    got = mb.bank_analysis(x, dense, periodic)
    y_want = mb.bank_synthesis_plain(want, dense, periodic)
    y_got = mb.bank_synthesis(want, dense, periodic)
    torch.cuda.synchronize()
    assert mc.LAUNCHES["modwt_bank_analysis"] == before["modwt_bank_analysis"] + 1
    assert mc.LAUNCHES["modwt_bank_synthesis"] == before["modwt_bank_synthesis"] + 1
    assert all(g.dtype == dtype and g.shape == x.shape for g in got)
    assert _err(got, want) <= _tol(dtype, want)
    # the synthesis sums len(dense) planes of the order of x
    assert _err((y_got,), (y_want,)) <= len(dense) * _tol(dtype, (y_want,))


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "zero"])
@pytest.mark.parametrize("kind,b,n", [("random", 2, 3001), ("tree4", 2, 16384),
                                      ("tree4", 5, 4617), ("random", 2, 150),
                                      ("widest", 1, 3000)])
def test_bank_kernels_are_adjoints_and_each_others_gradient(cuda, kind, b, n, periodic):
    """In float32: a ragged tree, a span >= N, and the widest span, whose
    synthesis holds one window buffer."""
    from vectorwave_tpu_torch.kernels import modwt_bank as mb

    dense = _bank_cases()[kind]
    x = _input(cuda, b, n, torch.float32, seed=21).requires_grad_(True)
    ys = [_input(cuda, b, n, torch.float32, seed=22 + i) for i in range(len(dense))]
    mc.reset_launches()
    outs = mb.bank_analysis(x, dense, periodic)
    lhs = sum((o.double() * y.double()).sum() for o, y in zip(outs, ys))
    (g,) = torch.autograd.grad(sum((o * y).sum() for o, y in zip(outs, ys)), x)
    torch.cuda.synchronize()
    assert {k: v for k, v in mc.LAUNCHES.items() if v} == {
        "modwt_bank_analysis": 1, "modwt_bank_synthesis": 1}
    rhs = (x.detach().double() * g.double()).sum()
    assert abs(float(lhs - rhs)) <= 1e-5 * abs(float(lhs))
    assert _err((g,), (mb.bank_synthesis_plain(ys, dense, periodic),)) <= 3 * TOL_F32
    assert mb.synthesis_stages(mb.bank_taps(dense).span) == (1 if kind == "widest" else 2)


def test_bank_wrappers_refuse_on_the_card_what_the_kernels_cannot_take(cuda):
    from vectorwave_tpu_torch.kernels import modwt_bank as mb

    x = _input(cuda, 2, 256, torch.float32)
    with pytest.raises(InvalidArgumentError):
        mb.bank_analysis(x.double(), ((1.0,),), True)
    with pytest.raises(InvalidArgumentError, match="at most 64 planes"):
        mb.bank_analysis(x, tuple((1.0,) for _ in range(65)), True)
    with pytest.raises(InvalidArgumentError, match="shared memory"):
        mb.bank_analysis(x, ((0.0,) * 60000 + (1.0,),), True)
    try:
        vt.set_backend("kernel")
        with pytest.raises(InvalidArgumentError):  # span 37 * 2^9 words: no window fits
            vt.modwpt(_input(cuda, 1, 1 << 16, torch.float32), "db38", 11)
    finally:
        vt.set_backend("auto")


@pytest.mark.parametrize("backend,packet,dual", [
    ("kernel", (1, 1), (1, 1)),        # the whole tree in one launch each way
    ("auto", (1, 1), (1, 1)),          # small trees whole
    ("torch", (0, 0), (0, 0)),
])
def test_packet_and_dual_tree_routing_on_the_card(cuda, backend, packet, dual):
    x = _input(cuda, 4, 4096, torch.float32, seed=23)
    try:
        vt.set_backend("torch")
        ref = vt.modwpt(x, "sym8", 3)
        ref_d = vt.dtcwt(x, "sym8", levels=4)
        vt.set_backend(backend)
        mc.reset_launches()
        tree = vt.modwpt(x, "sym8", 3)
        y = vt.imodwpt(tree, "sym8")
        torch.cuda.synchronize()
        assert (mc.LAUNCHES["modwt_bank_analysis"], mc.LAUNCHES["modwt_bank_synthesis"]) == packet
        mc.reset_launches()
        res = vt.dtcwt(x, "sym8", levels=4)
        z = vt.idtcwt(res, "sym8")
        torch.cuda.synchronize()
        assert (mc.LAUNCHES["modwt_bank_analysis"], mc.LAUNCHES["modwt_bank_synthesis"]) == dual
    finally:
        vt.set_backend("auto")
    assert _err(tree.levels, ref.levels) <= TOL_F32 and _err((y,), (x,)) <= 5 * TOL_F32
    got = (*res.highpasses, res.lowpass_a, res.lowpass_b)
    want = (*ref_d.highpasses, ref_d.lowpass_a, ref_d.lowpass_b)
    assert max(float((g - w).abs().max()) for g, w in zip(got, want)) <= 3e-5
    assert _err((z,), (x,)) <= 3e-5 * float(x.abs().max())


def test_packet_auto_takes_the_pairs_beyond_the_measured_work(cuda, monkeypatch):
    from vectorwave_tpu_torch.transforms import packets as tp

    x = _input(cuda, 4, 4096, torch.float32, seed=24)
    # the sym8 depth-3 tree has 1064 taps: this call's work is one past the gate
    monkeypatch.setattr(tp, "AUTO_TREE_MAX_WORK", 4 * 4096 * 1064 - 1)
    mc.reset_launches()
    vt.imodwpt(vt.modwpt(x, "sym8", 3), "sym8")
    torch.cuda.synchronize()
    assert (mc.LAUNCHES["modwt_bank_analysis"], mc.LAUNCHES["modwt_bank_synthesis"]) == (3, 3)
    monkeypatch.setattr(tp, "AUTO_TREE_MAX_WORK", 4 * 4096 * 1064)
    mc.reset_launches()
    vt.imodwpt(vt.modwpt(x, "sym8", 3), "sym8")
    torch.cuda.synchronize()
    assert (mc.LAUNCHES["modwt_bank_analysis"], mc.LAUNCHES["modwt_bank_synthesis"]) == (1, 1)


def test_dual_tree_auto_takes_the_pairs_beyond_the_measured_work(cuda, monkeypatch):
    from vectorwave_tpu_torch.transforms import dtcwt as td

    x = _input(cuda, 4, 4096, torch.float32, seed=24)
    monkeypatch.setattr(td, "AUTO_WHOLE_TREE_MAX_WORK", 4 * 4096 * 100)
    mc.reset_launches()
    vt.idtcwt(vt.dtcwt(x, "sym8", levels=4), "sym8")
    torch.cuda.synchronize()
    assert (mc.LAUNCHES["modwt_bank_analysis"], mc.LAUNCHES["modwt_bank_synthesis"]) == (8, 8)


def test_float64_and_symmetric_packets_take_the_plain_cascade_on_the_card(cuda):
    x = _input(cuda, 2, 1024, torch.float32, seed=25)
    mc.reset_launches()
    vt.imodwpt(vt.modwpt(x.double(), "db4", 2), "db4")
    vt.idtcwt(vt.dtcwt(x.double(), levels=2))
    vt.modwpt(x, "db4", 2, boundary="symmetric")
    vt.denoise_packet(x.double(), "db4", 2)
    torch.cuda.synchronize()
    assert not any(mc.LAUNCHES.values())
    got = vt.denoise_packet(x, "db4", 2)
    # the whole tree in one launch: far below packets.AUTO_TREE_MAX_WORK
    assert mc.LAUNCHES["modwt_bank_analysis"] == 1 and got.device == x.device


# --- the streaming tier: the external edge and the stream mode ----------------------

STREAM_CASES = [("db4", 6, 4, 8192, 441), ("db4", 6, 3, 5000, 100), ("db4", 6, 2, 300, 441),
                ("sym8", 4, 3, 5000, 700), ("db36", 8, 2, 16384, 8925)]


@pytest.mark.parametrize("name,levels,b,n,h", STREAM_CASES)
def test_external_edge_and_stream_mode_match_plain(cuda, name, levels, b, n, h):
    """Halos shorter than, equal to and longer than the span; a block
    shorter than the span; db36 J=8, whose span outlasts the tile."""
    w = vt.wavelet(name)
    fd, fr = _kernel_filters(w, False), _kernel_filters(w, True)
    x, halo = _input(cuda, b, n, torch.float32, seed=30), _input(cuda, b, h, torch.float32, 31)
    got = mc.analysis(x, levels, fd, False, halo=halo)
    want = mc.analysis_plain(x, levels, fd, False, halo=halo)
    torch.cuda.synchronize()
    assert _err(got, want) <= TOL_F32
    th = gap_thresholds(mc._external_cascade(x, halo, levels, fd), levels)
    if mc.denoise_tile(w.filter_length, levels) is None:
        with pytest.raises(InvalidArgumentError):
            mc.denoise(x, th, levels, fd, fr, False, "soft", halo=halo)
        return
    for mode in ("none", "soft", "hard"):
        got = mc.denoise(x, th, levels, fd, fr, False, mode, halo=halo)
        want = mc.denoise_plain(x, th, levels, fd, fr, False, mode, halo=halo)
        torch.cuda.synchronize()
        assert _err((got,), (want,)) <= TOL_F32


def test_external_edge_bfloat16_and_with_the_head_splice(cuda, filters):
    fd, _ = filters
    x = _input(cuda, 3, 5000, torch.bfloat16, seed=32)
    halo = _input(cuda, 3, 441, torch.bfloat16, seed=33)
    want = mc.analysis_plain(x, LEVELS, fd, False, halo=halo)
    got = mc.analysis(x, LEVELS, fd, False, halo=halo)
    torch.cuda.synchronize()
    assert _err(got, want) <= _tol(torch.bfloat16, want)
    xf, hf = x.float(), halo.float()
    head = torch.stack(ms._symmetric_cascade(xf[:, :441], fd, LEVELS)).contiguous()
    got = mc.analysis(xf, LEVELS, fd, False, head=head, halo=hf)
    want = mc.analysis_plain(xf, LEVELS, fd, False, head=head, halo=hf)
    torch.cuda.synchronize()
    assert _err(got, want) <= TOL_F32


def test_stream_wrappers_refuse_what_the_kernels_do_not_take(cuda, filters):
    fd, fr = filters
    x = _input(cuda, 2, 1024, torch.float32)
    with pytest.raises(InvalidArgumentError, match="dtype"):
        mc.analysis(x, 3, fd, False, halo=_input(cuda, 2, 49, torch.bfloat16))
    with pytest.raises(InvalidArgumentError, match="periodic"):
        mc.analysis(x, 3, fd, True, halo=_input(cuda, 2, 49, torch.float32))
    with pytest.raises(InvalidArgumentError):
        mc.launch_analysis(x, 3, fd, "external", "modwt_analysis")  # no halo
    with pytest.raises(InvalidArgumentError, match="periodic"):
        mc.denoise(x, torch.zeros(2, 3, device=cuda), 3, fd, fr, True, "soft",
                   halo=_input(cuda, 2, 49, torch.float32))


def test_streaming_paths_launch_one_kernel_per_block(cuda):
    from vectorwave_tpu_torch import streaming as st

    blocks = _input(cuda, 4, 4 * 2048, torch.float32, seed=34).reshape(4, 4, 2048)
    blocks = blocks.transpose(0, 1).contiguous()  # [K, B, block]
    whole = {b: vt.modwt_multilevel(blocks.transpose(0, 1).reshape(4, -1), "db4",
                                    levels=LEVELS, boundary=b, backend="torch")
             for b in ("zero", "symmetric")}
    for boundary in ("zero", "symmetric", "periodic"):
        t = st.StreamingTransform("db4", levels=LEVELS, boundary=boundary,
                                  batch_shape=(4,))
        assert t.backend == "kernel"
        outs = []
        for i in range(4):
            mc.reset_launches()
            outs.append(t.process(blocks[i]))
            torch.cuda.synchronize()
            assert {k: v for k, v in mc.LAUNCHES.items() if v} == {"modwt_analysis": 1}
        if boundary != "periodic":
            got = torch.cat([o.approx for o in outs], -1)
            assert float((got - whole[boundary].approx).abs().max()) <= TOL_F32
    state = st.kernel_streaming_denoiser_init("db4", levels=LEVELS, batch_shape=(4,))
    st_s, outs = state, []
    for i in range(4):
        mc.reset_launches()
        st_s, o = st.streaming_denoise_block_kernel(st_s, blocks[i], "db4", levels=LEVELS)
        outs.append(o)
        torch.cuda.synchronize()
        assert {k: v for k, v in mc.LAUNCHES.items() if v} == {"modwt_denoise": 1}
    mc.reset_launches()
    st_m, out_m = st.streaming_denoise_blocks_kernel(state, blocks, "db4", levels=LEVELS)
    torch.cuda.synchronize()
    assert {k: v for k, v in mc.LAUNCHES.items() if v} == {"modwt_denoise": 1}
    assert torch.equal(torch.stack(outs), out_m)
    assert torch.equal(st_s.noise_window, st_m.noise_window)
    _, o_p = st.streaming_denoise_block_kernel(state, blocks[0], "db4", levels=LEVELS,
                                               backend="torch")
    assert float((o_p - outs[0]).abs().max()) <= TOL_F32


def test_streaming_gates_on_the_card(cuda):
    """Under auto a shape the kernels cannot serve takes the plain version
    before any launch; with backend='kernel' it raises."""
    from vectorwave_tpu_torch import streaming as st

    w = vt.wavelet("db38")
    assert mc.analysis_tile(w.filter_length, 10) is None
    state = st.kernel_streaming_init(w, 10, batch_shape=(1,))
    x = _input(cuda, 1, 4096, torch.float32, seed=35)
    mc.reset_launches()
    _, res = st.modwt_stream_block_kernel(state, x, w, levels=10)
    assert not any(mc.LAUNCHES.values()) and res.approx.device == x.device
    with pytest.raises(InvalidArgumentError):
        st.modwt_stream_block_kernel(state, x, w, levels=10, backend="kernel")
    s64 = st.kernel_streaming_init("db4", 3, batch_shape=(1,), dtype=torch.float64)
    st.modwt_stream_block_kernel(s64, x.double(), "db4", levels=3)
    assert not any(mc.LAUNCHES.values())
    with pytest.raises(InvalidArgumentError):
        st.modwt_stream_block_kernel(s64, x.double(), "db4", levels=3, backend="kernel")
    d_state = st.kernel_streaming_denoiser_init("db20", levels=8, batch_shape=(1,))
    assert mc.denoise_tile(40, 8) is None
    st.streaming_denoise_block_kernel(d_state, x, "db20", levels=8)
    assert not any(mc.LAUNCHES.values())
    with pytest.raises(InvalidArgumentError):
        st.streaming_denoise_block_kernel(d_state, x, "db20", levels=8, backend="kernel")
    sym = st.kernel_streaming_init("db4", LEVELS, batch_shape=(1,))
    with pytest.raises(InvalidArgumentError, match="first block"):
        st.modwt_stream_block_kernel(sym, x[:, :440], "db4", levels=LEVELS,
                                     boundary="symmetric")
    mc.reset_launches()
    st.modwt_stream_block_kernel(sym, x[:, :441], "db4", levels=LEVELS, boundary="symmetric")
    assert mc.LAUNCHES["modwt_analysis"] == 1


# --- the tiled tier: the synthesis's and the exact pair's external halos -------------

HALO_CASES = [("db4", 6, 4, 8192, 441), ("db4", 6, 3, 5000, 100), ("db4", 6, 2, 300, 441),
              ("sym8", 4, 3, 5000, 700), ("db36", 8, 2, 16384, 18105)]


def _halos(cuda, b, h, count, dtype, seed):
    return tuple(_input(cuda, b, h, dtype, seed=seed + i) for i in range(count))


@pytest.mark.parametrize("name,levels,b,n,h", HALO_CASES)
def test_synthesis_external_halo_matches_plain(cuda, name, levels, b, n, h):
    """Right halos shorter than, equal to and longer than the span; planes
    shorter than the span; db36 J=8, whose span outlasts the tile."""
    fr = _kernel_filters(vt.wavelet(name), True)
    planes = _halos(cuda, b, n, levels + 1, torch.float32, 40)
    halo = _halos(cuda, b, h, levels + 1, torch.float32, 60)
    got = mc.synthesis(planes, levels, fr, False, halo=halo)
    want = mc.synthesis_plain(planes, levels, fr, False, halo=halo)
    torch.cuda.synchronize()
    assert _err((got,), (want,)) <= TOL_F32


def test_synthesis_external_halo_bfloat16(cuda, filters):
    _, fr = filters
    planes = _halos(cuda, 3, 5000, LEVELS + 1, torch.bfloat16, 70)
    halo = _halos(cuda, 3, 441, LEVELS + 1, torch.bfloat16, 80)
    want = mc.synthesis_plain(planes, LEVELS, fr, False, halo=halo)
    got = mc.synthesis(planes, LEVELS, fr, False, halo=halo)
    torch.cuda.synchronize()
    assert _err((got,), (want,)) <= _tol(torch.bfloat16, (want,))


#: (wavelet, levels, batch, n, halo samples, lo word, launches each way): db4
#: J=6 is one window launch (the load rule), sym8 J=10 a split plan (the
#: materialised [halo | x])
EXACT_HALO_CASES = [("db4", 6, 4, 8192, 441, False, 1), ("db4", 6, 3, 5000, 100, True, 1),
                    ("db4", 6, 2, 300, 441, False, 1), ("sym8", 10, 2, 16384, 20000, False, 2),
                    ("sym8", 10, 2, 3000, 5000, True, 2)]


@pytest.mark.parametrize("name,levels,b,n,h,with_lo,launches", EXACT_HALO_CASES)
def test_exact_halos_match_plain(cuda, name, levels, b, n, h, with_lo, launches):
    w = vt.wavelet(name)
    fd, fr = _kernel_filters(w, False), _kernel_filters(w, True)
    x = _input(cuda, b, n, torch.float32, seed=90)
    x_lo = x * 2.0**-26 * _input(cuda, b, n, torch.float32, seed=91) if with_lo else None
    halo = _input(cuda, b, h, torch.float32, seed=92)
    before = dict(mc.LAUNCHES)
    got = mc.exact_analysis(x, x_lo, levels, fd, False, halo=halo)
    want = mc.exact_analysis_plain(x, x_lo, levels, fd, False, halo=halo)
    pair_halo = tuple((a[:, : h // 2].contiguous(), b_[:, : h // 2].contiguous())
                      for a, b_ in mc.exact_analysis_plain(
                          _input(cuda, b, h, torch.float32, seed=93), None, levels, fd, True))
    y = mc.exact_synthesis(want, levels, fr, False, halo=pair_halo)
    y_want = mc.exact_synthesis_plain(want, levels, fr, False, halo=pair_halo)
    torch.cuda.synchronize()
    assert _pair_err(got, want) <= 1e-13
    assert _pair_err((y,), (y_want,)) <= 1e-13
    for k in ("modwt_exact_analysis", "modwt_exact_synthesis"):
        assert mc.LAUNCHES[k] - before[k] == launches


def test_halo_wrappers_refuse_what_the_kernels_do_not_take(cuda, filters):
    fd, fr = filters
    planes = _halos(cuda, 2, 1024, 4, torch.float32, 100)
    halo = _halos(cuda, 2, 49, 4, torch.float32, 110)
    with pytest.raises(InvalidArgumentError, match="periodic"):
        mc.synthesis(planes, 3, fr, True, halo=halo)
    with pytest.raises(InvalidArgumentError, match="per plane"):
        mc.synthesis(planes, 3, fr, False, halo=halo[:3])
    with pytest.raises(InvalidArgumentError, match="same width"):
        mc.synthesis(planes, 3, fr, False, halo=halo[:3] + (halo[3][:, :10].contiguous(),))
    with pytest.raises(InvalidArgumentError, match="dtype"):
        mc.synthesis(planes, 3, fr, False, halo=tuple(t.bfloat16() for t in halo))
    with pytest.raises(InvalidArgumentError, match="periodic"):
        mc.exact_analysis(planes[0], None, 3, fd, True, halo=halo[0])
    pairs = tuple((p, torch.zeros_like(p)) for p in planes)
    with pytest.raises(InvalidArgumentError, match="periodic"):
        mc.exact_synthesis(pairs, 3, fr, True, halo=tuple((h, h) for h in halo))
    mc.reset_launches()
    mc.synthesis(planes, 3, fr, False, halo=halo)
    assert mc.LAUNCHES["modwt_synthesis"] == 1


@pytest.mark.parametrize("shards", [4, 8, 64])  # 64: a hop chain of two shards
def test_tiled_round_trip_launches_once_each_way_for_all_shards(cuda, shards):
    from vectorwave_tpu_torch import parallel as par

    mesh = par.make_mesh({"signal": shards}, devices=[cuda] * shards)
    x = _input(cuda, 8, 16384, torch.float32, seed=120)
    mc.reset_launches()
    res = par.modwt_multilevel_tiled(x, "db4", levels=LEVELS, mesh=mesh)
    y = par.imodwt_multilevel_tiled(res, "db4", mesh=mesh)
    torch.cuda.synchronize()
    assert {k: v for k, v in mc.LAUNCHES.items() if v} == {"modwt_analysis": 1,
                                                            "modwt_synthesis": 1}
    ref = vt.modwt_multilevel(x, "db4", levels=LEVELS, backend="torch")
    assert _err((*res.details, res.approx), (*ref.details, ref.approx)) <= TOL_F32
    assert float((y - x).pow(2).mean().sqrt()) <= 3e-7
    mc.reset_launches()
    d, a = par.modwt_multilevel_tiled_exact(x, "db4", levels=LEVELS, mesh=mesh)
    hi, lo = par.imodwt_multilevel_tiled_exact(d, a, "db4", mesh=mesh)
    torch.cuda.synchronize()
    assert {k: v for k, v in mc.LAUNCHES.items() if v} == {"modwt_exact_analysis": 1,
                                                            "modwt_exact_synthesis": 1}
    assert float((hi.double() + lo.double() - x.double()).pow(2).mean().sqrt()) <= 1e-10


def test_tiled_gates_on_the_card(cuda):
    """Under auto a symmetric boundary or a window the kernels cannot serve
    takes the plain route before any launch; backend='kernel' raises."""
    from vectorwave_tpu_torch import parallel as par

    mesh = par.make_mesh({"signal": 4}, devices=[cuda] * 4)
    x = _input(cuda, 2, 65536, torch.float32, seed=130)
    for boundary, name, levels in (("symmetric", "db4", 3), ("periodic", "db38", 10)):
        mc.reset_launches()
        par.modwt_multilevel_tiled(x, name, levels=levels, mesh=mesh, boundary=boundary)
        torch.cuda.synchronize()
        assert not any(mc.LAUNCHES.values())
        with pytest.raises(InvalidArgumentError):
            par.modwt_multilevel_tiled(x, name, levels=levels, mesh=mesh, boundary=boundary,
                                       backend="kernel")
    mc.reset_launches()
    par.modwt_multilevel_tiled(x, "db4", levels=3, mesh=mesh, boundary="zero")
    assert mc.LAUNCHES["modwt_analysis"] == 1


# --- the CWT's kernel-direct tier on the bank analysis kernel ----------------------


def _under(backend, fn):
    vt.set_backend(backend)
    try:
        return fn()
    finally:
        vt.set_backend("auto")


def _rel(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


#: (batch, n, scales): morl to h = 2048 (s = 512) on one long row and a batch,
#: a ragged row, a row shorter than the span, and mexh
CWT_CASES = [(1, 1 << 16, "morl", (2.0, 8.0, 32.0, 128.0, 512.0)),
             (8, 8192, "morl", (2.0, 3.0, 5.0, 9.0, 17.0, 33.0, 65.0)),
             (3, 5000, "morl", (2.0, 16.0, 256.0)),
             (2, 300, "morl", (4.0, 100.0, 512.0)),
             (4, 8192, "mexh", (1.0, 2.0, 5.0, 9.0))]


@pytest.mark.parametrize("b,n,name,scales", CWT_CASES)
def test_cwt_tier_matches_plain_and_the_fft_path(cuda, b, n, name, scales):
    """The bank kernel on the tier's dense taps against its plain version,
    and the whole tier against the FFT path (past N: against the periodic
    correlation in float64), within 2e-5 of the largest coefficient."""
    from vectorwave_tpu_torch.kernels import modwt_bank as mb
    from vectorwave_tpu_torch.transforms import cwt as tc

    x = _input(cuda, b, n, torch.float32, seed=30)
    w = vt.wavelet(name)
    chunks = tc._kernel_direct_chunks(w, scales)
    want_rows = []
    for maxhalf, dense in chunks:
        xr = torch.roll(x, -maxhalf, dims=-1)
        got = mb.bank_analysis(xr, dense, True)
        want = mb.bank_analysis_plain(xr, dense, True)
        # of the chunk's largest output: a long wavelet wrapped many times
        # round a short row nearly cancels, so one plane's own scale is tiny
        top = max(float(p.abs().max()) for p in want)
        assert _err(got, want) <= TOL_F32 * top
        want_rows += mb.bank_analysis_plain(torch.roll(x.double(), -maxhalf, dims=-1), dense,
                                            True)
    mc.reset_launches()
    tier = _under("kernel", lambda: vt.cwt(x, scales, name, boundary="periodic")).coeffs
    torch.cuda.synchronize()
    assert {k: v for k, v in mc.LAUNCHES.items() if v} == {"modwt_bank_analysis": len(chunks)}
    assert tier.shape == (b, len(scales), n) and tier.device == x.device
    if 2 * tc._half_support(max(scales), w.bandwidth) + 1 <= n:
        fft = _under("torch", lambda: vt.cwt(x, scales, name, boundary="periodic")).coeffs
        assert _rel(tier, fft) <= TOL_F32
    assert _rel(tier, torch.stack(want_rows, -2)) <= TOL_F32


def test_cwt_tier_gradient_is_one_bank_synthesis_launch(cuda):
    from vectorwave_tpu_torch.kernels import modwt_bank as mb
    from vectorwave_tpu_torch.transforms import cwt as tc

    scales = (2.0, 8.0, 32.0, 128.0, 512.0)
    x = _input(cuda, 2, 1 << 15, torch.float32, seed=31).requires_grad_(True)
    wts = _input(cuda, 2 * len(scales), 1 << 15, torch.float32, seed=32).reshape(
        2, len(scales), -1)
    mc.reset_launches()
    (g,) = _under("kernel", lambda: torch.autograd.grad(
        (vt.cwt(x, scales, "morl", boundary="periodic").coeffs * wts).sum(), x))
    torch.cuda.synchronize()
    assert {k: v for k, v in mc.LAUNCHES.items() if v} == {
        "modwt_bank_analysis": 1, "modwt_bank_synthesis": 1}
    ((maxhalf, dense),) = tc._kernel_direct_chunks(vt.wavelet("morl"), scales)
    planes = mb.bank_analysis_plain(torch.roll(x, -maxhalf, dims=-1), dense, True)
    (want,) = torch.autograd.grad((torch.stack(planes, -2) * wts).sum(), x)
    assert _rel(g, want) <= TOL_F32


def test_cwt_auto_routing_on_both_sides_of_the_gate(cuda):
    """``auto`` sends a call to one bank launch when every scale is within
    AUTO_KERNEL_DIRECT_MAX_HALF and they make one chunk, its result the
    bank's allocation seen as [B, S, N]; a scale past the cap, or more
    planes than one launch takes, send the whole call to the FFT path;
    float64, the zero boundary, a complex wavelet and descending scales take
    no launch."""
    from vectorwave_tpu_torch.kernels import modwt_bank as mb
    from vectorwave_tpu_torch.transforms import cwt as tc

    cap = tc.AUTO_KERNEL_DIRECT_MAX_HALF
    at, past = cap / 4.0, cap / 4.0 + 0.25  # morl: h = ceil(4 s)
    many = tuple(torch.logspace(-2, 0, mb.MAX_PLANES + 1, base=at).tolist())
    x = _input(cuda, 2, 1 << 14, torch.float32, seed=33)
    for scales, launches in (((2.0, at), 1), ((2.0, at, past), 0), ((past, 2 * past), 0),
                             (many[1:], 1), (many, 0)):
        mc.reset_launches()
        got = vt.cwt(x, scales, "morl", boundary="periodic").coeffs
        torch.cuda.synchronize()
        assert mc.LAUNCHES["modwt_bank_analysis"] == launches, scales
        if launches:  # no copy: the planes of the one bank launch, time innermost
            assert got.stride() == (1 << 14, 2 << 14, 1)
        else:
            assert got.is_contiguous()
        want = _under("torch", lambda: vt.cwt(x, scales, "morl", boundary="periodic")).coeffs
        assert _rel(got, want) <= TOL_F32
    for call in (lambda: vt.cwt(x.double(), (2.0, at), "morl", boundary="periodic"),
                 lambda: vt.cwt(x, (2.0, at), "morl"),
                 lambda: vt.cwt(x, (2.0, at), "cmor", boundary="periodic"),
                 lambda: vt.cwt(x, (2.0, at), "morl", boundary="periodic", analytic=True),
                 lambda: vt.cwt(x, (at, 2.0), "morl", boundary="periodic")):
        mc.reset_launches()
        call()
        torch.cuda.synchronize()
        assert not any(mc.LAUNCHES.values())


def test_cwt_kernel_backend_raises_where_the_window_does_not_fit(cuda, monkeypatch):
    """With the cap lifted past what a window holds, ``kernel`` raises on the
    card; it does not fall back to the FFT path."""
    from vectorwave_tpu_torch.transforms import cwt as tc

    monkeypatch.setattr(tc, "KERNEL_DIRECT_MAX_HALF", 1 << 16)
    x = _input(cuda, 1, 4096, torch.float32, seed=34)
    with pytest.raises(InvalidArgumentError, match="shared memory"):
        _under("kernel", lambda: vt.cwt(x, (2.0, 15000.0), "morl", boundary="periodic"))


def test_cwt_auto_tier_result_is_a_view_with_a_gradient(cuda):
    """Under auto with every scale within the cap, the result is the bank
    launch's own tensor (``movedim``), and d/dx through it is one bank
    synthesis launch, equal to the plain route's gradient."""
    from vectorwave_tpu_torch.kernels import modwt_bank as mb
    from vectorwave_tpu_torch.transforms import cwt as tc

    cap = tc.AUTO_KERNEL_DIRECT_MAX_HALF
    scales = tuple(torch.logspace(-3, 0, 12, base=2).mul(cap / 4.0).tolist())
    x = _input(cuda, 3, 8192, torch.float32, seed=35).requires_grad_(True)
    wts = _input(cuda, 3 * 12, 8192, torch.float32, seed=36).reshape(3, 12, 8192)
    seen = []
    real = mb.bank_analysis_stacked

    def spy(*a):
        seen.append(real(*a))
        return seen[-1]

    mb.bank_analysis_stacked = spy
    try:
        mc.reset_launches()
        c = vt.cwt(x, scales, "morl", boundary="periodic").coeffs
        (g,) = torch.autograd.grad((c * wts).sum(), x)
        torch.cuda.synchronize()
    finally:
        mb.bank_analysis_stacked = real
    assert c.data_ptr() == seen[0].data_ptr() and c.shape == (3, 12, 8192)
    assert {k: v for k, v in mc.LAUNCHES.items() if v} == {
        "modwt_bank_analysis": 1, "modwt_bank_synthesis": 1}
    (want,) = _under("torch", lambda: torch.autograd.grad(
        (vt.cwt(x, scales, "morl", boundary="periodic").coeffs * wts).sum(), x))
    assert _rel(g, want) <= TOL_F32


@pytest.mark.parametrize("shards,boundary", [(4, "zero"), (8, "periodic"), (8, "zero")])
def test_cwt_tiled_matches_the_single_card_cwt(cuda, shards, boundary):
    """Config #5's scales (64, 2-4096) on 2^18 samples over virtual shards of
    the card, float32, within 2e-5 of the largest coefficient of the
    single-card cwt; and the 2 x 4 host x chip layout."""
    from vectorwave_tpu_torch import parallel as par

    x = _input(cuda, 1, 1 << 18, torch.float32, seed=37)[0]
    scales = tuple(torch.logspace(1, 12, 64, base=2).tolist())
    want = vt.cwt(x, scales, "morl", boundary=boundary).coeffs
    mesh = par.make_mesh({"signal": shards}, devices=[cuda] * shards)
    mc.reset_launches()
    got = par.cwt_tiled(x, scales, "morl", mesh=mesh, boundary=boundary).coeffs
    torch.cuda.synchronize()
    assert not any(mc.LAUNCHES.values())
    assert got.device == x.device and _rel(got, want) <= TOL_F32
    hosts = par.make_multihost_mesh(n_hosts=2, chips_per_host=4, devices=[cuda] * 8)
    got = par.cwt_tiled_2d(x, scales, "morl", mesh=hosts, boundary=boundary).coeffs
    assert _rel(got, want) <= TOL_F32


def test_sst_scatter_matches_the_masked_sum(cuda):
    """The SST's one scatter-add (atomic adds in any order) against the JAX
    package's form, one masked sum a bin, within 2e-5 of the largest bin."""
    from vectorwave_tpu_torch.transforms import sst as tsst

    g = torch.Generator(device=cuda).manual_seed(38)
    contrib = torch.complex(torch.randn(4, 32, 16384, device=cuda, generator=g),
                            torch.randn(4, 32, 16384, device=cuda, generator=g))
    idx = torch.randint(0, 33, (4, 32, 16384), device=cuda, generator=g)
    got = tsst._squeeze(contrib, idx, 32)
    want = torch.stack([torch.where(idx == b, contrib, 0).sum(-2) for b in range(32)], -2)
    assert _rel(got, want) <= TOL_F32
    x = torch.sin(torch.arange(16384, device=cuda) * 0.25)
    res = vt.synchrosqueeze(x, tuple(torch.logspace(1, 6, 32, base=2).tolist()), "morl")
    assert res.coeffs.device == x.device and res.coeffs.shape == (32, 16384)


def test_host_inputs_take_the_card_by_default():
    """Functions that build tensors from host values default to the card and
    raise without one; with a card the tensors land there."""
    import numpy as np

    from vectorwave_tpu_torch import finance as fin

    prices = 100.0 * np.exp(np.cumsum(np.full(64, 0.001)))
    calls = (lambda: fin.analyze_volatility(prices),
             lambda: fin.incremental_init(),
             lambda: vt.cone_of_influence(64),
             lambda: vt.significance_levels((2.0, 4.0), n=64, lag1=0.1),
             lambda: vt.convert.sst_result_from_arrays(np.zeros((2, 8), np.complex64),
                                                       [0.1, 0.2], (2.0, 4.0)))
    for call in calls:
        if torch.cuda.is_available():
            call()
        else:
            with pytest.raises(InvalidArgumentError, match="no CUDA device"):
                call()
    if torch.cuda.is_available():
        assert fin.incremental_init().count.device.type == "cuda"
        assert vt.cone_of_influence(64).device.type == "cuda"


# --- the default depth and the 1-D analysis modules -----------------------------------


@pytest.mark.parametrize("name,levels,depth", [("db4", None, 9), ("sym8", None, 9),
                                               ("db4", 10, 10)])
def test_default_depth_takes_the_cascade_pair(cuda, name, levels, depth):
    """With no ``levels`` (max_levels stops at 9) and at db4 J=10 the gate
    asks for the pair's room alone: one analysis launch and one synthesis
    launch, both against the plain route 2e-5."""
    x = _input(cuda, 4, 16384, torch.float32)
    mc.reset_launches()
    res = vt.modwt_multilevel(x, name, levels=levels)
    torch.cuda.synchronize()
    assert res.levels == depth and mc.LAUNCHES["modwt_analysis"] == 1
    y = vt.imodwt_multilevel(res, name)
    torch.cuda.synchronize()
    assert mc.LAUNCHES["modwt_synthesis"] == 1
    ref = vt.modwt_multilevel(x, name, levels=levels, backend="torch")
    assert _err((*res.details, res.approx), (*ref.details, ref.approx)) <= TOL_F32
    assert _err((y,), (vt.imodwt_multilevel(ref, name, backend="torch"),)) <= TOL_F32


@pytest.mark.parametrize("name,levels,boundary,route", [
    ("sym8", None, "periodic", "pair"), ("sym8", None, "zero", "pair"),
    ("db4", 10, "periodic", "pair"), ("db9", 8, "zero", "denoise")])
def test_denoise_multilevel_takes_the_kernels_its_room_admits(cuda, name, levels, boundary,
                                                              route):
    """sym8 at its default depth (J=9) and db4 J=10, where no denoise block
    fits, take the 3-call path on the cascade pair (one analysis and one
    synthesis launch); db9 J=8 fits a tile of 512 and takes the fused
    kernel.  Each against the plain route 2e-5 (16384 samples: both take
    the full-sample sigma)."""
    x = _input(cuda, 4, 16384, torch.float32, seed=5)
    mc.reset_launches()
    got = vt.denoise_multilevel(x, name, levels=levels, boundary=boundary)
    torch.cuda.synchronize()
    want = {"pair": (1, 1, 0), "denoise": (0, 0, 1)}[route]
    assert (mc.LAUNCHES["modwt_analysis"], mc.LAUNCHES["modwt_synthesis"],
            mc.LAUNCHES["modwt_denoise"]) == want
    ref = _plain(lambda: vt.denoise_multilevel(x, name, levels=levels, boundary=boundary))
    assert _err((got,), (ref,)) <= TOL_F32


def _plain(fn):
    vt.set_backend("torch")
    try:
        return fn()
    finally:
        vt.set_backend("auto")


def test_variance_family_matches_the_plain_route(cuda):
    """One analysis launch a transform (the correlation's four); each level's
    estimate within 1e-4 of the plain route's, relative."""
    x = _input(cuda, 4, 16384, torch.float32, seed=1)
    y = 0.6 * x + 0.8 * _input(cuda, 4, 16384, torch.float32, seed=2)
    for call, launches in (
        (lambda: vt.wavelet_variance(x, "db4").variance, 1),
        (lambda: vt.wavelet_covariance(x, y, "db4")[0], 2),
        (lambda: vt.wavelet_correlation(x, y, "db4")[0], 4),
        (lambda: vt.hurst_exponent(x, "db4").variance, 1),
    ):
        mc.reset_launches()
        got = call()
        torch.cuda.synchronize()
        assert mc.LAUNCHES["modwt_analysis"] == launches
        assert _rel(got, _plain(call)) <= 1e-4
    h = vt.hurst_exponent(x, "db4").hurst
    assert float((h - _plain(lambda: vt.hurst_exponent(x, "db4").hurst)).abs().max()) <= 1e-4


def test_variance_stream_on_the_kernel_step_equals_the_whole_signal(cuda):
    """The kernel-tier stream step, one external-edge launch a block, folded
    into the accumulator gives the whole signal's variance within 1e-4."""
    from vectorwave_tpu_torch import streaming as st

    x = _input(cuda, 8, 8 * 2048, torch.float32, seed=3)
    state = st.kernel_streaming_init("db4", 6, batch_shape=(8,))
    acc = vt.variance_stream_init("db4", 6, batch_shape=(8,))
    mc.reset_launches()
    for blk in x.reshape(8, 8, 2048).unbind(1):
        state, res = st.modwt_stream_block_kernel(state, blk.contiguous(), "db4", levels=6)
        acc = vt.variance_stream_update(acc, res.details, "db4")
    torch.cuda.synchronize()
    assert mc.LAUNCHES["modwt_analysis"] == 8 and acc.position == 8 * 2048
    out = vt.variance_stream_result(acc)
    assert _rel(out.variance, _plain(lambda: vt.wavelet_variance(x, "db4", 6).variance)) <= 1e-4


def test_inpaint_takes_one_synthesis_and_one_analysis_launch_a_step(cuda):
    """Each FISTA step's gradient is autograd through the cascade synthesis
    kernel, whose backward is the analysis kernel: one launch of each a
    step, beside the first analysis and the final synthesis (the noise
    probe, one level, takes the plain route).  Against the same solve on the
    plain route within 1e-4 of the largest value."""
    steps = 30
    t = torch.arange(16384, device=cuda, dtype=torch.float32) / 16384
    clean = (torch.sin(2 * torch.pi * 5 * t) + 0.5 * torch.sin(2 * torch.pi * 13 * t))[None]
    g = torch.Generator(device=cuda).manual_seed(4)
    mask = (torch.rand(1, 16384, device=cuda, generator=g) > 0.3).float()

    def call():
        return vt.inpaint(torch.where(mask > 0, clean, torch.nan), mask, "db8", steps=steps)

    mc.reset_launches()
    got = call()
    torch.cuda.synchronize()
    assert mc.LAUNCHES["modwt_analysis"] == steps + 1
    assert mc.LAUNCHES["modwt_synthesis"] == steps + 1
    assert bool(torch.isfinite(got).all())
    assert _rel(got, _plain(call)) <= 1e-4


def test_deconvolve2_takes_the_2d_pair(cuda):
    """sym8 at its default 3 levels: one 2-D analysis launch a level and one
    for the one-level noise probe, one 2-D synthesis launch a level; in soft
    mode against the plain route within 2e-5 of the largest value."""
    yy, xx = torch.meshgrid(torch.arange(512.0, device=cuda), torch.arange(512.0, device=cuda),
                            indexing="ij")
    clean = torch.sin(2 * torch.pi * (5 * xx + 3 * yy) / 512).expand(2, 512, 512)
    psf = torch.ones(5, 5).numpy() / 25.0
    spec = torch.fft.rfft2(torch.nn.functional.pad(torch.ones(5, 5, device=cuda) / 25.0,
                                                   (0, 507, 0, 507)))
    img = (torch.fft.irfft2(torch.fft.rfft2(clean) * spec, s=(512, 512))
           + 0.05 * _input(cuda, 2, 512 * 512, torch.float32, seed=6).reshape(2, 512, 512))
    mc.reset_launches()
    res = vt.deconvolve2(img, psf, "sym8")
    torch.cuda.synchronize()
    assert mc.LAUNCHES["modwt2_analysis"] == 4 and mc.LAUNCHES["modwt2_synthesis"] == 3
    assert res.signal.dtype == torch.float32 and bool(torch.isfinite(res.signal).all())
    soft = vt.deconvolve2(img, psf, "sym8", mode="soft").signal
    assert _rel(soft, _plain(lambda: vt.deconvolve2(img, psf, "sym8", mode="soft").signal)) <= 2e-5


def test_calibrate_keeps_a_cuda_key(cuda, tmp_path, monkeypatch):
    """The calibration store is the port's own, keyed by the card's name."""
    import json

    from vectorwave_tpu_torch import cost_model

    monkeypatch.setenv("VECTORWAVE_TPU_TORCH_CACHE", str(tmp_path))
    assert not cost_model.estimate_processing_time(65536).calibrated
    rate = cost_model.calibrate(sizes=(16384,), batch=4)
    store = json.loads((tmp_path / "performance.json").read_text())
    key = f"cuda:{torch.cuda.get_device_name(0)}"
    assert rate > 0 and store[key]["samples_per_second"] == rate
    assert cost_model.estimate_processing_time(65536).calibrated


@pytest.mark.parametrize("name,levels", [("db4", 2), ("db4", 6), ("sym8", 4)])
def test_the_kernel_floor_on_the_card(cuda, name, levels):
    """At the gate's floor (multilevel.KERNEL_MIN_N, or the halo's length
    where it is longer) the round trip is the cascade pair, two launches;
    one sample shorter it is the plain cascade, none."""
    from vectorwave_tpu_torch.kernels.modwt_fused import total_halo
    from vectorwave_tpu_torch.transforms import multilevel as ml

    w = vt.wavelet(name)
    floor = max(ml.KERNEL_MIN_N, -(-total_halo(w.filter_length, levels) // 128) * 128)
    for n, want in ((floor, {"modwt_analysis": 1, "modwt_synthesis": 1}), (floor - 1, {})):
        x = torch.randn(4, n, device=cuda)
        mc.reset_launches()
        y = vt.imodwt_multilevel(vt.modwt_multilevel(x, name, levels=levels), name)
        torch.cuda.synchronize()
        assert {k: v for k, v in mc.LAUNCHES.items() if v} == want, n
        assert float((y - x).abs().max()) <= TOL_F32


def test_symmetric_synthesis_floor_on_the_card(cuda):
    """The symmetric synthesis kernel serves calls of at least
    SYMMETRIC_SYNTHESIS_MIN_SAMPLES samples; the analysis's mirror kernel
    serves both sides."""
    from vectorwave_tpu_torch.transforms import multilevel as ml

    n = 65536
    rows = ml.SYMMETRIC_SYNTHESIS_MIN_SAMPLES // n
    for batch, want in ((rows, {"modwt_mxu_analysis": 1, "modwt_symmetric_synthesis": 1}),
                        (rows - 1, {"modwt_mxu_analysis": 1})):
        x = torch.randn(batch, n, device=cuda)
        mc.reset_launches()
        y = vt.imodwt_multilevel(vt.modwt_multilevel(x, "db4", levels=LEVELS,
                                                     boundary="symmetric"),
                                 "db4", boundary="symmetric")
        torch.cuda.synchronize()
        assert {k: v for k, v in mc.LAUNCHES.items() if v} == want, batch
        assert bool(torch.isfinite(y).all())


def test_fft_route_on_both_sides_of_the_thresholds(cuda, monkeypatch):
    """The plain periodic cascade of a CUDA tensor takes the FFT from
    CUDA_FFT_MIN_TAPS taps and CUDA_FFT_MIN_SIGNAL samples, and agrees with
    the rolled CPU route either way."""
    from vectorwave_tpu_torch.ops import facade
    from vectorwave_tpu_torch.transforms import multilevel as ml

    calls = []
    real = ml.fft_analysis_pair
    monkeypatch.setattr(ml, "fft_analysis_pair",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    taps, n = facade.CUDA_FFT_MIN_TAPS, facade.CUDA_FFT_MIN_SIGNAL
    for name, length, fft in ((f"db{taps // 2}", n, True), (f"db{taps // 2 - 1}", n, False),
                              (f"db{taps // 2}", n - 1, False)):
        x = torch.randn(2, length, device=cuda, dtype=torch.float64)  # the plain route
        calls.clear()
        got = vt.modwt_multilevel(x, name, levels=2)
        want = vt.modwt_multilevel(x.cpu(), name, levels=2)
        assert bool(calls) == fft, (name, length)
        for g, w in zip((*got.details, got.approx), (*want.details, want.approx)):
            assert float((g.cpu() - w).abs().max()) <= 1e-12


@pytest.mark.parametrize("taps,spacing,n", [(8, 16, 256), (40, 512, 1 << 20), (76, 512, 1000)])
def test_filter_spectrum_on_the_card_matches_the_cpu(cuda, taps, spacing, n):
    """A spectrum made on the card (taps strided into zeros, or wrapped on
    the host where the filter outgrows n) equals the CPU one within 1e-12,
    in the cache for its device alone."""
    from vectorwave_tpu_torch.ops import convolve

    f = tuple(torch.randn(taps, dtype=torch.float64).tolist())
    got = convolve._filter_spectrum(f, spacing, n, torch.complex128, cuda)
    want = convolve._filter_spectrum(f, spacing, n, torch.complex128, torch.device("cpu"))
    assert got.device.type == "cuda" and want.device.type == "cpu"
    assert float((got.cpu() - want).abs().max()) <= 1e-12
    assert convolve._filter_spectrum(f, spacing, n, torch.complex128, cuda) is got


# --- the mirrored test cases (tools/mirror_cases.py) ------------------------------------


@pytest.mark.parametrize("label", [c.label for c in mirror_cases.cases()]
                         + [c.label for c in mirror_cases.family_cases()])
def test_mirror_case_on_the_card(cuda, label):
    """Each kernel-reaching case of the test mirrors (the MODWT core's, then
    the other kernel families'), at the JAX tests' shapes: under ``auto``
    and under ``backend='kernel'`` against the plain route on the card (2e-5
    in float32; 1e-13 on the exact tier's hi + lo, its round trip within
    1e-10 RMSE; the symmetric interior NRMSE within 10% of the committed
    baseline; the other families at the JAX tests' float32 bounds), each
    direction's launches where its router says, and ``kernel`` refusing only
    where the kernels cannot serve."""
    case = next(c for c in mirror_cases.cases() + mirror_cases.family_cases()
                if c.label == label)
    out = mirror_cases.run_case(case, cuda)
    assert out.ok, out.faults
