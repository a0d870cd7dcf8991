"""Mirrors of the JAX package's filter-bank tests on the port.

``tests/test_bank_kernel.py``, ``tests/test_packets.py``,
``tests/test_dtcwt.py``, ``tests/test_cwt_kernel_direct.py`` and
``tests/test_dtcwt_shrink.py``: the same names, seeds, shapes, wavelets and
boundaries, and the JAX test's own assertions and bounds, run on the port,
which is held to the JAX package besides.  On the CPU the port's kernel tier
(``backend='kernel'``) runs the filter bank's plain versions; the JAX side
runs ``backend='jnp'``, jitted once a shape from a module-scoped fixture
(``jax_refs``).  No JAX Pallas kernel runs here: the port's bank routes are
held to the JAX Pallas bank tier in interpret mode by
``tests/test_torch_packets.py::test_kernel_backend_matches_the_jax_pallas_bank_tier``
and ``tests/test_torch_dtcwt.py::test_bank_routes_match_the_jax_pallas_tier``
(the packet tree at 2 x 2048, the dual tree's whole tree and pairs at
``test_dtcwt_kernel_matches_jnp``'s input).

Tolerances: the JAX tests' own bounds (2e-5 for the bank in float32, 3e-5
for the dual tree, 2e-5 of the largest coefficient for the CWT's tier, 5e-6
of the largest entry for a gradient, 1e-10 for a float64 reconstruction);
else the port against the JAX package 1e-12 in float64 (the same float64
arithmetic in another order, values of order 1), 1e-10 for a denoiser whose
thresholds pass through a sort, and the float32 bound of the test for a
float32 input.  The JAX tests' slow cases run here in tier 1; where a sweep's
JAX references are costly, JAX parity is held on named draws and the
invariant on every draw (each test names its subset).

Differences by design, asserted on both sides: the port's bank routes have
no ``_BANK_CALL_BUDGET``, no ``n % 128`` rule and no span floor, so the
dual tree of 256 samples, the CWT of one 16384-sample row and a batched CWT
are each one bank call where JAX falls back, stands down or chunks rows;
``_kernel_direct_split`` takes the device, not the signal.  The
kernel-reaching cases of these tests (``tools/mirror_cases.family_cases``)
run here too, on CPU tensors, where nothing launches and nothing is refused.
"""

import importlib
import inspect
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from tools import mirror_cases
from vectorwave_tpu.denoise.dtcwt_shrink import _local_power as jax_local_power
from vectorwave_tpu.ops.dwt import dwt as jax_dwt
from vectorwave_tpu.transforms import cwt as jcwt
from vectorwave_tpu.transforms import dtcwt as jdt
from vectorwave_tpu.transforms import packets as jpackets
from vectorwave_tpu.wavelets.qshift import qshift_filters as jax_qshift_filters
from vectorwave_tpu_torch.denoise.dtcwt_shrink import _local_power
from vectorwave_tpu_torch.errors import InvalidArgumentError, VectorWaveError
from vectorwave_tpu_torch.kernels import modwt_bank as mb
from vectorwave_tpu_torch.ops.dwt import dwt, wavedec, waverec
from vectorwave_tpu_torch.transforms import cwt as tcwt
from vectorwave_tpu_torch.transforms import dtcwt as tdt
from vectorwave_tpu_torch.transforms.packets import _validate_basis
from vectorwave_tpu_torch.wavelets.qshift import qshift_filters

torch.set_num_threads(1)

TOL_F64 = 1e-12
TOL_BANK = 2e-5
TOL_DUAL_TREE = 3e-5


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return t.numpy() if t.is_complex() else t.double().numpy()
    return np.asarray(t)


def _maxdiff(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    out = 0.0
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        out = max(out, float(np.max(np.abs(g - w))))
    return out


def _t(x):
    return torch.from_numpy(np.array(x))


def _x(shape=(256,), seed=0):
    """``tests/test_packets.py::_x``: float64 draws."""
    return np.random.default_rng(seed).standard_normal(shape)


def _x32(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


class JaxRefs:
    """The JAX package's jnp results, each function jitted once per static
    arguments (so once a shape) and each result made once per input."""

    def __init__(self):
        self._jits = {}
        self._memo = {}

    def __call__(self, fn, x, *args, **kw):
        key = (fn, args, tuple(sorted(kw.items())))
        if key not in self._jits:
            self._jits[key] = jax.jit(lambda y: fn(y, *args, **kw))
        arr = np.asarray(x)
        memo = key + (arr.tobytes(), arr.shape, arr.dtype.str)
        if memo not in self._memo:
            self._memo[memo] = self._jits[key](jnp.asarray(arr))
        return self._memo[memo]


@pytest.fixture(scope="module")
def jax_refs():
    vw.set_backend("jnp")
    try:
        yield JaxRefs()
    finally:
        vw.set_backend("auto")


@pytest.fixture
def kernel_backend():
    vt.set_backend("kernel")
    try:
        yield
    finally:
        vt.set_backend("auto")


@pytest.fixture
def bank_calls(monkeypatch):
    """The bank wrappers the port's routes call (on a CPU tensor each runs
    its plain version), by name."""
    calls = []
    for fn in ("bank_analysis", "bank_synthesis", "bank_analysis_stacked"):
        real = getattr(mb, fn)
        monkeypatch.setattr(mb, fn, lambda *a, _f=fn, _r=real: (calls.append((_f, a)), _r(*a))[1])
    return calls


def _jax_pallas(fn):
    """``fn`` under the JAX package's Pallas backend in float32, as the JAX
    tests' fixtures set it: here only its gates are asked, so no kernel
    runs."""
    vw.set_backend("pallas")
    vw.set_fused_precision("float32")
    try:
        return fn()
    finally:
        vw.set_backend("jnp")
        vw.set_fused_precision("bf16_3x")


def _dt_coeffs(res):
    return (*res.highpasses, res.lowpass_a, res.lowpass_b)


# --- tests/test_bank_kernel.py --------------------------------------------------------


@pytest.mark.parametrize("boundary", ["periodic", "zero"])
def test_modwpt_kernel_matches_jnp(jax_refs, kernel_backend, bank_calls, boundary):
    """The kernel tier's packet tree (one bank call) within 2e-5 of the JAX
    jnp tree at every level."""
    x = _x32((2, 2048), 0)
    got = vt.modwpt(_t(x), "db4", 3, boundary=boundary)
    assert [c[0] for c in bank_calls] == ["bank_analysis"]
    want = jax_refs(vw.modwpt, x, "db4", 3, boundary=boundary)
    for lvl in range(4):
        assert _maxdiff(got.levels[lvl], want.levels[lvl]) <= TOL_BANK, lvl


def test_imodwpt_kernel_roundtrip(jax_refs, kernel_backend, bank_calls):
    x = _x32(2048, 1)
    tree = vt.modwpt(_t(x), "sym8", 3)
    xr = vt.imodwpt(tree, "sym8")
    assert [c[0] for c in bank_calls] == ["bank_analysis", "bank_synthesis"]
    assert _maxdiff(xr, x) <= TOL_BANK
    assert _maxdiff(tree.leaves, jax_refs(vw.modwpt, x, "sym8", 3).leaves) <= TOL_BANK


def test_modwpt_kernel_grad_flows(kernel_backend):
    """The gradient of the leaves' energy through the bank within 5e-6 of
    its largest entry of jax.grad through the JAX jnp tree."""
    x = _x32(2048, 2)
    xt = _t(x).requires_grad_(True)
    (g,) = torch.autograd.grad((vt.modwpt(xt, "db4", 2).leaves ** 2).sum(), xt)

    def loss(y):
        return jnp.sum(vw.modwpt(y, "db4", 2).leaves ** 2)

    vw.set_backend("jnp")
    try:
        gj = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    finally:
        vw.set_backend("auto")
    assert _maxdiff(g, gj) <= 5e-6 * float(np.abs(gj).max())


def test_dtcwt_kernel_matches_jnp(jax_refs, kernel_backend, bank_calls):
    x = _x32((2, 2048), 3)
    got = vt.dtcwt(_t(x), "sym8", levels=4)
    assert [c[0] for c in bank_calls] == ["bank_analysis"]
    want = jax_refs(vw.dtcwt, x, "sym8", levels=4)
    for j in range(4):
        assert _maxdiff(got.highpasses[j], want.highpasses[j]) <= TOL_DUAL_TREE, j
    assert _maxdiff(got.lowpass_a, want.lowpass_a) <= TOL_DUAL_TREE
    assert _maxdiff(got.lowpass_b, want.lowpass_b) <= TOL_DUAL_TREE


def test_idtcwt_kernel_roundtrip(jax_refs, kernel_backend, bank_calls):
    """The kernel tier's round trip within 3e-5 of x, its coefficients
    within 3e-5 of the JAX jnp dual tree."""
    x = _x32((1, 2048), 4)
    res = vt.dtcwt(_t(x), "sym8", levels=3)
    xr = vt.idtcwt(res, "sym8")
    assert [c[0] for c in bank_calls] == ["bank_analysis", "bank_synthesis"]
    assert _maxdiff(xr, x) <= TOL_DUAL_TREE
    assert _maxdiff(_dt_coeffs(res), _dt_coeffs(jax_refs(vw.dtcwt, x, "sym8", levels=3))
                    ) <= TOL_DUAL_TREE


def test_dtcwt_short_signal_falls_back(jax_refs, kernel_backend, bank_calls):
    """256 samples: below the JAX per-level bank tier's floor (512), so JAX
    falls back there, but its whole-tree gate admits sym8 J=2 (256 % 128 ==
    0 and 256 >= 2 x the span of 41), so JAX's whole tree serves the call,
    as the port's does (the port's bank serves any N, a difference by
    design): one whole-tree call each way, the round trip within 3e-5, the
    coefficients within 3e-5 of JAX's jnp tree."""
    x = _x32(256, 5)
    spans = [max(len(t) for t, _, _ in jdt._composed_tree_planes(
        jdt._tree_stage_filters("sym8", 2, tree))) - 1 for tree in ("a", "b")]
    assert max(spans) == 41
    assert _jax_pallas(lambda: all(jdt._dtcwt_kernel_eligible(256, jnp.float32, s, 1)
                                   for s in spans))
    assert not _jax_pallas(lambda: jdt._decimated_bank_ok(256, jnp.float32))
    res = vt.dtcwt(_t(x), "sym8", levels=2)
    xr = vt.idtcwt(res, "sym8")
    assert [c[0] for c in bank_calls] == ["bank_analysis", "bank_synthesis"]
    assert _maxdiff(xr, x) <= TOL_DUAL_TREE
    assert _maxdiff(_dt_coeffs(res), _dt_coeffs(jax_refs(vw.dtcwt, x, "sym8", levels=2))
                    ) <= TOL_DUAL_TREE


# --- tests/test_packets.py -----------------------------------------------------------


#: the draws of ``test_perfect_reconstruction_periodic`` held to the JAX
#: trees (each a compile of about a second); all ten round trip
RECONSTRUCT_AGAINST_JAX = (("wpt", "db4"), ("modwpt", "bior4.4"), ("wpt", "coif3"))


@pytest.mark.parametrize("wavelet", ["haar", "db4", "sym5", "coif3", "bior4.4"])
@pytest.mark.parametrize("transform,inverse", [("wpt", "iwpt"), ("modwpt", "imodwpt")])
def test_perfect_reconstruction_periodic(jax_refs, wavelet, transform, inverse):
    """Round trip within 1e-10 on every draw; on
    :data:`RECONSTRUCT_AGAINST_JAX` every level within 1e-12 of JAX's."""
    x = _x()
    tree = getattr(vt, transform)(_t(x), wavelet, 3)
    xr = getattr(vt, inverse)(tree, wavelet)
    assert _maxdiff(xr, x) < 1e-10
    if (transform, wavelet) in RECONSTRUCT_AGAINST_JAX:
        want = jax_refs(getattr(vw, transform), x, wavelet, 3)
        assert _maxdiff(tree.levels, want.levels) <= TOL_F64


def test_wpt_depth1_is_dwt():
    x = _x()
    tree = vt.wpt(_t(x), "db4", 1)
    ref = dwt(_t(x), "db4")
    assert torch.equal(tree.node(1, 0), ref.approx)
    assert torch.equal(tree.node(1, 1), ref.detail)
    jref = jax_dwt(jnp.asarray(x), "db4")
    assert _maxdiff((tree.node(1, 0), tree.node(1, 1)), (jref.approx, jref.detail)) <= TOL_F64


def test_modwpt_depth1_is_modwt():
    x = _x()
    tree = vt.modwpt(_t(x), "db4", 1)
    ref = vt.modwt(_t(x), "db4")
    assert torch.equal(tree.node(1, 0), ref.approx)
    assert torch.equal(tree.node(1, 1), ref.detail)
    jref = vw.modwt(jnp.asarray(x), "db4")
    assert _maxdiff((tree.node(1, 0), tree.node(1, 1)), (jref.approx, jref.detail)) <= TOL_F64


@pytest.mark.parametrize("transform", ["wpt", "modwpt"])
def test_energy_preserved_every_depth(jax_refs, transform):
    """Each depth a tight frame (relative 1e-12); the MODWPT's energy maps
    within 1e-10 of JAX's (sums of 256 squares of order 1; the decimated
    tree's JAX parity is held by ``test_tree_shapes_and_flags``)."""
    x = _x(seed=3)
    tree = getattr(vt, transform)(_t(x), "db6", 4)
    total = float((x ** 2).sum())
    for j in range(1, 5):
        assert float(tree.energy_map(j).sum()) == pytest.approx(total, rel=1e-12)
    if transform == "modwpt":
        want = jax_refs(vw.modwpt, x, "db6", 4)
        for j in range(1, 5):
            assert _maxdiff(tree.energy_map(j), want.energy_map(j)) <= 1e-10


def test_tree_shapes_and_flags(jax_refs):
    """The JAX test is marked slow; here in tier 1."""
    x = _x((5, 128))
    t = vt.wpt(_t(x), "db4", 3)
    assert [tuple(lvl.shape) for lvl in t.levels] == [(5, 1, 128), (5, 2, 64), (5, 4, 32),
                                                      (5, 8, 16)]
    assert t.is_decimated and t.depth == 3
    m = vt.modwpt(_t(x), "db4", 2)
    assert [tuple(lvl.shape) for lvl in m.levels] == [(5, 1, 128), (5, 2, 128), (5, 4, 128)]
    assert not m.is_decimated
    assert _maxdiff(t.leaves, jax_refs(vw.wpt, x, "db4", 3).leaves) <= TOL_F64
    assert _maxdiff(m.leaves, jax_refs(vw.modwpt, x, "db4", 2).leaves) <= TOL_F64


def test_batch_matches_single(jax_refs):
    xs = _x((4, 256), seed=9)
    batched = vt.modwpt(_t(xs), "sym4", 3)
    for b in range(4):
        single = vt.modwpt(_t(xs[b]), "sym4", 3)
        assert torch.equal(batched.leaves[b], single.leaves)
    assert _maxdiff(batched.leaves, jax_refs(vw.modwpt, xs, "sym4", 3).leaves) <= TOL_F64


#: the tones held to the JAX energy maps: the lowest and the highest (every
#: JAX tree of a tone is a compile; the invariant holds on all eight)
TONES_AGAINST_JAX = (0, 7)


@pytest.mark.parametrize("transform", ["wpt", "modwpt"])
def test_frequency_order_monotone_tones(jax_refs, transform):
    """The JAX test is marked slow; here in tier 1.  The peak leaf in
    frequency order rises with the tone on all eight tones, from leaf 0 to
    leaf 7; the energy maps of :data:`TONES_AGAINST_JAX` within 1e-10 of
    JAX's."""
    peaks = []
    for i, f in enumerate(np.linspace(0.02, 0.48, 8)):
        tone = np.sin(2 * np.pi * f * np.arange(512))
        tr = getattr(vt, transform)(_t(tone), "db8", 3)
        energies = tr.energy_map().numpy()[vt.frequency_order(3)]
        peaks.append(int(np.argmax(energies)))
        if i in TONES_AGAINST_JAX:
            want = jax_refs(getattr(vw, transform), tone, "db8", 3).energy_map()
            assert _maxdiff(tr.energy_map(), want) <= 1e-10
    assert peaks == sorted(peaks)
    assert peaks[0] == 0 and peaks[-1] == 7


def test_frequency_order_is_permutation():
    for level in range(6):
        order = vt.frequency_order(level)
        assert sorted(order.tolist()) == list(range(1 << level))
        np.testing.assert_array_equal(order, vw.frequency_order(level))


def test_packet_frequency_bands_tile_nyquist():
    bands = vt.packet_frequency_bands(3, sampling_rate=2.0)
    assert bands.shape == (8, 2)
    edges = bands[vt.frequency_order(3)]
    np.testing.assert_allclose(edges[:, 0], np.arange(8) / 8.0)
    np.testing.assert_allclose(edges[:, 1], (np.arange(8) + 1) / 8.0)
    np.testing.assert_allclose(bands, vw.packet_frequency_bands(3, sampling_rate=2.0),
                               rtol=0, atol=TOL_F64)


def _all_admissible_bases(depth):
    """``tests/test_packets.py::_all_admissible_bases``."""
    if depth == 0:
        return [[(0, 0)]]

    def expand(level, idx, remaining):
        if remaining == 0:
            return [[(level, idx)]]
        splits = [a + b for a in expand(level + 1, 2 * idx, remaining - 1)
                  for b in expand(level + 1, 2 * idx + 1, remaining - 1)]
        return [[(level, idx)]] + splits

    return expand(0, 0, depth)


@pytest.mark.parametrize("cost", ["shannon", "log_energy", "threshold", "l1"])
def test_best_basis_is_brute_force_optimal(jax_refs, cost):
    """The JAX test is marked slow; here in tier 1.  The port's basis costs
    the brute-force minimum (relative 1e-9) and is JAX's basis."""
    x = _x((192,), seed=11) * np.sin(2 * np.pi * 0.21 * np.arange(192))
    tree = vt.modwpt(_t(x), "db4", 2)
    basis = vt.best_basis(tree, cost=cost, threshold=0.2)
    _validate_basis(basis, 2)

    def basis_cost(b):
        total = 0.0
        root_energy = float((x ** 2).sum()) + 1e-30
        for level, idx in b:
            c = tree.node(level, idx).numpy()
            p = c ** 2 / root_energy
            if cost == "shannon":
                total += float(-(p * np.log(p + 1e-30)).sum())
            elif cost == "log_energy":
                total += float(np.log(p + 1e-30).sum())
            elif cost == "threshold":
                total += float((np.abs(c) > 0.2).sum())
            else:
                total += float(np.abs(c).sum())
        return total

    best = min(basis_cost(b) for b in _all_admissible_bases(2))
    assert basis_cost(list(basis)) == pytest.approx(best, rel=1e-9)
    jtree = jax_refs(vw.modwpt, x, "db4", 2)
    assert tuple(basis) == tuple(vw.best_basis(jtree, cost=cost, threshold=0.2))


def test_best_basis_callable_cost(jax_refs):
    x = _x()
    tree = vt.wpt(_t(x), "db4", 2)
    basis = vt.best_basis(tree, cost=lambda node: node.abs().sum())
    _validate_basis(basis, 2)
    jbasis = vw.best_basis(jax_refs(vw.wpt, x, "db4", 2), cost=lambda node: jnp.abs(node).sum())
    assert tuple(basis) == tuple(jbasis)


@pytest.mark.parametrize("transform", ["wpt", "modwpt"])
def test_reconstruct_from_best_basis_exact(jax_refs, transform):
    """The JAX test is marked slow; here in tier 1.  The Shannon basis is
    JAX's; it and the mixed-depth basis reconstruct within 1e-10 (as JAX's
    do: the JAX test's contract)."""
    x = _x(seed=5)
    tree = getattr(vt, transform)(_t(x), "sym6", 3)
    basis = vt.best_basis(tree, cost="shannon")
    jtree = jax_refs(getattr(vw, transform), x, "sym6", 3)
    assert tuple(basis) == tuple(vw.best_basis(jtree, cost="shannon"))
    for b in (basis, [(1, 0), (2, 2), (3, 6), (3, 7)]):
        assert _maxdiff(vt.reconstruct_basis(tree, b, "sym6"), x) < 1e-10


def test_reconstruct_basis_node_hook_denoises(jax_refs):
    rng = np.random.default_rng(8)
    clean = np.sin(2 * np.pi * 0.03 * np.arange(512))
    x = clean + 0.3 * rng.standard_normal(512)
    tree = vt.modwpt(_t(x), "sym8", 3)
    thr = 0.15

    def soft(level, idx, c):
        if level < 3:
            return c
        return c.sign() * (c.abs() - thr).clamp(min=0.0)

    def jsoft(level, idx, c):
        if level < 3:
            return c
        return jnp.sign(c) * jnp.maximum(jnp.abs(c) - thr, 0.0)

    leaves = [(3, i) for i in range(8)]
    den = vt.reconstruct_basis(tree, leaves, "sym8", transform_nodes=soft)
    noise_in = float(((x - clean) ** 2).mean())
    noise_out = float(((den.numpy() - clean) ** 2).mean())
    assert noise_out < 0.5 * noise_in
    want = jax.jit(lambda t: vw.reconstruct_basis(t, leaves, "sym8", transform_nodes=jsoft))(
        jax_refs(vw.modwpt, x, "sym8", 3))
    assert _maxdiff(den, want) <= TOL_F64


def test_basis_coefficients_order(jax_refs):
    x = _x()
    tree = vt.wpt(_t(x), "db4", 2)
    basis = ((1, 0), (2, 2), (2, 3))
    coeffs = vt.basis_coefficients(tree, basis)
    assert len(coeffs) == 3
    assert coeffs[0].shape[-1] == 128 and coeffs[1].shape[-1] == 64
    assert _maxdiff(coeffs, vw.basis_coefficients(jax_refs(vw.wpt, x, "db4", 2), basis)
                    ) <= TOL_F64


def test_error_paths():
    """Each bad call raises in both packages."""
    x = _x()
    for lib, arr, err in ((vt, _t, InvalidArgumentError),
                          (vw, jnp.asarray, vw.InvalidArgumentError)):
        with pytest.raises(err):
            lib.wpt(arr(x), "db4", 0)
        with pytest.raises(err):
            lib.wpt(arr(np.ones(250)), "db4", 3)  # not divisible by 8
        tree = lib.wpt(arr(np.ones(64)), "db4", 2)
        with pytest.raises(err):
            lib.reconstruct_basis(tree, [(1, 0)], "db4")  # gap
        with pytest.raises(err):
            lib.reconstruct_basis(tree, [(1, 0), (1, 1), (2, 3)], "db4")  # overlap
        with pytest.raises(err):
            lib.reconstruct_basis(tree, [(5, 0)], "db4")  # outside tree
        with pytest.raises(err):
            lib.best_basis(tree, cost="nope")


def test_denoise_packet_beats_modwt_on_highband_tone():
    """The JAX test is marked slow; here in tier 1.  The port's packet
    denoise keeps the tone the MODWT denoiser loses (MSE under 0.75 of it).
    JAX parity of ``denoise_packet`` on this draw is held by
    ``test_torch_denoise.py::test_denoise_packet_keeps_a_high_band_tone_the_modwt_denoiser_loses``,
    and for every named cost, method, mode and boundary by the tests beside
    it (each JAX denoiser is a compile of seconds)."""
    rng = np.random.default_rng(14)
    t = np.arange(2048)
    clean = np.sin(2 * np.pi * 0.41 * t) + np.sin(2 * np.pi * 0.02 * t)
    x = clean + 0.5 * rng.standard_normal(2048)
    packet = vt.denoise_packet(_t(x), "sym8", 4)
    modwt = vt.denoise_multilevel(_t(x), "sym8", levels=4)
    mse = [float(((p.numpy() - clean) ** 2).mean()) for p in (packet, modwt)]
    assert mse[0] < 0.75 * mse[1]


def test_denoise_packet_smooth_signal():
    """The JAX test's bound (JAX parity: see above)."""
    rng = np.random.default_rng(15)
    t = np.arange(2048)
    clean = 2 * np.sin(2 * np.pi * 0.02 * t) * np.exp(-(((t - 1024) / 600) ** 2))
    x = clean + 0.5 * rng.standard_normal(2048)
    den = vt.denoise_packet(_t(x), "sym8", 4)
    assert float(((den.numpy() - clean) ** 2).mean()) < 0.2 * float(((x - clean) ** 2).mean())


def test_denoise_packet_noiseless_near_identity():
    """Within 0.05 of x (the JAX test's bound)."""
    x = np.sin(2 * np.pi * 0.01 * np.arange(1024))
    assert _maxdiff(vt.denoise_packet(_t(x), "db4", 3), x) < 0.05


# --- tests/test_dtcwt.py -------------------------------------------------------------


def test_qshift_filters_exactly_orthonormal():
    h, g = qshift_filters()
    jh, jg = jax_qshift_filters()
    np.testing.assert_allclose(h, jh, rtol=0, atol=1e-15)
    np.testing.assert_allclose(g, jg, rtol=0, atol=1e-15)
    assert len(h) == 14
    assert abs(h.sum() - np.sqrt(2)) < 1e-12
    assert abs((h * h).sum() - 1.0) < 1e-12
    for k in range(2, 14, 2):
        assert abs(np.dot(h[:-k], h[k:])) < 1e-12
        assert abs(np.dot(g[:-k], g[k:])) < 1e-12
    assert abs(np.dot(h, g)) < 1e-12
    assert abs((h * (-1.0) ** np.arange(14)).sum()) < 1e-12


def test_qshift_quarter_sample_delay():
    h, _ = qshift_filters()
    w = np.linspace(0.05, 0.45 * np.pi, 200)
    spec = np.exp(-1j * np.outer(w, np.arange(14))) @ h
    dev = np.abs(np.angle(spec * np.exp(1j * w * (13 / 2 - 0.25))))
    assert dev.max() < 0.06


#: the draw of ``test_perfect_reconstruction`` held to the JAX coefficients
#: (each JAX dual tree is a compile of seconds; the invariants hold on all six)
RECONSTRUCTION_AGAINST_JAX = (3, (3, 512))


@pytest.mark.parametrize("levels", [1, 3, 5])
@pytest.mark.parametrize("shape", [(512,), (3, 512)])
def test_perfect_reconstruction(jax_refs, levels, shape):
    """The JAX test is marked slow; here in tier 1.  Float32: the round trip
    within 1e-5, complex highpasses of N/2 at level 1; on
    :data:`RECONSTRUCTION_AGAINST_JAX` the coefficients within 3e-5 of
    JAX's."""
    x = _x32(shape, 0)
    res = vt.dtcwt(_t(x), levels=levels)
    xr = vt.idtcwt(res)
    assert _maxdiff(xr, x) < 1e-5
    assert tuple(res.highpasses[0].shape) == shape[:-1] + (shape[-1] // 2,)
    assert res.highpasses[0].is_complex()
    if (levels, shape) == RECONSTRUCTION_AGAINST_JAX:
        assert _maxdiff(_dt_coeffs(res), _dt_coeffs(jax_refs(vw.dtcwt, x, levels=levels))
                        ) <= TOL_DUAL_TREE


def test_energy_identity(jax_refs):
    x = _x(1024, seed=1)
    res = vt.dtcwt(_t(x), levels=4)
    total = sum(float((z.abs() ** 2).sum()) for z in res.highpasses)
    total += 0.5 * float((res.lowpass_a ** 2).sum() + (res.lowpass_b ** 2).sum())
    assert total == pytest.approx(float((x ** 2).sum()), rel=1e-5)
    assert _maxdiff(_dt_coeffs(res), _dt_coeffs(jax_refs(vw.dtcwt, x, levels=4))) <= TOL_F64


def _recon_level(x, j, levels=4):
    """``tests/test_dtcwt.py::_recon_level`` on the port."""
    res = vt.dtcwt(_t(x), levels=levels)
    hp = tuple(z if k == j - 1 else torch.zeros_like(z) for k, z in enumerate(res.highpasses))
    return vt.idtcwt(vt.DTCWTResult(hp, torch.zeros_like(res.lowpass_a),
                                    torch.zeros_like(res.lowpass_b))).numpy()


def _recon_level_dwt(x, j, levels=4):
    dec = wavedec(_t(x), "sym8", levels=levels)
    det = tuple(d if k == j - 1 else torch.zeros_like(d) for k, d in enumerate(dec.details))
    return waverec(dec._replace(details=det, approx=torch.zeros_like(dec.approx)),
                   "sym8").numpy()


def test_near_shift_invariance_vs_dwt(jax_refs):
    """The JAX test is marked slow; here in tier 1.  Every level and shift
    of the JAX test (the invariant on all 24 draws); JAX parity of the
    unshifted signal's tree, which every level's reconstruction edits, 1e-12."""
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal(256)
    assert _maxdiff(_dt_coeffs(vt.dtcwt(_t(x0), levels=4)),
                    _dt_coeffs(jax_refs(vw.dtcwt, x0, levels=4))) <= TOL_F64
    for j, bound in ((2, 0.12), (3, 0.25), (4, 0.25)):
        base = _recon_level(x0, j)
        base_d = _recon_level_dwt(x0, j)
        dev = max(np.linalg.norm(_recon_level(np.roll(x0, s), j) - np.roll(base, s))
                  / np.linalg.norm(base) for s in range(1, 9))
        dev_dwt = max(np.linalg.norm(_recon_level_dwt(np.roll(x0, s), j) - np.roll(base_d, s))
                      / np.linalg.norm(base_d) for s in range(1, 9))
        assert dev < bound, (j, dev)
        assert dev_dwt > 3 * dev, (j, dev, dev_dwt)


def test_magnitude_envelope_smooth_for_tone(jax_refs):
    tone = np.cos(2 * np.pi * 0.04 * np.arange(1024))
    res = vt.dtcwt(_t(tone), levels=5)
    energies = [float((z.abs() ** 2).sum()) for z in res.highpasses]
    j = int(np.argmax(energies)) + 1
    mag = res.highpasses[j - 1].abs().numpy()[16:-16]
    assert (mag.max() - mag.min()) / mag.mean() < 0.25
    dec = wavedec(_t(tone), "sym8", levels=5)
    mag_dwt = np.abs(dec.details[j - 1].numpy())[16:-16]
    assert (mag_dwt.max() - mag_dwt.min()) / mag_dwt.mean() > 1.0
    assert _maxdiff(_dt_coeffs(res), _dt_coeffs(jax_refs(vw.dtcwt, tone, levels=5))) <= TOL_F64


def test_coefficient_delay_aligns_features():
    """Float32, as the JAX test: the envelope peak lands within 2^(j+1)
    samples of the burst; the delays equal JAX's (the highpasses' JAX
    parity in float32 is held by ``test_dtcwt_kernel_matches_jnp``)."""
    t = np.arange(1024)
    x = (np.exp(-0.5 * ((t - 400) / 30.0) ** 2) * np.cos(2 * np.pi * 0.05 * t)).astype(
        np.float32)
    res = vt.dtcwt(_t(x), levels=5)
    energies = [float((z.abs() ** 2).sum()) for z in res.highpasses]
    j = int(np.argmax(energies)) + 1
    mag = res.highpasses[j - 1].abs().numpy()
    shift = round(vt.coefficient_delay(j))
    peak = (int(np.argmax(np.roll(mag, shift))) * (1 << j)) % 1024
    assert abs(peak - 400) <= 2 * (1 << j)
    for level in range(1, 6):
        assert vt.coefficient_delay(level) == pytest.approx(vw.coefficient_delay(level),
                                                            rel=1e-15)


def test_validation_and_max_levels():
    assert vt.dtcwt_max_levels(1024) == vw.dtcwt_max_levels(1024) == 6
    for lib, arr, err in ((vt, torch.zeros, VectorWaveError), (vw, jnp.zeros, vw.VectorWaveError)):
        with pytest.raises(err):
            lib.dtcwt(arr(100), levels=3)  # 100 not divisible by 8
        with pytest.raises(err):
            lib.dtcwt(arr(64), levels=0)
        with pytest.raises(err):
            lib.dtcwt(arr(64), "bior2.2", levels=2)  # not orthogonal


def test_decimated_bank_cascade_matches_jnp(jax_refs, kernel_backend, bank_calls, monkeypatch):
    """The per-level bank pairs (the whole-tree calls patched out, as the
    JAX test does): two bank calls a level each way, within 2e-5 of the JAX
    jnp cascade, the inverse within 5e-5 of x (which the JAX jnp inverse
    gives back to float32 round-off).  Both packages' stage gates admit 4096
    float32 samples."""
    x = _x32((2, 4096), 9)
    ref = jax_refs(vw.dtcwt, x, "sym8", levels=3)
    assert _jax_pallas(lambda: jdt._decimated_bank_ok(4096, jnp.float32))
    monkeypatch.setattr(tdt, "_dtcwt_kernel_analysis", lambda *a, **k: None)
    monkeypatch.setattr(tdt, "_dtcwt_kernel_synthesis", lambda *a, **k: None)
    h, g = tdt._stage_filters(*tdt._level1("sym8"), 1)[:2]
    assert tdt._decimated_bank_ok(_t(x), h, g)
    got = vt.dtcwt(_t(x), "sym8", levels=3)
    assert [c[0] for c in bank_calls] == ["bank_analysis"] * 6
    assert _maxdiff(got.highpasses, ref.highpasses) <= 2e-5
    assert _maxdiff(got.lowpass_a, ref.lowpass_a) <= 2e-5
    inv = vt.idtcwt(got, "sym8")
    assert [c[0] for c in bank_calls[6:]] == ["bank_synthesis"] * 6
    assert _maxdiff(inv, x) <= 5e-5


# --- tests/test_cwt_kernel_direct.py -------------------------------------------------


def _cwt_ref(jax_refs, x, scales):
    return jax_refs(lambda y: vw.cwt(y, scales, "morl", boundary="periodic").coeffs, x)


def _rel(got, want):
    return _maxdiff(got, want) / float(np.abs(np.asarray(want)).max())


def test_hybrid_matches_fft_path(jax_refs, kernel_backend, bank_calls):
    """Every scale through the kernel-direct tier (one bank call), within
    2e-5 of the largest coefficient of the JAX FFT path."""
    x = _x32(16384, 0)
    scales = tuple(np.geomspace(2.0, 64.0, 8).tolist())
    w = tcwt._resolve_continuous("morl")
    assert tcwt._kernel_direct_split(torch.device("cpu"), w, scales, "periodic",
                                     torch.float32) == 8
    got = vt.cwt(_t(x), scales, "morl", boundary="periodic")
    assert [c[0] for c in bank_calls] == ["bank_analysis_stacked"]
    assert _rel(got.coeffs, _cwt_ref(jax_refs, x, scales)) <= 2e-5


def test_hybrid_split_mixed_scales(jax_refs, kernel_backend):
    """The two leading scales go kernel-direct in both packages, the one
    past the cap to the FFT path; the rows line up within 2e-5 of the
    largest coefficient of the JAX FFT path."""
    w = tcwt._resolve_continuous("morl")
    jw = jcwt._resolve_continuous("morl")
    big_scale = (jcwt._KERNEL_DIRECT_MAX_HALF // 4) * 4
    assert tcwt.KERNEL_DIRECT_MAX_HALF == jcwt._KERNEL_DIRECT_MAX_HALF
    scales = (4.0, 16.0, float(big_scale))
    x = _x32(16384, 1)
    assert tcwt._kernel_direct_split(torch.device("cpu"), w, scales, "periodic",
                                     torch.float32) == 2
    assert _jax_pallas(lambda: jcwt._kernel_direct_split(jnp.asarray(x), jw, scales,
                                                         "periodic", jnp.float32)) == 2
    assert tcwt._half_support(scales[2], w.bandwidth) > tcwt.KERNEL_DIRECT_MAX_HALF
    assert jcwt._half_support(scales[2], jw.bandwidth) > jcwt._KERNEL_DIRECT_MAX_HALF
    got = vt.cwt(_t(x), scales, "morl", boundary="periodic")
    assert _rel(got.coeffs, _cwt_ref(jax_refs, x, scales)) <= 2e-5


def test_batched_rows_chunk_under_bank_budget(jax_refs, kernel_backend, bank_calls,
                                             monkeypatch):
    """Under a bank budget of 8192 samples JAX row-chunks a 4 x 8192 CWT
    (one row a call); the port has no budget (a difference by design): its
    tier makes one bank call on all four rows, within 2e-5 of the largest
    coefficient of the JAX FFT path."""
    monkeypatch.setattr(jpackets, "_BANK_CALL_BUDGET", 8192)
    assert jpackets._bank_rows_per_call(4, 8192) == 1
    x = _x32((4, 8192), 3)
    scales = (4.0, 16.0)
    assert _jax_pallas(lambda: jcwt._kernel_direct_split(
        jnp.asarray(x), jcwt._resolve_continuous("morl"), scales, "periodic", jnp.float32)) == 2
    got = vt.cwt(_t(x), scales, "morl", boundary="periodic")
    assert [(c[0], tuple(c[1][0].shape)) for c in bank_calls] == [
        ("bank_analysis_stacked", (4, 8192))]
    assert _rel(got.coeffs, _cwt_ref(jax_refs, x, scales)) <= 2e-5


def test_single_row_over_budget_stands_down(jax_refs, kernel_backend, bank_calls,
                                            monkeypatch):
    """One row longer than JAX's budget: JAX's tier stands down (0 scales);
    the port's serves both scales (a difference by design), its
    coefficients JAX's FFT path's within 2e-5 of the largest."""
    monkeypatch.setattr(jpackets, "_BANK_CALL_BUDGET", 8192)
    x = np.zeros(16384, np.float32)
    scales = (4.0, 16.0)
    assert _jax_pallas(lambda: jcwt._kernel_direct_split(
        jnp.asarray(x), jcwt._resolve_continuous("morl"), scales, "periodic",
        jnp.float32)) == 0
    w = tcwt._resolve_continuous("morl")
    assert tcwt._kernel_direct_split(torch.device("cpu"), w, scales, "periodic",
                                     torch.float32) == 2
    got = vt.cwt(_t(x), scales, "morl", boundary="periodic")
    assert [c[0] for c in bank_calls] == ["bank_analysis_stacked"]
    assert _maxdiff(got.coeffs, _cwt_ref(jax_refs, x, scales)) <= 2e-5


def test_unsorted_scales_keep_fft_path(jax_refs, kernel_backend, bank_calls):
    """Descending scales: both packages' splits give 0, so the whole call
    stays on the FFT path (no bank call), within 1e-5 of JAX's."""
    x = _x32(16384, 2)
    scales = (64.0, 8.0, 2.0)
    w = tcwt._resolve_continuous("morl")
    assert tcwt._kernel_direct_split(torch.device("cpu"), w, scales, "periodic",
                                     torch.float32) == 0
    assert _jax_pallas(lambda: jcwt._kernel_direct_split(
        jnp.asarray(x), jcwt._resolve_continuous("morl"), scales, "periodic",
        jnp.float32)) == 0
    got = vt.cwt(_t(x), scales, "morl", boundary="periodic")
    assert bank_calls == []
    assert _maxdiff(got.coeffs, _cwt_ref(jax_refs, x, scales)) <= 1e-5


# --- tests/test_dtcwt_shrink.py ------------------------------------------------------


def _snr(clean, est):
    return 10 * np.log10(np.sum(clean ** 2) / np.sum((est - clean) ** 2))


def test_1d_beats_noisy_and_universal_modwt():
    """The JAX test is marked slow; here in tier 1.  Float32: the dual-tree
    shrinkage gains 8 dB and beats the universal MODWT denoise by 1 dB.
    JAX parity of ``dtcwt_denoise`` (levels, windows, a given sigma) is held
    by ``test_torch_denoise.py::test_dtcwt_denoise_matches_jax`` (each JAX
    denoiser is a compile of seconds)."""
    rng = np.random.default_rng(0)
    clean = mirror_cases.doppler(2048)
    noisy = (clean + 0.35 * rng.standard_normal(2048)).astype(np.float32)
    den = vt.dtcwt_denoise(_t(noisy), levels=6).numpy()
    den_uni = vt.denoise_multilevel(_t(noisy), "sym8", levels=6).numpy()
    assert _snr(clean, den) > _snr(clean, noisy) + 8
    assert _snr(clean, den) > _snr(clean, den_uni) + 1


def test_2d_beats_separable_denoise():
    """The JAX test is marked slow; here in tier 1.  Float32 128 x 128: the
    2-D dual-tree shrinkage gains 7 dB and beats ``denoise2`` by 1 dB.  JAX
    parity of ``dtcwt2_denoise`` is held by
    ``test_torch_dtcwt2.py::test_dtcwt2_denoise_matches_jax`` (the JAX
    reference compiles for about 25 s at this size)."""
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:128, 0:128]
    img = ((xx - 64) ** 2 + (yy - 64) ** 2 < 1600).astype(np.float64)
    img += 0.5 * np.cos(2 * np.pi * 0.1 * (0.97 * xx + 0.26 * yy)) * (xx > 80)
    img /= img.std()
    noisy = (img + 0.4 * rng.standard_normal((128, 128))).astype(np.float32)
    den = vt.dtcwt2_denoise(_t(noisy), levels=4).numpy()
    den_sep = vt.denoise2(_t(noisy), "sym8", levels=4).numpy()
    assert _snr(img, den) > _snr(img, noisy) + 7
    assert _snr(img, den) > _snr(img, den_sep) + 1


def test_clean_signal_nearly_untouched():
    """Above 15 dB (JAX parity: see above)."""
    clean = mirror_cases.doppler(1024).astype(np.float32)
    assert _snr(clean, vt.dtcwt_denoise(_t(clean), levels=5).numpy()) > 15


def test_local_power_window_is_uniform():
    delta = torch.zeros(32, dtype=torch.float32)
    delta[16] = 7.0
    out = _local_power(delta, 7, (0,)).numpy()
    np.testing.assert_allclose(out[13:20], np.ones(7), rtol=1e-6)
    assert out[12] == 0 and out[20] == 0
    want = np.asarray(jax_local_power(jnp.zeros(32, jnp.float32).at[16].set(7.0), 7, (0,)))
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-6)


def test_batch_and_explicit_sigma():
    """The JAX test is marked slow; here in tier 1.  Float32 2 x 1024 with
    sigma given: each row gains 6 dB (JAX parity: see above)."""
    rng = np.random.default_rng(2)
    d = mirror_cases.doppler(1024)
    clean = np.stack([d, -d])
    noisy = (clean + 0.3 * rng.standard_normal(clean.shape)).astype(np.float32)
    den = vt.dtcwt_denoise(_t(noisy), levels=5, noise_sigma=0.3).numpy()
    assert den.shape == noisy.shape
    for b in range(2):
        assert _snr(clean[b], den[b]) > _snr(clean[b], noisy[b]) + 6


# --- the card's cases, run on the CPU -------------------------------------------------

@pytest.mark.parametrize("label", mirror_cases.family_labels("bank"))
def test_family_case_runs_its_plain_versions_on_the_cpu(label):
    """Each bank case phase 2c runs on the card, here on CPU tensors: within
    its bounds of the plain route, no launch, no refusal."""
    assert not mirror_cases.cpu_problems(label)


def _jax_test_source(source):
    module, name = source.split("::")
    mod = importlib.import_module(f"tests.{module[:-3]}")
    return inspect.getsource(getattr(mod, name)), inspect.getsource(mod)


#: the phase 2c inputs the JAX tests make with a helper, and that helper
JAX_HELPERS = {
    ("doppler",): lambda case: _jax_doppler_input(case),
    ("signal", "image_batch"): lambda case: np.stack(
        [importlib.import_module("tests.test_twodim")._image(seed=s) for s in range(3)]),
    ("noisy",): lambda case: _jax_noisy_input(case),
    ("composite",): lambda case: importlib.import_module("tests.conftest").composite_sin(
        case.shape[-1], noise_std=case.data[1]),
}


def _jax_doppler_input(case):
    doppler = importlib.import_module("tests.test_dtcwt_shrink")._doppler
    _, seed, noise = case.data
    n = case.shape[-1]
    clean = doppler(n) if len(case.shape) == 1 else np.stack([doppler(n), -doppler(n)])
    return clean if seed is None else clean + noise * np.random.default_rng(seed).standard_normal(
        case.shape)


def _jax_noisy_input(case):
    _noisy = importlib.import_module("tests.test_denoise_swt")._noisy
    _, noisy = _noisy(case.shape[-1], noise=case.data[2], seed=case.data[1])
    return noisy if len(case.shape) == 1 else np.stack([noisy, noisy * 0.5])


def test_family_cases_are_the_jax_tests_shapes():
    """Every phase 2c case names a JAX test that exists; an input the JAX
    test makes with a helper equals that helper's (float32 cast); a seeded
    normal draw's seed and every extent of its shape appear in the JAX
    test's source (its decorators included) or its module's helpers."""
    cases = mirror_cases.family_cases()
    assert len({c.label for c in cases}) == len(cases)
    for case in cases:
        src, module_src = _jax_test_source(case.source)
        kind = case.data[0]
        helper = JAX_HELPERS.get(case.data[:2]) or JAX_HELPERS.get(case.data[:1])
        if helper is not None:
            want = np.asarray(helper(case)).astype(case.dtype)
            np.testing.assert_array_equal(mirror_cases.case_input(case), want)
        elif kind in ("normal", "row", "draws"):
            seed = case.data[1]
            assert any(f"{key}{seed}" in text for key in ("default_rng(", "seed=")
                       for text in (src, module_src)), case.label
            shape = case.data[2] if kind == "row" else case.shape
            for extent in shape:
                assert str(extent) in src or str(extent) in module_src, (case.label, extent)
        for extent in case.shape:
            assert str(extent) in src or str(extent) in module_src, (case.label, extent)
        assert case.wavelet in src or case.wavelet in module_src, case.label
