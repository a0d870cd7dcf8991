"""Port parity: wavelet packets (``transforms/packets.py``), mirroring
``tests/test_packets.py`` and the packet half of ``tests/test_bank_kernel.py``.

The same numpy inputs go through the JAX functions and the port's.  In
float64 both run their plain cascades and agree within 1e-12 (the same
arithmetic, values of order 1).  In float32 the port's ``backend='kernel'``
(on the CPU: the filter bank's plain version) is held against the JAX Pallas
bank tier in interpret mode within 2e-5, route by route.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from vectorwave_tpu.transforms import packets as jpackets
from vectorwave_tpu_torch import convert
from vectorwave_tpu_torch.errors import InvalidArgumentError
from vectorwave_tpu_torch.kernels import modwt_bank as mb
from vectorwave_tpu_torch.transforms import packets as tpackets

torch.set_num_threads(1)

TOL_F64, TOL_KERNEL = 1e-12, 2e-5


def _x(shape=(2, 256), seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


def _maxdiff(got, want):
    return float(np.max(np.abs(got.detach().numpy() - np.asarray(want))))


@pytest.fixture
def jax_pallas():
    vw.set_backend("pallas")
    vw.set_fused_precision("float32")
    try:
        yield
    finally:
        vw.set_backend("auto")
        vw.set_fused_precision("bf16_3x")


@pytest.fixture
def kernel_backend():
    vt.set_backend("kernel")
    try:
        yield
    finally:
        vt.set_backend("auto")


@pytest.mark.parametrize("boundary", ["periodic", "zero"])
@pytest.mark.parametrize("wavelet", ["db4", "sym8", "bior4.4", "coif2"])
def test_packet_transforms_match_jax_float64(wavelet, boundary):
    x = _x()
    for forward, inverse, jforward, jinverse in ((vt.wpt, vt.iwpt, vw.wpt, vw.iwpt),
                                                 (vt.modwpt, vt.imodwpt, vw.modwpt, vw.imodwpt)):
        want = jforward(jnp.asarray(x), wavelet, 3, boundary=boundary)
        got = forward(torch.from_numpy(x), wavelet, 3, boundary=boundary)
        assert got.depth == want.depth == 3
        assert got.is_decimated == want.is_decimated
        for g, w in zip(got.levels, want.levels):
            assert g.dtype == torch.float64 and tuple(g.shape) == w.shape
            assert _maxdiff(g, w) <= TOL_F64
        # both inverses read the JAX coefficients, carried across as arrays
        tree = convert.packet_tree_from_arrays([np.asarray(l) for l in want.levels],
                                               device="cpu")
        y_want = jinverse(want, wavelet, boundary=boundary)
        assert _maxdiff(inverse(tree, wavelet, boundary=boundary), y_want) <= TOL_F64
        assert _maxdiff(inverse(tree.leaves, wavelet, boundary=boundary), y_want) <= TOL_F64
        if boundary == "periodic":
            assert _maxdiff(inverse(got, wavelet), x) <= 1e-10
        assert _maxdiff(got.energy_map(2), want.energy_map(2)) <= 1e-10
        assert _maxdiff(got.node(2, 3), want.node(2, 3)) <= TOL_F64


def test_depth_one_is_the_single_level_transform():
    x = torch.from_numpy(_x((256,)))
    tree, ref = vt.wpt(x, "db4", 1), vt.dwt(x, "db4")
    assert torch.equal(tree.node(1, 0), ref.approx) and torch.equal(tree.node(1, 1), ref.detail)
    tree, ref = vt.modwpt(x, "db4", 1), vt.modwt(x, "db4")
    assert torch.equal(tree.node(1, 0), ref.approx) and torch.equal(tree.node(1, 1), ref.detail)


def test_tree_shapes_flags_and_batching():
    x = torch.from_numpy(_x((5, 128)))
    t = vt.wpt(x, "db4", 3)
    assert [tuple(l.shape) for l in t.levels] == [(5, 1, 128), (5, 2, 64), (5, 4, 32),
                                                  (5, 8, 16)]
    assert t.is_decimated and t.depth == 3
    m = vt.modwpt(x, "db4", 2)
    assert [tuple(l.shape) for l in m.levels] == [(5, 1, 128), (5, 2, 128), (5, 4, 128)]
    assert not m.is_decimated
    assert torch.equal(vt.modwpt(x[2], "db4", 2).leaves, m.leaves[2])


@pytest.mark.parametrize("boundary", ["periodic", "zero"])
@pytest.mark.parametrize("route", ["tree", "level"])
def test_kernel_backend_matches_the_jax_pallas_bank_tier(jax_pallas, kernel_backend,
                                                         monkeypatch, route, boundary):
    """Each bank route of the port (on the CPU the bank's plain version)
    against the same route of the JAX package in interpret mode."""
    if route == "level":
        monkeypatch.setattr(tpackets, "TREE_MAX_DEPTH", 0)
        monkeypatch.setattr(jpackets, "_modwpt_tree_kernel", lambda *a, **k: None)
        monkeypatch.setattr(jpackets, "_imodwpt_tree_kernel", lambda *a, **k: None)
    calls = []
    for fn in ("bank_analysis", "bank_synthesis"):
        real = getattr(mb, fn)
        monkeypatch.setattr(mb, fn, lambda *a, _f=fn, _r=real: (calls.append(_f), _r(*a))[1])
    x = _x((2, 2048), seed=1).astype(np.float32)
    want = vw.modwpt(jnp.asarray(x), "db4", 3, boundary=boundary)
    got = vt.modwpt(torch.from_numpy(x), "db4", 3, boundary=boundary)
    each = 1 if route == "tree" else 3
    assert calls == ["bank_analysis"] * each
    for g, w in zip(got.levels, want.levels):
        assert g.dtype == torch.float32 and _maxdiff(g, w) <= TOL_KERNEL
    y_want = vw.imodwpt(want, "db4", boundary=boundary)
    tree = convert.packet_tree_from_arrays([np.asarray(l) for l in want.levels], device="cpu")
    y = vt.imodwpt(tree, "db4", boundary=boundary)
    assert calls[each:] == ["bank_synthesis"] * each
    assert _maxdiff(y, y_want) <= TOL_KERNEL
    if boundary == "periodic":
        assert _maxdiff(y, x) <= TOL_KERNEL


def test_kernel_backend_gradient_matches_the_plain_route(kernel_backend):
    x = torch.from_numpy(_x((2, 512), seed=2).astype(np.float32)).requires_grad_(True)
    (g,) = torch.autograd.grad((vt.modwpt(x, "db4", 2).leaves ** 2).sum(), x)
    vt.set_backend("torch")
    (want,) = torch.autograd.grad((vt.modwpt(x, "db4", 2).leaves ** 2).sum(), x)
    assert float((g - want).abs().max()) <= 5e-6 * float(want.abs().max())


def test_routing_gates_on_both_sides(kernel_backend, monkeypatch):
    """What is left of the JAX gates: the boundary, the dtype, the depth one
    launch holds (62 planes at depth 5) and the window that fits shared
    memory.  The TPU's row chunking and its N % 128 and N >= 256 floors are
    gone: one call serves any batch and any N."""
    calls = []
    real = mb.bank_analysis
    monkeypatch.setattr(mb, "bank_analysis",
                        lambda x, dense, per: (calls.append(len(dense)), real(x, dense, per))[1])
    x32 = torch.from_numpy(_x((1, 66), seed=3).astype(np.float32))
    vt.modwpt(x32, "db4", 2)                       # N = 66: neither 128-aligned nor >= 256
    assert calls == [6]
    vt.modwpt(x32, "db4", 2, boundary="zero")
    assert calls == [6, 6]
    vt.modwpt(x32, "db4", 2, boundary="symmetric")  # no bank for the symmetric edge
    vt.modwpt(x32.double(), "db4", 2)               # float64 keeps the cascade
    assert calls == [6, 6]
    vt.modwpt(x32.bfloat16(), "haar", 1)            # bfloat16 is served
    assert calls == [6, 6, 2]
    del calls[:]
    vt.modwpt(x32, "haar", 5)                       # depth 5: 62 planes, one launch
    assert calls == [62]
    vt.modwpt(x32, "haar", 6)                       # depth 6: 126 planes, so pairs
    assert calls == [62] + [2] * 6
    assert tpackets.TREE_MAX_DEPTH == 5
    vt.set_backend("torch")
    vt.modwpt(x32, "haar", 2)
    vt.set_backend("auto")                          # no card here: the cascade
    vt.modwpt(x32, "haar", 2)
    assert calls == [62] + [2] * 6
    # on the card, a window too wide for shared memory: the tree route steps
    # aside and the pair route lets the kernel wrapper raise
    meta = torch.zeros(1, 64, device="meta")
    wide = ((0.0,) * 60000 + (1.0,),)
    assert not tpackets._bank_serves(meta, wide, "kernel")
    assert tpackets._bank_serves(x32, wide, "kernel") and not mb.bank_fits(wide)
    assert tpackets._bank_serves(meta, ((1.0,),), "auto")


def test_the_whole_tree_gate_on_both_sides_of_the_measured_work():
    """``auto`` takes the whole tree up to AUTO_TREE_MAX_WORK FMAs (samples
    times the analysis tree's taps) and the per-level pairs beyond, where
    they measured faster on an H100: the sym8 tree to depth 4 at 64 x 16384
    and to depth 2 at 128 x 65536; ``kernel`` takes it to TREE_MAX_DEPTH."""
    w = vt.wavelet("sym8")
    taps = {d: mb.bank_taps(tpackets._tree_dense(w, d, True)).nonzeros for d in range(1, 6)}
    assert taps == {1: 32, 2: 216, 3: 1064, 4: 4680, 5: 19592}
    edge = tpackets.AUTO_TREE_MAX_WORK // taps[4]
    assert tpackets._use_tree(4, "auto", edge, w)
    assert not tpackets._use_tree(4, "auto", edge + 1, w)
    for (b, n), tree in (((64, 16384), (1, 2, 3, 4)), ((128, 65536), (1, 2)), ((1, 1024),
                                                                                (1, 2, 3, 4, 5))):
        for depth in range(1, 6):
            assert tpackets._use_tree(depth, "auto", b * n, w) == (depth in tree), (b, n, depth)
            assert tpackets._use_tree(depth, "kernel", b * n, w)
    assert not tpackets._use_tree(6, "kernel", 1024, w)
    assert not tpackets._use_tree(6, "auto", 1024, w)


def test_packet_plane_filters_match_jax_and_compose_the_cascade():
    for name, dec in (("sym8", True), ("bior4.4", False)):
        ours = tpackets._packet_plane_filters(vt.wavelet(name), 3, dec)
        ref = jpackets._packet_plane_filters(vw.wavelet(name), 3, dec)
        for lo, lr in zip(ours, ref):
            assert len(lo) == len(lr)
            for a, b in zip(lo, lr):
                np.testing.assert_array_equal(a, b)
    taps = [len(t) for lvl in tpackets._packet_plane_filters(vt.wavelet("sym8"), 4) for t in lvl]
    assert sorted(set(taps)) == [16, 46, 106, 226] and sum(taps) == 4680
    assert tpackets._upsampled_taps(np.array([1.0, 2.0, 3.0]), 4) == (
        1.0, 0.0, 0.0, 0.0, 2.0, 0.0, 0.0, 0.0, 3.0)


def test_frequency_order_and_bands_match_jax():
    for level in range(6):
        np.testing.assert_array_equal(vt.frequency_order(level), vw.frequency_order(level))
        np.testing.assert_array_equal(vt.packet_frequency_bands(level, 2.0),
                                      vw.packet_frequency_bands(level, 2.0))
    peaks = []
    for f in np.linspace(0.02, 0.48, 8):
        tone = torch.from_numpy(np.sin(2 * np.pi * f * np.arange(512)))
        energies = vt.modwpt(tone, "db8", 3).energy_map().numpy()[vt.frequency_order(3)]
        peaks.append(int(np.argmax(energies)))
    assert peaks == sorted(peaks) and peaks[0] == 0 and peaks[-1] == 7


@pytest.mark.parametrize("cost", ["shannon", "log_energy", "threshold", "risk", "l1"])
@pytest.mark.parametrize("transform", ["wpt", "modwpt"])
def test_best_basis_picks_the_same_basis_as_jax(transform, cost):
    x = _x((3, 192), seed=11) * np.sin(2 * np.pi * 0.21 * np.arange(192))
    want_tree = getattr(vw, transform)(jnp.asarray(x), "db4", 3)
    got_tree = getattr(vt, transform)(torch.from_numpy(x), "db4", 3)
    want = vw.best_basis(want_tree, cost=cost, threshold=0.2)
    got = vt.best_basis(got_tree, cost=cost, threshold=0.2)
    assert got == want
    tpackets._validate_basis(got, 3)
    y = vt.reconstruct_basis(got_tree, got, "db4")
    assert _maxdiff(y, vw.reconstruct_basis(want_tree, want, "db4")) <= TOL_F64
    assert _maxdiff(y, x) <= 1e-10


def test_best_basis_callable_cost_and_the_device_program():
    x = _x((2, 256), seed=12)
    want_tree = vw.modwpt(jnp.asarray(x), "db4", 3)
    got_tree = vt.modwpt(torch.from_numpy(x), "db4", 3)
    want = vw.best_basis(want_tree, cost=lambda node: jnp.abs(node).sum())
    got = vt.best_basis(got_tree, cost=lambda node: node.abs().sum())
    assert got == want == vt.best_basis(got_tree, cost="l1")
    # the on-device dynamic program marks exactly the nodes of that basis
    costs = [lvl.abs().sum(dim=-1).reshape(-1, lvl.shape[-2]).sum(dim=0)
             for lvl in got_tree.levels]
    used = tpackets._device_best_basis_masks(costs, 3, 2)
    marked = {(j, i) for j, mask in enumerate(used) for i in torch.nonzero(mask)[:, 0].tolist()}
    assert marked == set(got)
    for name in ("shannon", "log_energy", "threshold", "risk", "l1"):
        lvl = got_tree.levels[2]
        from vectorwave_tpu.transforms.packets2d import _node_costs as jax_node_costs

        ours = tpackets._node_costs(lvl, name, 0.3, 7.0, axes=(-1,))
        ref = jax_node_costs(jnp.asarray(lvl.numpy()), name, 0.3, 7.0, axes=(-1,))
        assert _maxdiff(ours.double(), ref) <= 1e-9
    with pytest.raises(InvalidArgumentError):
        tpackets._node_costs(got_tree.levels[1], "nope", 0.3, 7.0)


@pytest.mark.parametrize("transform", ["wpt", "modwpt"])
def test_reconstruct_basis_with_transform_nodes_matches_jax(transform):
    x = _x((2, 256), seed=5)
    want_tree = getattr(vw, transform)(jnp.asarray(x), "sym6", 3)
    got_tree = getattr(vt, transform)(torch.from_numpy(x), "sym6", 3)
    mixed = [(1, 0), (2, 2), (3, 6), (3, 7)]
    assert _maxdiff(vt.reconstruct_basis(got_tree, mixed, "sym6"), x) <= 1e-10
    want = vw.reconstruct_basis(
        want_tree, mixed, "sym6",
        transform_nodes=lambda lv, i, c: jnp.sign(c) * jnp.maximum(jnp.abs(c) - 0.1 * lv, 0.0))
    got = vt.reconstruct_basis(
        got_tree, mixed, "sym6",
        transform_nodes=lambda lv, i, c: torch.sign(c) * torch.clamp(c.abs() - 0.1 * lv, min=0))
    assert _maxdiff(got, want) <= TOL_F64
    coeffs = vt.basis_coefficients(got_tree, mixed)
    for c, w in zip(coeffs, vw.basis_coefficients(want_tree, mixed)):
        assert _maxdiff(c, w) <= TOL_F64


def test_error_paths():
    x = torch.from_numpy(_x((256,)))
    with pytest.raises(InvalidArgumentError):
        vt.wpt(x, "db4", 0)
    with pytest.raises(InvalidArgumentError):
        vt.modwpt(x, "db4", 0)
    with pytest.raises(InvalidArgumentError):
        vt.wpt(torch.ones(250), "db4", 3)  # not divisible by 8
    with pytest.raises(InvalidArgumentError):
        vt.imodwpt(torch.ones(3, 64), "db4")  # 3 leaves
    tree = vt.wpt(torch.ones(64), "db4", 2)
    with pytest.raises(InvalidArgumentError):
        vt.reconstruct_basis(tree, [(1, 0)], "db4")  # gap
    with pytest.raises(InvalidArgumentError):
        vt.reconstruct_basis(tree, [(1, 0), (1, 1), (2, 3)], "db4")  # overlap
    with pytest.raises(InvalidArgumentError):
        vt.reconstruct_basis(tree, [(5, 0)], "db4")  # outside tree
    with pytest.raises(InvalidArgumentError):
        vt.best_basis(tree, cost="nope")
    with pytest.raises(InvalidArgumentError):
        vt.modwpt(x, "morl", 2)  # a continuous wavelet: packets need a discrete one


def test_packet_tree_from_arrays_checks_shapes_and_the_device():
    levels = [np.zeros((2, 1, 8)), np.zeros((2, 2, 8))]
    tree = convert.packet_tree_from_arrays(levels, device="cpu")
    assert isinstance(tree, vt.WaveletPacketTree) and tree.depth == 1
    assert tree.levels[1].dtype == torch.float64
    with pytest.raises(InvalidArgumentError):
        convert.packet_tree_from_arrays([np.zeros((2, 1, 8)), np.zeros((2, 3, 8))],
                                        device="cpu")
    with pytest.raises(InvalidArgumentError):
        convert.packet_tree_from_arrays([], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(InvalidArgumentError):
            convert.packet_tree_from_arrays(levels)
