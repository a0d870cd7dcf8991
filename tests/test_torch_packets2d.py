"""Port parity: 2-D wavelet packets (``transforms/packets2d.py``) and
``denoise_packet2``, mirroring ``tests/test_packets2d.py``.

The same seeded numpy images go through the JAX functions (under
``jax.jit`` where they trace, since their eager form compiles op by op) and
the port's.  In float64 both run the same decimated ops and agree within
1e-10; float32 within 1e-5.  The best bases must be equal, node for node.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu_torch as vt
from vectorwave_tpu.denoise.packet import denoise_packet2 as jax_denoise_packet2
from vectorwave_tpu.transforms import packets2d as jp2
from vectorwave_tpu_torch import convert
from vectorwave_tpu_torch.errors import InvalidArgumentError
from vectorwave_tpu_torch.ops.thresholds import apply_threshold
from vectorwave_tpu_torch.transforms.packets import frequency_order
from vectorwave_tpu_torch.transforms.packets2d import _validate_basis2

torch.set_num_threads(1)

TOL, TOL_F32 = 1e-10, 1e-5
COSTS = ("shannon", "log_energy", "threshold", "risk", "l1")


def _x(shape, seed=0, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, np.abs(want).max()))


@functools.lru_cache(maxsize=None)
def _jax_wpt2(wavelet, depth, boundary):
    return jax.jit(lambda z: jp2.wpt2(z, wavelet, depth, boundary=boundary))


def _jax_tree(x, wavelet, depth, boundary="periodic"):
    return _jax_wpt2(wavelet, depth, boundary)(jnp.asarray(x))


@functools.lru_cache(maxsize=None)
def _jax_iwpt2(wavelet, boundary):
    return jax.jit(lambda t: jp2.iwpt2(t, wavelet, boundary=boundary))


@pytest.mark.parametrize("wavelet, boundary, dtype", [
    ("db4", "periodic", np.float64),
    ("bior2.2", "zero", np.float32),
])
def test_quadtree_and_inverse_match_jax(wavelet, boundary, dtype):
    depth = 2
    x = _x((2, 32, 32), seed=3, dtype=dtype)
    tol = TOL if dtype == np.float64 else TOL_F32
    want = _jax_tree(x, wavelet, depth, boundary)
    want_rec = _jax_iwpt2(wavelet, boundary)(want)
    got = vt.wpt2(torch.from_numpy(x), wavelet, depth, boundary=boundary)
    assert got.depth == want.depth == depth
    for g, w in zip(got.levels, want.levels):
        assert g.dtype == torch.from_numpy(x).dtype
        _close(g, w, tol)
    for level in range(depth + 1):
        _close(got.energy_map(level), want.energy_map(level), tol)
    _close(got.node(depth, 3), want.node(depth, 3), tol)
    _close(vt.iwpt2(got, wavelet, boundary=boundary), want_rec, tol)
    # the JAX leaves carried across, inverted by the port
    carried = convert.packet2_tree_from_arrays([np.asarray(v) for v in want.levels], device="cpu")
    _close(vt.iwpt2(carried, wavelet, boundary=boundary), want_rec, tol)
    _close(vt.iwpt2(carried.leaves, wavelet, boundary=boundary), want_rec, tol)
    if boundary == "periodic":
        _close(vt.iwpt2(got, wavelet), x, tol)


@pytest.mark.parametrize("case", [
    "roundtrip", "zero_interior", "level1_is_dwt2", "energy", "separable", "leaf_and_root",
    "hook", "invalid", "batch",
])
def test_quadtree_behaviour(case):
    """The checks of ``tests/test_packets2d.py`` on the port."""
    x = torch.from_numpy(_x((32, 32), seed=11))
    if case == "roundtrip":
        for wavelet in ("db4", "bior2.2"):
            xb = torch.from_numpy(_x((2, 32, 32), seed=1))
            tree = vt.wpt2(xb, wavelet, 3)
            assert tree.depth == 3 and tuple(tree.leaves.shape) == (2, 64, 4, 4)
            _close(vt.iwpt2(tree, wavelet), xb.numpy())
    elif case == "zero_interior":
        rec = vt.iwpt2(vt.wpt2(x, "haar", 2, boundary="zero"), "haar", boundary="zero")
        _close(rec[:28, :28], x.numpy()[:28, :28])
    elif case == "level1_is_dwt2":
        y = x[:16, :16]
        tree = vt.wpt2(y, "db2", 1)
        for k, band in enumerate(vt.dwt2(y, "db2")):
            _close(tree.node(1, k), band.numpy())
    elif case == "energy":
        tree = vt.wpt2(x, "db4", 2)
        for level in range(tree.depth + 1):
            assert float(tree.energy_map(level).sum()) == pytest.approx(float((x**2).sum()),
                                                                        rel=1e-10)
    elif case == "separable":
        u, v = _x(32, seed=2), _x(32, seed=3)
        tree2 = vt.wpt2(torch.from_numpy(np.outer(u, v)), "db3", 2)
        tu, tv = vt.wpt(torch.from_numpy(u), "db3", 2), vt.wpt(torch.from_numpy(v), "db3", 2)
        for idx in (0, 1, 5, 10, 15):
            digits = [(idx >> 2) & 3, idx & 3]
            h_nat = (digits[0] >> 1) * 2 + (digits[1] >> 1)
            w_nat = (digits[0] & 1) * 2 + (digits[1] & 1)
            expect = np.outer(tu.node(2, h_nat).numpy(), tv.node(2, w_nat).numpy())
            _close(tree2.node(2, idx), expect)
    elif case == "leaf_and_root":
        tree = vt.wpt2(x, "sym4", 2)
        for basis in (((0, 0),), tuple((2, i) for i in range(16))):
            _close(vt.reconstruct_basis2(tree, basis, "sym4"), x.numpy(), 1e-9)
    elif case == "hook":
        tree = vt.wpt2(x, "db2", 2)
        rec = vt.reconstruct_basis2(tree, tuple((2, i) for i in range(16)), "db2",
                                    transform_nodes=lambda lvl, idx, c: torch.zeros_like(c))
        assert float(rec.abs().max()) == 0.0
    elif case == "invalid":
        tree = vt.wpt2(x[:16, :16], "haar", 2)
        for basis in (((0, 0), (1, 0)), ((1, 0), (1, 1), (1, 2)), ((3, 0),), ()):
            with pytest.raises(InvalidArgumentError):
                vt.reconstruct_basis2(tree, basis, "haar")
        with pytest.raises(InvalidArgumentError):  # odd dims
            vt.wpt2(torch.zeros(15, 16), "haar", 1)
        with pytest.raises(InvalidArgumentError):  # too deep for the dims
            vt.wpt2(torch.zeros(16, 16), "haar", 5)
        with pytest.raises(InvalidArgumentError):
            vt.packet_frequency_bands2(-1)
    elif case == "batch":
        xb = torch.from_numpy(_x((3, 2, 16, 16), seed=4))
        _close(vt.iwpt2(vt.wpt2(xb, "db2", 2), "db2"), xb.numpy())


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_frequency_bands_equal_jax(level):
    got = vt.packet_frequency_bands2(level, sampling_rate=2.0)
    np.testing.assert_array_equal(got, jp2.packet_frequency_bands2(level, sampling_rate=2.0))
    if level == 2:  # each axis follows the 1-D sequency rule
        inv = np.argsort(frequency_order(2))
        for idx in range(16):
            digits = [(idx >> 2) & 3, idx & 3]
            h_nat = (digits[0] >> 1) * 2 + (digits[1] >> 1)
            np.testing.assert_allclose(got[idx, 0], [inv[h_nat] * 0.25, (inv[h_nat] + 1) * 0.25])
        assert got.min() == 0.0 and got.max() == 1.0


def _texture(n=64, seed=0):
    t = np.linspace(0.0, 1.0, n)
    tex = np.sin(2 * np.pi * 24 * t)[:, None] * np.sin(2 * np.pi * 3 * t)[None, :]
    return tex + 0.01 * _x((n, n), seed=seed)


@functools.lru_cache(maxsize=None)
def _basis_input():
    x = np.stack([_texture(32, seed=1), _x((32, 32), seed=2)])
    return x, _jax_tree(x, "db4", 2)


@pytest.mark.parametrize("cost", COSTS + ("callable",))
def test_best_basis2_equals_jax(cost):
    x, want_tree = _basis_input()
    tree = vt.wpt2(torch.from_numpy(x), "db4", 2)
    if cost == "callable":
        got = vt.best_basis2(tree, lambda p: p.abs().sum() ** 0.5)
        want = jp2.best_basis2(want_tree, lambda p: jnp.abs(p).sum() ** 0.5)
    else:
        got = vt.best_basis2(tree, cost, threshold=0.5)
        want = jp2.best_basis2(want_tree, cost, threshold=0.5)
    assert got == want
    _validate_basis2(got, tree.depth)
    _close(vt.reconstruct_basis2(tree, got, "db4"), x, 1e-9)
    assert len(vt.basis_coefficients2(tree, got)) == len(got)
    if cost == "shannon":
        want_rec = jax.jit(lambda t: jp2.reconstruct_basis2(
            t, want, "db4", transform_nodes=lambda lv, i, p: 0.5 * p))(want_tree)
        _close(vt.reconstruct_basis2(tree, got, "db4",
                                     transform_nodes=lambda lv, i, p: 0.5 * p), want_rec)


@pytest.mark.parametrize("cost, dtype", [("risk", np.float64)])
def test_best_basis_denoise2_matches_jax(cost, dtype):
    x = _x((2, 32, 32), seed=7, dtype=dtype)
    got = vt.best_basis_denoise2(torch.from_numpy(x), "db4", 2, threshold=0.6, cost=cost,
                                 cost_threshold=0.5, mode="soft")
    want = jp2.best_basis_denoise2(jnp.asarray(x), "db4", 2, threshold=0.6, cost=cost,
                                   cost_threshold=0.5, mode="soft")
    assert got.dtype == torch.from_numpy(x).dtype
    _close(got, want, TOL if dtype == np.float64 else TOL_F32)
    if dtype == np.float64:
        # the masked program equals the explicit basis workflow
        tree = vt.wpt2(torch.from_numpy(x), "db4", 2)
        basis = vt.best_basis2(tree, cost=cost, threshold=0.5)
        explicit = vt.reconstruct_basis2(
            tree, basis, "db4", transform_nodes=lambda _l, _i, p: apply_threshold(p, 0.6, "soft"))
        _close(got, explicit.numpy())


def _weave(kx, ky, n=64):
    yy, xx = np.mgrid[0:n, 0:n]
    return np.sin(2 * np.pi * (kx * xx + ky * yy) / n)


@pytest.mark.parametrize("cost, method", [("risk", "sure")])
def test_denoise_packet2_matches_jax(cost, method):
    noisy = _weave(21, 5, 32) + 0.4 * _x((2, 32, 32), seed=9)
    got = vt.denoise_packet2(torch.from_numpy(noisy), "sym4", 2, cost=cost, method=method)
    want = jax_denoise_packet2(jnp.asarray(noisy), "sym4", 2, cost=cost, method=method)
    _close(got, want)


def test_denoise_packet2_callable_cost_matches_jax():
    """The callable-cost branch: the basis on the host, then the shrunk
    reconstruction.  The JAX reference runs its own branch's steps, its
    reconstruction under ``jax.jit`` (eager, it compiles op by op)."""
    from vectorwave_tpu.denoise import packet as jpacket
    from vectorwave_tpu.ops.thresholds import mad_sigma as jax_mad_sigma
    from vectorwave_tpu.transforms.modwt import _resolve_discrete

    noisy = _weave(21, 5, 32) + 0.4 * _x((2, 32, 32), seed=10)
    got = vt.denoise_packet2(torch.from_numpy(noisy), "db4", 2,
                             cost=lambda p: (p**2).clamp(max=1.0).sum(), method="universal")
    tree = _jax_tree(noisy, "db4", 2)
    basis = jp2.best_basis2(tree, cost=lambda p: jnp.minimum(p**2, 1.0).sum())

    def ref(t):
        flat = t.leaves.reshape(t.leaves.shape[:-2] + (-1,))
        sigma = jnp.median(jax_mad_sigma(flat)[..., 0], axis=-1, keepdims=True)
        return jpacket._reconstruct_shrunk_2d(t, basis, _resolve_discrete("db4"), sigma,
                                              32 * 32, "universal", "hard", "periodic")

    _close(got, jax.jit(ref)(tree))


def test_denoise_packet2_noise_floor_averages_the_middle_pair():
    """16 leaves at depth 2: the noise floor is the mean of the two middle
    per-node MADs (``jnp.median``), not the lower one (``torch.median``)."""
    from vectorwave_tpu_torch.denoise.packet import _median_last

    leaves = vt.wpt2(torch.from_numpy(0.7 * _x((1, 32, 32), seed=13)), "sym4", 2).leaves
    mads = vt.mad_sigma(leaves.reshape(1, 16, -1))[..., 0]
    got = _median_last(mads)
    np.testing.assert_array_equal(got.numpy(), jnp.median(mads.numpy(), axis=-1, keepdims=True))
    assert float(got) > float(torch.median(mads))


@pytest.mark.parametrize("case", ["beats_noise", "beats_pyramid", "noiseless"])
def test_denoise_packet2_quality(case):
    """The quality checks of ``tests/test_packets2d.py`` on the port."""
    rng = np.random.default_rng(42)
    if case == "beats_noise":
        clean = _weave(21, 5)
        noisy = clean + 0.4 * rng.standard_normal(clean.shape)
        den = vt.denoise_packet2(torch.from_numpy(noisy), "sym8", 3).numpy()
        assert np.mean((den - clean) ** 2) < 0.6 * np.mean((noisy - clean) ** 2)
    elif case == "beats_pyramid":
        clean = _weave(27, 23)
        noisy = torch.from_numpy(clean + 0.5 * rng.standard_normal(clean.shape))
        packet = np.mean((vt.denoise_packet2(noisy, "sym8", 3).numpy() - clean) ** 2)
        pyramid = np.mean((vt.denoise2(noisy, "sym8", levels=3).numpy() - clean) ** 2)
        assert packet < pyramid
    else:
        yy, xx = np.mgrid[0:64, 0:64]
        clean = torch.from_numpy(np.sin(2 * np.pi * yy / 16) * np.cos(2 * np.pi * xx / 8))
        den = vt.denoise_packet2(clean, "db4", 2)
        assert float(torch.linalg.norm(den - clean) / torch.linalg.norm(clean)) < 0.15


def test_convert_refuses_a_bad_quadtree():
    with pytest.raises(InvalidArgumentError):
        convert.packet2_tree_from_arrays([np.zeros((1, 8, 8)), np.zeros((2, 4, 4))], device="cpu")
