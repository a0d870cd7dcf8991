"""Test mirrors of the JAX package's decimated 2-D tree tests, on the port.

Mirrors ``tests/test_dtcwt2.py`` and ``tests/test_packets2d.py`` test by
test, under the JAX tests' names, at their shapes and seeds; the audit of
the eight files of the 2-D trees, the solvers and the infrastructure is in
CHANGES.md.

These JAX tests state properties of the package's output (perfect
reconstruction, the four trees' energy identity, each band's quadrant,
shift robustness of the magnitudes, admissible best bases, the packet
denoise beating the pyramid on a texture).  Here the port is held to the
same property on its own output; the earlier parity tests
(``test_torch_dtcwt2.py``, ``test_torch_packets2d.py``) hold it to JAX value
by value.  Each family is anchored to the JAX package once more, at a named
draw of its mirror, through a module-scoped fixture (``anchor_*``), the JAX
side on its jnp path under one ``jax.jit``.  ``anchor_dtcwt2`` is used by
the slow ``test_perfect_reconstruction`` alone, as four of the six JAX
``dtcwt2`` tests are slow and the JAX dual tree compiles for about 9 s at
any size.  The JAX ``jit`` half of ``test_jit_and_batch`` has no
counterpart (the port does not trace); its batch half is mirrored.

Tolerances: the anchors 1e-10 of the largest value (float64 on both
sides); the properties at the JAX tests' own bounds.

Neither tree reaches a kernel (decimated rolls, ``ops/dwt.py``); the one
kernel-reaching call of these files, ``denoise2`` in
``test_denoise_packet2_beats_pyramid_on_texture``, is a phase 2g case
(``tools/mirror_cases.solver_cases``), run on CPU tensors in
``tests/test_torch_solvers_mirror.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu_torch as vt
from vectorwave_tpu.transforms import dtcwt2 as jd2
from vectorwave_tpu.transforms import packets2d as jp2
from vectorwave_tpu_torch.errors import InvalidArgumentError, VectorWaveError
from vectorwave_tpu_torch.ops.thresholds import apply_threshold
from vectorwave_tpu_torch.transforms.packets import frequency_order
from vectorwave_tpu_torch.transforms.packets2d import _validate_basis2

torch.set_num_threads(1)

ANCHOR = 1e-10


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _t(a, dtype=torch.float64) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


# --- the anchors: each family against the JAX package once ---------------------------


@pytest.fixture(scope="module")
def anchor_dtcwt2():
    """JAX's dual tree (near_sym_b / qshift_b, 3 levels) and its inverse at
    test_perfect_reconstruction's draw (seed 0, 64 x 64), in float64
    (ANCHOR_DTCWT2)."""
    img = np.random.default_rng(0).standard_normal((64, 64))

    def ref(z):
        res = jd2.dtcwt2(z, levels=3)
        return list(res.highpasses), res.lowpasses, jd2.idtcwt2(res)

    out = jax.tree_util.tree_map(np.asarray, jax.jit(ref)(jnp.asarray(img)))
    return img, out


@pytest.fixture(scope="module")
def anchor_packets2d():
    """JAX's db4 quadtree (depth 3, periodic) and its shannon best basis
    (threshold 0.5) at test_best_basis_denoise2_matches_explicit_workflow's
    draw (the conftest's ``rng``, seed 42, 64 x 64), in float64
    (ANCHOR_PACKETS2D)."""
    x = np.random.default_rng(42).standard_normal((64, 64))
    levels = jax.jit(lambda z: list(jp2.wpt2(z, "db4", 3).levels))(jnp.asarray(x))
    basis = jp2.best_basis2(jp2.WaveletPacket2DTree(tuple(levels)), cost="shannon",
                           threshold=0.5)
    return x, [np.asarray(v) for v in levels], basis


def test_anchor_packets2d_matches_jax(anchor_packets2d):
    x, levels, basis = anchor_packets2d
    tree = vt.wpt2(_t(x), "db4", 3)
    assert tree.depth == 3
    for got, want in zip(tree.levels, levels):
        assert _rel(got, want) <= ANCHOR
    assert tuple(vt.best_basis2(tree, cost="shannon", threshold=0.5)) == tuple(basis)


# --- test_dtcwt2.py ---------------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("shape", [(64, 64), (2, 64, 96)])
def test_perfect_reconstruction(shape, anchor_dtcwt2):
    img = np.random.default_rng(0).standard_normal(shape)
    res = vt.dtcwt2(_t(img, torch.float32), levels=3)
    rec = vt.idtcwt2(res)
    assert float((rec - _t(img, torch.float32)).abs().max()) < 2e-5
    assert tuple(res.highpasses[0].shape) == shape[:-2] + (6, shape[-2] // 2, shape[-1] // 2)
    assert tuple(res.lowpasses.shape) == shape[:-2] + (4, shape[-2] // 8, shape[-1] // 8)
    if shape == (64, 64):  # the JAX anchor at this draw, in float64
        a_img, (highpasses, lowpasses, inverse) = anchor_dtcwt2
        got = vt.dtcwt2(_t(a_img), levels=3)
        for g, w in zip(got.highpasses, highpasses):
            assert _rel(g, w) <= ANCHOR
        assert _rel(got.lowpasses, lowpasses) <= ANCHOR
        assert _rel(vt.idtcwt2(got), inverse) <= ANCHOR


@pytest.mark.slow
def test_energy_identity():
    img = _t(np.random.default_rng(1).standard_normal((128, 128)))
    res = vt.dtcwt2(img, levels=3)
    hp = sum(float((z.abs() ** 2).sum()) for z in res.highpasses)
    lp = float((res.lowpasses**2).sum())
    # four orthonormal trees; complex bands carry half the 4-tree energy
    assert (2 * hp + lp) / 4 == pytest.approx(float((img**2).sum()), rel=1e-5)


def _effective_wavelet_spectrum(band, level=3, n=128):
    """FFT of the band's effective complex wavelet (via two inversions)."""
    res0 = vt.dtcwt2(torch.zeros(n, n, dtype=torch.float64), levels=level)
    out = []
    for val in (1.0, 1j):
        hp = [torch.zeros_like(z) for z in res0.highpasses]
        hp[level - 1][band, 8, 8] = val
        out.append(_np(vt.idtcwt2(vt.DTCWT2Result(tuple(hp),
                                                  torch.zeros_like(res0.lowpasses)))))
    psi = out[0] - 1j * out[1]
    return np.abs(np.fft.fft2(psi)) ** 2


@pytest.mark.slow
def test_quadrant_localization():
    n = 128
    fy = np.fft.fftfreq(n)[:, None]
    fx = np.fft.fftfreq(n)[None, :]
    quads = [
        (fy < 0) & (fx > 0),  # band 0: -15 deg
        (fy > 0) & (fx > 0),  # band 1: +15
        (fy > 0) & (fx < 0),  # band 2: -75
        (fy < 0) & (fx < 0),  # band 3: +75
        (fy > 0) & (fx > 0),  # band 4: +45
        (fy < 0) & (fx > 0),  # band 5: -45
    ]
    for band in range(6):
        energy = _effective_wavelet_spectrum(band)
        frac = energy[quads[band]].sum() / energy.sum()
        assert frac > (0.97 if band >= 4 else 0.75), (band, frac)


@pytest.mark.slow
def test_oriented_gratings_pick_their_band():
    n = 128
    yy, xx = np.mgrid[0:n, 0:n]
    cases = [(-15, 0.09, 0), (15, 0.09, 1), (-75, 0.09, 2), (75, 0.09, 3),
             (45, 0.13, 4), (-45, 0.13, 5)]
    for deg, f0, expected in cases:
        th = np.deg2rad(deg)
        gr = np.cos(2 * np.pi * f0 * (np.cos(th) * xx + np.sin(th) * yy)).astype(np.float32)
        oe = _np(vt.dtcwt2(torch.from_numpy(gr), levels=3).orientation_energy(3))
        assert int(np.argmax(oe)) == expected, (deg, oe / oe.sum())
        assert oe[expected] / oe.sum() > 0.45, (deg, oe / oe.sum())


def test_magnitude_shift_robustness():
    """|z| fields move with the image under translation: the level-3 band
    energies move less than 6% under a half-coefficient shift."""
    img = np.random.default_rng(2).standard_normal((128, 128)).astype(np.float32)
    base_mag = _np(vt.dtcwt2(torch.from_numpy(img), levels=3).highpasses[2].abs())
    devs = []
    for sy, sx in ((4, 0), (0, 4), (4, 4)):
        shifted = np.roll(img, (sy, sx), axis=(0, 1))
        mag = _np(vt.dtcwt2(torch.from_numpy(shifted), levels=3).highpasses[2].abs())
        e0 = base_mag.reshape(6, -1).sum(axis=1)
        e1 = mag.reshape(6, -1).sum(axis=1)
        devs.append(np.max(np.abs(e1 - e0) / e0))
    assert max(devs) < 0.06, devs


def test_validation():
    with pytest.raises(VectorWaveError):
        vt.dtcwt2(torch.zeros(64), levels=2)  # 1-D input
    with pytest.raises(VectorWaveError):
        vt.dtcwt2(torch.zeros(60, 64), levels=3)  # 60 % 8 != 0
    with pytest.raises(VectorWaveError):
        vt.dtcwt2(torch.zeros(64, 64), levels=0)


# --- test_packets2d.py ------------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("wavelet", ["db4", "bior2.2"])
def test_quadtree_roundtrip(wavelet, rng):
    x = _t(rng.standard_normal((2, 32, 32)))
    tree = vt.wpt2(x, wavelet, 3, boundary="periodic")
    assert tree.depth == 3
    assert tuple(tree.leaves.shape) == (2, 64, 4, 4)
    rec = vt.iwpt2(tree, wavelet, boundary="periodic")
    np.testing.assert_allclose(_np(rec), _np(x), atol=1e-10)


def test_quadtree_zero_boundary_interior(rng):
    """Zero padding affects only the trailing edge; haar's depth-2 spread is
    3 samples, so all but the last rows and columns agree."""
    x = _t(rng.standard_normal((32, 32)))
    rec = vt.iwpt2(vt.wpt2(x, "haar", 2, boundary="zero"), "haar", boundary="zero")
    np.testing.assert_allclose(_np(rec)[:28, :28], _np(x)[:28, :28], atol=1e-10)


def test_level1_matches_dwt2(rng):
    x = _t(rng.standard_normal((16, 16)))
    tree = vt.wpt2(x, "db2", 1)
    for k, band in enumerate(vt.dwt2(x, "db2")):
        np.testing.assert_allclose(_np(tree.node(1, k)), _np(band), atol=1e-12)


def test_energy_conserved_orthogonal(rng):
    x = _t(rng.standard_normal((32, 32)))
    tree = vt.wpt2(x, "db4", 2)
    for level in range(tree.depth + 1):
        np.testing.assert_allclose(float(tree.energy_map(level).sum()),
                                   float((x**2).sum()), rtol=1e-10)


def test_separable_tensor_structure(rng):
    """wpt2 of a rank-1 image is the outer product of the two 1-D packet nodes."""
    u = _t(rng.standard_normal(32))
    v = _t(rng.standard_normal(32))
    tree2 = vt.wpt2(u[:, None] * v[None, :], "db3", 2)
    tree_u, tree_v = vt.wpt(u, "db3", 2), vt.wpt(v, "db3", 2)
    for idx in [0, 1, 5, 10, 15]:
        digits = [(idx >> 2) & 3, idx & 3]
        h_nat = (digits[0] >> 1) * 2 + (digits[1] >> 1)
        w_nat = (digits[0] & 1) * 2 + (digits[1] & 1)
        expect = _np(tree_u.node(2, h_nat))[:, None] * _np(tree_v.node(2, w_nat))[None, :]
        np.testing.assert_allclose(_np(tree2.node(2, idx)), expect, atol=1e-10)


@pytest.mark.slow
def test_best_basis_admissible_and_minimal(rng):
    t = np.linspace(0.0, 1.0, 64)
    texture = np.sin(2 * np.pi * 24 * t)[:, None] * np.sin(2 * np.pi * 3 * t)[None, :]
    x = _t(texture + 0.01 * rng.standard_normal((64, 64)))
    tree = vt.wpt2(x, "db4", 2)
    basis = vt.best_basis2(tree, "shannon")
    _validate_basis2(basis, tree.depth)  # raises if not a tiling
    rec = vt.reconstruct_basis2(tree, basis, "db4")
    np.testing.assert_allclose(_np(rec), _np(x), atol=1e-8)
    assert len(vt.basis_coefficients2(tree, basis)) == len(basis)


def test_leaf_and_root_bases_reconstruct(rng):
    x = _t(rng.standard_normal((32, 32)))
    tree = vt.wpt2(x, "sym4", 2)
    leaves = tuple((2, i) for i in range(16))
    for basis in (((0, 0),), leaves):
        rec = vt.reconstruct_basis2(tree, basis, "sym4")
        np.testing.assert_allclose(_np(rec), _np(x), atol=1e-9)


def test_transform_nodes_hook(rng):
    x = _t(rng.standard_normal((32, 32)))
    tree = vt.wpt2(x, "db2", 2)
    basis = tuple((2, i) for i in range(16))
    rec = vt.reconstruct_basis2(tree, basis, "db2",
                                transform_nodes=lambda lvl, idx, c: torch.zeros_like(c))
    assert float(rec.abs().max()) == 0.0


def test_invalid_bases_rejected(rng):
    x = _t(rng.standard_normal((16, 16)))
    tree = vt.wpt2(x, "haar", 2)
    with pytest.raises(InvalidArgumentError):  # overlap: root + a child
        vt.reconstruct_basis2(tree, ((0, 0), (1, 0)), "haar")
    with pytest.raises(InvalidArgumentError):  # gap: three of four children
        vt.reconstruct_basis2(tree, ((1, 0), (1, 1), (1, 2)), "haar")
    with pytest.raises(InvalidArgumentError):  # outside tree
        vt.reconstruct_basis2(tree, ((3, 0),), "haar")
    with pytest.raises(InvalidArgumentError):  # odd dims
        vt.wpt2(torch.zeros(15, 16), "haar", 1)
    with pytest.raises(InvalidArgumentError):  # depth too deep for dims
        vt.wpt2(torch.zeros(16, 16), "haar", 5)


def test_frequency_bands_geometry():
    bands = vt.packet_frequency_bands2(1, sampling_rate=2.0)
    # ll: low in both axes; hh: high in both; lh: low-H, high-W
    np.testing.assert_allclose(bands[0], [[0.0, 0.5], [0.0, 0.5]])
    np.testing.assert_allclose(bands[3], [[0.5, 1.0], [0.5, 1.0]])
    np.testing.assert_allclose(bands[1], [[0.0, 0.5], [0.5, 1.0]])
    np.testing.assert_allclose(bands[2], [[0.5, 1.0], [0.0, 0.5]])
    # level 2: each axis band ordering follows the 1-D sequency rule
    bands2 = vt.packet_frequency_bands2(2, sampling_rate=2.0)
    inv = np.argsort(frequency_order(2))
    for idx in range(16):
        digits = [(idx >> 2) & 3, idx & 3]
        h_nat = (digits[0] >> 1) * 2 + (digits[1] >> 1)
        np.testing.assert_allclose(bands2[idx, 0], [inv[h_nat] * 0.25, (inv[h_nat] + 1) * 0.25])
    # edges tile [0, 1) exactly on each axis over any admissible basis
    assert bands2.min() == 0.0 and bands2.max() == 1.0


def test_jit_and_batch(rng):
    """The batch half (the port does not trace): a 3 x 2 batch of 16 x 16
    images round-trips within 1e-10."""
    x = _t(rng.standard_normal((3, 2, 16, 16)))
    rec = vt.iwpt2(vt.wpt2(x, "db2", 2), "db2")
    np.testing.assert_allclose(_np(rec), _np(x), atol=1e-10)


@pytest.mark.slow
def test_denoise_packet2_beats_noise(rng):
    h = w = 64
    yy, xx = np.mgrid[0:h, 0:w]
    clean = np.sin(2 * np.pi * (21 * xx + 5 * yy) / w)  # high-frequency texture
    noisy = clean + 0.4 * rng.standard_normal((h, w))
    den = _np(vt.denoise_packet2(_t(noisy), "sym8", 3))
    mse_in = float(np.mean((noisy - clean) ** 2))
    mse_out = float(np.mean((den - clean) ** 2))
    assert mse_out < 0.6 * mse_in


def test_denoise_packet2_beats_pyramid_on_texture(rng):
    """High-frequency weave: the quadtree isolates the texture band, the
    LL-spine pyramid (denoise2) dumps it into one noisy detail level."""
    h = w = 64
    yy, xx = np.mgrid[0:h, 0:w]
    clean = np.sin(2 * np.pi * (27 * xx + 23 * yy) / w)
    noisy = _t(clean + 0.5 * rng.standard_normal((h, w)))

    def mse(est):
        return float(np.mean((_np(est) - clean) ** 2))

    packet = mse(vt.denoise_packet2(noisy, "sym8", 3))
    pyramid = mse(vt.denoise2(noisy, "sym8", levels=3))
    assert packet < pyramid


def test_denoise_packet2_noiseless_near_identity():
    yy, xx = np.mgrid[0:64, 0:64]
    clean = _t(np.sin(2 * np.pi * yy / 16) * np.cos(2 * np.pi * xx / 8))
    den = vt.denoise_packet2(clean, "db4", 2)
    assert float(torch.linalg.norm(den - clean) / torch.linalg.norm(clean)) < 0.15


def test_best_basis_denoise2_matches_explicit_workflow(rng):
    """The single-program masked reconstruction equals the explicit
    best_basis2 + reconstruct_basis2 composition node for node (float32)."""
    x = _t(rng.standard_normal((64, 64)), torch.float32)
    got = vt.best_basis_denoise2(x, "db4", 3, threshold=0.6, cost="shannon",
                                 cost_threshold=0.5, mode="soft")
    tree = vt.wpt2(x, "db4", 3)
    basis = vt.best_basis2(tree, cost="shannon", threshold=0.5)
    want = vt.reconstruct_basis2(tree, basis, "db4",
                                 transform_nodes=lambda _l, _i, p: apply_threshold(p, 0.6,
                                                                                   "soft"))
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)
