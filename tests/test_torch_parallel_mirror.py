"""Test mirrors of the JAX package's parallel-tier tests, on the port.

Mirrors ``tests/test_parallel.py``, ``tests/test_tiled2d.py``,
``tests/test_tiled_exact.py`` and ``tests/test_cwt_tiled.py`` test by test,
under the JAX tests' names, at their shapes and seeds: shards of 32-256
samples on a mesh of ``[torch.device("cpu")] * 8`` (the JAX tests' eight
virtual devices), 2-D tiles of 16-32 rows on four, where the halos hop
across several shards and wrap.  The audit of all four files, with the
earlier port tests that hold the rest of their guarantees, is in CHANGES.md.

Most of these JAX tests hold the tiled result to the single-device one.
Here the port's tiled result is held to the port's own single-device path,
which the earlier parity tests (``test_torch_parallel.py``,
``test_torch_tiled2d.py``, ``test_torch_tiled_exact.py``,
``test_torch_cwt_tiled.py``) hold to JAX; the 1-D tiling and the tiled CWT
are anchored to the JAX package once more at a named draw of their mirrors
(``ANCHOR_*``), and the two tests that compare against a value only JAX
gives call it per case: the multi-wrap periodic spans of the 2-D tiling
and of the exact tier.  The JAX side runs its jnp path, never a Pallas
kernel.  Tolerances, with their reasons:

* float64 tilings against one device: 1e-12 (the same sums, in another
  order at most); float32 2-D tilings 2e-5 a level and 3e-5 a round trip,
  the JAX tests' bounds;
* the kernel route in float32 (on the CPU the kernels' plain versions)
  against the single-device kernel tier: 1e-6, its round trip 1e-5, as in
  JAX;
* the exact tier's hi + lo against JAX's float64 jnp transform: 5e-11, its
  round trip RMSE 1e-10 (the tier's contract);
* the tiled CWT against the single-device ``cwt``: 1e-12 (``cwt_tiled_2d``
  1e-10), as in JAX;
* the analysis modules on a sharded batch against the whole batch: 1e-12
  (1e-10 through the CWT), the sparse solvers 1e-4 in float32, as in JAX.

The phase 2d cases of these files (``tools/mirror_cases.tier_cases``) run
here on CPU tensors (``mirror_cases.cpu_problems``).
"""

import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from tools import mirror_cases
from vectorwave_tpu import parallel as jp
from vectorwave_tpu_torch import parallel as tp

from .conftest import composite_sin

torch.set_num_threads(1)

TOL = 1e-12
TOL_KERNEL = 1e-6
TOL_2D = 2e-5
TOL_2D_ROUND_TRIP = 3e-5
CPU = torch.device("cpu")
CPU8 = [CPU] * 8


@pytest.fixture(scope="module")
def meshes():
    return {
        "signal": tp.make_mesh({"signal": 8}, devices=CPU8),
        "2d": tp.make_mesh({"data": 2, "signal": 4}, devices=CPU8),
        "hosts": tp.make_multihost_mesh(n_hosts=2, chips_per_host=4, devices=CPU8),
        "rows": tp.make_mesh({"rows": 4}, devices=CPU8[:4]),
    }


def _planes(res) -> list:
    return [*res.details, res.approx]


def _bands(res) -> list:
    return [p for trip in res.details for p in trip] + [res.approx]


def _as_t(a) -> torch.Tensor:
    t = torch.as_tensor(np.array(a))
    return t.to(torch.complex128) if t.is_complex() else t.double()


def _err(got, want) -> float:
    assert len(got) == len(want)
    pairs = [(_as_t(g), _as_t(w)) for g, w in zip(got, want)]
    assert all(g.shape == w.shape for g, w in pairs), [(g.shape, w.shape) for g, w in pairs]
    return max(float((g - w).abs().max()) for g, w in pairs)


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _single(x, name, levels, boundary):
    return vt.modwt_multilevel(x, name, levels=levels, boundary=boundary, backend="torch")


def _single_round_trip(x, name, levels, boundary):
    return vt.imodwt_multilevel(_single(x, name, levels, boundary), name, boundary=boundary,
                                backend="torch")


# --- the anchors: each family against the JAX package once ---------------------------


@pytest.fixture(scope="module")
def anchor_tiled():
    """JAX's tiled jnp route at test_tiled_forward_equals_single_device's
    periodic draw (db4 J=4, 1024 samples on 8 shards) (ANCHOR_TILED)."""
    x = composite_sin(1024, noise_std=0.3)
    res = jp.modwt_multilevel_tiled(jnp.asarray(x), "db4", levels=4,
                                    mesh=jp.make_mesh({"signal": 8}), backend="jnp")
    return x, [np.asarray(p) for p in _planes(res)]


def test_anchor_tiled_matches_jax(meshes, anchor_tiled):
    x, want = anchor_tiled
    got = tp.modwt_multilevel_tiled(_t(x), "db4", levels=4, mesh=meshes["signal"])
    assert _err(_planes(got), want) <= TOL


@pytest.fixture(scope="module")
def anchor_cwt_tiled():
    """JAX's tiled CWT at test_tiled_cwt_matches_single_device's draw (morl,
    16 log scales 2-32, 2048 samples on 8 shards) (ANCHOR_CWT_TILED)."""
    x = _cwt_signal()
    scales = tuple(vw.scales_log(2, 32, 16))
    res = jp.cwt_tiled(jnp.asarray(x), scales, "morl", mesh=jp.make_mesh({"signal": 8}))
    return x, scales, np.asarray(res.coeffs)


def test_anchor_cwt_tiled_matches_jax(meshes, anchor_cwt_tiled):
    x, scales, want = anchor_cwt_tiled
    got = tp.cwt_tiled(_t(x), scales, "morl", mesh=meshes["signal"]).coeffs
    assert _err([got], [want]) <= TOL


# --- tests/test_parallel.py --------------------------------------------------------------


def test_tiled_inverse_matches_single_device_zero(meshes):
    x = _t(composite_sin(512, noise_std=0.2))
    m = meshes["signal"]
    res = tp.modwt_multilevel_tiled(x, "db4", levels=3, mesh=m, boundary="zero")
    xr = tp.imodwt_multilevel_tiled(res, "db4", mesh=m, boundary="zero")
    assert _err([xr], [_single_round_trip(x, "db4", 3, "zero")]) <= TOL


@pytest.mark.parametrize("wavelet,levels", [("db4", 3), ("sym8", 1), ("haar", 4)])
def test_tiled_symmetric_inverse_matches_single_device(meshes, wavelet, levels):
    """Two-sided tau-offset halos against the single-device inverse."""
    x = _t(composite_sin(512, noise_std=0.2))
    m = meshes["signal"]
    res = tp.modwt_multilevel_tiled(x, wavelet, levels=levels, mesh=m, boundary="symmetric")
    xr = tp.imodwt_multilevel_tiled(res, wavelet, mesh=m, boundary="symmetric")
    assert _err([xr], [_single_round_trip(x, wavelet, levels, "symmetric")]) <= TOL


def test_tiled_symmetric_deep_halo_matches_single_device(meshes):
    """Halos wider than the 64-sample shard (db4 levels 5-6: 112 / 224): the
    mirror comes from the gathered global head."""
    x = _t(composite_sin(512, noise_std=0.3))
    for levels in (5, 6):
        got = tp.modwt_multilevel_tiled(x, "db4", levels=levels, mesh=meshes["signal"],
                                        boundary="symmetric")
        assert _err(_planes(got), _planes(_single(x, "db4", levels, "symmetric"))) <= TOL


def test_tiled_symmetric_deep_halo_inverse(meshes):
    x = _t(composite_sin(512, noise_std=0.2))
    m = meshes["signal"]
    res = tp.modwt_multilevel_tiled(x, "db4", levels=5, mesh=m, boundary="symmetric")
    xr = tp.imodwt_multilevel_tiled(res, "db4", mesh=m, boundary="symmetric")
    assert _err([xr], [_single_round_trip(x, "db4", 5, "symmetric")]) <= TOL


def test_multihop_halo(meshes):
    """A halo wider than one 32-sample shard: db8 J=4 reaches (16-1)*15 = 225."""
    x = _t(composite_sin(256, noise_std=0.1))
    got = tp.modwt_multilevel_tiled(x, "db8", levels=4, mesh=meshes["signal"])
    assert _err(_planes(got), _planes(_single(x, "db8", 4, "periodic"))) <= TOL


def test_batched_tiled_2d_mesh(meshes):
    x = _t(np.stack([composite_sin(512, seed=s, noise_std=0.1) for s in range(4)]))
    got = tp.modwt_multilevel_tiled(x, "db4", levels=3, mesh=meshes["2d"])
    assert _err(_planes(got), _planes(_single(x, "db4", 3, "periodic"))) <= TOL


def test_multihost_mesh_and_parity(meshes):
    """The host x chip layout against one device, every boundary, both ways."""
    m = meshes["hosts"]
    assert m.shape == {"host": 2, "chip": 4}
    x = _t(np.stack([composite_sin(512, seed=s, noise_std=0.2) for s in range(4)]))
    for boundary in ("periodic", "zero", "symmetric"):
        res = tp.modwt_multilevel_multihost(x, "db4", levels=3, mesh=m, boundary=boundary)
        single = _single(x, "db4", 3, boundary)
        assert _err(_planes(res), _planes(single)) <= TOL
        xr = tp.imodwt_multilevel_multihost(res, "db4", mesh=m, boundary=boundary)
        assert _err([xr], [vt.imodwt_multilevel(single, "db4", boundary=boundary,
                                                backend="torch")]) <= 1e-11


def test_multihost_batch_stays_sharded(meshes):
    """The port has no sharding annotation (ROADMAP, the multi-process run):
    local rows in, local rows out.  In one process the result keeps the
    input's rows in order, on the mesh's home device; each rank's own rows
    across processes are held by ``test_torch_multiprocess.py``."""
    m = meshes["hosts"]
    x = _t(np.stack([composite_sin(512, seed=s) for s in range(4)]))
    res = tp.modwt_multilevel_multihost(x, "haar", levels=2, mesh=m)
    assert res.approx.shape == (4, 512) and res.approx.device == m.local_devices[0]
    for row in range(4):
        alone = _single(x[row], "haar", 2, "periodic")
        assert _err([p[row] for p in _planes(res)], _planes(alone)) <= TOL


def test_sharded_batch_analysis_modules(meshes):
    """The analysis modules run unchanged on a batch split over the mesh:
    each shard's rows through the module equal those rows of the whole
    batch's result (the port's modules are functions of each row)."""
    mesh = tp.make_mesh({"data": 8}, devices=CPU8)
    rng = np.random.default_rng(50)
    xb = torch.from_numpy(rng.standard_normal((8, 1024)))
    yb = torch.from_numpy(rng.standard_normal((8, 1024)))
    xs = tp.shard_batch(xb, mesh)
    assert len(xs) == 8 and all(s.shape == (1, 1024) for s in xs)

    def sharded(fn, *shards):
        return torch.cat([fn(*parts) for parts in zip(*shards)])

    def check(fn, tol, *args):
        assert _err([sharded(fn, *(tp.shard_batch(a, mesh) for a in args))], [fn(*args)]) <= tol

    check(lambda z: vt.modwpt(z, "db4", 3).leaves, TOL, xb)
    check(lambda z: vt.wavelet_variance(z, "db4", 4).variance, TOL, xb)
    scales = tuple(vt.scales_log(2, 32, 8))
    check(lambda a, b: vt.wavelet_coherence(a, b, scales, "morl").coherence, 1e-10, xb, yb)
    check(lambda z: vt.synchrosqueeze(z, scales, "morl").coeffs.abs(), 1e-10, xb)

    def ridge(z):
        r = vt.cross_wavelet(z, z, scales, "morl")
        return vt.extract_ridge(type(r)(r.coeffs.abs() + 1e-6, scales, "zero")).indices

    assert torch.equal(sharded(ridge, xs), ridge(xb))


@pytest.mark.slow
def test_sharded_batch_sparse_solvers(meshes):
    """The FISTA solvers on a batch split over the mesh.  ``bpdn``'s default
    λ is per signal; ``inpaint``'s λ schedule comes from the whole batch's
    largest coefficient (in both packages), so each shard is given the
    batch's schedule, which a sharded JAX array computes as one."""
    mesh = tp.make_mesh({"data": 8}, devices=CPU8)
    rng = np.random.default_rng(51)
    xb = torch.from_numpy(rng.standard_normal((8, 512)).astype(np.float32))
    mask = torch.from_numpy((rng.random(512) > 0.3).astype(np.float32))
    peak = float(vt.modwt_multilevel(xb * mask, "db4", levels=1).details[0].abs().max())

    def bp(z):
        return vt.bpdn(z, "db4", levels=3, steps=15).signal

    def inp(z, **lams):
        return vt.inpaint(z * mask, mask, "db4", levels=3, steps=20, **lams)

    got = torch.cat([bp(s) for s in tp.shard_batch(xb, mesh)])
    assert _err([got], [bp(xb)]) <= 1e-4
    got = torch.cat([inp(s, lam=1e-3 * peak, lam_init=peak) for s in tp.shard_batch(xb, mesh)])
    assert _err([got], [inp(xb)]) <= 1e-4


@pytest.mark.parametrize("boundary", ["periodic", "zero"])
def test_tiled_pallas_matches_fused_kernel(meshes, boundary):
    """The tiled kernel route (one external-halo call per device) against
    the single-device kernel tier, both on the CPU as the kernels' plain
    versions, float32."""
    x = _t(composite_sin(2048, noise_std=0.3), torch.float32)
    m = meshes["signal"]
    tiled = tp.modwt_multilevel_tiled(x, "db4", levels=3, mesh=m, boundary=boundary,
                                      backend="kernel", precision="float32")
    d_ref, a_ref = vt.fused_analysis(x, "db4", levels=3, boundary=boundary,
                                     precision="float32")
    assert _err(_planes(tiled), [*d_ref, a_ref]) <= TOL_KERNEL
    xr = tp.imodwt_multilevel_tiled(tiled, "db4", mesh=m, boundary=boundary, backend="kernel",
                                    precision="float32")
    xr_ref = vt.fused_synthesis(d_ref, a_ref, "db4", boundary=boundary, precision="float32")
    assert _err([xr], [xr_ref]) <= TOL_KERNEL
    if boundary == "periodic":
        assert _err([xr], [x]) <= 1e-5


def test_tiled_pallas_deep_halo_and_batch(meshes):
    """A cumulative halo wider than a shard (225 > 128: two hops) and the
    batch over a 2 x 4 mesh, on the kernel route."""
    xb = _t(np.random.default_rng(5).standard_normal((4, 512)), torch.float32)
    m = meshes["2d"]
    tiled = tp.modwt_multilevel_tiled(xb, "db8", levels=4, mesh=m, axis="signal",
                                      batch_axis="data", backend="kernel", precision="float32")
    d_ref, a_ref = vt.fused_analysis(xb, "db8", levels=4, precision="float32")
    assert _err(_planes(tiled), [*d_ref, a_ref]) <= TOL_KERNEL
    xr = tp.imodwt_multilevel_tiled(tiled, "db8", mesh=m, axis="signal", batch_axis="data",
                                    backend="kernel", precision="float32")
    assert _err([xr], [xb]) <= 1e-5


# --- tests/test_tiled2d.py ---------------------------------------------------------------


def _image(shape, seed):
    return _t(np.random.default_rng(seed).standard_normal(shape), torch.float32)


@pytest.mark.parametrize("boundary", ["periodic", "zero", "symmetric"])
@pytest.mark.parametrize("name,levels", [("db4", 3), ("haar", 4)])
def test_tiled2d_analysis_matches_single_device(meshes, name, levels, boundary):
    x = _image((2, 128, 96), 0)
    got = tp.modwt2_multilevel_tiled(x, name, levels=levels, mesh=meshes["rows"],
                                     boundary=boundary)
    want = vt.modwt2_multilevel(x, name, levels=levels, boundary=boundary)
    assert _err(_bands(got), _bands(want)) <= TOL_2D


@pytest.mark.parametrize("boundary", ["periodic", "zero", "symmetric"])
def test_tiled2d_roundtrip_matches_single_device(meshes, boundary):
    x = _image((128, 96), 1)
    m = meshes["rows"]
    res = tp.modwt2_multilevel_tiled(x, "db4", levels=3, mesh=m, boundary=boundary)
    xr = tp.imodwt2_multilevel_tiled(res, "db4", mesh=m, boundary=boundary)
    ref = vt.imodwt2_multilevel(vt.modwt2_multilevel(x, "db4", levels=3, boundary=boundary),
                                "db4", boundary=boundary)
    assert _err([xr], [ref]) <= TOL_2D_ROUND_TRIP
    if boundary == "periodic":
        assert _err([xr], [x]) <= TOL_2D_ROUND_TRIP


def test_tiled2d_deep_halo_spans_multiple_shards(meshes):
    """db4 J=3: a span of 49 rows over shards of 16, the hop chain."""
    x = _image((64, 128), 2)
    m = meshes["rows"]
    res = tp.modwt2_multilevel_tiled(x, "db4", levels=3, mesh=m, boundary="periodic")
    want = vt.modwt2_multilevel(x, "db4", levels=3, boundary="periodic")
    assert _err([res.approx], [want.approx]) <= TOL_2D
    xr = tp.imodwt2_multilevel_tiled(res, "db4", mesh=m, boundary="periodic")
    assert _err([xr], [x]) <= TOL_2D_ROUND_TRIP


def test_tiled2d_periodic_multiwrap_span(meshes):
    """db4 J=4: a span of 105 rows past H = 64, so the periodic extension
    wraps more than once; every band against JAX's single-device transform
    (its jnp route), and the round trip."""
    x = np.random.default_rng(4).standard_normal((64, 128)).astype(np.float32)
    m = meshes["rows"]
    res = tp.modwt2_multilevel_tiled(_t(x, torch.float32), "db4", levels=4, mesh=m,
                                     boundary="periodic")
    previous = vw.get_backend()
    vw.set_backend("jnp")
    try:
        want = vw.modwt2_multilevel(jnp.asarray(x), "db4", levels=4, boundary="periodic")
    finally:
        vw.set_backend(previous)
    assert _err(_bands(res), [np.asarray(b) for b in _bands(want)]) <= TOL_2D
    xr = tp.imodwt2_multilevel_tiled(res, "db4", mesh=m, boundary="periodic")
    assert _err([xr], [x]) <= TOL_2D_ROUND_TRIP


# --- tests/test_tiled_exact.py -----------------------------------------------------------


def test_tiled_exact_multi_wrap_periodic(meshes):
    """db8 J=6 on 1024 samples: the span (945 samples; the JAX tier's
    128-row halo blocks round it to 1024 >= N) reaches past seven of the
    eight shards.  hi + lo against JAX's float64 jnp transform, and the round
    trip."""
    levels, n = 6, 1024
    x32 = np.random.default_rng(4).standard_normal(n).astype(np.float32)
    details, approx = tp.modwt_multilevel_tiled_exact(_t(x32, torch.float32), "db8",
                                                      levels=levels, mesh=meshes["signal"])
    ref = vw.modwt_multilevel(jnp.asarray(x32.astype(np.float64)), "db8", levels=levels,
                              boundary="periodic", backend="jnp")
    got = [h.double() + lo.double() for h, lo in (*details, approx)]
    assert _err(got, [np.asarray(p) for p in _planes(ref)]) <= 5e-11
    hi, lo = tp.imodwt_multilevel_tiled_exact(details, approx, "db8", mesh=meshes["signal"])
    err = hi.double() + lo.double() - torch.from_numpy(x32).double()
    assert float(err.pow(2).mean().sqrt()) <= 1e-10


# --- tests/test_cwt_tiled.py -------------------------------------------------------------


def _cwt_signal(n=2048):
    """``tests/test_cwt_tiled.py::_signal``."""
    t = np.arange(n)
    return np.sin(2 * np.pi * t / 32) + 0.5 * np.sin(2 * np.pi * t / 128)


def _cwt_close(tiled, single, tol):
    assert tiled.shape == single.shape
    assert _err([tiled], [single]) <= tol


def test_tiled_cwt_matches_single_device(meshes):
    x = _t(_cwt_signal())
    scales = tuple(vt.scales_log(2, 32, 16))
    _cwt_close(tp.cwt_tiled(x, scales, "morl", mesh=meshes["signal"]).coeffs,
               vt.cwt(x, scales, "morl").coeffs, TOL)


def test_tiled_cwt_complex_wavelet_exact(meshes):
    x = _t(_cwt_signal())
    scales = tuple(vt.scales_log(2, 16, 8))
    tiled = tp.cwt_tiled(x, scales, "cmor", mesh=meshes["signal"]).coeffs
    assert tiled.is_complex()
    _cwt_close(tiled, vt.cwt(x, scales, "cmor").coeffs, TOL)


def test_tiled_cwt_multihop_halo(meshes):
    """The largest scale's support (4 x 48 = 192) is wider than a
    128-sample shard."""
    x = _t(_cwt_signal(1024))
    _cwt_close(tp.cwt_tiled(x, (8.0, 48.0), "mexh", mesh=meshes["signal"]).coeffs,
               vt.cwt(x, (8.0, 48.0), "mexh").coeffs, TOL)


def test_cwt_tiled_2d_matches_single_device(meshes):
    """Scales over 'host', the signal over 'chip': the single-device
    zero-boundary CWT (the port's result carries no sharding)."""
    x = _t(_cwt_signal(1024))
    scales = tuple(vt.scales_log(2.0, 16.0, 8))
    tiled = tp.cwt_tiled_2d(x, scales, "morl", mesh=meshes["hosts"])
    assert tiled.coeffs.shape == (8, 1024)
    _cwt_close(tiled.coeffs, vt.cwt(x, scales, "morl", boundary="zero").coeffs, 1e-10)


def test_cwt_tiled_2d_complex_wavelet(meshes):
    x = _t(_cwt_signal(512))
    scales = (2.0, 4.0, 6.0, 8.0)
    tiled = tp.cwt_tiled_2d(x, scales, "cmor", mesh=meshes["hosts"]).coeffs
    single = vt.cwt(x, scales, "cmor", boundary="zero").coeffs
    _cwt_close(tiled.real, single.real, 1e-10)
    _cwt_close(tiled.imag, single.imag, 1e-10)


def test_cwt_tiled_2d_cache_keys_on_shape_and_dtype(meshes):
    """Back-to-back lengths (and a float32 call) never reuse another
    call's bank spectrum."""
    for n, dtype, tol in ((1024, torch.float64, 1e-10), (4096, torch.float64, 1e-10),
                          (1024, torch.float32, 1e-5)):
        x = _t(_cwt_signal(n), dtype)
        tiled = tp.cwt_tiled_2d(x, (2.0, 4.0), "morl", mesh=meshes["hosts"]).coeffs
        assert tiled.dtype == vt.cwt(x, (2.0, 4.0), "morl").coeffs.dtype
        _cwt_close(tiled, vt.cwt(x, (2.0, 4.0), "morl", boundary="zero").coeffs, tol)


# --- phase 2d's cases on the CPU -------------------------------------------------------


@pytest.mark.parametrize("label", mirror_cases.tier_labels("parallel"))
def test_tier_case_runs_its_plain_versions_on_the_cpu(label):
    """Each parallel case phase 2d runs on the card, here on CPU tensors:
    within its bounds of the plain route, no launch, no refusal beyond the
    tiled kernel route's symmetric one (by design, on every device)."""
    assert not mirror_cases.cpu_problems(label)


def _jax_test_source(source):
    module, name = source.split("::")
    mod = importlib.import_module(f"tests.{module[:-3]}")
    return inspect.getsource(getattr(mod, name)), inspect.getsource(mod)


def test_tier_cases_are_the_jax_tests_shapes():
    """Every phase 2d case names a JAX test that exists and whose source (or
    its module's) names the case's wavelet and every extent of its shape;
    the inputs made with the JAX tests' helpers equal the helpers' (float32
    cast)."""
    conftest = importlib.import_module("tests.conftest")
    cases = mirror_cases.tier_cases()
    assert len({c.label for c in cases}) == len(cases)
    for case in cases:
        src, module_src = _jax_test_source(case.source)
        assert case.wavelet in src or case.wavelet in module_src, case.label
        extents = case.shape if case.data[0] != "blocks" else case.shape[:-1] + (
            case.shape[-1] // case.data[2],)
        for extent in extents:
            assert str(extent) in src or str(extent) in module_src, (case.label, extent)
        if case.data[0] == "composite":
            want = conftest.composite_sin(case.shape[-1], noise_std=case.data[1])
        elif case.data[0] == "rows":
            want = np.stack([conftest.composite_sin(case.shape[-1], seed=s,
                                                    noise_std=case.data[1])
                             for s in case.data[2]])
        else:
            seed = case.data[1] if case.data[0] in ("normal", "blocks") else None
            if seed is not None:
                assert f"default_rng({seed})" in src, case.label
            continue
        np.testing.assert_array_equal(mirror_cases.case_input(case), want.astype(case.dtype))
    assert {c.source.split("::")[0] for c in cases} == {
        "test_streaming.py", "test_streaming_denoise_kernel.py", "test_sliding.py",
        "test_native_ingest.py", "test_parallel.py", "test_tiled2d.py",
        "test_tiled_exact.py"}
