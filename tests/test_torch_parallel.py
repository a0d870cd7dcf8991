"""Port parity: the parallel tier (meshes, long-signal tiling, the batch
facade, the host x chip layout) and the synthesis kernel's external right
halo, against vectorwave_tpu.

The same seeded numpy inputs go through ``vectorwave_tpu.parallel`` on the
conftest's 8 virtual CPU devices (``make_mesh({"signal": 8})``) and through
``vectorwave_tpu_torch.parallel`` on a mesh of ``[torch.device("cpu")] *
8``, eight shards on one CPU.  Mirrors ``tests/test_parallel.py``.
Tolerances, with their reasons:

* the plain route in float64 against JAX's jnp tiled route: 1e-12 (the
  same à trous sums, in another order at most);
* the kernel route in float32 (on the CPU the kernels' plain versions)
  against JAX's Pallas tiled route in interpret mode: 1e-6 (float32 sums of
  values of order 1 in another order; the JAX kernels sum composite
  filters);
* the synthesis's external-halo plain version against
  ``run_synthesis_composite(halo=)``: 1e-6, with the plain version run in
  float64 on the same float32 inputs, so the gap is the JAX kernel's own
  float32 rounding (up to 6.7e-7 on unit-variance sym8 J=4 planes; a
  float32 plain version adds as much again);
* the communication model: equal field for field; errors: the same codes.

The fault test: at db4 J=8 on 2 x 1024 over 8 shards the periodic span
(1785) is longer than the signal.  JAX's kernel route caps its halo at N and
strays; the port's halo wraps as often as the span needs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from vectorwave_tpu import parallel as jp
from vectorwave_tpu.kernels.modwt_mxu import run_synthesis_composite
from vectorwave_tpu_torch import parallel as tp
from vectorwave_tpu_torch.errors import InvalidArgumentError
from vectorwave_tpu_torch.kernels import modwt_composite as mc
from vectorwave_tpu_torch.kernels.modwt_fused import _kernel_filters
from vectorwave_tpu_torch.parallel import tiled as tt

from .conftest import composite_sin

torch.set_num_threads(1)

TOL_F64 = 1e-12
TOL_KERNEL = 1e-6
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def meshes():
    """(JAX mesh, port mesh) pairs by name."""
    return {
        "signal": (jp.make_mesh({"signal": 8}), tp.make_mesh({"signal": 8}, devices=CPU8)),
        "2d": (jp.make_mesh({"data": 2, "signal": 4}),
               tp.make_mesh({"data": 2, "signal": 4}, devices=CPU8)),
        "hosts": (jp.make_multihost_mesh(n_hosts=2, chips_per_host=4),
                  tp.make_multihost_mesh(n_hosts=2, chips_per_host=4, devices=CPU8)),
    }


def _planes(res):
    return (*res.details, res.approx)


def _err(got, want) -> float:
    return max(float(np.max(np.abs(np.asarray(g.detach().double()) - np.asarray(w, np.float64))))
               for g, w in zip(got, want))


def _code(excinfo) -> str:
    return excinfo.value.code.value


# --- meshes ---------------------------------------------------------------------------


def test_mesh_helpers(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    mesh = tp.default_mesh()
    assert mesh.shape == {"data": 8} and mesh.devices[3] == torch.device("cuda", 3)
    with pytest.raises(vw.InvalidArgumentError) as want:
        jp.make_mesh({"data": 64})
    with pytest.raises(InvalidArgumentError) as got:
        tp.make_mesh({"data": 64})
    assert _code(got) == _code(want) == "DIST_001"
    # one card: four shards are asked for explicitly, as virtual shards
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(InvalidArgumentError) as got:
        tp.make_mesh({"signal": 4})
    assert _code(got) == "DIST_001"
    virtual = tp.make_mesh({"signal": 4}, devices=[torch.device("cuda")] * 4)
    assert virtual.shape == {"signal": 4} and virtual.size == 4
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(InvalidArgumentError) as got:
        tp.default_mesh()
    assert _code(got) == "DIST_001"
    with pytest.raises(InvalidArgumentError) as got:
        tp.make_mesh({"a": 2, "b": 0}, devices=CPU8)
    assert _code(got) == "DIST_001"


def test_ring_perms_and_the_hop_chain_match_jax(meshes):
    jm, tm = meshes["signal"]
    for wrap in (True, False):
        assert tt._ring_perms("signal", tm, wrap) == jp.tiled._ring_perms("signal", jm, wrap)
    # a halo two and a half shards wide, with and without the wrap link
    shards = (torch.arange(4.0) + 10 * torch.arange(8.0)[:, None])[None]  # [1, T, n_loc]
    from_left, _ = tt._ring_perms("signal", tm, True)
    got = tt._gather_halo(shards, 10, from_left, "left")
    assert got.shape == (1, 8, 10)
    assert got[0, 0].tolist() == [52.0, 53.0, 60.0, 61.0, 62.0, 63.0, 70.0, 71.0, 72.0, 73.0]
    _, from_right = tt._ring_perms("signal", tm, False)
    got = tt._gather_halo(shards, 6, from_right, "right")
    assert got[0, 6].tolist() == [70.0, 71.0, 72.0, 73.0, 0.0, 0.0]
    assert got[0, 7].tolist() == [0.0] * 6
    assert tt._mirror_tail(torch.arange(3.0), 5).tolist() == [1.0, 2.0, 2.0, 1.0, 0.0]


# --- the plain route against JAX's jnp route, float64 ---------------------------------


@pytest.mark.parametrize("boundary", ["periodic", "zero", "symmetric"])
def test_tiled_forward_equals_jax_and_single_device(meshes, boundary):
    jm, tm = meshes["signal"]
    x = composite_sin(1024, noise_std=0.3)
    want = jp.modwt_multilevel_tiled(jnp.asarray(x), "db4", levels=4, mesh=jm,
                                     boundary=boundary, backend="jnp")
    got = tp.modwt_multilevel_tiled(torch.from_numpy(x), "db4", levels=4, mesh=tm,
                                    boundary=boundary)
    assert _err(_planes(got), _planes(want)) <= TOL_F64
    single = vt.modwt_multilevel(torch.from_numpy(x), "db4", levels=4, boundary=boundary)
    assert _err(_planes(got), [p.numpy() for p in _planes(single)]) <= TOL_F64


def test_tiled_roundtrip_periodic_exact(meshes):
    jm, tm = meshes["signal"]
    x = composite_sin(1024, noise_std=0.2)
    res = tp.modwt_multilevel_tiled(torch.from_numpy(x), "sym8", levels=2, mesh=tm)
    xr = tp.imodwt_multilevel_tiled(res, "sym8", mesh=tm)
    assert float((xr - torch.from_numpy(x)).abs().max()) < 1e-10
    want = jp.imodwt_multilevel_tiled(
        jp.modwt_multilevel_tiled(jnp.asarray(x), "sym8", levels=2, mesh=jm), "sym8", mesh=jm)
    assert _err((xr,), (want,)) <= TOL_F64


def test_tiled_inverse_matches_jax_zero(meshes):
    jm, tm = meshes["signal"]
    x = composite_sin(512, noise_std=0.2)
    res = tp.modwt_multilevel_tiled(torch.from_numpy(x), "db4", levels=3, mesh=tm,
                                    boundary="zero")
    xr = tp.imodwt_multilevel_tiled(res, "db4", mesh=tm, boundary="zero")
    want = jp.imodwt_multilevel_tiled(
        jp.modwt_multilevel_tiled(jnp.asarray(x), "db4", levels=3, mesh=jm, boundary="zero"),
        "db4", mesh=jm, boundary="zero")
    assert _err((xr,), (want,)) <= TOL_F64


@pytest.mark.parametrize("wavelet,levels", [("db4", 3), ("sym8", 1), ("haar", 4), ("db4", 5)])
def test_tiled_symmetric_inverse_matches_jax(meshes, wavelet, levels):
    """Two-sided tau-offset halos; at db4 J=5 the branches' halos outgrow
    the 64-sample shards and gather the signal."""
    jm, tm = meshes["signal"]
    x = composite_sin(512, noise_std=0.2)
    res = tp.modwt_multilevel_tiled(torch.from_numpy(x), wavelet, levels=levels, mesh=tm,
                                    boundary="symmetric")
    xr = tp.imodwt_multilevel_tiled(res, wavelet, mesh=tm, boundary="symmetric")
    want = jp.imodwt_multilevel_tiled(
        jp.modwt_multilevel_tiled(jnp.asarray(x), wavelet, levels=levels, mesh=jm,
                                  boundary="symmetric"),
        wavelet, mesh=jm, boundary="symmetric")
    assert _err((xr,), (want,)) <= TOL_F64


@pytest.mark.parametrize("levels", [5, 6])
def test_tiled_symmetric_deep_halo_matches_jax(meshes, levels):
    """Halo wider than the shard (db4 levels 5-6: 112/224 > 64): the mirror
    comes from the gathered global head."""
    jm, tm = meshes["signal"]
    x = composite_sin(512, noise_std=0.3)
    got = tp.modwt_multilevel_tiled(torch.from_numpy(x), "db4", levels=levels, mesh=tm,
                                    boundary="symmetric")
    want = jp.modwt_multilevel_tiled(jnp.asarray(x), "db4", levels=levels, mesh=jm,
                                     boundary="symmetric")
    assert _err(_planes(got), _planes(want)) <= TOL_F64


def test_tiled_uneven_shards_rejected(meshes):
    jm, tm = meshes["signal"]
    with pytest.raises(vw.InvalidArgumentError) as want:
        jp.modwt_multilevel_tiled(jnp.zeros(1001), "db4", levels=2, mesh=jm)
    with pytest.raises(InvalidArgumentError) as got:
        tp.modwt_multilevel_tiled(torch.zeros(1001), "db4", levels=2, mesh=tm)
    assert _code(got) == _code(want) == "DIST_002"


@pytest.mark.parametrize("boundary", ["periodic", "zero"])
def test_multihop_halo_matches_jax(meshes, boundary):
    """Halo wider than one shard: db8 J=4 needs (16-1)*15 = 225 > 32."""
    jm, tm = meshes["signal"]
    x = composite_sin(256, noise_std=0.1)
    got = tp.modwt_multilevel_tiled(torch.from_numpy(x), "db8", levels=4, mesh=tm,
                                    boundary=boundary)
    want = jp.modwt_multilevel_tiled(jnp.asarray(x), "db8", levels=4, mesh=jm,
                                     boundary=boundary, backend="jnp")
    assert _err(_planes(got), _planes(want)) <= TOL_F64
    xr = tp.imodwt_multilevel_tiled(got, "db8", mesh=tm, boundary=boundary)
    x_want = jp.imodwt_multilevel_tiled(want, "db8", mesh=jm, boundary=boundary, backend="jnp")
    assert _err((xr,), (x_want,)) <= TOL_F64


def test_batched_tiled_2d_mesh(meshes):
    jm, tm = meshes["2d"]
    x = np.stack([composite_sin(512, seed=s, noise_std=0.1) for s in range(4)])
    got = tp.modwt_multilevel_tiled(torch.from_numpy(x), "db4", levels=3, mesh=tm)
    want = jp.modwt_multilevel_tiled(jnp.asarray(x), "db4", levels=3, mesh=jm)
    assert _err(_planes(got), _planes(want)) <= TOL_F64
    got_b = tp.modwt_multilevel_tiled(torch.from_numpy(x), "db4", levels=3, mesh=tm,
                                      batch_axis="data")
    assert _err(_planes(got_b), _planes(want)) <= TOL_F64
    with pytest.raises(InvalidArgumentError) as got_e:
        tp.modwt_multilevel_tiled(torch.zeros(512, dtype=torch.float64), "db4", levels=2,
                                  mesh=tm, batch_axis="data")
    with pytest.raises(vw.InvalidArgumentError) as want_e:
        jp.modwt_multilevel_tiled(jnp.zeros(512), "db4", levels=2, mesh=jm, batch_axis="data")
    assert _code(got_e) == _code(want_e) == "VAL_007"


def test_shards_on_distinct_devices_match_one_device(meshes):
    """A mesh of eight distinct device objects takes the per-device path
    (shards stacked per device, halos moved with Tensor.to); it equals the
    one-device path."""
    _, tm = meshes["signal"]
    distinct = tp.make_mesh({"signal": 8}, devices=[torch.device("cpu", i) for i in range(8)])
    x = torch.from_numpy(np.stack([composite_sin(1024, seed=s, noise_std=0.2) for s in range(2)]))
    for boundary, backend in (("periodic", "kernel"), ("zero", "torch"), ("symmetric", "torch")):
        one = tp.modwt_multilevel_tiled(x, "db4", levels=4, mesh=tm, boundary=boundary,
                                        backend=backend)
        many = tp.modwt_multilevel_tiled(x, "db4", levels=4, mesh=distinct, boundary=boundary,
                                         backend=backend)
        assert _err(_planes(many), [p.numpy() for p in _planes(one)]) <= TOL_F64
        y_one = tp.imodwt_multilevel_tiled(one, "db4", mesh=tm, boundary=boundary,
                                           backend=backend)
        y_many = tp.imodwt_multilevel_tiled(many, "db4", mesh=distinct, boundary=boundary,
                                            backend=backend)
        assert _err((y_many,), (y_one.numpy(),)) <= TOL_F64


@pytest.mark.parametrize("boundary", ["periodic", "zero", "symmetric"])
def test_one_shard_mesh_equals_single_device(boundary):
    """A one-shard ring: the periodic halo is the shard's own tail, the zero
    one zeros."""
    one = tp.make_mesh({"signal": 1}, devices=[torch.device("cpu")])
    x = torch.from_numpy(composite_sin(512, noise_std=0.3))
    backend = "torch" if boundary == "symmetric" else "kernel"
    got = tp.modwt_multilevel_tiled(x, "db4", levels=6, mesh=one, boundary=boundary,
                                    backend=backend)
    want = vt.modwt_multilevel(x, "db4", levels=6, boundary=boundary)
    assert _err(_planes(got), [p.numpy() for p in _planes(want)]) <= TOL_F64
    y = tp.imodwt_multilevel_tiled(got, "db4", mesh=one, boundary=boundary, backend=backend)
    y_want = vt.imodwt_multilevel(want, "db4", boundary=boundary)
    assert _err((y,), (y_want.numpy(),)) <= TOL_F64


def test_tiled_roundtrip_check(meshes):
    _, tm = meshes["signal"]
    assert tp.tiled_roundtrip_check(tm) < 1e-5
    assert tp.tiled_roundtrip_check(tm, dtype=torch.float64, n=2048, levels=5) < 1e-12


# --- the batch facade and the host x chip layout ------------------------------------


def test_sharded_batch_facade(meshes):
    jm, tm = meshes["2d"]
    batch = np.stack([composite_sin(256, seed=s) for s in range(4)])
    got = tp.modwt_multilevel_sharded_batch(torch.from_numpy(batch), "db4", levels=3, mesh=tm,
                                            axis="data")
    want = jp.modwt_multilevel_sharded_batch(jnp.asarray(batch), "db4", levels=3, mesh=jm,
                                             axis="data")
    assert _err(_planes(got), _planes(want)) <= TOL_F64
    shards = tp.shard_batch(torch.from_numpy(batch), tm)
    assert len(shards) == 2 and all(s.shape == (2, 256) for s in shards)
    distinct = tp.make_mesh({"data": 2, "signal": 4},
                            devices=[torch.device("cpu", i) for i in range(8)])
    again = tp.modwt_multilevel_sharded_batch(torch.from_numpy(batch), "db4", levels=3,
                                              mesh=distinct, axis="data")
    assert _err(_planes(again), _planes(want)) <= TOL_F64
    with pytest.raises(InvalidArgumentError) as got_e:
        tp.shard_batch(torch.zeros(3, 8), tm)
    assert _code(got_e) == "VAL_007"


def test_config4_batch_256x16k_sharded():
    """BASELINE config #4: 256 x 16384 db4 J=4 through the batch facade."""
    tm = tp.make_mesh({"data": 8}, devices=CPU8)
    x = np.random.default_rng(1).standard_normal((256, 16384)).astype(np.float32)
    got = tp.modwt_multilevel_sharded_batch(torch.from_numpy(x), "db4", levels=4, mesh=tm,
                                            axis="data")
    whole = vt.modwt_multilevel(torch.from_numpy(x), "db4", levels=4)
    assert all(torch.equal(g, w) for g, w in zip(_planes(got), _planes(whole)))
    for row in (0, 100, 255):
        single = vw.modwt_multilevel(jnp.asarray(x[row]), "db4", levels=4)
        assert _err([p[row] for p in _planes(got)], _planes(single)) <= 1e-5


@pytest.mark.parametrize("boundary", ["periodic", "zero", "symmetric"])
def test_multihost_mesh_and_parity(meshes, boundary):
    jm, tm = meshes["hosts"]
    assert tm.shape == dict(jm.shape) == {"host": 2, "chip": 4}
    x = np.stack([composite_sin(512, seed=s, noise_std=0.2) for s in range(4)])
    got = tp.modwt_multilevel_multihost(torch.from_numpy(x), "db4", levels=3, mesh=tm,
                                        boundary=boundary)
    want = jp.modwt_multilevel_multihost(jnp.asarray(x), "db4", levels=3, mesh=jm,
                                         boundary=boundary)
    assert _err(_planes(got), _planes(want)) <= TOL_F64
    xr = tp.imodwt_multilevel_multihost(got, "db4", mesh=tm, boundary=boundary)
    x_want = jp.imodwt_multilevel_multihost(want, "db4", mesh=jm, boundary=boundary)
    assert _err((xr,), (x_want,)) <= TOL_F64


def test_multihost_validation(meshes):
    jm, tm = meshes["hosts"]
    for make in ((lambda: jp.make_multihost_mesh(n_hosts=16)),):
        with pytest.raises(vw.InvalidArgumentError) as want:
            make()
    with pytest.raises(InvalidArgumentError) as got:
        tp.make_multihost_mesh(n_hosts=16, devices=CPU8)
    assert _code(got) == _code(want) == "DIST_001"
    for jx, tx in ((jnp.zeros(512), torch.zeros(512)),  # 1-D input
                   (jnp.zeros((3, 512)), torch.zeros(3, 512))):  # batch not divisible
        with pytest.raises(vw.InvalidArgumentError) as want:
            jp.modwt_multilevel_multihost(jx, "db4", levels=2, mesh=jm)
        with pytest.raises(InvalidArgumentError) as got:
            tp.modwt_multilevel_multihost(tx, "db4", levels=2, mesh=tm)
        assert _code(got) == _code(want) == "VAL_007"


@pytest.mark.parametrize("wavelet,levels,n,batch,direction", [
    ("db4", 3, 4096, 4, "forward"), ("db4", 3, 4096, 4, "inverse_symmetric"),
    ("sym8", 6, 65536, 128, "forward"), ("haar", 1, 1024, 2, "forward"),
])
def test_communication_report_equals_jax(meshes, wavelet, levels, n, batch, direction):
    jm, tm = meshes["hosts"]
    got = tp.communication_report(tm, wavelet, levels=levels, n=n, batch=batch,
                                  direction=direction)
    want = jp.communication_report(jm, wavelet, levels=levels, n=n, batch=batch,
                                   direction=direction)
    assert tuple(got) == tuple(want)
    assert got._fields == want._fields
    one_chip = tp.make_multihost_mesh(2, 1, devices=CPU8)
    assert tp.communication_report(one_chip, wavelet, levels=levels, n=n, batch=batch) == \
        jp.communication_report(jp.make_multihost_mesh(2, 1), wavelet, levels=levels, n=n,
                                batch=batch)
    with pytest.raises(InvalidArgumentError) as got_e:
        tp.communication_report(tm, wavelet, levels=levels, n=n, batch=3)
    with pytest.raises(vw.InvalidArgumentError) as want_e:
        jp.communication_report(jm, wavelet, levels=levels, n=n, batch=3)
    assert _code(got_e) == _code(want_e)


# --- the kernel route: the plain versions against the JAX Pallas tiled route -----------


@pytest.mark.parametrize("boundary", ["periodic", "zero"])
def test_tiled_kernel_route_matches_jax_pallas(meshes, boundary):
    jm, tm = meshes["signal"]
    x = composite_sin(2048, noise_std=0.3).astype(np.float32)
    want = jp.modwt_multilevel_tiled(jnp.asarray(x), "db4", levels=3, mesh=jm,
                                     boundary=boundary, backend="pallas", precision="float32")
    got = tp.modwt_multilevel_tiled(torch.from_numpy(x), "db4", levels=3, mesh=tm,
                                    boundary=boundary, backend="pallas", precision="float32")
    assert all(p.dtype == torch.float32 for p in _planes(got))
    assert _err(_planes(got), _planes(want)) <= TOL_KERNEL
    xr = tp.imodwt_multilevel_tiled(got, "db4", mesh=tm, boundary=boundary, backend="kernel")
    x_want = jp.imodwt_multilevel_tiled(want, "db4", mesh=jm, boundary=boundary,
                                        backend="pallas", precision="float32")
    assert _err((xr,), (x_want,)) <= TOL_KERNEL
    if boundary == "periodic":
        assert float((xr - torch.from_numpy(x)).abs().max()) <= 1e-5


def test_tiled_kernel_route_deep_halo_and_batch(meshes):
    """Cumulative halo wider than a shard (225 > 128: two hops) and a batch
    axis over a 2 x 4 mesh."""
    jm, tm = meshes["2d"]
    x = np.random.default_rng(5).standard_normal((4, 512)).astype(np.float32)
    want = jp.modwt_multilevel_tiled(jnp.asarray(x), "db8", levels=4, mesh=jm, axis="signal",
                                     batch_axis="data", backend="pallas", precision="float32")
    got = tp.modwt_multilevel_tiled(torch.from_numpy(x), "db8", levels=4, mesh=tm,
                                    axis="signal", batch_axis="data", backend="kernel")
    assert _err(_planes(got), _planes(want)) <= TOL_KERNEL
    xr = tp.imodwt_multilevel_tiled(got, "db8", mesh=tm, axis="signal", batch_axis="data",
                                    backend="kernel")
    x_want = jp.imodwt_multilevel_tiled(want, "db8", mesh=jm, axis="signal", batch_axis="data",
                                        backend="pallas", precision="float32")
    assert _err((xr,), (x_want,)) <= TOL_KERNEL
    assert float((xr - torch.from_numpy(x)).abs().max()) <= 1e-5


def test_tiled_kernel_route_keeps_every_wrap_where_jax_does_not(meshes):
    """The fault: db4 J=8, span (L-1)(2^J-1) = 1785 > N = 1024.  The port's
    kernel route matches the single-device float64 transform; JAX's Pallas
    tiled route caps its halo at N and strays by more than 1e-3."""
    jm, tm = meshes["signal"]
    x = np.random.default_rng(11).standard_normal((2, 1024)).astype(np.float32)
    ref = vt.modwt_multilevel(torch.from_numpy(x.astype(np.float64)), "db4", levels=8)
    got = tp.modwt_multilevel_tiled(torch.from_numpy(x), "db4", levels=8, mesh=tm,
                                    backend="kernel")
    assert _err(_planes(got), [p.numpy() for p in _planes(ref)]) <= TOL_KERNEL
    xr = tp.imodwt_multilevel_tiled(got, "db4", mesh=tm, backend="kernel")
    assert float((xr - torch.from_numpy(x)).abs().max()) <= 1e-5
    stray = jp.modwt_multilevel_tiled(jnp.asarray(x), "db4", levels=8, mesh=jm,
                                      backend="pallas", precision="float32")
    assert _err([torch.from_numpy(np.array(p)) for p in _planes(stray)],
                [p.numpy() for p in _planes(ref)]) > 1e-3


def test_kernel_route_hands_the_kernels_contiguous_rows(meshes, monkeypatch):
    """The CUDA kernels take contiguous [rows, n] tensors: the shard rows and
    the halos of a hop chain (a narrowed view) reach them contiguous, from a
    transposed input too."""
    _, tm = meshes["signal"]
    seen = []

    def checked(fn):
        def run(planes, *args, halo=None, **kwargs):
            for t in (planes, halo):
                for u in (t if isinstance(t, tuple) else (t,)):
                    seen.append(u.is_contiguous())
            return fn(planes, *args, halo=halo, **kwargs)
        return run

    monkeypatch.setattr(mc, "analysis", checked(mc.analysis))
    monkeypatch.setattr(mc, "synthesis", checked(mc.synthesis))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1024, 2)).astype(np.float32)).T
    res = tp.modwt_multilevel_tiled(x, "db4", levels=8, mesh=tm, backend="kernel")
    tp.imodwt_multilevel_tiled(res, "db4", mesh=tm, backend="kernel")
    assert len(seen) == 2 + 2 * 9 and all(seen)


def test_tiled_backend_validation(meshes):
    jm, tm = meshes["signal"]
    for kwargs, code in (({"backend": "cuda"}, "CFG_003"),
                         ({"boundary": "symmetric", "backend": "pallas"}, "CFG_002"),
                         ({"boundary": "symmetric", "backend": "kernel"}, "CFG_002")):
        with pytest.raises(InvalidArgumentError) as got:
            tp.modwt_multilevel_tiled(torch.zeros(1024), "db4", levels=2, mesh=tm, **kwargs)
        assert _code(got) == code
        if kwargs["backend"] != "kernel":
            with pytest.raises(vw.InvalidArgumentError) as want:
                jp.modwt_multilevel_tiled(jnp.zeros(1024, dtype=jnp.float32), "db4", levels=2,
                                          mesh=jm, **kwargs)
            assert _code(want) == code


@pytest.mark.parametrize("halo_len", [3, 10])
@pytest.mark.parametrize("wrap", [True, False])
def test_gather_halos_sends_every_plane_in_one_exchange(meshes, monkeypatch, halo_len, wrap):
    """Several planes' halos go round the ring together: one exchange a hop
    for all of them, each halo equal to its own gather and contiguous."""
    _, tm = meshes["signal"]
    rng = np.random.default_rng(5)
    planes = tuple(torch.from_numpy(rng.standard_normal((2, 8, 4))) for _ in range(7))
    _, from_right = tt._ring_perms("signal", tm, wrap)
    want = [tt._gather_halo(p, halo_len, from_right, "right") for p in planes]
    exchanges = []

    def counted(blocks, perm):
        exchanges.append(blocks.shape)
        return ppermute(blocks, perm)

    ppermute = tt._ppermute
    monkeypatch.setattr(tt, "_ppermute", counted)
    got = tt._gather_halos(planes, halo_len, from_right, "right")
    assert len(exchanges) == -(-halo_len // 4)
    assert len(got) == len(planes)
    for g, w in zip(got, want):
        assert g.is_contiguous() and torch.equal(g, w)


def test_precision_is_checked_on_every_route(meshes):
    """An unknown precision raises on the plain route (CPU, float64,
    symmetric) as it does on the kernel route, in both directions and
    through the host x chip facades."""
    _, tm = meshes["signal"]
    _, hosts = meshes["hosts"]
    x = torch.zeros(2, 1024, dtype=torch.float64)
    res = tp.modwt_multilevel_tiled(x, "db4", levels=2, mesh=tm, boundary="symmetric")
    calls = (
        lambda: tp.modwt_multilevel_tiled(x, "db4", levels=2, mesh=tm, boundary="symmetric",
                                          precision="fp16"),
        lambda: tp.imodwt_multilevel_tiled(res, "db4", mesh=tm, boundary="symmetric",
                                           precision="fp16"),
        lambda: tp.modwt_multilevel_tiled(x.float(), "db4", levels=2, mesh=tm,
                                          backend="kernel", precision="fp16"),
        lambda: tp.modwt_multilevel_multihost(x, "db4", levels=2, mesh=hosts,
                                              precision="fp16"),
        lambda: tp.imodwt_multilevel_multihost(res, "db4", mesh=hosts, precision="fp16"),
    )
    for call in calls:
        with pytest.raises(InvalidArgumentError) as got:
            call()
        assert _code(got) == "CFG_003"


def test_auto_routes_by_the_mesh_devices(monkeypatch):
    """``auto``: the kernel route only on a mesh of Hopper cards, for
    periodic/zero float32 or bfloat16 whose windows fit; else the plain
    route, decided before any launch."""
    from vectorwave_tpu_torch.kernels import modwt_fused

    cards = tp.make_mesh({"signal": 4}, devices=[torch.device("cuda")] * 4)
    cpus = tp.make_mesh({"signal": 4}, devices=CPU8[:4])

    def route(mesh, boundary="periodic", dtype=torch.float32, taps=8, levels=6):
        tiles = tt._tiles(mesh, "signal", None, (2, 4096), -1)
        return tt._resolve_tiled_backend("auto", boundary, tiles, dtype, taps, levels)

    monkeypatch.setattr(modwt_fused, "kernel_available", lambda: True)
    assert route(cards) == route(cards, "zero") == route(cards, dtype=torch.bfloat16) == "kernel"
    assert route(cards, "symmetric") == route(cards, dtype=torch.float64) == "torch"
    assert not mc.kernels_fit(76, 10) and route(cards, taps=76, levels=10) == "torch"
    # sym8 J=9: the pair fits, whatever the fused denoise would ask
    assert route(cards, taps=16, levels=9) == route(cards, taps=8, levels=10) == "kernel"
    assert route(cpus) == "torch"
    monkeypatch.setattr(modwt_fused, "kernel_available", lambda: False)
    assert route(cards) == "torch"


# --- the synthesis kernel's external right halo: plain version vs the JAX kernel -------


@pytest.mark.parametrize("name,levels", [("db4", 3), ("sym8", 4)])
@pytest.mark.parametrize("halo_kind", ["short", "span", "long"])
def test_synthesis_external_halo_matches_jax_kernel(name, levels, halo_kind):
    """A halo shorter than the span (zeros after it), equal to it, and longer
    (only its first span samples count)."""
    fr = _kernel_filters(vt.wavelet(name), synthesis=True)
    span = mc.composite_halo_samples(len(fr[0]), levels)
    h = {"short": span // 3, "span": span, "long": span + 300}[halo_kind]
    rng = np.random.default_rng(levels)
    planes = [rng.standard_normal((2, 1024)).astype(np.float32) for _ in range(levels + 1)]
    halo = [rng.standard_normal((2, h)).astype(np.float32) for _ in range(levels + 1)]
    want = run_synthesis_composite(tuple(map(jnp.asarray, planes)), levels, fr, False, 65536,
                                   "float32", True, halo=tuple(map(jnp.asarray, halo)))
    got = mc.synthesis(tuple(map(torch.from_numpy, planes)), levels, fr, False,
                       halo=tuple(map(torch.from_numpy, halo)))
    assert got.dtype == torch.float32 and got.shape == (2, 1024)
    exact = mc.synthesis(tuple(torch.from_numpy(p).double() for p in planes), levels, fr,
                         False, halo=tuple(torch.from_numpy(p).double() for p in halo))
    assert _err((exact,), (want,)) <= TOL_KERNEL
    assert float((got.double() - exact).abs().max()) <= 2 * TOL_KERNEL


def test_synthesis_halo_refusals():
    fr = _kernel_filters(vt.wavelet("db4"), synthesis=True)
    planes = tuple(torch.zeros(2, 64) for _ in range(4))
    halo = tuple(torch.zeros(2, 8) for _ in range(4))
    with pytest.raises(InvalidArgumentError, match="periodic"):
        mc.synthesis(planes, 3, fr, True, halo=halo)
    with pytest.raises(InvalidArgumentError, match="per plane"):
        mc.synthesis(planes, 3, fr, False, halo=halo[:2])
