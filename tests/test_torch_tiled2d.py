"""Port parity: the 2-D MODWT tiled along H (``parallel.tiled2d``), against
vectorwave_tpu.  Mirrors ``tests/test_tiled2d.py``.

The port runs on a mesh of ``[torch.device("cpu")] * 4`` (and of 2 x 4 for
the batch axis), JAX on the conftest's virtual devices.  Both tile the
same float64 images; the plain route against JAX's tiled jnp route: 1e-12
(the same à trous sums, in another order at most).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import vectorwave_tpu_torch as vt
from vectorwave_tpu import parallel as jp
from vectorwave_tpu_torch import parallel as tp
from vectorwave_tpu_torch.errors import InvalidArgumentError

torch.set_num_threads(1)

TOL_F64 = 1e-12
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def meshes():
    return Mesh(np.array(jax.devices()[:4]), ("rows",)), tp.make_mesh({"rows": 4},
                                                                      devices=[CPU] * 4)


def _bands(res):
    return [p for trip in res.details for p in trip] + [res.approx]


def _err(got, want) -> float:
    return max(float(np.max(np.abs(g.numpy() - np.asarray(w)))) for g, w in zip(got, want))


@pytest.mark.parametrize("boundary", ["periodic", "zero", "symmetric"])
@pytest.mark.parametrize("name,levels,shape", [
    ("db4", 3, (2, 128, 96)), ("haar", 4, (2, 128, 96)),
    ("db4", 3, (64, 128)),  # span 49 > 16 rows a shard: the hop chain
    ("db4", 4, (64, 128)),  # span 105 > H: periodic gathers the image
])
def test_tiled2d_round_trip_matches_jax(meshes, name, levels, shape, boundary):
    jm, tm = meshes
    x = np.random.default_rng(levels).standard_normal(shape)
    want = jp.modwt2_multilevel_tiled(jnp.asarray(x), name, levels=levels, mesh=jm,
                                      boundary=boundary)
    got = tp.modwt2_multilevel_tiled(torch.from_numpy(x), name, levels=levels, mesh=tm,
                                     boundary=boundary)
    assert _err(_bands(got), _bands(want)) <= TOL_F64
    single = vt.modwt2_multilevel(torch.from_numpy(x), name, levels=levels, boundary=boundary)
    assert _err(_bands(got), [p.numpy() for p in _bands(single)]) <= TOL_F64
    xr = tp.imodwt2_multilevel_tiled(got, name, mesh=tm, boundary=boundary)
    x_want = jp.imodwt2_multilevel_tiled(want, name, mesh=jm, boundary=boundary)
    assert xr.shape == x.shape and _err((xr,), (x_want,)) <= TOL_F64
    if boundary == "periodic":
        assert float((xr - torch.from_numpy(x)).abs().max()) <= 1e-12


def test_tiled2d_batch_axis():
    jm = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("batch", "rows"))
    tm = tp.make_mesh({"batch": 2, "rows": 4}, devices=[CPU] * 8)
    x = np.random.default_rng(3).standard_normal((4, 64, 96))
    want = jp.modwt2_multilevel_tiled(jnp.asarray(x), "haar", levels=2, mesh=jm,
                                      boundary="periodic", batch_axis="batch")
    got = tp.modwt2_multilevel_tiled(torch.from_numpy(x), "haar", levels=2, mesh=tm,
                                     boundary="periodic", batch_axis="batch")
    assert _err(_bands(got), _bands(want)) <= TOL_F64
    xr = tp.imodwt2_multilevel_tiled(got, "haar", mesh=tm, boundary="periodic",
                                     batch_axis="batch")
    assert float((xr - torch.from_numpy(x)).abs().max()) <= 1e-12


def test_tiled2d_distinct_devices_match_one_device(meshes):
    _, tm = meshes
    distinct = tp.make_mesh({"rows": 4}, devices=[torch.device("cpu", i) for i in range(4)])
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 64, 96)))
    for boundary in ("periodic", "zero"):
        one = tp.modwt2_multilevel_tiled(x, "db4", levels=2, mesh=tm, boundary=boundary)
        many = tp.modwt2_multilevel_tiled(x, "db4", levels=2, mesh=distinct, boundary=boundary)
        assert _err(_bands(many), [p.numpy() for p in _bands(one)]) <= TOL_F64
        y = tp.imodwt2_multilevel_tiled(many, "db4", mesh=distinct, boundary=boundary)
        y_one = tp.imodwt2_multilevel_tiled(one, "db4", mesh=tm, boundary=boundary)
        assert _err((y,), (y_one.numpy(),)) <= TOL_F64


def test_tiled2d_validation(meshes):
    jm, tm = meshes
    with pytest.raises(InvalidArgumentError) as got:
        tp.modwt2_multilevel_tiled(torch.zeros(66, 64), "db4", levels=2, mesh=tm)
    assert got.value.code.value == "DIST_002"
    with pytest.raises(InvalidArgumentError) as got:
        tp.modwt2_multilevel_tiled(torch.zeros(64, 64), "db4", levels=2, mesh=tm,
                                   batch_axis="rows")
    assert got.value.code.value == "VAL_007"
    with pytest.raises(InvalidArgumentError) as got:
        tp.modwt2_multilevel_tiled(torch.zeros(64, 64), "db4", levels=2, mesh=tm, axis="cols")
    assert got.value.code.value == "DIST_001"
