"""Port parity: the tiled CWT (``parallel.cwt_tiled``, ``cwt_tiled_2d``),
mirroring ``tests/test_cwt_tiled.py`` and the config #5 case of
``tests/test_baseline_configs.py``.

The same seeded numpy signals go through ``vectorwave_tpu.parallel`` on the
conftest's 8 virtual CPU devices and through ``vectorwave_tpu_torch.parallel``
on a mesh of ``[torch.device("cpu")] * 8`` (eight shards on one CPU), in
float64.  Tolerances, with their reasons:

* against JAX's tiled result: 1e-12 of the largest coefficient (the same
  FFT products at the same tile FFT size, in another FFT library);
* against the single-device ``cwt`` (the port's and JAX's): 1e-10 of the
  largest coefficient, BASELINE config #5's bar, zero and periodic edges;
* ``analytic=True`` on a real wavelet takes the Hilbert transform per
  extended tile, which is approximate near tile edges by design: held to
  JAX's tiled result, not to the single-device one;
* errors: the same codes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from vectorwave_tpu import parallel as jp
from vectorwave_tpu_torch import parallel as tp
from vectorwave_tpu_torch.errors import InvalidArgumentError

torch.set_num_threads(1)

TOL_JAX = 1e-12
TOL_SINGLE = 1e-10
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def meshes():
    return {
        "signal": (jp.make_mesh({"signal": 8}), tp.make_mesh({"signal": 8}, devices=CPU8)),
        "hosts": (jp.make_multihost_mesh(n_hosts=2, chips_per_host=4),
                  tp.make_multihost_mesh(n_hosts=2, chips_per_host=4, devices=CPU8)),
    }


def _signal(n, seed=0):
    t = np.arange(n)
    noise = np.random.default_rng(seed).standard_normal(n)
    return np.sin(2 * np.pi * t / 32) + 0.5 * np.sin(2 * np.pi * t / 128) + 0.1 * noise


def _rel(got, want) -> float:
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


# (wavelet, n, scales, boundary): test_cwt_tiled.py's real, complex and
# multi-hop cases (mexh's 192-sample halo is wider than a 128-sample shard),
# each also periodic, which JAX's tests lack
CASES = [
    ("morl", 2048, tuple(vw.scales_log(2, 32, 16)), "zero"),
    ("morl", 2048, tuple(vw.scales_log(2, 32, 16)), "periodic"),
    ("cmor", 2048, tuple(vw.scales_log(2, 16, 8)), "zero"),
    ("cmor", 2048, tuple(vw.scales_log(2, 16, 8)), "periodic"),
    ("mexh", 1024, (8.0, 48.0), "zero"),
    ("mexh", 1024, (8.0, 48.0), "periodic"),
]


@pytest.mark.parametrize("name,n,scales,boundary", CASES)
def test_tiled_matches_jax_tiled_and_the_single_device_cwt(meshes, name, n, scales, boundary):
    jmesh, tmesh = meshes["signal"]
    x = _signal(n)
    want = jp.cwt_tiled(jnp.asarray(x), scales, name, mesh=jmesh, boundary=boundary).coeffs
    got = tp.cwt_tiled(torch.from_numpy(x), scales, name, mesh=tmesh, boundary=boundary)
    assert got.boundary == boundary and got.scales == scales
    assert _rel(got.coeffs, want) <= TOL_JAX
    single = vt.cwt(torch.from_numpy(x), scales, name, boundary=boundary).coeffs
    assert _rel(got.coeffs, single.numpy()) <= TOL_SINGLE


@pytest.mark.parametrize("boundary", ["zero", "periodic"])
def test_config5_64_scales_on_8_shards(meshes, boundary):
    """BASELINE config #5 cut to 2^14 samples for the CPU mesh: 64 log
    scales 2-128 on 8 shards, within 1e-10 of the single-device ``cwt`` of
    both packages."""
    jmesh, tmesh = meshes["signal"]
    n = 1 << 14
    t = np.arange(n)
    x = np.sin(2 * np.pi * t / 512) + 0.5 * np.sin(2 * np.pi * t / 64)
    scales = tuple(vw.scales_log(2, 128, 64))
    got = tp.cwt_tiled(torch.from_numpy(x), scales, "morl", mesh=tmesh, boundary=boundary).coeffs
    want_single = vw.cwt(jnp.asarray(x), scales, "morl", boundary=boundary).coeffs
    assert _rel(got, want_single) <= TOL_SINGLE
    want = jp.cwt_tiled(jnp.asarray(x), scales, "morl", mesh=jmesh, boundary=boundary).coeffs
    assert _rel(got, want) <= TOL_JAX


def test_analytic_real_wavelet_is_held_to_jax_tiled(meshes):
    jmesh, tmesh = meshes["signal"]
    x = _signal(2048, seed=1)
    scales = tuple(vw.scales_log(2, 32, 8))
    want = jp.cwt_tiled(jnp.asarray(x), scales, "morl", mesh=jmesh, analytic=True).coeffs
    got = tp.cwt_tiled(torch.from_numpy(x), scales, "morl", mesh=tmesh, analytic=True).coeffs
    assert got.is_complex()
    assert _rel(got, want) <= TOL_JAX
    single = vt.cwt(torch.from_numpy(x), scales, "morl", analytic=True).coeffs
    assert 1e-8 < _rel(got, single.numpy()) < 5e-3  # tile-local Hilbert, as JAX documents


def test_batch_and_distinct_devices(meshes):
    """Leading axes are rows of the tiling; a mesh whose shards lie on
    devices that compare unequal (``cpu`` and ``cpu:0``) computes run by
    run and moves each run's tiles with ``Tensor.to``."""
    _, tmesh = meshes["signal"]
    x = np.random.default_rng(2).standard_normal((3, 2, 1024))
    scales = (2.0, 5.0, 9.0)
    want = vt.cwt(torch.from_numpy(x), scales, "morl", boundary="periodic").coeffs
    got = tp.cwt_tiled(torch.from_numpy(x), scales, "morl", mesh=tmesh, boundary="periodic")
    assert _rel(got.coeffs, want.numpy()) <= TOL_SINGLE
    mixed = tp.make_mesh({"signal": 8}, devices=["cpu", "cpu", "cpu:0", "cpu:0", "cpu:0",
                                                  "cpu", "cpu:0", "cpu"])
    got = tp.cwt_tiled(torch.from_numpy(x), scales, "morl", mesh=mixed, boundary="periodic")
    assert _rel(got.coeffs, want.numpy()) <= TOL_SINGLE


@pytest.mark.parametrize("name,n,scales,boundary", [
    ("morl", 1024, tuple(vw.scales_log(2.0, 16.0, 8)), "zero"),
    ("cmor", 512, (2.0, 4.0, 6.0, 8.0), "zero"),
    ("morl", 4096, (2.0, 4.0), "periodic"),
])
def test_tiled_2d_matches_jax_and_the_single_device_cwt(meshes, name, n, scales, boundary):
    """Scales over 'host', the signal over 'chip' (config #5's layout)."""
    jmesh, tmesh = meshes["hosts"]
    x = _signal(n, seed=3)
    want = jp.cwt_tiled_2d(jnp.asarray(x), scales, name, mesh=jmesh, boundary=boundary).coeffs
    got = tp.cwt_tiled_2d(torch.from_numpy(x), scales, name, mesh=tmesh, boundary=boundary)
    assert got.coeffs.shape == (len(scales), n)
    assert _rel(got.coeffs, want) <= TOL_JAX
    single = vt.cwt(torch.from_numpy(x), scales, name, boundary=boundary).coeffs
    assert _rel(got.coeffs, single.numpy()) <= TOL_SINGLE


def _code(excinfo) -> str:
    return excinfo.value.code.value


def test_errors_match_jax(meshes):
    """Each refusal of ``test_cwt_tiled.py`` raises the same error code."""
    (jmesh, tmesh), (jhm, thm) = meshes["signal"], meshes["hosts"]
    cases = [
        (lambda m, a: (jp if a is jnp else tp).cwt_tiled(a.zeros(1001), (4.0,), "morl",
                                                          mesh=m), "signal"),
        # a halo past the reachable span: 7 shards of 16 samples
        (lambda m, a: (jp if a is jnp else tp).cwt_tiled(a.zeros(128), (64.0,), "morl",
                                                          mesh=m), "signal"),
        (lambda m, a: (jp if a is jnp else tp).cwt_tiled_2d(a.zeros((2, 512)), (2.0, 4.0),
                                                             "morl", mesh=m), "hosts"),
        (lambda m, a: (jp if a is jnp else tp).cwt_tiled_2d(a.zeros(512), (2.0, 4.0, 6.0),
                                                             "morl", mesh=m), "hosts"),
        (lambda m, a: (jp if a is jnp else tp).cwt_tiled_2d(a.zeros(510), (2.0, 4.0), "morl",
                                                             mesh=m), "hosts"),
        (lambda m, a: (jp if a is jnp else tp).cwt_tiled(a.zeros(512), (), "morl", mesh=m),
         "signal"),
        (lambda m, a: (jp if a is jnp else tp).cwt_tiled_2d(a.zeros(512), (-2.0, 4.0), "morl",
                                                             mesh=m), "hosts"),
        (lambda m, a: (jp if a is jnp else tp).cwt_tiled(a.zeros(512), (2.0,), "db4", mesh=m),
         "signal"),
    ]
    for call, which in cases:
        jm, tm = meshes[which]
        with pytest.raises(vw.InvalidArgumentError) as want:
            call(jm, jnp)
        with pytest.raises(InvalidArgumentError) as got:
            call(tm, torch)
        assert _code(got) == _code(want) and str(got.value) == str(want.value)


def test_two_custom_wavelets_do_not_share_a_bank(meshes):
    """Two wavelets with one (name, fc, bw) but different psi: the bank
    spectrum is keyed by the wavelet object, not its name."""
    from vectorwave_tpu_torch.wavelets.base import ContinuousWavelet

    def mk(width):
        return ContinuousWavelet(
            name="custom-x", family="Custom",
            psi=lambda t, wdt=width: np.exp(-(t / wdt) ** 2) * np.cos(5 * t),
            center_frequency=0.8, bandwidth=1.0,
        )

    _, tmesh = meshes["signal"]
    x = torch.from_numpy(_signal(512, seed=4))
    a = tp.cwt_tiled(x, (2.0, 4.0), mk(1.0), mesh=tmesh).coeffs
    b = tp.cwt_tiled(x, (2.0, 4.0), mk(0.5), mesh=tmesh).coeffs
    assert float((a - b).abs().max()) > 1e-3
