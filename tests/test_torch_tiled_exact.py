"""Port parity: the sharded exact tier and the exact pair's external halos,
against vectorwave_tpu.  Mirrors ``tests/test_tiled_exact.py``.

The port runs on a mesh of ``[torch.device("cpu")] * 8`` (on the CPU the
exact kernels' float64 plain versions), JAX on the conftest's 8 virtual
devices.  Tolerances, with their reasons:

* the tiled exact round trip: RMSE of hi + lo against x <= 1e-10 (the
  tier's contract, BASELINE.json's parity bar);
* the tiled exact planes against the float64 single-device oracle (JAX's
  jnp transform): 1e-11, the JAX test's bound (the port computes in fp64
  and lands near 1e-15);
* the halo modes' plain versions against ``analysis_exact(halo=)`` and
  ``synthesis_exact(halo=)`` in interpret mode (``profile='full'``, whose
  error is ~1e-13): 1e-12 on hi + lo.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from vectorwave_tpu import parallel as jp
from vectorwave_tpu.kernels import modwt_exact as jax_exact
from vectorwave_tpu.kernels.modwt_pallas import _kernel_filters as jax_kernel_filters
from vectorwave_tpu_torch import parallel as tp
from vectorwave_tpu_torch.errors import InvalidArgumentError
from vectorwave_tpu_torch.kernels import modwt_composite as mc
from vectorwave_tpu_torch.kernels import modwt_exact as port_exact
from vectorwave_tpu_torch.kernels.modwt_fused import _kernel_filters

torch.set_num_threads(1)

TOL_ORACLE = 1e-11
TOL_HALO = 1e-12


@pytest.fixture(scope="module")
def mesh():
    return tp.make_mesh({"signal": 8}, devices=[torch.device("cpu")] * 8)


def _x32(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _combined(pair) -> np.ndarray:
    hi, lo = pair
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def _oracle_err(pairs, x, name, levels, boundary):
    ref = vw.modwt_multilevel(jnp.asarray(x.astype(np.float64)), name, levels=levels,
                              boundary=boundary, backend="jnp")
    return max(float(np.max(np.abs(_combined(p) - np.asarray(w))))
               for p, w in zip(pairs, (*ref.details, ref.approx)))


def _rmse(pair, x) -> float:
    return float(np.sqrt(np.mean((_combined(pair) - x.astype(np.float64)) ** 2)))


def test_tiled_exact_roundtrip_below_1e10(mesh):
    x = _x32(8192, 0)
    details, approx = tp.modwt_multilevel_tiled_exact(torch.from_numpy(x), "db4", levels=4,
                                                      mesh=mesh)
    assert all(h.dtype == l.dtype == torch.float32 and h.shape == (8192,)
               for h, l in (*details, approx))
    hi, lo = tp.imodwt_multilevel_tiled_exact(details, approx, "db4", mesh=mesh)
    assert _rmse((hi, lo), x) <= 1e-10


@pytest.mark.parametrize("name,levels,n,boundary", [
    ("sym8", 3, 4096, "periodic"), ("db4", 3, 4096, "zero"),
    ("db8", 6, 1024, "periodic"),  # span 945 over 128-sample shards: an 8-hop chain
    ("db8", 7, 1024, "periodic"),  # span 1905 >= N: the gathered signal
    ("db4", 8, 1024, "zero"),  # span 1785 > N, zero edge: the chain's zeros
])
def test_tiled_exact_matches_f64_oracle(mesh, name, levels, n, boundary):
    x = _x32((2, n), levels + n)
    details, approx = tp.modwt_multilevel_tiled_exact(torch.from_numpy(x), name,
                                                      levels=levels, mesh=mesh,
                                                      boundary=boundary)
    assert _oracle_err((*details, approx), x, name, levels, boundary) <= TOL_ORACLE
    if boundary == "periodic":
        hi, lo = tp.imodwt_multilevel_tiled_exact(details, approx, name, mesh=mesh)
        assert _rmse((hi, lo), x) <= 1e-10


def test_tiled_exact_batch_axis_and_jax_round_trip():
    jm = jp.make_mesh({"data": 2, "signal": 4})
    tm = tp.make_mesh({"data": 2, "signal": 4}, devices=[torch.device("cpu")] * 8)
    x = _x32((4, 2048), 7)
    details, approx = tp.modwt_multilevel_tiled_exact(torch.from_numpy(x), "db4", levels=3,
                                                      mesh=tm, batch_axis="data")
    assert _oracle_err((*details, approx), x, "db4", 3, "periodic") <= TOL_ORACLE
    hi, lo = jp.imodwt_multilevel_tiled_exact(
        tuple((jnp.asarray(h.numpy()), jnp.asarray(l.numpy())) for h, l in details),
        (jnp.asarray(approx[0].numpy()), jnp.asarray(approx[1].numpy())), "db4",
        mesh=jm, batch_axis="data", interpret=True)
    assert _rmse((hi, lo), x) <= 1e-10


def test_tiled_exact_validation(mesh):
    jm = jp.make_mesh({"signal": 8})
    with pytest.raises(vw.InvalidArgumentError) as want:
        jp.modwt_multilevel_tiled_exact(jnp.zeros(1024, jnp.float32), "db4", levels=2,
                                        mesh=jm, boundary="symmetric", interpret=True)
    with pytest.raises(InvalidArgumentError) as got:
        tp.modwt_multilevel_tiled_exact(torch.zeros(1024), "db4", levels=2, mesh=mesh,
                                        boundary="symmetric")
    assert got.value.code.value == want.value.code.value == "CFG_002"
    with pytest.raises(InvalidArgumentError) as got:
        tp.modwt_multilevel_tiled_exact(torch.zeros(1024), "db4", levels=2, mesh=mesh,
                                        profile="fast")
    assert got.value.code.value == "CFG_003"
    with pytest.raises(InvalidArgumentError) as got:
        tp.modwt_multilevel_tiled_exact(torch.zeros(1001), "db4", levels=2, mesh=mesh)
    assert got.value.code.value == "DIST_002"


def test_exact_symmetric_analysis_matches_f64():
    """Per-level mirrored exact cascade == f64 jnp symmetric analysis."""
    x = _x32((2, 2048), 3)
    details, approx = vt.modwt_multilevel_exact(torch.from_numpy(x), "db4", levels=3,
                                                boundary="symmetric")
    assert _oracle_err((*details, approx), x, "db4", 3, "symmetric") <= TOL_ORACLE


# --- the exact pair's external halos: plain versions vs the JAX kernels -------------


@pytest.mark.parametrize("name,levels", [("db4", 3), ("sym8", 2)])
@pytest.mark.parametrize("halo_kind", ["short", "span", "long"])
def test_exact_halos_match_jax_kernels(name, levels, halo_kind):
    """Left halo of raw samples (with a lo word on x) and right (hi, lo)
    halo pairs, shorter than the span, equal to it and longer."""
    span = mc.composite_halo_samples(vt.wavelet(name).filter_length, levels)
    h = {"short": span // 3, "span": span, "long": span + 200}[halo_kind]
    x, halo = _x32((2, 1024), 1), _x32((2, h), 2)
    x_lo = (_x32((2, 1024), 3) * np.abs(x) * 2.0**-26).astype(np.float32)
    fd_j = jax_kernel_filters(vw.wavelet(name), synthesis=False)
    fr_j = jax_kernel_filters(vw.wavelet(name), synthesis=True)
    want = jax_exact.analysis_exact(jnp.asarray(x), levels, fd_j, False, interpret=True,
                                    x_lo=jnp.asarray(x_lo), halo=jnp.asarray(halo),
                                    profile="full")
    got = port_exact.analysis_exact(torch.from_numpy(x), levels,
                                    _kernel_filters(vt.wavelet(name), synthesis=False), False,
                                    x_lo=torch.from_numpy(x_lo), halo=torch.from_numpy(halo))
    assert max(float(np.max(np.abs(_combined(g) - _combined(w))))
               for g, w in zip(got, want)) <= TOL_HALO
    pairs = [(_x32((2, 1024), 10 + i), _x32((2, 1024), 20 + i) * 2.0**-26)
             for i in range(levels + 1)]
    halos = [(_x32((2, h), 30 + i), _x32((2, h), 40 + i) * 2.0**-26) for i in range(levels + 1)]
    y_want = jax_exact.synthesis_exact(
        tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in pairs), levels, fr_j, False,
        interpret=True, halo=tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in halos),
        profile="full")
    y_got = port_exact.synthesis_exact(
        tuple((torch.from_numpy(a), torch.from_numpy(b)) for a, b in pairs), levels,
        _kernel_filters(vt.wavelet(name), synthesis=True), False,
        halo=tuple((torch.from_numpy(a), torch.from_numpy(b)) for a, b in halos))
    assert float(np.max(np.abs(_combined(y_got) - _combined(y_want)))) <= TOL_HALO


def test_exact_halo_plans():
    """db4 J=6 (config #2) is one window launch, whose halo goes to the load
    rule; sym8 J=10 splits over two launches, and db38 J=9 runs its deep
    levels direct: both materialise [halo | x] on the card."""
    for name, levels, one in (("db4", 6, True), ("sym8", 10, False), ("db38", 9, False)):
        taps = vt.wavelet(name).filter_length
        for bytes_fn in (mc.exact_analysis_shared_bytes, mc.exact_synthesis_shared_bytes):
            assert mc._one_window(mc.exact_launches(bytes_fn, taps, levels)) is one


def test_exact_halo_refusals():
    fd = _kernel_filters(vt.wavelet("db4"), synthesis=False)
    fr = _kernel_filters(vt.wavelet("db4"), synthesis=True)
    x = torch.zeros(2, 64)
    with pytest.raises(InvalidArgumentError, match="periodic"):
        mc.exact_analysis(x, None, 3, fd, True, halo=torch.zeros(2, 8))
    pairs = tuple((x, x) for _ in range(4))
    with pytest.raises(InvalidArgumentError, match="periodic"):
        mc.exact_synthesis(pairs, 3, fr, True, halo=tuple((x, x) for _ in range(4)))
    with pytest.raises(InvalidArgumentError, match="per plane"):
        mc.exact_synthesis(pairs, 3, fr, False, halo=((x, x),))
    with pytest.raises(InvalidArgumentError):
        mc.exact_analysis(x.requires_grad_(), None, 3, fd, False, halo=torch.zeros(2, 8))
