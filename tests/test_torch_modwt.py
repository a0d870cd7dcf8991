"""Port parity: the plain PyTorch MODWT path against vectorwave_tpu's jnp path.

Same seeded numpy input to both packages, float64, tolerance 1e-12 relative
to the largest coefficient: the two run the same rolled-sum cascade in the
same order, so they differ at most in the last bits.
"""

import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from vectorwave_tpu_torch.errors import (
    InvalidArgumentError,
    InvalidConfigurationError,
    InvalidSignalError,
)

torch.set_num_threads(1)

RTOL = 1e-12


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


def _close(got, want):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)


@pytest.mark.parametrize("boundary", ["periodic", "zero", "symmetric"])
@pytest.mark.parametrize("name", ["haar", "db4", "sym8"])
def test_single_level_modwt_matches_jax(name, boundary):
    x = _x((3, 777), seed=1)
    got = vt.modwt(torch.from_numpy(x), name, boundary=boundary)
    want = vw.modwt(x, name, boundary=boundary)
    _close(got.approx, want.approx)
    _close(got.detail, want.detail)
    _close(vt.imodwt(got, name, boundary=boundary),
           vw.imodwt(want, name, boundary=boundary))


@pytest.mark.parametrize("levels", [3, 6])
@pytest.mark.parametrize("boundary", ["periodic", "zero", "symmetric"])
@pytest.mark.parametrize("name", ["db4", "sym8"])
def test_multilevel_matches_jax(name, boundary, levels):
    x = _x((2, 1000), seed=levels)
    got = vt.modwt_multilevel(torch.from_numpy(x), name, levels=levels,
                              boundary=boundary, backend="torch")
    want = vw.modwt_multilevel(x, name, levels=levels, boundary=boundary,
                               backend="jnp")
    assert got.levels == want.levels == levels
    for g, w in zip((*got.details, got.approx), (*want.details, want.approx)):
        _close(g, w)
    _close(vt.imodwt_multilevel(got, name, boundary=boundary, backend="torch"),
           vw.imodwt_multilevel(want, name, boundary=boundary, backend="jnp"))


def test_fft_path_matches_jax():
    """db32 has 64 taps, the FFT routing threshold."""
    x = _x((2, 2048), seed=3)
    got = vt.modwt_multilevel(torch.from_numpy(x), "db32", levels=2)
    want = vw.modwt_multilevel(x, "db32", levels=2, backend="jnp")
    for g, w in zip((*got.details, got.approx), (*want.details, want.approx)):
        _close(g, w)


def test_batch_axes_and_1d_inputs():
    x = _x((2, 3, 512), seed=4)
    got = vt.modwt_multilevel(torch.from_numpy(x), "db4", levels=4)
    want = vw.modwt_multilevel(x, "db4", levels=4, backend="jnp")
    _close(got.details[2], want.details[2])
    one = vt.modwt_multilevel(torch.from_numpy(x[0, 0]), "db4", levels=4)
    assert one.approx.shape == (512,)
    _close(one.approx, np.asarray(want.approx)[0, 0])


def test_periodic_round_trip_is_exact_in_float64():
    x = _x((2, 4096), seed=5)
    res = vt.modwt_multilevel(torch.from_numpy(x), "db4", levels=6)
    y = vt.imodwt_multilevel(res, "db4")
    assert float((y - torch.from_numpy(x)).abs().max()) < 1e-12


def test_result_energy_helpers_match_jax():
    x = _x((2, 600), seed=6)
    got = vt.modwt_multilevel(torch.from_numpy(x), "sym8", levels=3)
    want = vw.modwt_multilevel(x, "sym8", levels=3, backend="jnp")
    _close(got.total_energy(), want.total_energy())
    _close(got.relative_energy_distribution(), want.relative_energy_distribution())
    _close(got.detail_energy(2), want.detail_energy(2))


@pytest.mark.parametrize("n,name", [(7, "db4"), (8, "db4"), (1000, "db4"),
                                    (65536, "db4"), (4096, "sym20"), (100, "haar")])
def test_max_levels_matches_jax(n, name):
    assert vt.max_levels(n, name) == vw.max_levels(n, name)


@pytest.mark.parametrize("tol", [1.0, 3e-2, 1e-3, 1e-4, 1e-5, 3e-6, 1e-6, 1e-12])
def test_tolerance_ladder_matches_jax(tol):
    assert vt.resolve_tolerance(tol) == vw.resolve_tolerance(tol)


def test_exact_tier_raises_for_float32():
    """float32 input on the exact tier returns double-float planes; only an
    exact inverse of a plain float32 result raises, as in JAX."""
    x = torch.randn(2, 4096)
    for how in ({"precision": "exact"}, {"tolerance": 1e-7}):
        res = vt.modwt_multilevel(x, "db4", levels=3, **how)
        assert isinstance(res, vt.ExactMODWTResult) and res.levels == 3
        assert torch.equal(vt.imodwt_multilevel(res, "db4", **how), x)
    res = vt.modwt_multilevel(x, "db4", levels=3, tolerance=1e-5)
    assert isinstance(res, vt.MultiLevelMODWTResult)
    with pytest.raises(InvalidArgumentError, match=r"(?s)exact tier.*ExactMODWTResult"):
        vt.imodwt_multilevel(res, "db4", precision="exact")


def test_exact_tier_request_on_float64_takes_the_plain_path():
    x = _x((2, 512), seed=7)
    got = vt.modwt_multilevel(torch.from_numpy(x), "db4", levels=3, tolerance=1e-12)
    want = vw.modwt_multilevel(x, "db4", levels=3, backend="jnp")
    _close(got.approx, want.approx)
    y = vt.imodwt_multilevel(got, "db4", precision="exact")
    assert float((y - torch.from_numpy(x)).abs().max()) < 1e-12


def test_invalid_arguments_raise():
    x = torch.randn(2, 64)
    with pytest.raises(InvalidArgumentError):
        vt.modwt_multilevel(x, "db4", levels=5)  # upsampled filter too long
    with pytest.raises(InvalidArgumentError):
        vt.modwt_multilevel(x, "db4", levels=0)
    with pytest.raises(InvalidArgumentError):
        vt.modwt_multilevel(x, "db4", levels=2, boundary="mirror")
    with pytest.raises(InvalidArgumentError):
        vt.modwt_multilevel(x, "db4", levels=2, precision="fp8")
    with pytest.raises(InvalidConfigurationError):
        vt.modwt_multilevel(x, "db4", levels=2, backend="cuda")
    with pytest.raises(InvalidSignalError):
        vt.modwt(torch.zeros(2, 0), "db4")


def test_kernel_backend_with_symmetric_boundary_raises():
    """Forced onto the kernel tier, a symmetric call the kernels cannot serve
    raises off the CPU (a meta tensor stands for a CUDA one): windows too
    wide for shared memory (db38, 9 levels), or head and tail splice windows
    that overlap (a short signal).  The gates are the card's: a CPU tensor
    runs the plain version under every backend, and returns."""
    from vectorwave_tpu_torch.kernels.modwt_symmetric import (
        symmetric_level_ops,
        synthesis_windows,
    )

    x = torch.randn(2, 20000)
    with pytest.raises(InvalidArgumentError, match="symmetric kernel tier"):
        vt.modwt_multilevel(x.to("meta"), "db38", levels=9, boundary="symmetric",
                            backend="kernel")
    got = vt.modwt_multilevel(x, "db38", levels=9, boundary="symmetric", backend="kernel")
    want = vt.modwt_multilevel(x, "db38", levels=9, boundary="symmetric", backend="torch")
    assert torch.equal(got.approx, want.approx)
    w = vt.wavelet("db4")
    _, _, w_head, w_tail = synthesis_windows(w.filter_length, symmetric_level_ops(w, 3))
    res = vt.modwt_multilevel(torch.randn(2, w_head + w_tail - 1), "db4", levels=3,
                              boundary="symmetric")
    on_card = vt.MultiLevelMODWTResult(tuple(d.to("meta") for d in res.details),
                                       res.approx.to("meta"))
    with pytest.raises(InvalidArgumentError, match="symmetric kernel tier"):
        vt.imodwt_multilevel(on_card, "db4", boundary="symmetric", backend="pallas")
    y = vt.imodwt_multilevel(res, "db4", boundary="symmetric", backend="pallas")
    assert torch.equal(y, vt.imodwt_multilevel(res, "db4", boundary="symmetric",
                                               backend="torch"))
