"""Port parity: the kernel tier's plain versions against the JAX kernel tier.

On the CPU each kernel wrapper of vectorwave_tpu_torch runs its plain
version; vectorwave_tpu's Pallas kernels run in interpret mode, as its own
tests run them.  Same seeded float32 input, tolerance 1e-5 max abs: both
compute in float32 (the JAX tier at precision='float32'), in different
summation orders (a per-level cascade against composite filters).

Gradients of the kernel tier are held against ``jax.grad`` of the jnp path
in float64 to 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from chip_smoke import gap_thresholds
from vectorwave_tpu.kernels import modwt_mxu
from vectorwave_tpu.kernels import modwt_pallas as jax_fused
from vectorwave_tpu_torch.errors import InvalidArgumentError
from vectorwave_tpu_torch.kernels import _build
from vectorwave_tpu_torch.kernels import modwt_composite as mc
from vectorwave_tpu_torch.kernels.modwt_fused import _kernel_filters

torch.set_num_threads(1)

TOL = 1e-5
B, N, TILE, LEVELS = 2, 4096, 2048, 6


def _x32(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _maxdiff(got, want):
    return float(np.max(np.abs(got.detach().numpy().astype(np.float64)
                               - np.asarray(want, np.float64))))


@pytest.mark.parametrize("boundary", ["periodic", "zero"])
def test_fused_analysis_and_synthesis_match_jax_kernels(boundary):
    x = _x32((B, N), seed=1)
    jd, ja = jax_fused.fused_analysis(x, "db4", levels=LEVELS, boundary=boundary,
                                      tile=TILE, interpret=True, precision="float32")
    before = dict(mc.LAUNCHES)
    td, ta = vt.fused_analysis(torch.from_numpy(x), "db4", levels=LEVELS,
                               boundary=boundary, precision="float32")
    for g, w in zip((*td, ta), (*jd, ja)):
        assert _maxdiff(g, w) <= TOL
    jy = jax_fused.fused_synthesis(jd, ja, "db4", boundary=boundary, tile=TILE,
                                   interpret=True, precision="float32")
    ty = vt.fused_synthesis(td, ta, "db4", boundary=boundary, precision="float32")
    assert _maxdiff(ty, jy) <= TOL
    assert mc.LAUNCHES == before  # CPU tensors run the plain versions


def test_fused_analysis_sym8_few_levels_matches_jax():
    x = _x32((1, 2048), seed=2)
    jd, ja = jax_fused.fused_analysis(x, "sym8", levels=3, boundary="periodic",
                                      tile=1024, interpret=True, precision="float32")
    td, ta = vt.fused_analysis(torch.from_numpy(x), "sym8", levels=3)
    for g, w in zip((*td, ta), (*jd, ja)):
        assert _maxdiff(g, w) <= TOL


@pytest.mark.parametrize("mode", ["none", "soft", "hard"])
@pytest.mark.parametrize("boundary", ["periodic", "zero"])
def test_fused_denoise_matches_jax_kernel(boundary, mode):
    x = _x32((B, N), seed=3)
    planes = vw.modwt_multilevel(x.astype(np.float64), "db4", levels=LEVELS,
                                 boundary=boundary, backend="jnp")
    th = gap_thresholds([torch.tensor(np.asarray(d)) for d in planes.details],
                        LEVELS).numpy()
    want = jax_fused.fused_denoise_multilevel(
        x, "db4", levels=LEVELS, thresholds=th, boundary=boundary, mode=mode,
        tile=TILE, interpret=True, precision="float32")
    got = vt.fused_denoise_multilevel(
        torch.from_numpy(x), "db4", levels=LEVELS, thresholds=torch.from_numpy(th),
        boundary=boundary, mode=mode)
    assert _maxdiff(got, want) <= TOL


def test_roundtrip_fused_on_cpu_reconstructs():
    x = torch.from_numpy(_x32((2, 3000), seed=4))
    y = vt.modwt_roundtrip_fused(x, "db4", levels=LEVELS)
    assert float((y - x).abs().max()) < 5e-6
    assert y.shape == x.shape


def test_fused_denoise_symmetric_returns_none_and_roundtrip_raises():
    """No fused symmetric denoise (as in the JAX package): the round trip takes
    the two-call symmetric path; an unknown boundary raises."""
    x = torch.from_numpy(_x32((2, 4096), seed=5))
    th = torch.zeros(2, 3)
    assert vt.fused_denoise_multilevel(x, "db4", levels=3, thresholds=th,
                                       boundary="symmetric") is None
    y = vt.modwt_roundtrip_fused(x, "db4", levels=3, boundary="symmetric")
    d, a = vt.fused_analysis(x, "db4", levels=3, boundary="symmetric")
    assert torch.equal(y, vt.fused_synthesis(d, a, "db4", boundary="symmetric"))
    with pytest.raises(InvalidArgumentError, match="Unknown boundary"):
        vt.modwt_roundtrip_fused(x, "db4", levels=3, boundary="mirror")
    with pytest.raises(InvalidArgumentError, match="Unknown boundary"):
        vt.fused_analysis(x, "db4", levels=3, boundary="mirror")


def test_kernel_tier_rejects_the_exact_precision():
    x = torch.from_numpy(_x32((1, 1024)))
    with pytest.raises(InvalidArgumentError):
        vt.fused_analysis(x, "db4", levels=3, precision="exact")


@pytest.mark.parametrize("levels", [1, 3, 6])
@pytest.mark.parametrize("name", ["haar", "db4", "sym8"])
def test_composite_plane_filters_match_jax(name, levels):
    lo, hi = _kernel_filters(vt.wavelet(name), synthesis=False)
    ours = mc.composite_plane_filters(np.array(lo), np.array(hi), levels)
    ref = modwt_mxu.composite_plane_filters(np.array(lo), np.array(hi), levels)
    assert len(ours) == len(ref) == levels + 1
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    assert mc.composite_halo_samples(len(lo), levels) == max(len(p) for p in ours) - 1


@pytest.mark.parametrize("periodic", [True, False])
def test_cascade_equals_composite_filters(periodic):
    """The kernels run the per-level cascade where the TPU kernels apply the
    composite filters; for periodic and zero edges the two are equal."""
    n, levels = 700, 6
    x = np.random.default_rng(6).standard_normal((2, n))
    filters = _kernel_filters(vt.wavelet("db4"), synthesis=False)
    planes = mc.analysis_plain(torch.from_numpy(x), levels, filters, periodic)
    comps = mc.composite_plane_filters(np.array(filters[0]), np.array(filters[1]),
                                       levels)
    for plane, f in zip(planes, comps):
        taps = np.arange(len(f))
        idx = np.arange(n)[:, None] - taps[None, :]
        if periodic:
            want = (x[:, idx % n] * f).sum(-1)
        else:
            want = (np.where(idx >= 0, x[:, np.clip(idx, 0, None)], 0.0) * f).sum(-1)
        np.testing.assert_allclose(plane.numpy(), want, rtol=0, atol=1e-12)


def test_plain_versions_follow_the_input_dtype():
    filters = _kernel_filters(vt.wavelet("db4"), synthesis=False)
    for dtype in (torch.float32, torch.bfloat16, torch.float64):
        x = torch.randn(2, 512).to(dtype)
        planes = mc.analysis(x, 3, filters, True)
        assert all(p.dtype == dtype for p in planes)
        assert mc.synthesis(planes, 3, filters, True).dtype == dtype


def test_wrappers_raise_on_a_device_they_cannot_serve():
    filters = _kernel_filters(vt.wavelet("db4"), synthesis=False)
    x = torch.empty(2, 64, device="meta")
    with pytest.raises(InvalidArgumentError, match="CUDA tensor"):
        mc.analysis(x, 2, filters, True)
    with pytest.raises(InvalidArgumentError, match="CUDA tensor"):
        mc.synthesis((x, x, x), 2, filters, True)
    with pytest.raises(InvalidArgumentError, match="CUDA tensor"):
        mc.denoise(x, torch.zeros(2, 2, device="meta"), 2, filters, filters, True, "soft")
    with pytest.raises(InvalidArgumentError, match="threshold mode"):
        mc.denoise(x, x, 2, filters, filters, True, "garrote")
    with pytest.raises(InvalidArgumentError, match="CUDA tensor"):
        mc.exact_analysis(x, None, 2, filters, True)
    with pytest.raises(InvalidArgumentError, match="CUDA tensor"):
        mc.exact_synthesis(((x, x),) * 3, 2, filters, True)


def test_shared_memory_budget_and_tiles():
    assert mc.kernels_fit(8, 6)  # db4 J=6, the main path
    assert mc.denoise_shared_bytes(8, 6) > 48 * 1024  # needs the opt-in
    assert mc.analysis_shared_bytes(8, 6) <= 48 * 1024
    assert not mc.kernels_fit(76, 10)  # db38 J=10: halo of 76725 samples
    # sym8 J=9, the default depth: the pair fits, the denoise asks for its own room
    assert mc.kernels_fit(16, 9) and mc.denoise_shared_bytes(16, 9) > mc.SHARED_LIMIT
    assert mc._tile(mc.analysis_shared_bytes, 8, 6, 2048) == 2048
    assert mc._tile(mc.denoise_shared_bytes, 18, 8, 1024) == 512  # db9 J=8
    with pytest.raises(InvalidArgumentError):
        mc._tile(mc.denoise_shared_bytes, 76, 10, 2048)


def test_build_uses_only_repo_sources_and_hopper_flags(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(cpp, "CUDA_HOME", str(tmp_path))
    units = _build.compile_commands(tmp_path)
    for obj, cmd in units:  # one nvcc per unit, each to its own object
        assert cmd[0] == str(tmp_path / "bin" / "nvcc")
        assert "arch=compute_90a,code=sm_90a" in cmd and "-O3" in cmd and "-c" in cmd
        assert obj.parent == tmp_path and str(obj) in cmd
        assert len([c for c in cmd if c.endswith(".cu")]) == 1
    sources = [c for _, cmd in units for c in cmd if c.endswith(".cu")]
    assert sorted(p.split("/")[-1] for p in sources) == [
        "modwt2_analysis.cu", "modwt2_synthesis.cu",
        "modwt_analysis.cu", "modwt_bank_analysis.cu", "modwt_bank_synthesis.cu",
        "modwt_denoise.cu", "modwt_exact_analysis.cu",
        "modwt_exact_synthesis.cu", "modwt_symmetric_synthesis.cu", "modwt_synthesis.cu"]
    assert all(str(_build.CSRC) in u for u in sources)
    link = _build.link_command([obj for obj, _ in units], tmp_path / "lib.so")
    assert "-shared" in link and link[-len(units):] == [str(obj) for obj, _ in units]
    assert _build._lib is None  # nothing is built when the package is imported


def test_build_without_a_toolkit_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="CUDA toolkit"):
        _build.nvcc()


def _loss_weights(levels, shape, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape) for _ in range(levels + 1)]


@pytest.mark.parametrize("boundary", ["periodic", "zero"])
def test_analysis_gradient_matches_jax_grad(boundary):
    x = np.random.default_rng(8).standard_normal((2, 1024))
    ws = _loss_weights(4, x.shape)

    def jloss(xx):
        r = vw.modwt_multilevel(xx, "db4", levels=4, boundary=boundary, backend="jnp")
        return sum(jnp.sum(p * w) for p, w in zip((*r.details, r.approx), ws))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    details, approx = vt.fused_analysis(xt, "db4", levels=4, boundary=boundary)
    loss = sum((p * torch.from_numpy(w)).sum() for p, w in zip((*details, approx), ws))
    (got,) = torch.autograd.grad(loss, xt)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("boundary", ["periodic", "zero"])
def test_synthesis_gradient_matches_jax_grad(boundary):
    rng = np.random.default_rng(9)
    planes = [rng.standard_normal((2, 1024)) for _ in range(5)]
    w = rng.standard_normal((2, 1024))

    def jloss(ps):
        res = vw.MultiLevelMODWTResult(tuple(ps[:4]), ps[4])
        return jnp.sum(vw.imodwt_multilevel(res, "db4", boundary=boundary,
                                            backend="jnp") * w)

    want = jax.grad(jloss)([jnp.asarray(p) for p in planes])
    pt = [torch.from_numpy(p).requires_grad_(True) for p in planes]
    y = vt.fused_synthesis(pt[:4], pt[4], "db4", boundary=boundary)
    got = torch.autograd.grad((y * torch.from_numpy(w)).sum(), pt)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-10)


def test_kernel_backend_on_cpu_runs_the_plain_versions():
    x = torch.from_numpy(np.random.default_rng(10).standard_normal((2, 4096)))
    before = dict(mc.LAUNCHES)
    got = vt.modwt_multilevel(x, "db4", levels=6, backend="kernel")
    want = vt.modwt_multilevel(x, "db4", levels=6, backend="torch")
    for g, w in zip((*got.details, got.approx), (*want.details, want.approx)):
        assert float((g - w).abs().max()) < 1e-12
    assert mc.LAUNCHES == before


def test_auto_routing_keeps_cpu_tensors_on_the_plain_path(monkeypatch):
    from vectorwave_tpu_torch.transforms import multilevel

    x = torch.randn(2, 8192)
    assert not multilevel._kernel_eligible(x, vt.wavelet("db4"), 6, "periodic")
    monkeypatch.setattr(vt.kernels.modwt_fused, "kernel_available", lambda: True)
    # still a CPU tensor: the kernel tier needs a CUDA tensor under 'auto'
    assert not multilevel._kernel_eligible(x, vt.wavelet("db4"), 6, "periodic")
