"""Port parity: the dual-tree complex wavelet transform (``transforms/dtcwt.py``),
mirroring ``tests/test_dtcwt.py`` and the DTCWT half of
``tests/test_bank_kernel.py``.

The same numpy inputs go through the JAX functions and the port's.  In
float64 both run the plain decimated cascade and agree within 1e-12.  In
float32 the port's bank routes (on the CPU: the filter bank's plain version)
are held against the same routes of the JAX package's Pallas tier in
interpret mode within 3e-5, the JAX package's own bound for them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from vectorwave_tpu.transforms import dtcwt as jdt
from vectorwave_tpu_torch import convert
from vectorwave_tpu_torch.errors import VectorWaveError
from vectorwave_tpu_torch.kernels import modwt_bank as mb
from vectorwave_tpu_torch.transforms import dtcwt as tdt

torch.set_num_threads(1)

TOL_F64, TOL_KERNEL = 1e-12, 3e-5


def _coeffs(res):
    return (*res.highpasses, res.lowpass_a, res.lowpass_b)


def _maxdiff(got, want):
    return max(float(np.max(np.abs(g.detach().numpy() - np.asarray(w))))
               for g, w in zip(got, want))


def _carry(res):
    """A JAX result as the port's, through numpy arrays."""
    return convert.dtcwt_result_from_arrays(
        [np.asarray(z) for z in res.highpasses], np.asarray(res.lowpass_a),
        np.asarray(res.lowpass_b), device="cpu")


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


@pytest.fixture
def bank_calls(monkeypatch):
    calls = []
    for fn in ("bank_analysis", "bank_synthesis"):
        real = getattr(mb, fn)
        monkeypatch.setattr(mb, fn, lambda *a, _f=fn, _r=real: (calls.append(_f), _r(*a))[1])
    return calls


@pytest.mark.parametrize("wavelet", ["sym8", "db4", "coif2"])
@pytest.mark.parametrize("levels,shape", [(1, (512,)), (3, (3, 512)), (5, (2, 512))])
def test_dtcwt_matches_jax_float64(levels, shape, wavelet):
    x = np.random.default_rng(levels).standard_normal(shape)
    want = vw.dtcwt(jnp.asarray(x), wavelet, levels=levels)
    got = vt.dtcwt(torch.from_numpy(x), wavelet, levels=levels)
    assert got.levels == levels
    assert all(z.dtype == torch.complex128 for z in got.highpasses)
    assert got.lowpass_a.dtype == torch.float64
    assert [tuple(c.shape) for c in _coeffs(got)] == [c.shape for c in _coeffs(want)]
    assert _maxdiff(_coeffs(got), _coeffs(want)) <= TOL_F64
    y_want = vw.idtcwt(want, wavelet)
    assert _maxdiff((vt.idtcwt(_carry(want), wavelet),), (y_want,)) <= TOL_F64
    assert _maxdiff((vt.idtcwt(got, wavelet),), (x,)) <= 1e-10
    assert _maxdiff(got.magnitudes(), want.magnitudes()) <= TOL_F64
    assert _maxdiff((got.level_energy(),), (want.level_energy(),)) <= 1e-10


def test_float32_input_gives_complex64():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 256)).astype(np.float32))
    res = vt.dtcwt(x, levels=3)
    assert all(z.dtype == torch.complex64 for z in res.highpasses)
    assert res.lowpass_b.dtype == torch.float32
    assert float((vt.idtcwt(res) - x).abs().max()) <= 1e-5


def test_energy_identity():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(1024))
    res = vt.dtcwt(x, levels=4)
    energy = 2 * res.level_energy().sum() + (res.lowpass_a**2).sum() + (res.lowpass_b**2).sum()
    assert float(energy) == pytest.approx(2 * float((x**2).sum()), rel=1e-12)


@pytest.mark.parametrize("route", ["tree", "stage"])
def test_bank_routes_match_the_jax_pallas_tier(jax_pallas, kernel_backend, bank_calls,
                                               monkeypatch, route):
    """Whole dual tree in one bank call, and one bank pair per tree and
    level: each against the same route of the JAX package."""
    if route == "stage":
        monkeypatch.setattr(tdt, "_use_whole_tree", lambda *a: False)
        monkeypatch.setattr(jdt, "_dtcwt_kernel_analysis", lambda *a, **k: None)
        monkeypatch.setattr(jdt, "_dtcwt_kernel_synthesis", lambda *a, **k: None)
    levels = 4 if route == "tree" else 3
    x = np.random.default_rng(3).standard_normal((2, 2048)).astype(np.float32)
    want = vw.dtcwt(jnp.asarray(x), "sym8", levels=levels)
    got = vt.dtcwt(torch.from_numpy(x), "sym8", levels=levels)
    each = 1 if route == "tree" else 2 * levels
    assert bank_calls == ["bank_analysis"] * each
    assert all(z.dtype == torch.complex64 for z in got.highpasses)
    assert _maxdiff(_coeffs(got), _coeffs(want)) <= TOL_KERNEL
    y_want = vw.idtcwt(want, "sym8")
    y = vt.idtcwt(_carry(want), "sym8")
    assert bank_calls[each:] == ["bank_synthesis"] * each
    assert _maxdiff((y,), (y_want,)) <= TOL_KERNEL
    assert _maxdiff((y,), (x,)) <= TOL_KERNEL


def test_bank_routes_agree_with_the_plain_cascade_in_float64_taps(kernel_backend, monkeypatch):
    """The composed planes and their phases are exact: with the plain bank in
    float32 both routes stay within float32 rounding of the float64 cascade."""
    x = np.random.default_rng(4).standard_normal((2, 320))  # 320 = 5 * 64: no power of two
    ref = vt.dtcwt(torch.from_numpy(x), "db4", levels=5)    # float64: the cascade
    x32 = torch.from_numpy(x.astype(np.float32))
    tree = vt.dtcwt(x32, "db4", levels=5)
    monkeypatch.setattr(tdt, "_use_whole_tree", lambda *a: False)
    stage = vt.dtcwt(x32, "db4", levels=5)
    for got in (tree, stage):
        assert _maxdiff(_coeffs(got), [c.numpy() for c in _coeffs(ref)]) <= 1e-5
        assert float((vt.idtcwt(got, "db4") - x32).abs().max()) <= 1e-5


def test_short_signal_is_served_by_every_route(kernel_backend, bank_calls):
    """The JAX package falls back to its jnp cascade below 256 samples; the
    port's bank serves any N (its wrap is taken modulo N), so the routes
    stay and agree."""
    x = np.random.default_rng(5).standard_normal(256).astype(np.float32)
    res = vt.dtcwt(torch.from_numpy(x), "sym8", levels=2)
    assert bank_calls == ["bank_analysis"]
    want = vw.dtcwt(jnp.asarray(x), "sym8", levels=2)
    assert _maxdiff(_coeffs(res), _coeffs(want)) <= TOL_KERNEL
    assert float((vt.idtcwt(res, "sym8") - torch.from_numpy(x)).abs().max()) <= TOL_KERNEL
    tiny = torch.from_numpy(np.random.default_rng(6).standard_normal((3, 32)).astype(np.float32))
    got = vt.dtcwt(tiny, "sym8", levels=4)  # the last stages wrap many times over
    vt.set_backend("torch")
    ref = vt.dtcwt(tiny, "sym8", levels=4)
    assert _maxdiff(_coeffs(got), [c.numpy() for c in _coeffs(ref)]) <= TOL_KERNEL


def test_routing_gates_on_both_sides(bank_calls, monkeypatch):
    x32 = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 128)).astype(np.float32))
    vt.dtcwt(x32, levels=2)                          # auto without a card: the cascade
    assert bank_calls == []
    try:
        vt.set_backend("kernel")
        vt.dtcwt(x32.double(), levels=2)             # float64 keeps the cascade
        assert bank_calls == []
        vt.dtcwt(x32, levels=2)
        assert bank_calls == ["bank_analysis"]
        vt.set_backend("torch")
        vt.dtcwt(x32, levels=2)
        assert bank_calls == ["bank_analysis"]
    finally:
        vt.set_backend("auto")
    # auto's choice between the bank routes: the whole tree up to the measured work
    dense, _ = tdt._dual_tree_bank("sym8", 5)
    nnz = mb.bank_taps(dense).nonzeros
    edge = tdt.AUTO_WHOLE_TREE_MAX_WORK // nnz
    assert tdt._use_whole_tree("auto", edge, dense)
    assert not tdt._use_whole_tree("auto", edge + 1, dense)
    assert tdt._use_whole_tree("kernel", 1 << 40, dense)
    assert tdt._use_whole_tree("auto", 64 * 16384, dense)
    assert not tdt._use_whole_tree("auto", 128 * 65536, dense)


def test_composed_planes_match_jax():
    stages_t = tdt._tree_stage_filters(*tdt._level1("sym8"), 4, "b")
    stages_j = jdt._tree_stage_filters("sym8", 4, "b")
    for (ta, pa, la), (tb, pb, lb) in zip(tdt._composed_tree_planes(stages_t),
                                          jdt._composed_tree_planes(stages_j)):
        np.testing.assert_array_equal(ta, tb)
        assert (pa, la) == (pb, lb)
    dense, phases = tdt._dual_tree_bank("sym8", 5)
    assert len(dense) == 12 and max(len(f) for f in dense) == 406
    assert tdt._dual_tree_bank("sym8", 5)[0] is dense  # one table per (wavelet, levels)


def test_max_levels_delay_and_validation_match_jax():
    for n in (1024, 96, 40, 7):
        for name in ("sym8", "haar", "db4"):
            assert vt.dtcwt_max_levels(n, name) == vw.dtcwt_max_levels(n, name)
    assert vt.dtcwt_max_levels(1024) == 6
    for level in range(1, 7):
        for name in ("sym8", "db2", "coif1"):
            assert vt.coefficient_delay(level, name) == vw.coefficient_delay(level, name)
    with pytest.raises(VectorWaveError):
        vt.dtcwt(torch.zeros(100), levels=3)  # 100 not divisible by 8
    with pytest.raises(VectorWaveError):
        vt.dtcwt(torch.zeros(64), levels=0)
    with pytest.raises(VectorWaveError):
        vt.dtcwt(torch.zeros(64), "bior2.2", levels=2)  # not orthogonal


def test_coefficient_delay_aligns_features():
    n, pos = 1024, 400
    t = np.arange(n)
    x = np.exp(-0.5 * ((t - pos) / 30.0) ** 2) * np.cos(2 * np.pi * 0.05 * t)
    res = vt.dtcwt(torch.from_numpy(x), levels=5)
    j = int(torch.argmax(res.level_energy())) + 1
    mag = res.highpasses[j - 1].abs().numpy()
    shift = round(vt.coefficient_delay(j))
    peak = (int(np.argmax(np.roll(mag, shift))) * (1 << j)) % n
    assert abs(peak - pos) <= 2 * (1 << j)


def test_dtcwt_result_from_arrays_checks_shapes_and_the_device():
    highs = [np.zeros((2, 8), np.complex64), np.zeros((2, 4), np.complex64)]
    low = np.zeros((2, 4), np.float32)
    res = convert.dtcwt_result_from_arrays(highs, low, low, device="cpu")
    assert isinstance(res, vt.DTCWTResult) and res.levels == 2
    assert res.highpasses[0].dtype == torch.complex64 and res.lowpass_a.dtype == torch.float32
    with pytest.raises(VectorWaveError):
        convert.dtcwt_result_from_arrays([np.zeros((2, 8))], low, low, device="cpu")
    with pytest.raises(VectorWaveError):
        convert.dtcwt_result_from_arrays(highs, low, np.zeros((2, 3), np.float32), device="cpu")
    with pytest.raises(VectorWaveError):
        convert.dtcwt_result_from_arrays(highs[::-1], low, low, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(VectorWaveError):
            convert.dtcwt_result_from_arrays(highs, low, low)
