"""Mirrors of the JAX package's 2-D kernel tests on the port.

``tests/test_modwt2_pallas.py`` test by test, and the difference by design
of ``tests/test_modwt2_fast.py::test_fast2_ineligible_shapes_fall_back``:
the same names, seeds, shapes, wavelets and boundaries, and the JAX test's
own bounds, run on the port's 2-D kernel tier (``backend='kernel'``, whose
level wrappers run their plain versions on a CPU tensor).  The other tests
of ``tests/test_modwt2_fast.py``, ``tests/test_twodim.py`` and
``tests/test_swt2.py`` are mirrored under their own names in
``tests/test_torch_twodim.py`` and ``tests/test_torch_swt2.py``.

The JAX side runs its non-Pallas paths, jitted once a shape from a
module-scoped fixture (``jax_refs``): the XLA banded path
(``modwt2_multilevel_fast`` and its inverse, the JAX tests' own oracle) for
periodic and zero edges, the jnp cascade for symmetric ones.  Every draw is
held to JAX but the family sweep's (a JAX test marked slow), whose
references compile for seconds each at 512 x 512: it holds JAX parity on
named draws (``FAMILIES_AGAINST_JAX``) and on every draw an invariant,
which the deep-span and sym8 J=6 tests hold beside JAX's: x back from the
round trip where periodic, and where zero the periodic transform's bands
past each level's filter reach.  No JAX Pallas kernel runs here: the port's
2-D tier is held to the JAX Pallas kernels in interpret mode by
``tests/test_torch_twodim.py`` (``test_kernel_tier_matches_pallas_kernels``,
``test_kernel_tier_round_trip_matches_pallas``).  Tolerances are the JAX
tests' float32 bounds: 2e-5 a band, 4e-5 at the deep spans, 1e-4 across the
families, 2e-4 at sym8 J=6, 3e-5 and 5e-5 a round trip, 5e-6 the db8 J=5
periodic round trip against x and 1e-5 its inverse against JAX's.

The port's 2-D tier has no Pallas layout gates (H and W multiples of 256,
at most four 128-row halo blocks): its gate is ``kernel_refusal``, which
admits every shape here; JAX's fast paths refuse the unaligned and
symmetric shapes of ``test_fast2_ineligible_shapes_fall_back``, asserted on
both sides.  The kernel-reaching 2-D cases (``tools/mirror_cases.py``)
run here too, on CPU tensors.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from vectorwave_tpu.kernels import modwt2_mxu as jk2
from vectorwave_tpu.kernels.modwt2_pallas import _cascade_start, modwt2_pallas_eligible
from vectorwave_tpu.transforms import twodim as jtwo
from vectorwave_tpu.transforms.modwt import _resolve_discrete as jwavelet
from tools import mirror_cases
from vectorwave_tpu_torch.kernels import modwt2 as k2
from vectorwave_tpu_torch.kernels import modwt2_composite as c2

torch.set_num_threads(1)

BANDS = ("lh", "hl", "hh")


def _x32(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _maxdiff(got, want):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.detach().double().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)))


def _port(x, name, levels, boundary):
    return vt.modwt2_multilevel(torch.from_numpy(x), name, levels=levels, boundary=boundary,
                                backend="kernel")


def _assert_levels(got_details, got_ll, want_details, want_ll, levels, tol):
    for j in levels:
        for g, w, tag in zip(got_details[j], want_details[j], BANDS):
            assert _maxdiff(g, w) <= tol, (j + 1, tag)
    assert _maxdiff(got_ll, want_ll) <= tol, "ll"


@partial(jax.jit, static_argnames=("name", "levels", "boundary"))
def _jax_decompose(x, name, levels, boundary):
    return vw.modwt2_multilevel(x, name, levels=levels, boundary=boundary)


@partial(jax.jit, static_argnames=("name", "boundary"))
def _jax_reconstruct(res, name, boundary):
    return vw.imodwt2_multilevel(res, name, boundary=boundary)


class JaxRefs:
    """The JAX package's 2-D results, each made once per input: the XLA
    banded path for periodic and zero edges, the jnp cascade for symmetric
    ones; ``(details, ll)`` and the inverse of those planes."""

    def __init__(self):
        self._memo = {}

    def decompose(self, x, name, levels, boundary):
        key = ("dec", x.tobytes(), x.shape, name, levels, boundary)
        if key not in self._memo:
            if boundary == "symmetric":
                res = _jax_decompose(jnp.asarray(x), name, levels, boundary)
                self._memo[key] = (res.details, res.approx)
            else:
                self._memo[key] = jk2.modwt2_multilevel_fast(jnp.asarray(x), jwavelet(name),
                                                              levels, boundary, "float32")
        return self._memo[key]

    def roundtrip(self, x, name, levels, boundary):
        key = ("rt", x.tobytes(), x.shape, name, levels, boundary)
        if key not in self._memo:
            det, ll = self.decompose(x, name, levels, boundary)
            if boundary == "symmetric":
                out = _jax_reconstruct(jtwo.MultiLevelMODWT2Result(det, ll), name, boundary)
            else:
                out = jk2.imodwt2_multilevel_fast(det, ll, jwavelet(name), boundary, "float32")
            self._memo[key] = out
        return self._memo[key]

    def inverse(self, res, name, boundary):
        """The JAX XLA banded inverse of the port's planes ``res``."""
        det = tuple(tuple(jnp.asarray(p.numpy()) for p in trip) for trip in res.details)
        return jk2.imodwt2_multilevel_fast(det, jnp.asarray(res.approx.numpy()), jwavelet(name),
                                           boundary, "float32")


def _assert_invariant(x, res, name, levels, boundary, tol):
    """The invariant of a draw held to no JAX reference: periodic, the round
    trip gives x back; zero, each level's bands and the LL equal the
    periodic transform's past the level's filter reach from the top and
    left edges, (L - 1)(2^j - 1) rows and columns (the zero edge reads no
    sample the periodic one wraps there)."""
    if boundary == "periodic":
        xr = vt.imodwt2_multilevel(res, name, boundary=boundary, backend="kernel")
        assert _maxdiff(xr, x) <= tol
        return
    per = vt.modwt2_multilevel(torch.from_numpy(x), name, levels=levels, boundary="periodic",
                               backend="torch")
    taps, side = vt.wavelet(name).filter_length, min(x.shape[-2:])
    compared = 0
    for j in range(1, levels + 1):
        cut = (taps - 1) * ((1 << j) - 1)
        if cut >= side:
            break
        planes = res.details[j - 1] + ((res.approx,) if j == levels else ())
        wanted = per.details[j - 1] + ((per.approx,) if j == levels else ())
        for g, w in zip(planes, wanted):
            assert _maxdiff(g[..., cut:, cut:], w[..., cut:, cut:]) <= tol, j
        compared += 1
    assert compared


@pytest.fixture(scope="module")
def jax_refs():
    vw.set_backend("jnp")
    try:
        yield JaxRefs()
    finally:
        vw.set_backend("auto")


def _jax_pallas(fn):
    """``fn`` under the JAX package's Pallas backend: here only its gates
    are asked, so no kernel runs."""
    vw.set_backend("pallas")
    vw.set_fused_precision("float32")
    try:
        return fn()
    finally:
        vw.set_backend("jnp")
        vw.set_fused_precision("bf16_3x")


# --- tests/test_modwt2_pallas.py ------------------------------------------------------


@pytest.mark.parametrize("boundary", ["periodic", "zero"])
@pytest.mark.parametrize("name,levels", [("db4", 3), ("haar", 4), ("sym8", 2)])
def test_2d_pallas_analysis_matches_xla_path(jax_refs, name, levels, boundary):
    """Every level's bands and the LL within 2e-5 of the JAX XLA path, and
    of the port's composite form."""
    x = _x32((2, 256, 256), 0)
    got = _port(x, name, levels, boundary)
    det, ll = c2.modwt2_multilevel_composite(torch.from_numpy(x), vt.wavelet(name), levels,
                                             boundary)
    _assert_levels(got.details, got.approx, det, ll, range(levels), 2e-5)
    det, ll = jax_refs.decompose(x, name, levels, boundary)
    _assert_levels(got.details, got.approx, det, ll, range(levels), 2e-5)


@pytest.mark.parametrize("boundary", ["periodic", "zero"])
@pytest.mark.parametrize("name,levels,hw", [("db4", 5, 512), ("sym8", 4, 256), ("db4", 6, 512)])
def test_2d_pallas_deep_span_matches_xla_path(jax_refs, name, levels, hw, boundary):
    """Spans past one 128-row block (217, 225, 441): the shallowest and the
    deepest level and the LL within 4e-5 of the JAX XLA path, and the
    invariant (``_assert_invariant``) within 5e-5."""
    x = _x32((1, hw, hw), 3)
    got = _port(x, name, levels, boundary)
    det, ll = jax_refs.decompose(x, name, levels, boundary)
    _assert_levels(got.details, got.approx, det, ll, (0, levels - 1), 4e-5)
    _assert_invariant(x, got, name, levels, boundary, 5e-5)


@pytest.mark.parametrize("boundary", ["periodic", "zero"])
def test_2d_pallas_deep_span_roundtrip(jax_refs, boundary):
    """db4 J=5 at 512 x 512, the kernel tier each way: within 5e-5 of the
    port's plain 2-D cascade's round trip and of the JAX XLA path's, and of
    x where periodic."""
    x = _x32((1, 512, 512), 4)
    res = _port(x, "db4", 5, boundary)
    xr = vt.imodwt2_multilevel(res, "db4", boundary=boundary, backend="kernel")
    plain = vt.imodwt2_multilevel(
        vt.modwt2_multilevel(torch.from_numpy(x), "db4", levels=5, boundary=boundary,
                             backend="torch"), "db4", boundary=boundary, backend="torch")
    assert _maxdiff(xr, plain) <= 5e-5
    assert _maxdiff(xr, jax_refs.roundtrip(x, "db4", 5, boundary)) <= 5e-5
    if boundary == "periodic":
        assert _maxdiff(xr, x) <= 5e-5


@pytest.mark.parametrize("boundary", ["periodic", "zero"])
def test_2d_pallas_roundtrip(jax_refs, boundary):
    """db4 J=3 at 1 x 256 x 256, the port's kernel tier each way: the bands
    within 2e-5 of the JAX XLA path, the inverse within 3e-5 of its round
    trip, and of x where periodic."""
    x = _x32((1, 256, 256), 1)
    res = _port(x, "db4", 3, boundary)
    xr = vt.imodwt2_multilevel(res, "db4", boundary=boundary, backend="kernel")
    det, ll = jax_refs.decompose(x, "db4", 3, boundary)
    _assert_levels(res.details, res.approx, det, ll, range(3), 2e-5)
    assert _maxdiff(xr, jax_refs.roundtrip(x, "db4", 3, boundary)) <= 3e-5
    if boundary == "periodic":
        assert _maxdiff(xr, x) <= 3e-5


@pytest.mark.parametrize("name,levels", [("db4", 3), ("sym8", 2)])
def test_2d_symmetric_analysis_fast_path(jax_refs, name, levels):
    """The port's kernel tier has a symmetric edge mode of its own (JAX
    reflect-pads into zero-boundary Pallas calls): its gate admits the call,
    and every level within 3e-5 of the JAX jnp symmetric cascade."""
    x = _x32((2, 256, 256), 5)
    assert k2.kernel_refusal(torch.from_numpy(x), vt.wavelet(name), levels, "symmetric") is None
    got = _port(x, name, levels, "symmetric")
    det, ll = jax_refs.decompose(x, name, levels, "symmetric")
    _assert_levels(got.details, got.approx, det, ll, range(levels), 3e-5)


@pytest.mark.parametrize("name,levels", [("db4", 3), ("sym8", 2)])
def test_2d_symmetric_inverse_fast_path(jax_refs, name, levels):
    """The JAX jnp symmetric planes through the port's kernel-tier inverse
    (``imodwt2_multilevel_kernel``, and routed end to end under the
    ``kernel`` backend): within 3e-5 of the JAX jnp inverse."""
    x = _x32((2, 256, 256), 6)
    det, ll = jax_refs.decompose(x, name, levels, "symmetric")
    want = jax_refs.roundtrip(x, name, levels, "symmetric")
    details = tuple(tuple(torch.from_numpy(np.array(p)) for p in trip) for trip in det)
    approx = torch.from_numpy(np.array(ll))
    got = k2.imodwt2_multilevel_kernel(details, approx, vt.wavelet(name), "symmetric")
    assert _maxdiff(got, want) <= 3e-5
    vt.set_backend("kernel")
    try:
        routed = vt.imodwt2_multilevel(vt.MultiLevelMODWT2Result(details, approx), name,
                                       boundary="symmetric")
    finally:
        vt.set_backend("auto")
    assert _maxdiff(routed, want) <= 3e-5


def test_public_routing_forced_pallas_matches_jnp(jax_refs):
    x = _x32((256, 256), 2)
    vt.set_backend("pallas")
    try:
        res = vt.modwt2_multilevel(torch.from_numpy(x), "db4", levels=2)
        xr = vt.imodwt2_multilevel(res, "db4")
    finally:
        vt.set_backend("auto")
    assert _maxdiff(xr, x) <= 3e-5


#: the family sweep's draws held to the JAX XLA path (each a compile of
#: seconds at 512 x 512); every draw is held to its round trip
FAMILIES_AGAINST_JAX = (("db6", 5, "periodic"), ("coif2", 4, "zero"))


@pytest.mark.parametrize("boundary", ["periodic", "zero"])
@pytest.mark.parametrize("name,levels,hw", [("db6", 5, 512), ("sym6", 5, 512),
                                            ("coif2", 4, 512), ("db8", 5, 512)])
def test_2d_deep_span_family_sweep(jax_refs, name, levels, hw, boundary):
    """The JAX test is marked slow; here in tier 1.  On
    :data:`FAMILIES_AGAINST_JAX` the deep level and the LL within 1e-4 of
    the JAX XLA path; on every draw the invariant (``_assert_invariant``)
    within 1e-4."""
    x = _x32((1, hw, hw), 11)
    got = _port(x, name, levels, boundary)
    if (name, levels, boundary) in FAMILIES_AGAINST_JAX:
        det, ll = jax_refs.decompose(x, name, levels, boundary)
        _assert_levels(got.details, got.approx, det, ll, (levels - 1,), 1e-4)
    _assert_invariant(x, got, name, levels, boundary, 1e-4)


@pytest.mark.parametrize("boundary", ["periodic", "zero"])
def test_2d_cascade_tier_sym8_j6_newly_eligible(jax_refs, boundary):
    """sym8 J=6 on 1024 x 512: JAX's Pallas gate admits it through its
    cascade tier (from level 5); the port's counterpart, ``kernel_refusal``,
    admits it whole.  The cascaded levels 5 and 6 and the LL within 2e-4 of
    the JAX XLA path, and the invariant (``_assert_invariant``) within
    2e-4."""
    x = _x32((1, 1024, 512), 12)
    w = jwavelet("sym8")
    assert _jax_pallas(lambda: modwt2_pallas_eligible(jnp.asarray(x), w, 6, boundary))
    assert _cascade_start(w.filter_length, 6) == 5
    assert k2.kernel_refusal(torch.from_numpy(x), vt.wavelet("sym8"), 6, boundary) is None
    got = _port(x, "sym8", 6, boundary)
    det, ll = jax_refs.decompose(x, "sym8", 6, boundary)
    _assert_levels(got.details, got.approx, det, ll, (4, 5), 2e-4)
    _assert_invariant(x, got, "sym8", 6, boundary, 2e-4)


@pytest.mark.parametrize("boundary", ["periodic", "zero"])
def test_2d_cascade_synthesis_roundtrip_db8_j5(jax_refs, boundary):
    """db8 J=5 at 512 x 512 (JAX's cascade synthesis tier from level 5): the
    port's kernel tier each way, periodic within 5e-6 of x; its inverse of
    its own planes within 1e-5 of the JAX XLA path's inverse of the same
    planes (the JAX test's parity) and of the port's plain inverse, and the
    zero edge's analysis past each level's reach equal to the periodic
    one's (``_assert_invariant``, 1e-5)."""
    assert _cascade_start(jwavelet("db8").filter_length, 5) == 5
    x = _x32((1, 512, 512), 13)
    res = _port(x, "db8", 5, boundary)
    out = vt.imodwt2_multilevel(res, "db8", boundary=boundary, backend="kernel")
    if boundary == "periodic":
        assert _maxdiff(out, x) <= 5e-6
    assert _maxdiff(out, jax_refs.inverse(res, "db8", boundary)) <= 1e-5
    assert _maxdiff(out, vt.imodwt2_multilevel(res, "db8", boundary=boundary,
                                               backend="torch")) <= 1e-5
    if boundary == "zero":
        _assert_invariant(x, res, "db8", 5, boundary, 1e-5)


# --- tests/test_modwt2_fast.py: the difference by design -----------------------------


def test_fast2_ineligible_shapes_fall_back(jax_refs):
    """JAX's fast paths (Pallas and banded) refuse 100 x 96 and a symmetric
    128 x 128, so its jnp cascade serves them; the port's kernel tier admits
    both (``kernel_refusal`` is None: on a card ``auto`` routes them to the
    2-D kernels).  The port's round trip within 1e-5 of x, its symmetric
    inverse within 1e-6 of the JAX jnp route's, both routes alike."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((100, 96)).astype(np.float32)
    x2 = rng.standard_normal((128, 128)).astype(np.float32)
    w = jwavelet("db4")
    for arr, b in ((x, "periodic"), (x2, "symmetric")):
        assert not _jax_pallas(lambda: modwt2_pallas_eligible(jnp.asarray(arr), w, 2, b)
                               or jtwo._fast2_eligible(jnp.asarray(arr), 2, b))
        assert k2.kernel_refusal(torch.from_numpy(arr), vt.wavelet("db4"), 2, b) is None
    for backend in ("auto", "kernel"):
        res = vt.modwt2_multilevel(torch.from_numpy(x), "db4", levels=2, backend=backend)
        assert _maxdiff(vt.imodwt2_multilevel(res, "db4", backend=backend), x) <= 1e-5
        res2 = vt.modwt2_multilevel(torch.from_numpy(x2), "db4", levels=2,
                                    boundary="symmetric", backend=backend)
        xr2 = vt.imodwt2_multilevel(res2, "db4", boundary="symmetric", backend=backend)
        assert _maxdiff(xr2, jax_refs.roundtrip(x2, "db4", 2, "symmetric")) <= 1e-6


# --- the card's 2-D cases, run on the CPU ---------------------------------------------


@pytest.mark.parametrize("label", mirror_cases.family_labels("2-D"))
def test_family_case_runs_its_plain_versions_on_the_cpu(label):
    """Each 2-D case phase 2c runs on the card, here on CPU tensors: within
    its bounds of the plain route, no launch, no refusal."""
    assert not mirror_cases.cpu_problems(label)
