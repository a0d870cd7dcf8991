"""Port parity: wavelets, registry, configuration and packaging.

Every ported wavelet's filters, generated by vectorwave_tpu_torch on its own
(in its own cache directory), must equal vectorwave_tpu's to 1e-14: both
run the same 80-digit spectral factorization, so only the final float64
rounding may differ.
"""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from vectorwave_tpu_torch import convert
from vectorwave_tpu_torch.config import cache_root
from vectorwave_tpu_torch.errors import InvalidArgumentError, InvalidConfigurationError

torch.set_num_threads(1)

PORTED = ["haar", "db1"] + [f"db{p}" for p in range(2, 39)] + [
    f"sym{p}" for p in range(2, 21)
]
#: every discrete name of the JAX registry beyond haar, db and sym
FAMILIES = sorted(
    n for n in vw.available_wavelets()
    if n not in PORTED and isinstance(vw.wavelet(n), vw.DiscreteWavelet)
)
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", PORTED)
def test_filters_match_jax(name):
    ours, ref = vt.wavelet(name), vw.wavelet(name)
    for field in ("dec_lo", "dec_hi", "rec_lo", "rec_hi"):
        np.testing.assert_allclose(
            getattr(ours, field), getattr(ref, field), rtol=0, atol=1e-14
        )
    assert ours.filter_length == ref.filter_length
    assert ours.vanishing_moments == ref.vanishing_moments
    assert ours.validate_perfect_reconstruction()


@pytest.mark.parametrize("name", FAMILIES)
def test_family_filters_match_jax(name):
    ours, ref = vt.wavelet(name), vw.wavelet(name)
    for field in ("dec_lo", "dec_hi", "rec_lo", "rec_hi"):
        np.testing.assert_allclose(
            getattr(ours, field), getattr(ref, field), rtol=0, atol=1e-14
        )
    assert (ours.name, ours.family, ours.vanishing_moments, ours.wavelet_type.value) == (
        ref.name, ref.family, ref.vanishing_moments, ref.wavelet_type.value)
    assert ours.validation_tolerance() == ref.validation_tolerance()
    assert ours.validate_perfect_reconstruction()


def test_families_cover_every_discrete_family():
    assert {re.match(r"[a-z]+", n).group() for n in FAMILIES} == {
        "coif", "bior", "rbio", "dmey", "blem"}
    assert len(FAMILIES) == 17 + 15 + 15 + 1 + 5


def test_qshift_filters_match_jax():
    from vectorwave_tpu.wavelets import qshift as jq
    from vectorwave_tpu_torch.wavelets import qshift as tq

    assert tq.QSHIFT_THETAS_14 == jq.QSHIFT_THETAS_14
    for ours, ref in zip(tq.qshift_filters(), jq.qshift_filters()):
        np.testing.assert_array_equal(ours, ref)
    with pytest.raises(ValueError):
        tq.qshift_filters(10)


def test_available_wavelets_are_the_ported_families():
    continuous = [n for n in vw.available_wavelets()
                  if isinstance(vw.wavelet(n), vw.ContinuousWavelet)]
    assert vt.available_wavelets() == sorted(PORTED + FAMILIES + continuous)
    assert vt.available_wavelets() == vw.available_wavelets()


def _names(values):
    return [v.value if hasattr(v, "value") else v for v in values]


def test_registry_queries_match_jax_over_the_discrete_names():
    discrete = set(vt.available_wavelets())
    for wtype in vt.WaveletType:
        ref = vw.wavelets_of_type(vw.WaveletType(wtype.value))
        assert vt.wavelets_of_type(wtype) == [n for n in ref if n in discrete]
    for family in ("db", "Daubechies", "sym", "coif", "Coiflet", "bior", "rbio", "blem",
                   "dmey", "BattleLemarie", "morl", "nothing"):
        ref = [n for n in vw.wavelets_in_family(family) if n in discrete]
        assert vt.wavelets_in_family(family) == ref, family
    for name in ("haar", "db4", "coif3", "bior4.4", "rbio2.2", "dmey", "blem3"):
        assert _names(vt.supported_transforms(name)) == _names(vw.supported_transforms(name))
        assert vt.recommended_transform(name).value == vw.recommended_transform(name).value
        for t in vt.TransformType:
            assert vt.is_compatible(name, t) == vw.is_compatible(
                name, vw.TransformType(t.value))
    assert [t.value for t in vt.TransformType] == [t.value for t in vw.TransformType]
    assert vt.Wavelet == vt.DiscreteWavelet | vt.ContinuousWavelet
    assert vw.Wavelet == vw.DiscreteWavelet | vw.ContinuousWavelet


def test_register_wavelet_and_alias():
    from vectorwave_tpu_torch.wavelets import registry

    try:
        vt.register_wavelet("MyHaar", lambda: vt.wavelet("haar"))
        registry.register_alias("mh", "myhaar")
        assert vt.wavelet("myhaar") is vt.wavelet("haar")
        assert vt.wavelet("MH") is vt.wavelet("haar")
        assert "myhaar" in vt.available_wavelets()
    finally:
        registry._FACTORIES.pop("myhaar", None)
        registry._ALIASES.pop("mh", None)
        registry.wavelet.cache_clear()
    with pytest.raises(InvalidArgumentError):
        vt.wavelet("myhaar")


@pytest.mark.parametrize("name", ["gaus2", "cgau3", "shan", "fbsp", "morse",
                                  "morl", "cmor", "mexh", "paul4", "dog"])
def test_continuous_families_match_jax(name):
    ours, ref = vt.wavelet(name), vw.wavelet(name)
    assert isinstance(ours, vt.ContinuousWavelet)
    assert (ours.name, ours.family, ours.center_frequency, ours.bandwidth, ours.is_complex,
            ours.wavelet_type.value) == (ref.name, ref.family, ref.center_frequency,
                                         ref.bandwidth, ref.is_complex, ref.wavelet_type.value)
    t = np.linspace(-8, 8, 513)
    np.testing.assert_allclose(ours.psi(t), ref.psi(t), rtol=0, atol=1e-14)
    assert _names(vt.supported_transforms(name)) == _names(vw.supported_transforms(name))
    assert vt.recommended_transform(name).value == vw.recommended_transform(name).value


# --- mirrors of tests/test_wavelet_families.py and tests/test_wavelet_filters.py -------
#
# The JAX tests' invariants and published values, on the port's own filters;
# the filters themselves equal the JAX package's at 1e-14 (above), and the
# round trips equal the JAX jnp round trips at 1e-12 of the largest value.

COIF_ORDERS = list(range(1, 18))
BIOR_NAMES = [
    "bior1.1", "bior1.3", "bior1.5",
    "bior2.2", "bior2.4", "bior2.6", "bior2.8",
    "bior3.1", "bior3.3", "bior3.5", "bior3.7", "bior3.9",
    "bior4.4", "bior5.5", "bior6.8",
]
DB2_PUBLISHED = [0.4829629131445341, 0.8365163037378079, 0.2241438680420134,
                 -0.1294095225512603]
DB4_PUBLISHED = [
    0.23037781330885523, 0.7148465705525415, 0.6308807679295904, -0.02798376941698385,
    -0.18703481171888114, 0.030841381835986965, 0.032883011666982945, -0.010597401784997278,
]
SYM4_PUBLISHED = [
    -0.07576571478927333, -0.02963552764599851, 0.49761866763201545, 0.8037387518059161,
    0.29785779560527736, -0.09921954357684722, -0.012603967262037833, 0.0322231006040427,
]
ALL_ORTHOGONAL = ["haar"] + [f"db{k}" for k in range(2, 39)] + [f"sym{k}" for k in range(2, 21)]


def _periodic_roundtrip_both(name, levels, x):
    """The port's and the JAX jnp periodic round trips of float64 x."""
    import jax
    import jax.numpy as jnp

    got = vt.imodwt_multilevel(vt.modwt_multilevel(torch.from_numpy(x), name, levels=levels),
                               name)
    want = jax.jit(lambda z: vw.imodwt_multilevel(
        vw.modwt_multilevel(z, name, levels=levels, backend="jnp"), name, backend="jnp"))(
        jnp.asarray(x))
    scale = max(1.0, float(np.abs(np.asarray(want)).max()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12 * scale)
    return got.numpy()


@pytest.mark.parametrize("order", COIF_ORDERS)
def test_coiflet_invariants(order):
    """6K taps, sum sqrt(2), unit energy, even-shift orthogonality, all
    within 1e-12."""
    h = vt.wavelet(f"coif{order}").dec_lo
    assert len(h) == 6 * order == len(vw.wavelet(f"coif{order}").dec_lo)
    assert abs(h.sum() - np.sqrt(2.0)) < 1e-12
    assert abs((h * h).sum() - 1.0) < 1e-12
    for k in range(2, len(h), 2):
        assert abs(np.dot(h[:-k], h[k:])) < 1e-12


def test_coif1_closed_form():
    s7 = np.sqrt(7.0)
    expected = np.array([s7 - 3, 1 - s7, 14 - 2 * s7, 14 + 2 * s7, 5 + s7, 1 - s7]) * (
        np.sqrt(2.0) / 32.0)
    np.testing.assert_allclose(vt.wavelet("coif1").dec_lo, expected, rtol=0, atol=1e-14)
    np.testing.assert_allclose(vw.wavelet("coif1").dec_lo, expected, rtol=0, atol=1e-14)


def test_coiflet_moments():
    """coif3: 2K vanishing wavelet moments and 2K - 1 scaling moments about
    tau, within 1e-7 * 10^j."""
    w = vt.wavelet("coif3")
    h, g = w.dec_lo, w.dec_hi
    n = np.arange(len(h), dtype=np.float64)
    tau = round(float((n * h).sum()) / np.sqrt(2.0))
    for j in range(6):
        assert abs(float(np.sum(n ** j * g))) < 1e-7 * 10.0 ** j, j
    for j in range(1, 6):
        assert abs(float(np.sum((n - tau) ** j * h))) < 1e-7 * 10.0 ** j, j


@pytest.mark.parametrize("name", BIOR_NAMES)
def test_biorthogonal_validation(name):
    """Biorthogonal type, perfect reconstruction, rbio the swapped pair."""
    w = vt.wavelet(name)
    assert w.wavelet_type is vt.WaveletType.BIORTHOGONAL
    assert w.wavelet_type.value == vw.wavelet(name).wavelet_type.value
    assert w.validate_perfect_reconstruction()
    rb = vt.wavelet(name.replace("bior", "rbio"))
    np.testing.assert_allclose(rb.dec_lo, w.rec_lo, atol=0)
    np.testing.assert_allclose(rb.rec_lo, w.dec_lo, atol=0)


def test_bior44_is_cdf97():
    published = [
        0.03782845550726404, -0.023849465019556843, -0.11062440441843718,
        0.37740285561283066, 0.8526986790088938, 0.37740285561283066,
        -0.11062440441843718, -0.023849465019556843, 0.03782845550726404,
    ]
    np.testing.assert_allclose(vt.wavelet("bior4.4").dec_lo, published, atol=1e-11)


@pytest.mark.parametrize("name", ["coif5", "bior2.4", "bior4.4", "rbio3.3", "dmey"])
def test_periodic_roundtrip_extended_families(name):
    """N = 512, up to 3 levels: within 1e-10 of x (dmey, a truncated
    filter: 1e-4), and within 1e-12 of the JAX round trip."""
    from tests.conftest import composite_sin

    x = composite_sin(512, noise_std=0.3)
    levels = min(3, vt.max_levels(512, name))
    assert levels == min(3, vw.max_levels(512, name))
    xr = _periodic_roundtrip_both(name, levels, x)
    assert float(np.abs(x - xr).max()) < (1e-4 if name == "dmey" else 1e-10)


def test_blem_roundtrip_quality():
    """blem3 at 2 levels reconstructs to an NRMSE under 0.08, as the JAX
    round trip (1e-12) does."""
    from tests.conftest import composite_sin

    x = composite_sin(256, noise_std=0.2)
    xr = _periodic_roundtrip_both("blem3", 2, x)
    assert float(np.sqrt(np.mean((x - xr) ** 2)) / np.std(x)) < 0.08


def test_dmey_orthogonality():
    h = vt.wavelet("dmey").dec_lo
    assert len(h) == 62
    assert max(abs(np.dot(h[:-k], h[k:])) for k in range(2, len(h), 2)) < 1e-4


def test_registry_family_counts():
    for names in (vt.available_wavelets(), vw.available_wavelets()):
        assert sum(1 for n in names if n.startswith("coif")) == 17
        assert sum(1 for n in names if n.startswith("bior")) == 15
        assert sum(1 for n in names if n.startswith("rbio")) == 15
        assert sum(1 for n in names if n.startswith("blem")) == 5
        assert "dmey" in names


def test_haar_constants():
    w = vt.wavelet("haar")
    s = 1.0 / np.sqrt(2.0)
    np.testing.assert_allclose(w.dec_lo, [s, s], rtol=0, atol=1e-15)
    np.testing.assert_allclose(w.dec_hi, [s, -s], rtol=0, atol=1e-15)


@pytest.mark.parametrize("name,published", [("db2", DB2_PUBLISHED), ("db4", DB4_PUBLISHED)])
def test_daubechies_published_parity(name, published):
    np.testing.assert_allclose(vt.wavelet(name).dec_lo, published, rtol=0, atol=1e-11)


def test_sym4_published_parity():
    np.testing.assert_allclose(vt.wavelet("sym4").dec_lo, SYM4_PUBLISHED, rtol=0, atol=1e-9)


@pytest.mark.parametrize("name", ALL_ORTHOGONAL)
def test_orthogonal_invariants(name):
    """sum sqrt(2), unit energy (1e-10), the QMF relation (1e-15), even-shift
    orthogonality (1e-10), perfect reconstruction."""
    w = vt.wavelet(name)
    h = w.dec_lo
    assert abs(h.sum() - np.sqrt(2.0)) < 1e-10
    assert abs((h * h).sum() - 1.0) < 1e-10
    signs = np.where(np.arange(len(h)) % 2 == 0, 1.0, -1.0)
    np.testing.assert_allclose(w.dec_hi, signs * h[::-1], rtol=0, atol=1e-15)
    for k in range(2, len(h), 2):
        assert abs(np.dot(h[:-k], h[k:])) < 1e-10
    assert w.validate_perfect_reconstruction()


@pytest.mark.parametrize("name", ["db4", "db10", "sym8"])
def test_vanishing_moments(name):
    w = vt.wavelet(name)
    assert w.vanishing_moments == vw.wavelet(name).vanishing_moments
    n = np.arange(len(w.dec_hi), dtype=np.float64)
    for p in range(w.vanishing_moments):
        assert abs(float(np.sum(n ** p * w.dec_hi))) < 1e-8 * 10.0 ** p, (name, p)


def test_registry_queries():
    assert "haar" in vt.available_wavelets()
    assert "db38" in vt.available_wavelets()
    assert vt.wavelet("DB4").name == "db4"
    assert vt.wavelet("db1").name == "haar" == vw.wavelet("db1").name
    daubs = vt.wavelets_in_family("Daubechies")
    assert "db4" in daubs and "haar" not in daubs
    assert vt.is_compatible("db4", vt.TransformType.MODWT)
    assert not vt.is_compatible("db4", vt.TransformType.CWT)
    assert vt.recommended_transform("db4") is vt.TransformType.MODWT


def test_unknown_wavelet_error():
    with pytest.raises(InvalidArgumentError) as info:
        vt.wavelet("nosuchwavelet42")
    assert info.value.code is vt.ErrorCode.CFG_UNSUPPORTED_WAVELET
    with pytest.raises(vw.InvalidArgumentError) as jax_info:
        vw.wavelet("nosuchwavelet42")
    assert jax_info.value.code is vw.ErrorCode.CFG_UNSUPPORTED_WAVELET


def test_unknown_wavelet_raises_with_suggestions():
    with pytest.raises(InvalidArgumentError, match="Unknown wavelet") as info:
        vt.wavelet("db99")
    assert "db" in str(info.value)


def test_filter_cache_is_the_ports_own():
    """The port's filters ship in its own table (no disk cache), and its
    cache root lies apart from the JAX package's filter cache."""
    assert "vectorwave_tpu_torch" in cache_root()
    from vectorwave_tpu.wavelets._cache import _cache_dir as jax_cache_dir
    from vectorwave_tpu_torch.wavelets._cache import table_filter

    root, jax_dir = os.path.realpath(cache_root()), os.path.realpath(jax_cache_dir())
    assert jax_dir != root and not jax_dir.startswith(root + os.sep)
    np.testing.assert_array_equal(table_filter("db4"), vt.wavelet("db4").dec_lo)


def test_wavelet_from_arrays_carries_jax_filters():
    ref = vw.wavelet("sym8")
    w = convert.wavelet_from_arrays(
        "sym8", ref.dec_lo, ref.dec_hi, ref.rec_lo, ref.rec_hi,
        family="Symlet", vanishing_moments=8,
    )
    assert w.validate_perfect_reconstruction()
    x = np.random.default_rng(0).standard_normal((2, 512))
    got = vt.modwt_multilevel(torch.from_numpy(x), w, levels=3)
    want = vw.modwt_multilevel(x, ref, levels=3, backend="jnp")
    np.testing.assert_array_equal(got.approx.numpy(), np.asarray(want.approx))


def test_wavelet_from_arrays_rejects_ragged_filters_and_infers_the_type():
    with pytest.raises(InvalidArgumentError):
        convert.wavelet_from_arrays("x", [1.0, 1.0], [1.0], [1.0, 1.0], [1.0, 1.0])
    bior = vw.wavelet("bior2.2")
    w = convert.wavelet_from_arrays("bior2.2", bior.dec_lo, bior.dec_hi,
                                    bior.rec_lo, bior.rec_hi)
    assert not w.is_orthogonal and w.validate_perfect_reconstruction()


def test_thresholds_from_numpy():
    th = convert.thresholds_from_numpy(np.arange(12, dtype=np.float64).reshape(2, 6),
                                       device="cpu")
    assert th.dtype == torch.float32 and th.shape == (2, 6) and th.is_contiguous()
    with pytest.raises(InvalidArgumentError):
        convert.thresholds_from_numpy(np.float64(1.0), device="cpu")


@pytest.mark.parametrize("alias,name", [("jnp", "torch"), ("pallas", "kernel"),
                                        ("auto", "auto"), ("torch", "torch")])
def test_backend_names_and_aliases(alias, name):
    try:
        vt.set_backend(alias)
        assert vt.get_backend() == name
    finally:
        vt.set_backend("auto")


def test_config_rejects_unknown_names():
    with pytest.raises(InvalidConfigurationError):
        vt.set_backend("cuda")
    with pytest.raises(InvalidConfigurationError):
        vt.set_fused_precision("exact")
    with pytest.raises(InvalidConfigurationError):
        vt.set_sigma_estimator("median")


def test_port_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['jaxlib'] = None\n"
        "import vectorwave_tpu_torch as vt, torch\n"
        "assert not any(m == 'vectorwave_tpu' or m.startswith('vectorwave_tpu.')"
        " for m in sys.modules)\n"
        "x = torch.randn(2, 4096)\n"
        "r = vt.modwt_multilevel(x, 'db4', levels=6)\n"
        "y = vt.imodwt_multilevel(r, 'db4')\n"
        "assert float((y - x).abs().max()) < 1e-5\n"
        "import vectorwave_tpu_torch.kernels.modwt_bank\n"
        "import vectorwave_tpu_torch.denoise.packet, vectorwave_tpu_torch.denoise.dtcwt_shrink\n"
        "import vectorwave_tpu_torch.transforms.packets, vectorwave_tpu_torch.transforms.dtcwt\n"
        "from vectorwave_tpu_torch.wavelets import (biorthogonal, coiflets,\n"
        "    fourier_families, qshift, _coiflet_seeds)\n"
        "for name in ('coif2', 'bior4.4', 'rbio1.3', 'dmey', 'blem2'):\n"
        "    assert vt.wavelet(name).validate_perfect_reconstruction()\n"
        "z = vt.idtcwt(vt.dtcwt(x, levels=3))\n"
        "assert float((z - x).abs().max()) < 1e-5\n"
        "z = vt.imodwpt(vt.modwpt(x, 'bior4.4', 3), 'bior4.4')\n"
        "assert float((z - x).abs().max()) < 1e-5\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_never_import_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|vectorwave_tpu)(\s|\.|$)",
                         re.MULTILINE)
    files = sorted((REPO / "vectorwave_tpu_torch").rglob("*.py"))
    assert files
    for path in files:
        assert not pattern.search(path.read_text()), path
    assert not pattern.search((REPO / "chip_smoke.py").read_text())


def test_public_names_exist():
    for name in vt.__all__:
        assert hasattr(vt, name), name
