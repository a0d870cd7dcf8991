"""Port parity: the synchrosqueezing transform (``transforms.sst``),
mirroring ``tests/test_sst.py``.

The same seeded numpy signals go through the JAX package and the port in
float64 on the CPU.  ``synchrosqueeze``, ``isst`` and ``extract_mode`` are
held to JAX within 1e-10 of the largest value: the port sums each bin by one
scatter-add where JAX sums one masked copy of the field per bin, the same
terms in another order, and a coefficient whose frequency lies within
rounding of a bin edge could change bins (none does at these seeds; the
bins are then equal).  ``dominant_frequencies`` equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from vectorwave_tpu_torch.errors import InvalidArgumentError
from vectorwave_tpu_torch.transforms import sst as tsst

torch.set_num_threads(1)

TOL = 1e-10
N = 1024
SCALES = tuple(vw.scales_log(2, 64, 32))


def _two_tone(n=N, f1=0.04, f2=0.06, a2=0.8, noise=0.05, seed=0):
    t = np.arange(n)
    x = np.sin(2 * np.pi * f1 * t) + a2 * np.sin(2 * np.pi * f2 * t)
    return x + noise * np.random.default_rng(seed).standard_normal(n)


def _rel(got, want) -> float:
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("name,kw", [
    ("morl", {}),
    ("morl", {"boundary": "periodic", "n_bins": 40}),
    ("cmor", {"gamma": 0.05}),
    ("mexh", {"n_bins": 16}),
])
def test_synchrosqueeze_isst_and_mode_match_jax(name, kw):
    xb = np.stack([_two_tone(), _two_tone(f1=0.03, seed=1)])
    want = vw.synchrosqueeze(jnp.asarray(xb), SCALES, name, **kw)
    got = vt.synchrosqueeze(torch.from_numpy(xb), SCALES, name, **kw)
    assert got.coeffs.shape == (2, want.n_bins, N) and got.coeffs.is_complex()
    np.testing.assert_array_equal(got.freqs, want.freqs)
    assert got.scales == want.scales and got.boundary == want.boundary
    assert _rel(got.coeffs, want.coeffs) <= TOL
    assert _rel(vt.isst(got, name), vw.isst(want, name)) <= TOL
    dom = vt.dominant_frequencies(got)
    np.testing.assert_array_equal(dom.numpy(), np.asarray(vw.dominant_frequencies(want)))
    for track in (np.full(N, 0.04), np.asarray(vw.dominant_frequencies(want))):
        assert _rel(vt.extract_mode(got, torch.from_numpy(np.array(track)), name,
                                    bandwidth_octaves=0.3),
                    vw.extract_mode(want, jnp.asarray(track), name,
                                    bandwidth_octaves=0.3)) <= TOL


def test_a_jax_sst_result_carried_across_inverts_in_the_port():
    """``convert.sst_result_from_arrays`` takes JAX's fields; the port's
    ``isst`` and ``extract_mode`` of them equal JAX's."""
    want = vw.synchrosqueeze(jnp.asarray(_two_tone(seed=2)), SCALES, "morl", n_bins=24)
    got = vt.convert.sst_result_from_arrays(np.asarray(want.coeffs), want.freqs, want.scales,
                                            want.boundary, device="cpu")
    assert got.n_bins == 24 and got.coeffs.dtype == torch.complex128
    assert _rel(vt.isst(got, "morl"), vw.isst(want, "morl")) <= TOL
    assert _rel(vt.dominant_frequencies(got), vw.dominant_frequencies(want)) == 0.0
    with pytest.raises(InvalidArgumentError):
        vt.convert.sst_result_from_arrays(np.zeros((3, 8)), [0.1, 0.2], SCALES, device="cpu")


def test_scatter_equals_the_masked_sum_per_bin():
    """The one scatter-add against JAX's form, one masked sum a bin."""
    rng = np.random.default_rng(3)
    contrib = torch.from_numpy(rng.standard_normal((2, 12, 300))
                               + 1j * rng.standard_normal((2, 12, 300)))
    idx = torch.from_numpy(rng.integers(0, 9, (2, 12, 300)))  # 8 bins + the discard bin
    got = tsst._squeeze(contrib, idx, 8)
    want = torch.stack([torch.where(idx == b, contrib, 0).sum(-2) for b in range(8)], -2)
    assert float((got - want).abs().max()) <= 1e-12


def test_isst_recovers_the_signal_and_errors():
    x = _two_tone(noise=0.0)
    res = vt.synchrosqueeze(torch.from_numpy(x), SCALES, "morl", boundary="periodic")
    y = vt.isst(res, "morl").numpy()
    assert np.sqrt(np.mean((y - x) ** 2)) / x.std() < 0.05
    for kw in ({"gamma": -1.0}, {"n_bins": 1}):
        with pytest.raises(InvalidArgumentError):
            vt.synchrosqueeze(torch.from_numpy(x), SCALES, "morl", **kw)
    with pytest.raises(InvalidArgumentError):
        vt.extract_mode(res, torch.full((N,), 0.04, dtype=torch.float64), "morl",
                        bandwidth_octaves=0.0)
