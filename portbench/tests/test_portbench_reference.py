"""The plain reference: its taps against their published definition, its
round trips, and its agreement with the program's plain CPU path for each
cell's entry.  CPU only, float64, small sizes."""

import itertools
import math

import numpy as np
import pytest
import torch

import vectorwave_tpu_torch as vt
from portbench import core
from portbench.reference import modwt as ref
from portbench.reference.taps import SCALING, wavelet_filter

CELLS = [w["name"] for w in core.manifest()["workloads"]]


def _signal(rows, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    walk = torch.randn(rows, n, generator=g, dtype=torch.float64).cumsum(-1)
    return walk + 3.0 * torch.randn(rows, n, generator=g, dtype=torch.float64)


@pytest.mark.parametrize("wavelet", sorted(SCALING))
def test_taps_orthonormal(wavelet):
    h = np.array(SCALING[wavelet])
    g = np.array(wavelet_filter(SCALING[wavelet]))
    assert abs(h.sum() - math.sqrt(2)) < 1e-15
    for m in range(len(h) // 2):
        want = 1.0 if m == 0 else 0.0
        assert abs(np.dot(h[: len(h) - 2 * m], h[2 * m:]) - want) < 1e-15
    k = np.arange(len(h), dtype=np.float64)
    for p in range(len(h) // 2):  # vanishing moments of the wavelet filter
        assert abs(np.sum(g * (k / len(h)) ** p)) < 1e-13


def _factorisations(n_moments):
    """Every real filter of Daubechies' factorisation with N vanishing moments,
    at 60 digits."""
    mp = pytest.importorskip("mpmath")
    mp.mp.dps = 60
    coeffs = [mp.binomial(n_moments - 1 + k, k) for k in range(n_moments)]
    pairs = []
    for y in mp.polyroots(list(reversed(coeffs)), maxsteps=200, extraprec=200):
        if mp.im(y) < -mp.mpf(10) ** -40:
            continue  # the conjugate of a root kept below
        b = 2 - 4 * y
        z = (b + mp.sqrt(b * b - 4)) / 2
        pairs.append(((z, 1 / z), abs(mp.im(y)) > mp.mpf(10) ** -40))
    for choice in itertools.product((0, 1), repeat=len(pairs)):
        roots = [mp.mpf(-1)] * n_moments
        for c, ((z1, z2), cplx) in zip(choice, pairs):
            roots += [(z1, z2)[c]] + ([mp.conj((z1, z2)[c])] if cplx else [])
        poly = [mp.mpf(1)]
        for r in roots:
            poly = [a - r * b for a, b in zip(poly + [0], [0] + poly)]
        total = sum(mp.re(c) for c in poly)
        yield [float(mp.re(c) * mp.sqrt(2) / total) for c in poly]


def test_db4_is_the_extremal_phase_factorisation():
    """db4 is, to the last bit, the factorisation whose energy comes
    earliest."""
    h = np.array(SCALING["db4"])
    cands = [np.array(c) for c in _factorisations(4)]
    cands += [c[::-1] for c in cands]
    front = max(cands, key=lambda c: np.sum(c[: len(c) // 2] ** 2))
    assert np.array_equal(front, h)


@pytest.mark.parametrize("levels", [1, 6, 10])
def test_periodic_round_trip_to_rounding(levels):
    x = _signal(3, 1024)
    details, approx = ref.analysis(x, "db4", levels)
    y = ref.synthesis(details, approx, "db4")
    assert float((y - x).abs().max() / x.abs().max()) < 1e-14


def test_planes_and_inverse_match_the_program():
    x = _signal(3, 2048)
    res = vt.modwt_multilevel(x, "db4", levels=6, boundary="periodic", backend="torch")
    details, approx = ref.analysis(x, "db4", 6)
    for p, q in zip(res.details + (res.approx,), details + [approx]):
        assert float((p - q).abs().max()) <= 1e-12 * float(q.abs().max())
    y = vt.imodwt_multilevel(res, "db4", boundary="periodic", backend="torch")
    yr = ref.synthesis(details, approx, "db4")
    assert float((y - yr).abs().max()) <= 1e-12 * float(yr.abs().max())


@pytest.mark.parametrize("boundary", ["symmetric", "zero"])
def test_reference_refuses_other_boundaries(boundary):
    with pytest.raises(ValueError):
        ref.analysis(_signal(1, 64), "db4", 2, boundary)
    with pytest.raises(ValueError):
        ref.synthesis([torch.zeros(1, 64)], torch.zeros(1, 64), "db4", boundary)


@pytest.mark.parametrize("name", CELLS)
def test_cell_reference_matches_the_program(name):
    """Each cell's entry on the program's plain CPU path, in float32 at a
    small size, against the reference on the same input."""
    cell = core.load_cell(name)
    x = _signal(4, 2048, seed=1).to(torch.float32)
    (errors,) = core.compare(cell.entry, cell.cfg, cell.mix, x,
                             [cell.entry.call(x, cell.cfg, cell.mix)])
    assert set(errors) == set(cell.limits)
    for g, e in errors.items():
        assert e < 2e-6, (g, e)
