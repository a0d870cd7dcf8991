"""The kernel-reaching cases of the JAX package's test mirrors, run on the card.

The CPU mirrors of the JAX package's MODWT tests
(``tests/test_torch_core_mirror.py``, ``tests/test_torch_kernel_tier_mirror.py``,
``tests/test_torch_property_sweep.py``) hold the port to the JAX package at the
JAX tests' own shapes.  The cases among those shapes that reach a CUDA kernel
are listed here (:func:`cases`), their inputs made with numpy from the JAX
tests' seeds (:func:`case_input`).  :func:`run_case` runs one case on a device
through the public entry points, twice:

* under ``backend='auto'``, held against the plain route on the same device
  (``backend='torch'``), with the kernel launches of each direction counted
  and held to the router's gate (``multilevel._kernel_eligible``);
* forced onto the kernel tier (``backend='kernel'``).  There a CUDA call is
  either served by a kernel launch and held against the same plain route, or
  refused with ``InvalidArgumentError``, and it is refused exactly where the
  kernels cannot serve the shape (:func:`kernel_serves`), never where the
  gate admits it; the gate's floors (2 levels, 128 samples, the halo, the
  symmetric synthesis's 2^23 samples) refuse more, which ``kernel`` serves.  A CPU call runs
  the kernels' plain versions: it launches nothing and is never refused.

``chip_smoke.py`` runs every case in its phase 2b; on a card
``tests/test_torch_cuda.py::test_mirror_case_on_the_card`` runs each as a
test, and ``tests/test_torch_kernel_tier_mirror.py`` runs every case on the
CPU.  Import this module from the root of a checkout.

:func:`family_cases` are the other kernel families' cases, from the mirrors
in ``tests/test_torch_bank_mirror.py``, ``tests/test_torch_twodim_mirror.py``
and ``tests/test_torch_symmetric_exact_mirror.py``: the filter bank (packet
trees and pairs, the dual tree, the CWT's kernel-direct tier), the 2-D pair,
the symmetric pair with the SWT and the denoiser, the exact tier and the
batch facade of BASELINE config #4.  ``chip_smoke.py`` runs them in its
phase 2c, the same way: under ``auto`` each direction's launches are held
to its family's router, asked through the decisions the router itself takes
(``packets._tree_bank`` and ``_pair_bank``; ``dtcwt._whole_tree_bank`` and
``_decimated_bank_ok``; ``cwt._kernel_direct_split``;
``modwt2.modwt2_kernel_eligible``; ``denoiser.fused_denoise_serves``;
``multilevel._kernel_eligible`` with ``modwt_symmetric.route_fits``), by
count where the router fixes one (a whole tree is one launch, the pairs one
a level), and under ``backend='kernel'`` a CUDA call is served or refused
exactly where the kernels' own windows say (``kernel_refusal``,
``bank_fits``, ``route_fits``).  A JAX test's float64 input reaches no
kernel; where the mirror holds an entry point of these families that the
JAX tests feed float64 alone (the SWT, the denoisers, the packet tools),
the case casts the JAX test's input to float32, as the sweep's cases do.

Bounds (PERF.md section 2): a float32 kernel against the float32 plain route
2e-5 max abs (fp32 in another summation order, values of order 1; the plain
periodic route of a CUDA tensor may take the FFT, which differs by 3.3e-6);
the exact tier's hi + lo against the plain float64 cascade 1e-13 and its
round trip within 1e-10 RMSE of the input; the symmetric round trip's
interior NRMSE within 10% above the JAX tests' committed baseline
(``tests/baselines/symmetric_nrmse_baseline.json``).  The other families
keep the JAX tests' float32 bounds: the bank 2e-5, the dual tree 3e-5, the
2-D levels 2e-5 and round trips 5e-5, the symmetric pair 5e-6, the CWT 2e-5
of the largest coefficient, and gradients 5e-6 of the largest entry.
"""

from __future__ import annotations

import contextlib
import json
import math
import pathlib
from typing import NamedTuple

import numpy as np
import torch

import vectorwave_tpu_torch as vt
from vectorwave_tpu_torch.denoise import denoiser
from vectorwave_tpu_torch.errors import InvalidArgumentError
from vectorwave_tpu_torch.kernels import modwt2 as k2
from vectorwave_tpu_torch.kernels import modwt_bank as mb
from vectorwave_tpu_torch.kernels import modwt_composite as mc
from vectorwave_tpu_torch.kernels import modwt_symmetric as ms
from vectorwave_tpu_torch.ops.thresholds import apply_threshold, mad_sigma, universal_threshold
from vectorwave_tpu_torch.transforms import cwt as cwt_mod
from vectorwave_tpu_torch.transforms import dtcwt as dt
from vectorwave_tpu_torch.transforms import multilevel as ml
from vectorwave_tpu_torch.transforms import packets as pk

TOL_F32 = 2e-5
TOL_DUAL_TREE = 3e-5
TOL_2D_ROUND_TRIP = 5e-5
TOL_SYMMETRIC = 5e-6
TOL_GRAD = 5e-6
TOL_EXACT = 1e-13
EXACT_RT_RMSE = 1e-10
NRMSE_HEADROOM = 1.10
BASELINES = pathlib.Path(__file__).resolve().parent.parent / "tests" / "baselines" / \
    "symmetric_nrmse_baseline.json"

#: tests/test_property_sweep.py's draw
SWEEP_WAVELETS = ("haar", "db2", "db4", "db7", "sym5", "coif2", "bior2.4", "rbio3.1")
SWEEP_BOUNDARIES = ("periodic", "zero", "symmetric")

ANALYSIS = ("modwt_analysis", "modwt_mxu_analysis", "modwt_exact_analysis")
SYNTHESIS = ("modwt_synthesis", "modwt_symmetric_synthesis", "modwt_exact_synthesis")
DENOISE = ("modwt_denoise",)
BANK_ANALYSIS = ("modwt_bank_analysis",)
BANK_SYNTHESIS = ("modwt_bank_synthesis",)
ANALYSIS_2D = ("modwt2_analysis",)
SYNTHESIS_2D = ("modwt2_synthesis",)


def sweep_configs(n_cases: int = 24, seed: int = 1234) -> list[tuple]:
    """``(wavelet, n, boundary, batch, index)`` of the JAX property sweep's
    MODWT cases, drawn as ``tests/test_property_sweep.py::_configs`` draws them."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_cases):
        w = SWEEP_WAVELETS[rng.integers(len(SWEEP_WAVELETS))]
        n = int(rng.integers(48, 700))
        boundary = SWEEP_BOUNDARIES[rng.integers(len(SWEEP_BOUNDARIES))]
        batch = () if rng.random() < 0.5 else tuple(
            int(b) for b in rng.integers(1, 4, size=rng.integers(1, 3)))
        out.append((w, n, boundary, batch, i))
    return out


def sweep_input(wavelet: str, n: int, batch: tuple, seed: int) -> tuple[np.ndarray, int]:
    """The sweep case's float64 signal and its depth, drawn in the JAX test's order."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(batch + (n,))
    levels = max(1, min(vt.max_levels(n, wavelet), int(rng.integers(1, 6))))
    return x, levels


def composite_sin(n: int, seed: int = 7, noise_std: float = 0.0) -> np.ndarray:
    """``tests/conftest.py::composite_sin``: the JAX tests' seeded test signal."""
    t = np.arange(n)
    x = (np.sin(2 * np.pi * t / 32.0) + 0.5 * np.sin(2 * np.pi * t / 8.0)
         + 0.25 * np.sin(2 * np.pi * t / 128.0 + 0.6))
    if noise_std > 0:
        x = x + np.random.default_rng(seed).normal(0.0, noise_std, n)
    return x


class Case(NamedTuple):
    """One mirrored call.  ``kind``: ``pair`` (analysis then synthesis),
    ``exact`` (the exact tier), ``denoise`` (the fused denoise with the JAX
    test's thresholds), ``roundtrip`` (``modwt_roundtrip_fused``) or
    ``nrmse`` (the symmetric round trip's interior NRMSE guard); phase 2c's
    kinds are the keys of :data:`RUNNERS` from ``packets`` on (one runner
    each, below).  ``source`` names the JAX test it mirrors; ``data`` how
    its input is made."""

    label: str
    kind: str
    source: str
    wavelet: str
    levels: int
    shape: tuple
    boundary: str = "periodic"
    data: tuple = ("normal", 0)
    dtype: str = "float32"
    options: tuple = ()

    def option(self, key, default=None):
        return dict(self.options).get(key, default)


def cases() -> list[Case]:
    """Every kernel-reaching case of the mirrors, at the JAX tests' shapes."""
    out = []
    pk = "test_pallas_kernels.py"
    for name, levels in (("haar", 4), ("db4", 6), ("sym8", 3)):
        for b in ("periodic", "zero"):
            out.append(Case(f"analysis {name} J={levels} {b} 4x2048", "pair",
                            f"{pk}::test_fused_analysis_matches_jnp", name, levels,
                            (4, 2048), b))
    out.append(Case("roundtrip db4 J=6 2x4096", "pair", f"{pk}::test_fused_roundtrip",
                    "db4", 6, (2, 4096), data=("normal", 1)))
    out.append(Case("synthesis db4 J=4 2x2048", "pair",
                    f"{pk}::test_fused_synthesis_matches_jnp_inverse", "db4", 4, (2, 2048),
                    data=("normal", 2)))
    out.append(Case("1-D haar J=3 1024", "pair", f"{pk}::test_fused_1d_input", "haar", 3,
                    (1024,), data=("normal", 3)))
    for name, levels, n in (("db4", 4, 2048), ("sym8", 3, 1000), ("haar", 5, 4096)):
        out.append(Case(f"symmetric {name} J={levels} 3x{n}", "pair",
                        f"{pk}::test_fused_symmetric_analysis_matches_jnp", name, levels,
                        (3, n), "symmetric", ("normal", 13)))
    out.append(Case("symmetric synthesis db4 J=3 2x512", "pair",
                    f"{pk}::test_fused_synthesis_unknown_boundary_rejected", "db4", 3,
                    (2, 512), "symmetric", ("normal", 7)))
    for n in (1000, 97 * 64, 4097):
        out.append(Case(f"arbitrary N db4 J=3 2x{n}", "pair", f"{pk}::test_fused_arbitrary_n",
                        "db4", 3, (2, n), data=("normal", 11)))
    for prec in ("float32", "bf16_3x"):
        out.append(Case(f"precision {prec} db4 J=4 2x2048", "pair",
                        f"{pk}::test_fused_precision_modes", "db4", 4, (2, 2048),
                        data=("normal", 21), options=(("precision", prec),)))
    out.append(Case("auto backend db4 J=3 256", "pair", f"{pk}::test_explicit_auto_backend_param",
                    "db4", 3, (256,), data=("sin", 0)))

    fd = "test_fused_denoise.py"
    for b, n, name, levels, boundary, mode in (
            (2, 2048, "db4", 4, "periodic", "soft"), (1, 4096, "sym8", 3, "zero", "soft"),
            (1, 4096, "sym8", 3, "zero", "hard"), (3, 4096, "haar", 5, "periodic", "soft"),
            (2, 2048, "bior2.2", 3, "periodic", "soft")):
        out.append(Case(f"denoise {name} J={levels} {boundary} {mode} {b}x{n}", "denoise",
                        f"{fd}::test_fused_denoise_matches_three_call_path", name, levels,
                        (b, n), boundary, options=(("mode", mode),)))
    out.append(Case("denoise short haar J=5 1x512", "denoise",
                    f"{fd}::test_fused_denoise_short_signal_falls_back", "haar", 5, (1, 512),
                    data=("zeros", 0), options=(("mode", "soft"), ("thresholds", "ones"))))
    out.append(Case("denoise public db4 J=4 2x4096", "denoise",
                    f"{fd}::test_public_api_routes_and_matches", "db4", 4, (2, 4096),
                    data=("normal", 1), options=(("mode", "soft"),)))
    for k, (name, boundary, mode) in enumerate((
            ("db2", "periodic", "soft"), ("db8", "zero", "hard"), ("sym12", "periodic", "hard"),
            ("coif3", "zero", "soft"), ("bior4.4", "periodic", "soft"),
            ("rbio2.2", "periodic", "hard"), ("db16", "periodic", "soft"),
            ("coif5", "periodic", "soft"))):
        out.append(Case(f"denoise family {name} {boundary} {mode} 1x4096", "denoise",
                        f"{fd}::test_fused_denoise_property_sweep_across_families", name, 3,
                        (1, 4096), boundary, ("sequence", 9, k), options=(("mode", mode),)))

    fr = "test_fused_roundtrip.py"
    for b, n, name, levels, boundary in ((2, 2048, "db4", 4, "periodic"),
                                         (1, 4096, "sym8", 3, "zero"),
                                         (3, 4096, "haar", 5, "periodic"),
                                         (2, 2048, "bior2.2", 3, "periodic")):
        out.append(Case(f"fused roundtrip {name} J={levels} {boundary} {b}x{n}", "roundtrip",
                        f"{fr}::test_roundtrip_fused_reconstructs", name, levels, (b, n),
                        boundary))
    out.append(Case("fused roundtrip short db4 J=3 1x512", "roundtrip",
                    f"{fr}::test_roundtrip_fused_short_signal_falls_back", "db4", 3, (1, 512),
                    data=("normal", 1)))
    out.append(Case("fused roundtrip 1-D db4 J=3 2048", "roundtrip",
                    f"{fr}::test_roundtrip_fused_1d_and_grad", "db4", 3, (2048,),
                    data=("normal", 2)))

    tr = "test_tolerance_routing.py"
    out.append(Case("exact tolerance 1e-10 db4 J=5 2x4096", "exact",
                    f"{tr}::test_tolerance_1e10_roundtrip_meets_contract", "db4", 5, (2, 4096),
                    options=(("tolerance", 1e-10),)))
    out.append(Case("exact precision sym8 J=3 4096", "exact",
                    f"{tr}::test_precision_kwarg_explicit", "sym8", 3, (4096,),
                    data=("normal", 1), options=(("precision", "exact"),)))
    out.append(Case("exact batched db4 J=3 2x3x2048", "exact",
                    f"{tr}::test_exact_tier_batched_leading_dims", "db4", 3, (2, 3, 2048),
                    data=("normal", 2), options=(("tolerance", 1e-10),)))
    out.append(Case("exact symmetric db4 J=3 2x2048", "exact",
                    f"{tr}::test_exact_result_symmetric_inverse_raises", "db4", 3, (2, 2048),
                    "symmetric", ("zeros", 0), options=(("precision", "exact"),)))
    out.append(Case("exact full profile db4 J=4 2x2048", "exact",
                    f"{tr}::test_tolerance_below_1e11_escalates_to_full_profile", "db4", 4,
                    (2, 2048), data=("normal", 5), options=(("tolerance", 1e-12),)))
    out.append(Case("float64 short circuit db4 J=4 4096", "pair",
                    f"{tr}::test_f64_input_short_circuits_exact_tier", "db4", 4, (4096,),
                    data=("normal", 3), dtype="float64", options=(("tolerance", 1e-10),)))

    for wavelet, n, boundary, batch, i in sweep_configs():
        _, levels = sweep_input(wavelet, n, batch, i)
        out.append(Case(f"sweep {i} {wavelet} J={levels} {boundary} {batch + (n,)}", "pair",
                        "test_property_sweep.py::test_modwt_multilevel_properties", wavelet,
                        levels, batch + (n,), boundary, ("sweep", i)))

    for name, levels in (("haar", 5), ("db4", 4), ("sym8", 4)):
        out.append(Case(f"nrmse {name} J={levels} 257", "nrmse",
                        "test_multilevel.py::test_symmetric_interior_nrmse_guard", name, levels,
                        (257,), "symmetric", ("sin", 0)))
    return out


def case_input(case: Case) -> np.ndarray:
    """The case's input, made with numpy as the JAX test makes it, in the
    case's dtype (the sweep's float64 signal is cast to float32)."""
    kind = case.data[0]
    if kind == "normal":
        x = np.random.default_rng(case.data[1]).standard_normal(case.shape)
    elif kind == "zeros":
        x = np.zeros(case.shape)
    elif kind == "sin":
        noise = 0.3 if case.kind == "nrmse" else 0.0
        x = composite_sin(case.shape[-1], noise_std=noise)
    elif kind == "sequence":  # the k-th of successive draws from one generator
        rng = np.random.default_rng(case.data[1])
        for _ in range(case.data[2] + 1):
            x = rng.standard_normal(case.shape)
    elif kind == "sweep":
        wavelet, n, _, batch, i = sweep_configs()[case.data[1]]
        x, _ = sweep_input(wavelet, n, batch, i)
    else:
        x = _family_input(case)
    return x.astype(case.dtype)


def kernel_serves(x: torch.Tensor, w, levels: int, boundary: str, synthesis: bool) -> bool:
    """Whether a CUDA call forced onto the kernel tier is served rather than
    refused: a float32 or bfloat16 tensor, and windows the kernels of that
    direction hold (the symmetric gate ``modwt_symmetric.route_fits``, or for
    periodic and zero the cascade pair's room ``kernels_fit``).  The router's
    gate (``_kernel_eligible``) asks this and, beside it, the floors it was
    tuned with."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        return False
    if boundary == "symmetric":
        return ms.route_fits(w, levels, x.shape[-1], synthesis)
    return mc.kernels_fit(w.filter_length, levels)


def _launched(before: dict, names) -> int:
    return sum(mc.LAUNCHES[k] - before[k] for k in names)


def _diff(g: torch.Tensor, v: torch.Tensor) -> float:
    if g.shape != v.shape:
        return math.inf
    if g.is_complex() or v.is_complex():
        return float((g.to(torch.complex128) - v.to(torch.complex128)).abs().max())
    return float((g.double() - v.double()).abs().max())


def _err(got, want) -> float:
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    if len(got) != len(want):
        return math.inf
    return max(_diff(g, v) for g, v in zip(got, want))


def _planes(res) -> tuple:
    return (*res.details, res.approx)


class Outcome:
    """What one case gave: its route under each backend, its errors against
    their bounds, and the faults found (an empty list when it passed)."""

    def __init__(self, case: Case):
        self.case = case
        self.routes: dict[str, str] = {}
        self.errors: list[tuple[str, float, float]] = []  # (what, error, bound)
        self.faults: list[str] = []

    def bound(self, what: str, err: float, bound: float) -> None:
        self.errors.append((what, err, bound))
        if not err <= bound:
            self.faults.append(f"{what}: {err:.3e} > {bound:.0e}")

    def route(self, backend: str, direction: str, launches: int, expected: bool | int,
              on_card: bool) -> None:
        """Record a direction's route; on the card a launch must come exactly
        where ``expected`` (a bool), or exactly ``expected`` launches (an
        int: the router's count); on the CPU never."""
        if type(expected) is bool:
            self.routes[f"{backend} {direction}"] = "kernel" if launches else "plain"
            want = expected and on_card
            if bool(launches) != want:
                self.faults.append(f"{backend} {direction}: {launches} launches where the "
                                   f"gate says {'kernel' if want else 'plain'}")
            return
        self.routes[f"{backend} {direction}"] = f"kernel x{launches}" if launches else "plain"
        want = expected if on_card else 0
        if launches != want:
            self.faults.append(f"{backend} {direction}: {launches} launches where the "
                               f"router says {want}")

    def refused(self, backend: str, direction: str, serves: bool, on_card: bool) -> None:
        self.routes[f"{backend} {direction}"] = "raised"
        if serves or not on_card:
            self.faults.append(f"{backend} {direction}: refused a call the kernels serve")

    @property
    def ok(self) -> bool:
        return not self.faults


def _pair(case, x, w, out, on_card) -> None:
    prec, tol = case.option("precision"), case.option("tolerance")
    bound = case.option("bound", TOL_F32)
    kw = dict(levels=case.levels, boundary=case.boundary)
    plain = vt.modwt_multilevel(x, w, backend="torch", **kw)
    plain_y = vt.imodwt_multilevel(plain, w, boundary=case.boundary, backend="torch")
    before = dict(mc.LAUNCHES)
    res = vt.modwt_multilevel(x, w, precision=prec, tolerance=tol, **kw)
    out.route("auto", "analysis", _launched(before, ANALYSIS),
              ml._kernel_eligible(x, w, case.levels, case.boundary), on_card)
    before = dict(mc.LAUNCHES)
    y = vt.imodwt_multilevel(res, w, boundary=case.boundary, precision=prec, tolerance=tol)
    out.route("auto", "synthesis", _launched(before, SYNTHESIS),
              ml._kernel_eligible(res.approx, w, case.levels, case.boundary, synthesis=True),
              on_card)
    out.bound("auto planes", _err(_planes(res), _planes(plain)), bound)
    out.bound("auto inverse", _err(y, plain_y), bound)
    for direction in ("analysis", "synthesis"):
        synthesis = direction == "synthesis"
        serves = kernel_serves(x, w, case.levels, case.boundary, synthesis)
        like = plain.approx if synthesis else x
        if ml._kernel_eligible(like, w, case.levels, case.boundary, synthesis) and not serves:
            out.faults.append(f"kernel {direction}: the gate admits a call the kernels "
                              "cannot serve")
        before = dict(mc.LAUNCHES)
        try:
            if direction == "analysis":
                got = _planes(vt.modwt_multilevel(x, w, backend="kernel", precision=prec, **kw))
                want = _planes(plain)
            else:
                got = vt.imodwt_multilevel(plain, w, boundary=case.boundary, backend="kernel",
                                           precision=prec)
                want = plain_y
        except InvalidArgumentError:
            out.refused("kernel", direction, serves, on_card)
            continue
        out.route("kernel", direction,
                  _launched(before, ANALYSIS if direction == "analysis" else SYNTHESIS),
                  serves, on_card)
        out.bound(f"kernel {direction}", _err(got, want), bound)
    if case.boundary == "periodic" and x.dtype != torch.float64:
        out.bound("periodic round trip", _err(y, x), TOL_F32)
    return y


def _exact(case, x, w, out, on_card) -> None:
    how = {k: v for k, v in case.options if k in ("precision", "tolerance")}
    kw = dict(levels=case.levels, boundary=case.boundary)
    want = vt.modwt_multilevel(x.double(), w, backend="torch", **kw)
    for backend in ("auto", "kernel"):
        before = dict(mc.LAUNCHES)
        res = vt.modwt_multilevel(x, w, backend=backend, **kw, **how)
        if not isinstance(res, vt.ExactMODWTResult):
            out.faults.append(f"{backend}: {type(res).__name__}, not an ExactMODWTResult")
            return
        out.route(backend, "analysis", _launched(before, ANALYSIS), True, on_card)
        pairs = zip((*res.details, res.approx), (*res.details_lo, res.approx_lo))
        out.bound(f"{backend} hi + lo", _err([h.double() + lo.double() for h, lo in pairs],
                                             _planes(want)), TOL_EXACT)
        if case.boundary == "symmetric":  # the exact tier has no symmetric inverse
            try:
                vt.imodwt_multilevel(res, w, boundary="symmetric")
            except InvalidArgumentError:
                out.routes[f"{backend} synthesis"] = "raised (no symmetric inverse)"
            else:
                out.faults.append(f"{backend}: the exact symmetric inverse did not raise")
            continue
        before = dict(mc.LAUNCHES)
        y = vt.imodwt_multilevel(res, w, boundary=case.boundary, backend=backend)
        out.route(backend, "synthesis", _launched(before, SYNTHESIS), True, on_card)
        cut = 0
        if case.boundary == "zero":  # the zero edge reconstructs the interior alone
            cut = (w.filter_length - 1) * ((1 << case.levels) - 1)
        err = (y.double() - x.double())[..., cut:x.shape[-1] - cut]
        out.bound(f"{backend} round trip rmse", float(err.pow(2).mean().sqrt()),
                  EXACT_RT_RMSE)


def plain_three_call(x, w, levels: int, boundary: str, mode: str, thresholds=None):
    """The JAX fused-denoise tests' oracle on the port's plain route: the
    analysis, each level shrunk by its threshold (by default the tests'
    universal rule, sigma from the MAD of the finest detail scaled by
    sqrt(2^j)), the inverse.  Returns ``(thresholds, output)``."""
    res = vt.modwt_multilevel(x, w, levels=levels, boundary=boundary, backend="torch")
    if thresholds is None:
        sigma = mad_sigma(res.details[0])
        thresholds = torch.cat([universal_threshold(x.shape[-1], sigma / math.sqrt(2.0 ** j))
                                for j in range(1, levels + 1)], dim=-1).to(torch.float32)
    shrunk = vt.MultiLevelMODWTResult(
        tuple(apply_threshold(d, thresholds[..., j:j + 1].to(d.dtype), mode)
              for j, d in enumerate(res.details)), res.approx)
    return thresholds, vt.imodwt_multilevel(shrunk, w, boundary=boundary, backend="torch")


def _denoise(case, x, w, out, on_card) -> None:
    mode = case.option("mode")
    ones = None
    if case.option("thresholds") == "ones":
        ones = torch.ones(x.shape[:-1] + (case.levels,), dtype=torch.float32, device=x.device)
    ths, want = plain_three_call(x, w, case.levels, case.boundary, mode, ones)
    before = dict(mc.LAUNCHES)
    got = vt.fused_denoise_multilevel(x, w, levels=case.levels, thresholds=ths,
                                      boundary=case.boundary, mode=mode)
    out.route("kernel", "denoise", _launched(before, DENOISE), True, on_card)
    out.bound("kernel denoise", _err(got, want), TOL_F32)
    if mode != "soft":  # the public route's own thresholds: a hard cut may flip
        return
    eligible = denoiser.fused_denoise_serves(x, w, case.levels, "universal", mode, case.boundary)
    before = dict(mc.LAUNCHES)
    got = vt.denoise_multilevel(x, w, levels=case.levels, boundary=case.boundary, mode=mode)
    out.route("auto", "denoise", _launched(before, DENOISE), eligible, on_card)
    previous = vt.get_backend()
    vt.set_backend("torch")
    try:
        want = vt.denoise_multilevel(x, w, levels=case.levels, boundary=case.boundary,
                                     mode=mode)
    finally:
        vt.set_backend(previous)
    out.bound("auto denoise", _err(got, want), TOL_F32)


def _roundtrip(case, x, w, out, on_card) -> None:
    kw = dict(levels=case.levels, boundary=case.boundary)
    want = vt.imodwt_multilevel(vt.modwt_multilevel(x, w, backend="torch", **kw), w,
                                boundary=case.boundary, backend="torch")
    before = dict(mc.LAUNCHES)
    got = vt.modwt_roundtrip_fused(x, w, **kw)
    out.route("kernel", "roundtrip", _launched(before, DENOISE), True, on_card)
    out.bound("fused round trip", _err(got, want), TOL_F32)
    if case.boundary == "periodic":
        out.bound("fused round trip against x", _err(got, x), TOL_F32)


def interior_nrmse(x: np.ndarray, y: np.ndarray, filter_length: int, levels: int) -> float:
    """``tests/test_multilevel.py::_interior_nrmse``: the error's RMSE over
    the interior, margin min(N/4, L_J/2), over the interior's spread."""
    n = x.shape[-1]
    eff = (filter_length - 1) * (1 << (levels - 1)) + 1
    margin = min(n // 4, eff // 2)
    err = x[margin:n - margin] - y[margin:n - margin]
    return float(np.sqrt(np.mean(err ** 2)) / np.std(x[margin:n - margin]))


def nrmse_baseline(name: str, n: int, levels: int) -> float:
    return json.loads(BASELINES.read_text())[f"{name},{n},{levels}"]


def _nrmse(case, x, w, out, on_card) -> None:
    y = _pair(case, x, w, out, on_card)
    baseline = nrmse_baseline(case.wavelet, case.shape[-1], case.levels)
    nrmse = interior_nrmse(x.double().cpu().numpy(), y.double().cpu().numpy(),
                           w.filter_length, case.levels)
    out.bound("interior nrmse / baseline", nrmse / baseline, NRMSE_HEADROOM)


# --- the other kernel families (phase 2c) ----------------------------------------------


def doppler(n: int) -> np.ndarray:
    """``tests/test_dtcwt_shrink.py::_doppler``: the unit-variance Doppler."""
    t = np.linspace(1e-3, 1, n)
    x = np.sqrt(t * (1 - t)) * np.sin(2.1 * np.pi / (t + 0.05))
    return x / x.std()


def image(h: int = 64, w: int = 96, seed: int = 0) -> np.ndarray:
    """``tests/test_twodim.py::_image``: two cosines and seeded noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.sin(2 * np.pi * yy / 16) + np.cos(2 * np.pi * xx / 12)
    return img + 0.1 * rng.standard_normal((h, w))


def _named_signal(name: str) -> np.ndarray:
    """The JAX tests' hand-made inputs, each as its test makes it."""
    if name == "packet_hf_tone":  # test_packets.py::test_denoise_packet_beats_...
        t = np.arange(2048)
        clean = np.sin(2 * np.pi * 0.41 * t) + np.sin(2 * np.pi * 0.02 * t)
        return clean + 0.5 * np.random.default_rng(14).standard_normal(2048)
    if name == "packet_smooth":  # test_packets.py::test_denoise_packet_smooth_signal
        t = np.arange(2048)
        clean = 2 * np.sin(2 * np.pi * 0.02 * t) * np.exp(-(((t - 1024) / 600) ** 2))
        return clean + 0.5 * np.random.default_rng(15).standard_normal(2048)
    if name == "packet_noiseless":  # test_packets.py::test_denoise_packet_noiseless_...
        return np.sin(2 * np.pi * 0.01 * np.arange(1024))
    if name == "packet_node_hook":  # test_packets.py::test_reconstruct_basis_node_hook_...
        clean = np.sin(2 * np.pi * 0.03 * np.arange(512))
        return clean + 0.3 * np.random.default_rng(8).standard_normal(512)
    if name == "burst":  # test_dtcwt.py::test_coefficient_delay_aligns_features
        t = np.arange(1024)
        return np.exp(-0.5 * ((t - 400) / 30.0) ** 2) * np.cos(2 * np.pi * 0.05 * t)
    if name == "disk":  # test_dtcwt_shrink.py::test_2d_beats_separable_denoise
        rng = np.random.default_rng(1)
        yy, xx = np.mgrid[0:128, 0:128]
        img = ((xx - 64) ** 2 + (yy - 64) ** 2 < 1600).astype(np.float64)
        img += 0.5 * np.cos(2 * np.pi * 0.1 * (0.97 * xx + 0.26 * yy)) * (xx > 80)
        img /= img.std()
        return img + 0.4 * rng.standard_normal((128, 128))
    if name == "swt2_noisy":  # test_swt2.py::test_swt2_denoise_reduces_noise
        yy, xx = np.meshgrid(np.linspace(0, 4 * np.pi, 64), np.linspace(0, 4 * np.pi, 64))
        return np.sin(xx) * np.cos(yy) + 0.3 * np.random.default_rng(1).standard_normal(
            (64, 64))
    if name == "image_noisy":  # test_twodim.py::test_denoise2_reduces_noise
        rng = np.random.default_rng(3)
        clean = image(64, 64) - 0.1 * rng.standard_normal((64, 64))
        return clean + 0.5 * rng.standard_normal((64, 64))
    if name == "image_batch":  # test_twodim.py::test_modwt2_multilevel_roundtrip_and_batch
        return np.stack([image(seed=s) for s in range(3)])
    raise ValueError(f"unknown signal {name!r}")


def _family_input(case: "Case") -> np.ndarray:
    kind = case.data[0]
    if kind == "row":  # one row of a seeded draw
        _, seed, full, row = case.data
        return np.random.default_rng(seed).standard_normal(full)[row]
    if kind == "draws":  # the draw after ones of other shapes from one generator
        rng = np.random.default_rng(case.data[1])
        for shape in case.data[2]:
            rng.standard_normal(shape)
        return rng.standard_normal(case.shape)
    if kind == "noisy":  # tests/test_denoise_swt.py::_noisy
        _, seed, noise = case.data
        n = case.shape[-1]
        x = composite_sin(n) + np.random.default_rng(seed).normal(0, noise, n)
        return x if len(case.shape) == 1 else np.stack([x, x * 0.5])
    if kind == "composite":
        return composite_sin(case.shape[-1], noise_std=case.data[1])
    if kind == "doppler":  # tests/test_dtcwt_shrink.py: seed None is the clean signal
        _, seed, noise = case.data
        n = case.shape[-1]
        clean = doppler(n) if len(case.shape) == 1 else np.stack([doppler(n), -doppler(n)])
        if seed is None:
            return clean
        return clean + noise * np.random.default_rng(seed).standard_normal(case.shape)
    if kind == "signal":
        return _named_signal(case.data[1])
    raise ValueError(f"unknown input {case.data!r}")


@contextlib.contextmanager
def using_backend(name: str):
    """The global backend set to ``name`` for the block (the families'
    entry points without a ``backend=`` argument read it)."""
    previous = vt.get_backend()
    vt.set_backend(name)
    try:
        yield
    finally:
        vt.set_backend(previous)


@contextlib.contextmanager
def dual_tree_stages_only():
    """The port's counterpart of ``tests/test_dtcwt.py``'s monkeypatch of
    the whole-tree calls: the dual tree takes its per-level bank pairs."""
    saved = dt._dtcwt_kernel_analysis, dt._dtcwt_kernel_synthesis
    dt._dtcwt_kernel_analysis = lambda *a, **k: None
    dt._dtcwt_kernel_synthesis = lambda *a, **k: None
    try:
        yield
    finally:
        dt._dtcwt_kernel_analysis, dt._dtcwt_kernel_synthesis = saved


def _counted(fn, names):
    before = dict(mc.LAUNCHES)
    result = fn()
    return result, _launched(before, names)


def _relative(got, want) -> float:
    want_t = want if isinstance(want, (tuple, list)) else (want,)
    return _err(got, want) / max(max(float(v.abs().max()) for v in want_t), 1e-30)


def _through(out, direction, fn, names, auto_launches, serves, kernel_launches, plain, bound,
             on_card, err=_err):
    """One direction of a call under ``auto``, then under ``kernel``, held
    against the plain route's result (the thunk ``plain``) within
    ``bound``.  The router's expectations are thunks, asked under the
    backend they judge: ``auto_launches`` (a count, or a bool where the
    router fixes none), ``serves`` (whether the kernels' windows serve the
    call on this device) and ``kernel_launches``.  A CPU tensor's ``auto``
    route is the plain one (it launches nothing, which ``Outcome.route``
    holds), so there its result stands for the plain route's and the
    ``kernel`` leg, the kernels' plain versions, is held to it.  Returns the
    output under ``auto``."""
    with using_backend("auto"):
        expected = auto_launches()
        got, n = _counted(fn, names)
    out.route("auto", direction, n, expected, on_card)
    want = plain() if on_card else got
    out.bound(f"auto {direction}", err(got, want), bound)
    auto_got = got
    with using_backend("kernel"):
        can = serves()
        if expected and on_card and not can:
            out.faults.append(f"kernel {direction}: the gate admits a call the kernels "
                              "cannot serve")
        try:
            got, n = _counted(fn, names)
        except InvalidArgumentError:
            out.refused("kernel", direction, can, on_card)
            return auto_got
        if on_card and not can:
            out.faults.append(f"kernel {direction}: served a call the kernels' windows refuse")
        out.route("kernel", direction, n, kernel_launches(), on_card)
    out.bound(f"kernel {direction}", err(got, want), bound)
    return auto_got


def _plain(fn):
    with using_backend("torch"):
        return fn()


# -- the filter bank: packet trees and pairs, the dual tree, the CWT's tier --


def _packet_pairs(w, levels: int, synthesis: bool):
    lo, hi = (w.rec_lo, w.rec_hi) if synthesis else (w.dec_lo, w.dec_hi)
    return [pk._pair_dense(np.asarray(lo) * pk._INV_SQRT2, np.asarray(hi) * pk._INV_SQRT2,
                           1 << j) for j in range(levels)]


def _pair_launches(x2: torch.Tensor, w, boundary: str, spacings, synthesis: bool) -> int:
    """The bank launches of one pair a spacing under the current backend:
    the router's own decision (``packets._pair_bank``)."""
    lo, hi = (w.rec_lo, w.rec_hi) if synthesis else (w.dec_lo, w.dec_hi)
    low, high = (np.asarray(f) * pk._INV_SQRT2 for f in (lo, hi))
    return sum(pk._pair_bank(x2, low, high, s, boundary) is not None for s in spacings)


def packet_launches(x2: torch.Tensor, w, levels: int, boundary: str, synthesis: bool) -> int:
    """The bank launches ``modwpt`` (or ``imodwpt``) makes under the current
    backend: the router's own decisions, one for the whole tree where
    ``packets._tree_bank`` takes it, else one a level (``_pair_bank``)."""
    if pk._tree_bank(x2, x2.numel(), w, levels, boundary, not synthesis) is not None:
        return 1
    return _pair_launches(x2, w, boundary, [1 << j for j in range(levels)], synthesis)


def packet_serves(x2: torch.Tensor, w, levels: int, synthesis: bool) -> bool:
    """Whether ``backend='kernel'`` serves the tree: on the card the whole
    tree's bank fits (``bank_fits``), or every level's pair does."""
    if x2.device.type == "cpu":
        return True
    if levels <= pk.TREE_MAX_DEPTH and mb.bank_fits(pk._tree_dense(w, levels, not synthesis)):
        return True
    return all(mb.bank_fits(d) for d in _packet_pairs(w, levels, synthesis))


def _packets(case, x, w, out, on_card) -> None:
    levels, b = case.levels, case.boundary
    x2 = x.reshape(-1, x.shape[-1])
    plain = _plain(lambda: vt.modwpt(x, w, levels, boundary=b))
    plain_y = _plain(lambda: vt.imodwpt(plain, w, boundary=b))
    tree = _through(out, "analysis", lambda: vt.modwpt(x, w, levels, boundary=b).levels,
                    BANK_ANALYSIS, lambda: packet_launches(x2, w, levels, b, False),
                    lambda: packet_serves(x2, w, levels, False),
                    lambda: packet_launches(x2, w, levels, b, False), lambda: plain.levels, TOL_F32,
                    on_card)
    _through(out, "synthesis", lambda: vt.imodwpt(plain, w, boundary=b), BANK_SYNTHESIS,
             lambda: packet_launches(x2, w, levels, b, True),
             lambda: packet_serves(x2, w, levels, True),
             lambda: packet_launches(x2, w, levels, b, True), lambda: plain_y, TOL_F32, on_card)
    if b == "periodic":
        with using_backend("auto"):
            y = vt.imodwpt(pk.WaveletPacketTree(tuple(tree)), w, boundary=b)
        out.bound("auto round trip against x", _err(y, x), TOL_F32)
    if case.option("grad"):
        _packet_gradient(case, x, w, out, on_card)


def _packet_gradient(case, x, w, out, on_card) -> None:
    """``test_modwpt_kernel_grad_flows``: the gradient of the leaves' energy
    through the bank (its backward is one synthesis launch a forward
    launch) against the plain route's autograd, 5e-6 of its largest entry."""
    def grad():
        xg = x.clone().requires_grad_(True)
        with torch.enable_grad():
            loss = (vt.modwpt(xg, w, case.levels, boundary=case.boundary).leaves ** 2).sum()
            return torch.autograd.grad(loss, xg)[0]

    want = _plain(grad)
    x2 = x.reshape(-1, x.shape[-1])
    for backend in ("auto", "kernel"):
        with using_backend(backend):
            forward = packet_launches(x2, w, case.levels, case.boundary, False)
            g, n = _counted(grad, BANK_SYNTHESIS)
        out.route(backend, "gradient", n, forward, on_card)
        out.bound(f"{backend} gradient / largest", _relative(g, want), TOL_GRAD)


def _internal_nodes(basis) -> set:
    """The nodes above an admissible basis: each one synthesis pair of
    ``reconstruct_basis`` (at à trous spacing 2^level)."""
    return {(lvl - k, idx >> k) for lvl, idx in basis for k in range(1, lvl + 1)}


def _packet_tools(case, x, w, out, on_card) -> None:
    """``denoise_packet``, and ``best_basis`` with ``reconstruct_basis`` (a
    soft-thresholding node hook where the JAX test has one): the tree's
    launches (``packet_launches``) and one synthesis pair launch an internal
    node, each where the bank route serves it; both routes choose the plain
    tree's basis; held to the plain route within 2e-5."""
    levels, b, entry = case.levels, case.boundary, case.option("entry")
    x2 = x.reshape(-1, x.shape[-1])
    hook = None
    if entry == "node_hook":
        def hook(level, idx, c):
            return c if level < levels else c.sign() * (c.abs() - 0.15).clamp(min=0.0)

    def basis_of(tree):
        if entry == "node_hook":
            return tuple((levels, i) for i in range(1 << levels))
        return vt.best_basis(tree, cost="shannon")

    def fn():
        if entry == "denoise_packet":
            return vt.denoise_packet(x, w, levels, boundary=b)
        tree = vt.modwpt(x, w, levels, boundary=b)
        basis = basis_of(tree)
        if basis != plain_basis:
            out.faults.append(f"{vt.get_backend()}: basis {basis}, the plain tree's "
                              f"{plain_basis}")
        return vt.reconstruct_basis(tree, basis, w, boundary=b, transform_nodes=hook)

    plain_basis = None
    if entry != "denoise_packet":
        plain_basis = basis_of(_plain(lambda: vt.modwpt(x, w, levels, boundary=b)))

    def spacings():
        if entry == "denoise_packet":
            return [1 << j for j in range(levels)]
        return [1 << lvl for lvl, _ in _internal_nodes(plain_basis)]

    def launches():
        return (packet_launches(x2, w, levels, b, False)
                + _pair_launches(x2, w, b, spacings(), True))

    def serves():
        if x.device.type == "cpu":
            return True
        low, high = (np.asarray(f) * pk._INV_SQRT2 for f in (w.rec_lo, w.rec_hi))
        return packet_serves(x2, w, levels, False) and all(
            mb.bank_fits(pk._pair_dense(low, high, s)) for s in spacings())

    _through(out, entry, fn, BANK_ANALYSIS + BANK_SYNTHESIS, launches, serves, launches,
             lambda: _plain(fn), TOL_F32, on_card)


def _dt_planes(res) -> tuple:
    return (*res.highpasses, res.lowpass_a, res.lowpass_b)


def dual_tree_launches(x2: torch.Tensor, wavelet: str, levels: int, synthesis: bool,
                       stages: bool = False) -> int:
    """The bank launches ``dtcwt`` (or ``idtcwt``) makes under the current
    backend: the router's own decisions, one for the whole tree where
    ``dtcwt._whole_tree_bank`` takes it (``auto`` up to
    ``AUTO_WHOLE_TREE_MAX_WORK``), else two a level (one a tree) where
    ``_decimated_bank_ok`` takes the level."""
    if not stages and dt._whole_tree_bank(x2, x2.numel(), wavelet, levels,
                                          0.5 if synthesis else 1.0) is not None:
        return 1
    h1, g1 = dt._level1(wavelet)
    return sum(2 * dt._decimated_bank_ok(x2, *dt._stage_filters(h1, g1, level)[:2])
               for level in range(1, levels + 1))


def dual_tree_serves(x2: torch.Tensor, wavelet: str, levels: int, synthesis: bool,
                     stages: bool = False) -> bool:
    if x2.device.type == "cpu":
        return True
    if not stages and mb.bank_fits(dt._dual_tree_bank(wavelet, levels,
                                                      0.5 if synthesis else 1.0)[0]):
        return True
    h1, g1 = dt._level1(wavelet)
    return all(mb.bank_fits(dt._stage_dense(*pair)[0])
               for level in range(1, levels + 1)
               for pair in (dt._stage_filters(h1, g1, level)[0:2],
                            dt._stage_filters(h1, g1, level)[2:4]))


def _dual_tree(case, x, w, out, on_card) -> None:
    levels, name = case.levels, case.wavelet
    stages = bool(case.option("stages"))
    x2 = x.reshape(-1, x.shape[-1])
    with dual_tree_stages_only() if stages else contextlib.nullcontext():
        plain = _plain(lambda: vt.dtcwt(x, name, levels=levels))
        plain_y = _plain(lambda: vt.idtcwt(plain, name))
        res = _through(out, "analysis", lambda: vt.dtcwt(x, name, levels=levels),
                       BANK_ANALYSIS, lambda: dual_tree_launches(x2, name, levels, False, stages),
                       lambda: dual_tree_serves(x2, name, levels, False, stages),
                       lambda: dual_tree_launches(x2, name, levels, False, stages), lambda: plain,
                       TOL_DUAL_TREE, on_card, err=lambda g, v: _err(_dt_planes(g),
                                                                     _dt_planes(v)))
        _through(out, "synthesis", lambda: vt.idtcwt(plain, name), BANK_SYNTHESIS,
                 lambda: dual_tree_launches(x2, name, levels, True, stages),
                 lambda: dual_tree_serves(x2, name, levels, True, stages),
                 lambda: dual_tree_launches(x2, name, levels, True, stages), lambda: plain_y,
                 TOL_DUAL_TREE, on_card)
        with using_backend("auto"):
            y = vt.idtcwt(res, name)
    out.bound("auto round trip against x", _err(y, x), TOL_DUAL_TREE)


def _dual_tree_denoise(case, x, w, out, on_card) -> None:
    """``dtcwt_denoise``: one dual tree each way, so the router's count is
    the analysis's and the synthesis's launches together."""
    levels, name = case.levels, case.wavelet
    sigma = case.option("noise_sigma")
    x2 = x.reshape(-1, x.shape[-1])

    def count():
        return (dual_tree_launches(x2, name, levels, False)
                + dual_tree_launches(x2, name, levels, True))

    def serves():
        return (dual_tree_serves(x2, name, levels, False)
                and dual_tree_serves(x2, name, levels, True))

    def fn():
        return vt.dtcwt_denoise(x, name, levels=levels, noise_sigma=sigma)

    _through(out, "denoise", fn, BANK_ANALYSIS + BANK_SYNTHESIS, count, serves, count,
             lambda: _plain(fn), TOL_DUAL_TREE, on_card)


def cwt_launches(device, scales) -> int:
    """The bank launches of a periodic float32 ``cwt`` under the current
    backend: one a chunk of the leading scales ``_kernel_direct_split``
    gives the kernel-direct tier."""
    w = cwt_mod._resolve_continuous("morl")
    n_small = cwt_mod._kernel_direct_split(device, w, tuple(scales), "periodic",
                                           torch.float32)
    return len(cwt_mod._kernel_direct_chunks(w, tuple(scales[:n_small]))) if n_small else 0


def cwt_serves(device, scales) -> bool:
    if torch.device(device).type == "cpu":
        return True
    w = cwt_mod._resolve_continuous("morl")
    n_small = cwt_mod._kernel_direct_split(device, w, tuple(scales), "periodic",
                                           torch.float32)
    return not n_small or all(mb.bank_fits(dense)
               for _, dense in cwt_mod._kernel_direct_chunks(w, tuple(scales[:n_small])))


def _cwt(case, x, w, out, on_card) -> None:
    """The kernel-direct tier: 2e-5 of the largest coefficient against the
    FFT path (the JAX tests' bound), or the JAX test's absolute bound."""
    scales = case.option("scales")
    absolute = case.option("abs_bound")

    def fn():
        return vt.cwt(x, scales, "morl", boundary="periodic").coeffs

    def err(g, v):
        return _err(g, v) if absolute else _relative(g, v)

    _through(out, "coefficients", fn, BANK_ANALYSIS, lambda: cwt_launches(x.device, scales),
             lambda: cwt_serves(x.device, scales), lambda: cwt_launches(x.device, scales),
             lambda: _plain(fn), absolute or TOL_F32, on_card, err=err)


# -- the 2-D pair -------------------------------------------------------------------


def _planes2(res) -> tuple:
    return (*(p for trip in res.details for p in trip), res.approx)


def _twod(case, x, w, out, on_card) -> None:
    """The 2-D pair: ``levels`` launches each way where
    ``modwt2_kernel_eligible`` admits the call, ``kernel`` refused exactly
    where ``kernel_refusal`` says.  The synthesis takes the plain route's
    planes (on a CPU tensor the ``auto`` analysis's, which are those)."""
    levels, b = case.levels, case.boundary

    def launches():
        return levels if k2.modwt2_kernel_eligible(x, w, levels, b) else 0

    def serves():
        return x.device.type == "cpu" or k2.kernel_refusal(x, w, levels, b) is None

    def forced():
        return levels

    def result(planes):
        details = tuple(tuple(planes[3 * j:3 * j + 3]) for j in range(levels))
        return vt.MultiLevelMODWT2Result(details, planes[-1])

    plain = None
    if on_card:
        plain = vt.modwt2_multilevel(x, w, levels=levels, boundary=b, backend="torch")
    res = _through(out, "analysis",
                   lambda: _planes2(vt.modwt2_multilevel(x, w, levels=levels, boundary=b)),
                   ANALYSIS_2D, launches, serves, forced, lambda: _planes2(plain), TOL_F32,
                   on_card)
    if plain is None:
        plain = result(res)
    y = _through(out, "synthesis", lambda: vt.imodwt2_multilevel(plain, w, boundary=b),
                 SYNTHESIS_2D, launches, serves, forced,
                 lambda: vt.imodwt2_multilevel(plain, w, boundary=b, backend="torch"),
                 TOL_2D_ROUND_TRIP, on_card)
    if b == "periodic":
        if on_card:  # the round trip of the auto route's own planes
            with using_backend("auto"):
                y = vt.imodwt2_multilevel(result(res), w, boundary=b)
        out.bound("auto round trip against x", _err(y, x), TOL_2D_ROUND_TRIP)


def _twod_denoise(case, x, w, out, on_card) -> None:
    """``denoise2`` (and ``swt2_denoise``, the same call): the 2-D pair
    each way where the gate admits it."""
    levels, b = case.levels, case.boundary

    def fn():
        return vt.denoise2(x, w, levels=levels, boundary=b)

    _through(out, "denoise", fn, ANALYSIS_2D + SYNTHESIS_2D,
             lambda: 2 * levels if k2.modwt2_kernel_eligible(x, w, levels, b) else 0,
             lambda: x.device.type == "cpu" or k2.kernel_refusal(x, w, levels, b) is None,
             lambda: 2 * levels, lambda: _plain(fn), TOL_2D_ROUND_TRIP, on_card)


# -- the symmetric pair, the SWT and the denoiser ----------------------------------------


def _fused_symmetric(case, x, w, out, on_card) -> None:
    """The public pair (``_pair``), then ``fused_analysis`` /
    ``fused_synthesis``, the kernel entry points: on the card each is
    served exactly where ``route_fits`` admits its direction, else refused."""
    _pair(case, x, w, out, on_card)
    levels, n = case.levels, x.shape[-1]
    plain = vt.modwt_multilevel(x, w, levels=levels, boundary="symmetric", backend="torch")
    plain_y = vt.imodwt_multilevel(plain, w, boundary="symmetric", backend="torch")
    def analysis():
        details, approx = vt.fused_analysis(x, w, levels=levels, boundary="symmetric")
        return (*details, approx)

    for direction, names, fn, want in (
            ("analysis", ANALYSIS, analysis, _planes(plain)),
            ("synthesis", SYNTHESIS,
             lambda: vt.fused_synthesis(plain.details, plain.approx, w, boundary="symmetric"),
             plain_y)):
        serves = not on_card or ms.route_fits(w, levels, n, direction == "synthesis")
        try:
            got, launched = _counted(fn, names)
        except InvalidArgumentError:
            out.refused("fused", direction, serves, on_card)
            continue
        out.route("fused", direction, launched, serves, on_card)
        out.bound(f"fused {direction}", _err(got, want), TOL_SYMMETRIC)


def _symmetric_gradient(case, x, w, out, on_card) -> None:
    """``test_symmetric_gradients_match_jnp``: the gradients through
    ``fused_analysis`` and ``fused_synthesis`` (the analysis kernel's
    backward is the synthesis kernel, the symmetric synthesis's its adjoint)
    against the plain route's autograd, 5e-6 of the largest entry; and
    through the public analysis under ``auto``."""
    levels, n = case.levels, x.shape[-1]
    weights = torch.arange(n, dtype=x.dtype, device=x.device)

    def analysis_grad(call):
        xg = x.clone().requires_grad_(True)
        with torch.enable_grad():
            details, approx = call(xg)
            loss = sum((p ** 2).sum() for p in details) + 0.5 * (approx ** 2).sum()
            return torch.autograd.grad(loss, xg)[0]

    def public(y):
        res = vt.modwt_multilevel(y, w, levels=levels, boundary="symmetric")
        return res.details, res.approx

    def fused(y):
        return vt.fused_analysis(y, w, levels=levels, boundary="symmetric")

    want = _plain(lambda: analysis_grad(public))
    with using_backend("auto"):
        eligible = ml._kernel_eligible(x, w, levels, "symmetric")
        g, launched = _counted(lambda: analysis_grad(public), ANALYSIS)
    out.route("auto", "analysis gradient", launched, eligible, on_card)
    out.bound("auto analysis gradient / largest", _relative(g, want), TOL_GRAD)
    serves = not on_card or ms.route_fits(w, levels, n, False)
    try:
        g, launched = _counted(lambda: analysis_grad(fused), ("modwt_synthesis",))
    except InvalidArgumentError:
        out.refused("fused", "analysis gradient", serves, on_card)
    else:
        out.route("fused", "analysis gradient", launched, serves, on_card)
        out.bound("fused analysis gradient / largest", _relative(g, want), TOL_GRAD)

    plain = vt.modwt_multilevel(x, w, levels=levels, boundary="symmetric", backend="torch")

    def synthesis_grads(call):
        planes = [p.clone().requires_grad_(True) for p in _planes(plain)]
        with torch.enable_grad():
            y = call(tuple(planes[:-1]), planes[-1])
            return torch.autograd.grad((y ** 2 * weights).sum(), planes)

    want = _plain(lambda: synthesis_grads(lambda d, a: vt.imodwt_multilevel(
        vt.MultiLevelMODWTResult(d, a), w, boundary="symmetric")))
    serves = not on_card or ms.route_fits(w, levels, n, True)
    try:
        g, launched = _counted(lambda: synthesis_grads(
            lambda d, a: vt.fused_synthesis(d, a, w, boundary="symmetric")),
            ("modwt_symmetric_adjoint",))
    except InvalidArgumentError:
        out.refused("fused", "synthesis gradient", serves, on_card)
        return
    out.route("fused", "synthesis gradient", launched, serves, on_card)
    out.bound("fused synthesis gradient / largest", _relative(g, want), TOL_GRAD)


def _route_thresholds_held(x, w, levels, b, method, mode, fused, got, backend, out) -> None:
    """A denoise whose threshold a kernel's rounding may move (SURE's arg
    min, a hard cut), held to the plain route on the route's own
    thresholds: the fused route against :func:`plain_three_call` on the
    thresholds it computes (``denoiser.fused_denoise_thresholds``); the
    3-call route by its planes against the plain analysis, and by its output
    against the plain inverse of those planes shrunk by the denoiser's own
    rule (``denoiser.threshold_coeffs``)."""
    if fused:
        ths = denoiser.fused_denoise_thresholds(x, w, levels, method, b)
        _, want = plain_three_call(x, w, levels, b, mode, ths)
        out.bound(f"{backend} denoise on its thresholds", _err(got, want), TOL_F32)
        return
    planes = vt.modwt_multilevel(x, w, levels=levels, boundary=b)
    plain = vt.modwt_multilevel(x, w, levels=levels, boundary=b, backend="torch")
    out.bound(f"{backend} denoise planes", _err(_planes(planes), _planes(plain)), TOL_F32)
    shrunk = denoiser.threshold_coeffs(planes, mad_sigma(planes.details[0]), method=method,
                                       mode=mode)
    want = vt.imodwt_multilevel(shrunk, w, boundary=b, backend="torch")
    out.bound(f"{backend} denoise on its planes", _err(got, want), TOL_F32)


def _denoise_method(case, x, w, out, on_card) -> None:
    """``denoise_multilevel`` with its method and mode (or ``swt_denoise``):
    the fused denoise kernel where ``denoiser.fused_denoise_serves`` takes
    the call, else the analysis and synthesis where ``_kernel_eligible``
    admits each.  A soft rule whose threshold is a smooth function of the
    planes is held to the plain route (2e-5); SURE's threshold is an arg min
    and a hard cut can flip, so those are held to the plain route on the
    route's own thresholds (:func:`_route_thresholds_held`, 2e-5), and to
    the JAX test's own check, a lower error against the clean signal than
    the noisy input's."""
    levels, b = case.levels, case.boundary
    method, mode = case.option("method", "universal"), case.option("mode", "soft")
    swt = case.option("entry") == "swt_denoise"

    def fn():
        if swt:
            return vt.swt_denoise(x, w, levels=levels, mode=mode, boundary=b)
        return vt.denoise_multilevel(x, w, levels=levels, method=method, mode=mode,
                                     boundary=b)

    def routes(backend):
        """Under ``auto`` the gates; under ``kernel`` the fused route where
        its gate admits the call, else the forced pair wherever it serves."""
        fused = not swt and denoiser.fused_denoise_serves(x, w, levels, method, mode, b)
        if backend == "auto":
            return {"denoise": fused,
                    "analysis": not fused and ml._kernel_eligible(x, w, levels, b),
                    "synthesis": not fused and ml._kernel_eligible(x, w, levels, b, True)}
        return {"denoise": fused,
                "analysis": not fused and kernel_serves(x, w, levels, b, False),
                "synthesis": not fused and kernel_serves(x, w, levels, b, True)}

    smooth = mode == "soft" and method != "sure"
    want = _plain(fn) if smooth else None
    clean = torch.from_numpy(composite_sin(x.shape[-1])).to(x.device)
    noisy_mse = float(((x.double() - clean) ** 2).mean())
    for backend in ("auto", "kernel"):
        with using_backend(backend):
            expected = routes(backend)
            serves = not on_card or expected["denoise"] or (
                kernel_serves(x, w, levels, b, False) and kernel_serves(x, w, levels, b, True))
            befores = dict(mc.LAUNCHES)
            try:
                got = fn()
            except InvalidArgumentError:
                out.refused(backend, "denoise", serves, on_card)
                continue
            for direction, names in (("denoise", DENOISE), ("analysis", ANALYSIS),
                                     ("synthesis", SYNTHESIS)):
                out.route(backend, direction, _launched(befores, names), expected[direction],
                          on_card)
            if not smooth:
                _route_thresholds_held(x, w, levels, b, method, mode, expected["denoise"],
                                       got, backend, out)
        if smooth:
            out.bound(f"{backend} denoise", _err(got, want), TOL_F32)
        else:
            mse = float(((got.double() - clean) ** 2).mean())
            out.bound(f"{backend} denoised error / noisy error", mse / noisy_mse, 1.0)


def _batch_facade(case, x, w, out, on_card) -> None:
    """BASELINE config #4: ``modwt_multilevel_sharded_batch`` on a one-device
    mesh, whose rows route as ``modwt_multilevel`` does."""
    from vectorwave_tpu_torch import parallel

    mesh = parallel.make_mesh({"data": 1}, devices=[x.device])
    levels, b = case.levels, case.boundary

    def fn():
        return _planes(parallel.modwt_multilevel_sharded_batch(x, w, levels=levels, mesh=mesh,
                                                               axis="data", boundary=b))

    _through(out, "analysis", fn, ANALYSIS, lambda: ml._kernel_eligible(x, w, levels, b),
             lambda: kernel_serves(x, w, levels, b, False), lambda: True, lambda: _plain(fn),
             TOL_F32, on_card)


def family_cases() -> list[Case]:
    """Phase 2c's cases: every kernel-reaching case of the other families'
    mirrors, at the JAX tests' shapes and seeds."""
    out = []
    bk = "test_bank_kernel.py"
    for b in ("periodic", "zero"):
        out.append(Case(f"modwpt db4 J=3 {b} 2x2048", "packets",
                        f"{bk}::test_modwpt_kernel_matches_jnp", "db4", 3, (2, 2048), b))
    out.append(Case("imodwpt sym8 J=3 2048", "packets", f"{bk}::test_imodwpt_kernel_roundtrip",
                    "sym8", 3, (2048,), data=("normal", 1)))
    out.append(Case("modwpt gradient db4 J=2 2048", "packets",
                    f"{bk}::test_modwpt_kernel_grad_flows", "db4", 2, (2048,),
                    data=("normal", 2), options=(("grad", True),)))
    out.append(Case("dtcwt sym8 J=4 2x2048", "dual_tree", f"{bk}::test_dtcwt_kernel_matches_jnp",
                    "sym8", 4, (2, 2048), data=("normal", 3)))
    out.append(Case("idtcwt sym8 J=3 1x2048", "dual_tree", f"{bk}::test_idtcwt_kernel_roundtrip",
                    "sym8", 3, (1, 2048), data=("normal", 4)))
    out.append(Case("dtcwt short sym8 J=2 256", "dual_tree",
                    f"{bk}::test_dtcwt_short_signal_falls_back", "sym8", 2, (256,),
                    data=("normal", 5)))

    pt = "test_packets.py"
    for name in ("haar", "db4", "sym5", "coif3", "bior4.4"):
        out.append(Case(f"modwpt {name} J=3 256 (float32)", "packets",
                        f"{pt}::test_perfect_reconstruction_periodic", name, 3, (256,)))
    out.append(Case("modwpt db6 J=4 256 (float32)", "packets",
                    f"{pt}::test_energy_preserved_every_depth", "db6", 4, (256,),
                    data=("normal", 3)))
    out.append(Case("modwpt sym4 J=3 4x256 (float32)", "packets", f"{pt}::test_batch_matches_single",
                    "sym4", 3, (4, 256), data=("normal", 9)))
    out.append(Case("best basis sym6 J=3 256 (float32)", "packet_tools",
                    f"{pt}::test_reconstruct_from_best_basis_exact", "sym6", 3, (256,),
                    data=("normal", 5), options=(("entry", "best_basis"),)))
    out.append(Case("node hook sym8 J=3 512 (float32)", "packet_tools",
                    f"{pt}::test_reconstruct_basis_node_hook_denoises", "sym8", 3, (512,),
                    data=("signal", "packet_node_hook"), options=(("entry", "node_hook"),)))
    for label, test, name, levels, n, signal in (
            ("high-band tone sym8 J=4 2048", "test_denoise_packet_beats_modwt_on_highband_tone",
             "sym8", 4, 2048, "packet_hf_tone"),
            ("smooth sym8 J=4 2048", "test_denoise_packet_smooth_signal", "sym8", 4, 2048,
             "packet_smooth"),
            ("noiseless db4 J=3 1024", "test_denoise_packet_noiseless_near_identity", "db4", 3,
             1024, "packet_noiseless")):
        out.append(Case(f"denoise_packet {label} (float32)", "packet_tools", f"{pt}::{test}",
                        name, levels, (n,), data=("signal", signal),
                        options=(("entry", "denoise_packet"),)))

    dc = "test_dtcwt.py"
    for levels in (1, 3, 5):
        for shape in ((512,), (3, 512)):
            out.append(Case(f"dtcwt sym8 J={levels} {'x'.join(map(str, shape))}", "dual_tree",
                            f"{dc}::test_perfect_reconstruction", "sym8", levels, shape))
    out.append(Case("dtcwt burst sym8 J=5 1024", "dual_tree",
                    f"{dc}::test_coefficient_delay_aligns_features", "sym8", 5, (1024,),
                    data=("signal", "burst")))
    out.append(Case("dtcwt per-level pairs sym8 J=3 2x4096", "dual_tree",
                    f"{dc}::test_decimated_bank_cascade_matches_jnp", "sym8", 3, (2, 4096),
                    data=("normal", 9), options=(("stages", True),)))

    ck = "test_cwt_kernel_direct.py"
    geom = tuple(float(s) for s in np.geomspace(2.0, 64.0, 8))
    for label, test, shape, scales, data, extra in (
            ("geomspace 2-64 x8 16384", "test_hybrid_matches_fft_path", (16384,), geom,
             ("normal", 0), ()),
            ("scales 4, 16, 2048 16384", "test_hybrid_split_mixed_scales", (16384,),
             (4.0, 16.0, 2048.0), ("normal", 1), ()),
            ("scales 4, 16 4x8192", "test_batched_rows_chunk_under_bank_budget", (4, 8192),
             (4.0, 16.0), ("normal", 3), ()),
            ("scales 4, 16 zeros 16384", "test_single_row_over_budget_stands_down", (16384,),
             (4.0, 16.0), ("zeros", 0), ()),
            ("descending scales 64, 8, 2 16384", "test_unsorted_scales_keep_fft_path",
             (16384,), (64.0, 8.0, 2.0), ("normal", 2), (("abs_bound", 1e-5),))):
        out.append(Case(f"cwt morl {label}", "cwt", f"{ck}::{test}", "morl", 0, shape,
                        data=data, options=(("scales", scales),) + extra))

    ds = "test_dtcwt_shrink.py"
    out.append(Case("dtcwt_denoise sym8 J=6 2048", "dual_tree_denoise",
                    f"{ds}::test_1d_beats_noisy_and_universal_modwt", "sym8", 6, (2048,),
                    data=("doppler", 0, 0.35)))
    out.append(Case("dtcwt_denoise clean sym8 J=5 1024", "dual_tree_denoise",
                    f"{ds}::test_clean_signal_nearly_untouched", "sym8", 5, (1024,),
                    data=("doppler", None, 0.0)))
    out.append(Case("dtcwt_denoise sigma 0.3 sym8 J=5 2x1024", "dual_tree_denoise",
                    f"{ds}::test_batch_and_explicit_sigma", "sym8", 5, (2, 1024),
                    data=("doppler", 2, 0.3), options=(("noise_sigma", 0.3),)))
    out.append(Case("denoise2 disk sym8 J=4 128x128", "twod_denoise",
                    f"{ds}::test_2d_beats_separable_denoise", "sym8", 4, (128, 128),
                    data=("signal", "disk")))

    mp = "test_modwt2_pallas.py"
    for name, levels in (("db4", 3), ("haar", 4), ("sym8", 2)):
        for b in ("periodic", "zero"):
            out.append(Case(f"2-D {name} J={levels} {b} 2x256x256", "twod",
                            f"{mp}::test_2d_pallas_analysis_matches_xla_path", name, levels,
                            (2, 256, 256), b))
    for name, levels, hw in (("db4", 5, 512), ("sym8", 4, 256), ("db4", 6, 512)):
        for b in ("periodic", "zero"):
            out.append(Case(f"2-D deep span {name} J={levels} {b} {hw}x{hw}", "twod",
                            f"{mp}::test_2d_pallas_deep_span_matches_xla_path", name, levels,
                            (1, hw, hw), b, ("normal", 3)))
    for b in ("periodic", "zero"):
        out.append(Case(f"2-D deep round trip db4 J=5 {b} 512x512", "twod",
                        f"{mp}::test_2d_pallas_deep_span_roundtrip", "db4", 5, (1, 512, 512), b,
                        ("normal", 4)))
        out.append(Case(f"2-D round trip db4 J=3 {b} 256x256", "twod",
                        f"{mp}::test_2d_pallas_roundtrip", "db4", 3, (1, 256, 256), b,
                        ("normal", 1)))
    for name, levels in (("db4", 3), ("sym8", 2)):
        out.append(Case(f"2-D symmetric {name} J={levels} 2x256x256", "twod",
                        f"{mp}::test_2d_symmetric_analysis_fast_path", name, levels,
                        (2, 256, 256), "symmetric", ("normal", 5)))
        out.append(Case(f"2-D symmetric inverse {name} J={levels} 2x256x256", "twod",
                        f"{mp}::test_2d_symmetric_inverse_fast_path", name, levels,
                        (2, 256, 256), "symmetric", ("normal", 6)))
    out.append(Case("2-D public db4 J=2 256x256", "twod",
                    f"{mp}::test_public_routing_forced_pallas_matches_jnp", "db4", 2, (256, 256),
                    data=("normal", 2)))
    for name, levels in (("db6", 5), ("sym6", 5), ("coif2", 4), ("db8", 5)):
        for b in ("periodic", "zero"):
            out.append(Case(f"2-D family {name} J={levels} {b} 512x512", "twod",
                            f"{mp}::test_2d_deep_span_family_sweep", name, levels, (1, 512, 512),
                            b, ("normal", 11)))
    for b in ("periodic", "zero"):
        out.append(Case(f"2-D sym8 J=6 {b} 1024x512", "twod",
                        f"{mp}::test_2d_cascade_tier_sym8_j6_newly_eligible", "sym8", 6,
                        (1, 1024, 512), b, ("normal", 12)))
        out.append(Case(f"2-D db8 J=5 {b} 512x512", "twod",
                        f"{mp}::test_2d_cascade_synthesis_roundtrip_db8_j5", "db8", 5,
                        (1, 512, 512), b, ("normal", 13)))

    mf = "test_modwt2_fast.py"
    for h, wd, name, levels, b in ((256, 128, "db4", 3, "periodic"),
                                   (128, 256, "sym8", 2, "zero"),
                                   (128, 128, "haar", 4, "periodic"),
                                   (256, 256, "bior2.2", 2, "periodic")):
        out.append(Case(f"2-D fast {name} J={levels} {b} 2x{h}x{wd}", "twod",
                        f"{mf}::test_fast2_matches_jnp", name, levels, (2, h, wd), b))
    out.append(Case("2-D unaligned db4 J=2 100x96", "twod",
                    f"{mf}::test_fast2_ineligible_shapes_fall_back", "db4", 2, (100, 96),
                    data=("normal", 1)))
    out.append(Case("2-D symmetric db4 J=2 128x128", "twod",
                    f"{mf}::test_fast2_ineligible_shapes_fall_back", "db4", 2, (128, 128),
                    "symmetric", ("draws", 1, ((100, 96),))))
    out.append(Case("2-D haar J=3 128x128", "twod", f"{mf}::test_fast2_energy_and_dtype_preserved",
                    "haar", 3, (128, 128), data=("normal", 2)))

    tw = "test_twodim.py"
    out.append(Case("2-D sym4 J=3 3x64x96 (float32)", "twod",
                    f"{tw}::test_modwt2_multilevel_roundtrip_and_batch", "sym4", 3, (3, 64, 96),
                    data=("signal", "image_batch")))
    out.append(Case("denoise2 sym4 J=3 64x64 (float32)", "twod_denoise",
                    f"{tw}::test_denoise2_reduces_noise", "sym4", 3, (64, 64),
                    data=("signal", "image_noisy")))
    sw = "test_swt2.py"
    out.append(Case("swt2 db4 J=3 64x96", "twod", f"{sw}::test_swt2_roundtrip_periodic", "db4", 3,
                    (64, 96)))
    out.append(Case("swt2 sym4 J=2 zero 64x96", "twod", f"{sw}::test_swt2_equals_modwt2", "sym4",
                    2, (64, 96), "zero"))
    out.append(Case("extract_level2 haar J=2 64x96", "twod",
                    f"{sw}::test_extract_level2_bands_sum", "haar", 2, (64, 96)))
    out.append(Case("swt2_denoise db4 J=3 64x64", "twod_denoise",
                    f"{sw}::test_swt2_denoise_reduces_noise", "db4", 3, (64, 64),
                    data=("signal", "swt2_noisy")))

    sk = "test_symmetric_kernel.py"
    for name, levels in (("db4", 3), ("sym8", 2), ("haar", 4), ("bior2.2", 3)):
        out.append(Case(f"symmetric pair {name} J={levels} 2x2048", "pair",
                        f"{sk}::test_symmetric_kernel_parity_both_directions", name, levels,
                        (2, 2048), "symmetric", options=(("bound", TOL_SYMMETRIC),)))
    out.append(Case("symmetric fused API db4 J=3 200", "fused_symmetric",
                    f"{sk}::test_symmetric_fused_api_routes_and_short_fallback", "db4", 3,
                    (200,), "symmetric", ("normal", 1), options=(("bound", TOL_SYMMETRIC),)))
    out.append(Case("symmetric gradients db4 J=3 1x2048", "symmetric_gradient",
                    f"{sk}::test_symmetric_gradients_match_jnp", "db4", 3, (1, 2048),
                    "symmetric", ("normal", 2)))

    dn = "test_denoise_swt.py"
    for method in ("universal", "sure", "minimax", "bayes"):
        for mode in ("soft", "hard"):
            out.append(Case(f"denoise_multilevel {method} {mode} db4 J=4 512 (float32)",
                            "denoise_method", f"{dn}::test_denoise_multilevel_improves_snr",
                            "db4", 4, (512,), data=("noisy", 3, 0.5),
                            options=(("method", method), ("mode", mode))))
    out.append(Case("swt sym8 J=4 512 (float32)", "pair", f"{dn}::test_swt_roundtrip_and_threshold",
                    "sym8", 4, (512,), data=("noisy", 3, 1.0)))
    out.append(Case("swt_denoise db4 J=4 512 (float32)", "denoise_method",
                    f"{dn}::test_swt_denoise_convenience", "db4", 4, (512,),
                    data=("noisy", 3, 1.0), options=(("entry", "swt_denoise"),)))
    out.append(Case("mra db4 J=3 256 (float32)", "pair", f"{dn}::test_mra_bands_sum_to_signal",
                    "db4", 3, (256,), data=("composite", 0.1)))
    out.append(Case("batched denoise db4 J=3 2x512 (float32)", "denoise_method",
                    f"{dn}::test_batched_denoise", "db4", 3, (2, 512), data=("noisy", 3, 0.5)))

    ex = "test_exact_mode.py"
    for name, levels in (("db4", 4), ("sym8", 3)):
        out.append(Case(f"exact {name} J={levels} 2x1024", "exact",
                        f"{ex}::test_exact_roundtrip_below_1e10", name, levels, (2, 1024),
                        data=("normal", 3), options=(("precision", "exact"),)))
        out.append(Case(f"exact full profile {name} J={levels} 2x1024", "exact",
                        f"{ex}::test_exact_roundtrip_below_1e10", name, levels, (2, 1024),
                        data=("normal", 3), options=(("tolerance", 1e-12),)))
    out.append(Case("exact analysis db4 J=3 1x512", "exact",
                    f"{ex}::test_exact_analysis_matches_f64_cascade", "db4", 3, (1, 512),
                    data=("normal", 4), options=(("precision", "exact"),)))
    out.append(Case("exact zero db4 J=2 1x512", "exact",
                    f"{ex}::test_exact_synthesis_inverts_exact_analysis_zero_boundary", "db4", 2,
                    (1, 512), "zero", ("normal", 5), options=(("precision", "exact"),)))
    out.append(Case("exact public db4 J=4 2x2048", "exact",
                    f"{ex}::test_public_exact_api_roundtrip_below_1e10", "db4", 4, (2, 2048),
                    data=("normal", 11), options=(("precision", "exact"),)))
    out.append(Case("exact public 1-D sym8 J=3 2048", "exact",
                    f"{ex}::test_public_exact_api_roundtrip_below_1e10", "sym8", 3, (2048,),
                    data=("row", 11, (2, 2048), 0), options=(("precision", "exact"),)))

    out.append(Case("config #4 batch facade db4 J=4 256x16384", "batch",
                    "test_baseline_configs.py::test_config4_batch_256x16k_sharded", "db4", 4,
                    (256, 16384), data=("normal", 1)))
    return out


RUNNERS = {"pair": _pair, "exact": _exact, "denoise": _denoise, "roundtrip": _roundtrip,
           "nrmse": _nrmse, "packets": _packets, "packet_tools": _packet_tools,
           "dual_tree": _dual_tree,
           "dual_tree_denoise": _dual_tree_denoise, "cwt": _cwt, "twod": _twod,
           "twod_denoise": _twod_denoise, "fused_symmetric": _fused_symmetric,
           "symmetric_gradient": _symmetric_gradient, "denoise_method": _denoise_method,
           "batch": _batch_facade}


def run_case(case: Case, device) -> Outcome:
    """Run one case on ``device`` (module docstring); never raises for a
    fault of the port: the faults are in the outcome."""
    x = torch.from_numpy(case_input(case)).to(device)
    w = vt.wavelet(case.wavelet)
    out = Outcome(case)
    with torch.no_grad():
        RUNNERS[case.kind](case, x, w, out, x.device.type == "cuda")
    return out


#: phase 2c's kinds by family: the filter bank, the 2-D pair, and the rest
#: (the symmetric pair, the SWT and the denoiser, the exact tier, config #4)
FAMILY_KINDS = {"bank": ("packets", "packet_tools", "dual_tree", "dual_tree_denoise", "cwt"),
                "2-D": ("twod", "twod_denoise"),
                "symmetric and exact": ("pair", "fused_symmetric", "symmetric_gradient",
                                        "denoise_method", "exact", "batch")}


def family_labels(family: str) -> list[str]:
    """The labels of ``family``'s phase 2c cases (a key of
    :data:`FAMILY_KINDS`)."""
    return [c.label for c in family_cases() if c.kind in FAMILY_KINDS[family]]


def cpu_problems(label: str) -> list[str]:
    """Run the phase 2c case ``label`` on CPU tensors and return what is
    wrong: its faults, any route that is not the plain one (a CPU tensor
    launches nothing and ``backend='kernel'`` refuses nothing), and any
    launch counted."""
    case = next(c for c in family_cases() if c.label == label)
    before = dict(mc.LAUNCHES)
    out = run_case(case, "cpu")
    problems = list(out.faults)
    problems += [f"{k}: {v}" for k, v in out.routes.items() if v != "plain"]
    if mc.LAUNCHES != before:
        problems.append("a launch was counted")
    return problems


def summary(outcomes: list[Outcome]) -> dict:
    """Cases, cases on a kernel and on the plain route under ``auto``,
    refusals under ``kernel``, and the worst error against each bound."""
    auto = [o for o in outcomes if any(k.startswith("auto") for k in o.routes)]
    on_kernel = sum(any(v.startswith("kernel") for k, v in o.routes.items()
                        if k.startswith("auto")) for o in auto)
    worst: dict[float, float] = {}
    for o in outcomes:
        for _, err, bound in o.errors:
            worst[bound] = max(worst.get(bound, 0.0), err)
    return {
        "cases": len(outcomes),
        "auto_kernel": on_kernel,
        "auto_plain": len(auto) - on_kernel,
        "kernel_only": len(outcomes) - len(auto),
        "kernel_refused": sum(any(v == "raised" for v in o.routes.values()) for o in outcomes),
        "worst": {f"{b:g}": e for b, e in sorted(worst.items())},
        "faults": sum(len(o.faults) for o in outcomes),
    }
