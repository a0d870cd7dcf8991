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

:func:`tier_cases` are the streaming and parallel tiers' cases, from
``tests/test_torch_streaming_mirror.py`` and
``tests/test_torch_parallel_mirror.py``: block streams and the streaming
denoiser on their kernel tiers, the sliding window and the ingest, the
tiled pair, the host x chip facades, the batch facade, the sharded exact
tier and the 2-D tiling's gathered image.  ``chip_smoke.py`` runs them in
its phase 2d, the same way, each direction's launches held to the tier's
own router by count (``stream.use_stream_kernel`` and ``resolve_tier`` a
block or a step; ``tiled._resolve_tiled_backend``, one launch a device;
the exact launch plan, ``exact_launches``; ``modwt2_kernel_eligible`` for
the gathered image; ``_kernel_eligible`` a window or a drain).  The tiled
kernel route refuses the symmetric boundary on every device by design;
that refusal is held to its error code.  A streaming denoiser class is
held to the plain tier within the JAX tests' bound between the tiers,
5e-5.

:func:`analysis_cases` are the CWT family's cases, from
``tests/test_torch_cwt_mirror.py`` and ``tests/test_torch_analysis_mirror.py``:
the CWT's periodic inverses (``icwt``, the band reconstructions) on a real
wavelet, the wavelet variance, covariance and correlation, the variance
stream on the kernel-tier step, and the financial analyzers that reach a
kernel (the Sharpe ratio and the market view through the fused denoise, the
indicators through the cascade).  ``chip_smoke.py`` runs them in its phase
2e, the same way, each direction's launches held to the router by count
(``cwt._kernel_direct_split`` and ``_kernel_direct_chunks``; one cascade
analysis a transform by ``_kernel_eligible``; ``stream.use_stream_kernel``
a block; ``denoiser.fused_denoise_serves``) and to its mode.  Under
``auto`` the CWT's 60 scales pass ``AUTO_KERNEL_DIRECT_MAX_HALF`` and take
the FFT path, so that side launches nothing; ``kernel`` sends all 60 to
the bank, the 9 whose support wraps past N among them (the bank and the
FFT path both sum the wrapped taps).

:func:`decimated_cases` are the 1-D analysis modules' cases, from
``tests/test_torch_decimated_mirror.py``: ``hurst_exponent`` (one cascade
analysis, through the wavelet variance), ``denoise_block`` (the cascade
pair around a plain block shrinkage) and ``denoise_multilevel`` (the fused
denoise for the universal rule, the cascade pair for FDR).
``chip_smoke.py`` runs them in its phase 2f, the same way, each
direction's launches held to ``_kernel_eligible`` or
``denoiser.fused_denoise_serves`` by count.  The block denoise is held to
the plain route within 1e-4 of its largest value (:data:`TOL_BLOCK`).

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
import io
import json
import math
import pathlib
from typing import NamedTuple

import numpy as np
import torch

import vectorwave_tpu_torch as vt
from vectorwave_tpu_torch.denoise import denoiser
from vectorwave_tpu_torch.errors import ErrorCode, InvalidArgumentError
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
#: the streaming denoiser's kernel tier against its plain tier (the JAX
#: package's own bound between them, tests/test_streaming_denoise_kernel.py)
TOL_STREAM_TIERS = 5e-5
#: ``calculate_wavelet_indicators``' momentum (``np.gradient`` of a float32
#: approximation of prices near 100) between two float32 routes: each route
#: alone is 1.6e-5 of its largest value off float64 at the JAX test's draw
TOL_MOMENTUM = 5e-5
EXACT_RT_RMSE = 1e-10
NRMSE_HEADROOM = 1.10
BASELINES = pathlib.Path(__file__).resolve().parent.parent / "tests" / "baselines" / \
    "symmetric_nrmse_baseline.json"

#: tests/test_property_sweep.py's draw
SWEEP_WAVELETS = ("haar", "db2", "db4", "db7", "sym5", "coif2", "bior2.4", "rbio3.1")
SWEEP_BOUNDARIES = ("periodic", "zero", "symmetric")

#: each direction's launch counters, the halo modes' own entries among them
ANALYSIS = ("modwt_analysis", "modwt_mxu_analysis", "modwt_exact_analysis",
            "modwt_analysis_external", "modwt_exact_analysis_halo")
SYNTHESIS = ("modwt_synthesis", "modwt_symmetric_synthesis", "modwt_exact_synthesis",
             "modwt_synthesis_external", "modwt_exact_synthesis_halo")
DENOISE = ("modwt_denoise", "modwt_denoise_stream")
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
    if name == "denoiser_noisy":  # test_streaming.py::test_streaming_denoiser_reduces_noise
        return composite_sin(2048) + np.random.default_rng(0).normal(0, 1.0, 2048)
    if name == "denoiser_sine":  # test_streaming_denoise_kernel.py::..._class_kernel_backend
        clean = np.sin(np.linspace(0, 16 * np.pi, 2048))
        return clean + 0.4 * np.random.default_rng(3).standard_normal(2048)
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
    if kind == "rows":  # composite_sin rows of the given seeds
        _, noise, seeds = case.data
        return np.stack([composite_sin(case.shape[-1], seed=s, noise_std=noise)
                         for s in seeds])
    if kind == "blocks":  # k successive draws of one generator, one block each
        _, seed, k = case.data
        rng = np.random.default_rng(seed)
        block = case.shape[:-1] + (case.shape[-1] // k,)
        return np.concatenate([rng.standard_normal(block) for _ in range(k)], axis=-1)
    if kind == "two_tone":  # tests/test_cwt.py::_two_tone
        t = np.arange(case.shape[-1])
        return np.sin(2 * np.pi * t / 32) + 0.5 * np.sin(2 * np.pi * t / 128)
    if kind == "scaled":  # a seeded draw times a factor
        _, seed, factor = case.data
        return np.random.default_rng(seed).standard_normal(case.shape) * factor
    if kind == "prices":  # tests/test_finance.py::_price_series
        _, seed, crash_at = case.data
        return price_series(case.shape[-1], seed, crash_at)
    if kind == "walk":  # tests/test_longmemory.py: a cumulative sum of a seeded draw
        return np.cumsum(np.random.default_rng(case.data[1]).standard_normal(case.shape),
                         axis=-1)
    if kind == "fgn":  # tests/test_longmemory.py::_fgn
        _, hurst, seed = case.data
        return fgn(hurst, case.shape[-1], seed)
    if kind == "sharpe_returns":  # tests/test_finance.py::test_wavelet_sharpe_denoises
        n = case.shape[-1]
        rng = np.random.default_rng(2)
        return 0.001 + 0.002 * np.sin(np.arange(n) / 64) + rng.normal(0, 0.02, n)
    return _solver_input(case)


def fgn(hurst: float, n: int, seed: int) -> np.ndarray:
    """``tests/test_longmemory.py::_fgn``: spectrally synthesized fractional
    Gaussian noise, unit variance."""
    rng = np.random.default_rng(seed)
    freqs = np.fft.rfftfreq(n)
    amp = np.zeros_like(freqs)
    amp[1:] = freqs[1:] ** (-(2.0 * hurst - 1.0) / 2.0)
    spec = amp * np.exp(2j * np.pi * rng.random(freqs.shape))
    spec[0] = 0.0
    x = np.fft.irfft(spec, n=n)
    return x / x.std()


def price_series(n: int, seed: int, crash_at: int | None = None) -> np.ndarray:
    """``tests/test_finance.py::_price_series``: a seeded log-normal walk
    from 100, with a two-day crash at ``crash_at``."""
    rets = np.random.default_rng(seed).normal(0.0005, 0.01, n)
    if crash_at is not None:
        rets[crash_at] = -0.12
        rets[crash_at + 1] = -0.06
    return 100.0 * np.exp(np.cumsum(rets))


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


def _counted(fn, names, out=None, label="", mode=None):
    """``fn``'s result and its launches under ``names``; where ``mode`` (a
    counter among ``names``) is given, a launch counted under another of
    ``names`` is a fault of ``out``'s, recorded under ``label``."""
    before = dict(mc.LAUNCHES)
    result = fn()
    n = _launched(before, names)
    if mode is not None and _launched(before, (mode,)) != n:
        out.faults.append(f"{label}: {n - _launched(before, (mode,))} of {n} launches "
                          f"outside {mode}")
    return result, n


def _relative(got, want) -> float:
    want_t = want if isinstance(want, (tuple, list)) else (want,)
    return _err(got, want) / max(max(float(v.abs().max()) for v in want_t), 1e-30)


def _through(out, direction, fn, names, auto_launches, serves, kernel_launches, plain, bound,
             on_card, err=_err, refused_by_design=None, mode=None):
    """One direction of a call under ``auto``, then under ``kernel``, held
    against the plain route's result (the thunk ``plain``) within
    ``bound``.  The router's expectations are thunks, asked under the
    backend they judge: ``auto_launches`` (a count, or a bool where the
    router fixes none), ``serves`` (whether the kernels' windows serve the
    call on this device) and ``kernel_launches``.  A CPU tensor's ``auto``
    route is the plain one (it launches nothing, which ``Outcome.route``
    holds), so there its result stands for the plain route's and the
    ``kernel`` leg, the kernels' plain versions, is held to it.  Where the
    entry point refuses ``kernel`` by design on every device,
    ``refused_by_design`` is ``(why, error code)``, and the ``kernel`` leg
    must raise that code.  ``mode``, a counter among ``names``: the mode
    every launch of the direction must take (an external halo, the stream
    mode), held by its own counter.  Returns the output under ``auto``."""
    with using_backend("auto"):
        expected = auto_launches()
        got, n = _counted(fn, names, out, f"auto {direction}", mode)
    out.route("auto", direction, n, expected, on_card)
    want = plain() if on_card else got
    out.bound(f"auto {direction}", err(got, want), bound)
    auto_got = got
    if refused_by_design is not None:
        why, code = refused_by_design
        with using_backend("kernel"):
            try:
                fn()
            except InvalidArgumentError as exc:
                if exc.code is not code:
                    out.faults.append(f"kernel {direction}: raised {exc.code.value}, not "
                                      f"{code.value} ({why})")
                out.routes[f"kernel {direction}"] = f"raised ({why})"
            else:
                out.faults.append(f"kernel {direction}: served a call refused by design "
                                  f"({why})")
        return auto_got
    with using_backend("kernel"):
        can = serves()
        if expected and on_card and not can:
            out.faults.append(f"kernel {direction}: the gate admits a call the kernels "
                              "cannot serve")
        try:
            got, n = _counted(fn, names, out, f"kernel {direction}", mode)
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


def cwt_launches(x, scales, wavelet: str = "morl") -> int:
    """The bank launches of a periodic float32 ``cwt`` of ``x`` under the
    current backend: one a chunk of the leading scales
    ``_kernel_direct_split`` gives the kernel-direct tier."""
    w = cwt_mod._resolve_continuous(wavelet)
    n_small = cwt_mod._kernel_direct_split(x.device, w, tuple(scales), "periodic",
                                           torch.float32)
    return len(cwt_mod._kernel_direct_chunks(w, tuple(scales[:n_small]))) if n_small else 0


def cwt_serves(x, scales, wavelet: str = "morl") -> bool:
    if x.device.type == "cpu":
        return True
    w = cwt_mod._resolve_continuous(wavelet)
    n_small = cwt_mod._kernel_direct_split(x.device, w, tuple(scales), "periodic",
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

    _through(out, "coefficients", fn, BANK_ANALYSIS, lambda: cwt_launches(x, scales),
             lambda: cwt_serves(x, scales), lambda: cwt_launches(x, scales),
             lambda: _plain(fn), absolute or TOL_F32, on_card, err=err)


# -- the 2-D pair -------------------------------------------------------------------


def _planes2(res) -> tuple:
    return (*(p for trip in res.details for p in trip), res.approx)


def _pair_launches_1d(x, w, levels: int) -> tuple[int, int]:
    """(analysis, synthesis) launches of one periodic cascade each way under
    the current backend: ``_kernel_eligible``'s answer for each direction."""
    return (int(ml._kernel_eligible(x, w, levels, "periodic")),
            int(ml._kernel_eligible(x, w, levels, "periodic", True)))


def _pair_launches_2d(x, w, levels: int, boundary: str = "periodic") -> int:
    """The 2-D pair's launches one way: one a level where
    ``modwt2_kernel_eligible`` admits the call."""
    return levels if k2.modwt2_kernel_eligible(x, w, levels, boundary) else 0


def _twod(case, x, w, out, on_card) -> None:
    """The 2-D pair: ``levels`` launches each way where
    ``modwt2_kernel_eligible`` admits the call, ``kernel`` refused exactly
    where ``kernel_refusal`` says.  The synthesis takes the plain route's
    planes (on a CPU tensor the ``auto`` analysis's, which are those)."""
    levels, b = case.levels, case.boundary

    def launches():
        return _pair_launches_2d(x, w, levels, b)

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
             lambda: 2 * _pair_launches_2d(x, w, levels, b),
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
    planes is held to the plain route (2e-5); SURE's threshold is an arg min,
    FDR's a step-up search, and a hard cut can flip, so those are held to the
    plain route on the route's own thresholds (:func:`_route_thresholds_held`,
    2e-5), and, on a composite signal with noise, to the JAX test's own
    check, a lower error against the clean signal than the noisy input's."""
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

    smooth = mode == "soft" and method not in ("sure", "fdr")
    want = _plain(fn) if smooth else None
    clean = None
    if case.data[0] == "noisy":
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
            err = _relative if case.option("relative") else _err
            out.bound(f"{backend} denoise", err(got, want), TOL_F32)
        elif clean is not None:
            mse = float(((got.double() - clean) ** 2).mean())
            out.bound(f"{backend} denoised error / noisy error", mse / noisy_mse, 1.0)


def _batch_facade(case, x, w, out, on_card) -> None:
    """``modwt_multilevel_sharded_batch`` over the ``data`` axis of the
    case's mesh (BASELINE config #4: a one-device mesh), whose rows on one
    device route as one ``modwt_multilevel`` call."""
    from vectorwave_tpu_torch import parallel

    mesh = _mesh(case, x.device)
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
                    (256, 16384), data=("normal", 1), options=(("mesh", (("data", 1),)),)))
    return out


# -- the streaming and parallel tiers (phase 2d) ----------------------------------------


def _joined(results) -> tuple:
    """A stream's block results, each plane concatenated along time."""
    return tuple(torch.cat(ps, dim=-1) for ps in zip(*(_planes(r) for r in results)))


def _blocks(x: torch.Tensor, size: int) -> list:
    return [x[..., s:s + size] for s in range(0, x.shape[-1], size)]


def stream_launches(blocks, w, levels: int, backend: str, kernel_fn: str = "analysis") -> int:
    """The launches of a kernel-tier stream's blocks under ``backend``: one
    a block that ``stream.use_stream_kernel`` sends to the kernel, whose
    window must fit (``analysis_tile`` or ``denoise_tile``)."""
    from vectorwave_tpu_torch.streaming import stream

    tile = mc.analysis_tile if kernel_fn == "analysis" else mc.denoise_tile
    fits = tile(w.filter_length, levels) is not None
    return sum(stream.use_stream_kernel(b.reshape(-1, b.shape[-1]), backend, fits)
               for b in blocks)


def _stream(case, x, w, out, on_card) -> None:
    """Block streaming on the kernel tier: ``modwt_stream_block_kernel``
    steps (``entry='step'``) or a ``StreamingTransform`` (``'class'``),
    with a flush where the JAX test flushes; one analysis launch a block
    where ``use_stream_kernel`` routes it (a class first by
    ``resolve_tier``).  Held to the whole-signal plain transform (periodic:
    each block's own)."""
    from vectorwave_tpu_torch import streaming as st
    from vectorwave_tpu_torch.streaming import stream

    levels, b = case.levels, case.boundary
    entry = case.option("entry", "step")
    blocks = _blocks(x, case.option("block"))
    batch = tuple(x.shape[:-1])
    tail = st.suggest_flush_tail_length(w, levels) if case.option("flush") else 0
    fed = blocks + ([torch.zeros(batch + (tail,), dtype=x.dtype, device=x.device)]
                    if tail else [])

    def fn():
        backend = vt.get_backend()
        if entry == "class":
            t = st.StreamingTransform(w, levels=levels, boundary=b, batch_shape=batch,
                                      dtype=x.dtype, backend=backend, device=x.device)
            res = [t.process(blk) for blk in blocks] + ([t.flush()] if tail else [])
            return _joined(res)
        state = st.kernel_streaming_init(w, levels, batch_shape=batch, dtype=x.dtype,
                                         device=x.device)
        res = []
        for blk in fed:
            state, r = st.modwt_stream_block_kernel(state, blk, w, levels=levels, boundary=b)
            res.append(r)
        return _joined(res)

    def launches():
        backend = vt.get_backend()
        if entry == "class" and not stream.resolve_tier(backend, x.device, x.dtype)[0]:
            return 0
        return stream_launches(fed, w, levels, backend)

    def serves():
        span = mc.composite_halo_samples(w.filter_length, levels)
        first_ok = b != "symmetric" or blocks[0].shape[-1] >= span
        return x.device.type == "cpu" or (
            mc.analysis_tile(w.filter_length, levels) is not None and first_ok)

    def plain():
        if b == "periodic":
            return _joined([vt.modwt_multilevel(blk, w, levels=levels, boundary=b,
                                                backend="torch") for blk in fed])
        return _planes(vt.modwt_multilevel(torch.cat(fed, dim=-1), w, levels=levels,
                                           boundary=b, backend="torch"))

    # a zero or symmetric block reads the carry through the external edge
    mode = "modwt_analysis" if b == "periodic" else "modwt_analysis_external"
    _through(out, "analysis", fn, ANALYSIS, launches, serves, launches, plain, TOL_F32,
             on_card, mode=mode)


def _stream_denoise(case, x, w, out, on_card) -> None:
    """The streaming denoiser's kernel tier: ``streaming_denoise_block_kernel``
    steps (``entry='step'``), one ``streaming_denoise_blocks_kernel`` call on
    blocks along the first axis (``'blocks'``), or a ``StreamingDenoiser``
    (``'class'``); one stream-mode denoise launch a step where
    ``use_stream_kernel`` routes it (the multi-block call one launch for all
    its blocks when they are at least the span long).  Steps are held to
    the same call's plain versions (the thresholds are the same numbers); a
    class to the plain tier under ``backend='torch'`` (its block inverse
    would take the synthesis kernel under ``auto``), within the JAX tests'
    bound between the two tiers (``TOL_STREAM_TIERS``)."""
    from vectorwave_tpu_torch import streaming as st
    from vectorwave_tpu_torch.streaming import stream

    levels, entry = case.levels, case.option("entry", "step")
    kw = dict(threshold_mode=case.option("mode", "soft"),
              noise_estimation=case.option("estimation", "mad"))
    if case.option("sigma") is not None:
        kw["fixed_sigma"] = case.option("sigma")
    if entry == "blocks":
        blocks = list(x)
        batch = tuple(x.shape[1:-1])
    else:
        blocks = _blocks(x, case.option("block"))
        batch = tuple(x.shape[:-1])

    def fn():
        backend = vt.get_backend()
        if entry == "class":
            den = st.StreamingDenoiser(w, implementation=case.option("implementation"),
                                       backend=backend, device=x.device)
            return torch.cat([den.denoise(blk) for blk in blocks], dim=-1)
        state = st.kernel_streaming_denoiser_init(w, levels=levels, batch_shape=batch,
                                                  device=x.device)
        if entry == "blocks":
            return st.streaming_denoise_blocks_kernel(state, x, w, levels=levels, **kw)[1]
        outs = []
        for blk in blocks:
            state, o = st.streaming_denoise_block_kernel(state, blk, w, levels=levels, **kw)
            outs.append(o)
        return torch.cat(outs, dim=-1)

    def launches():
        backend = vt.get_backend()
        if entry == "class":
            tier, backend = stream.resolve_tier(backend, x.device, x.dtype,
                                                x.dtype == torch.float32)
            if not tier:
                return 0
        n = stream_launches(blocks, w, levels, backend, "denoise")
        span = st.kernel_history_length(w, levels)
        if entry == "blocks" and n and len(blocks) > 1 and blocks[0].shape[-1] >= span:
            return 1
        return n

    def serves():
        return x.device.type == "cpu" or mc.denoise_tile(w.filter_length, levels) is not None

    def plain():
        if entry != "class":
            return _plain(fn)
        # the plain tier's block inverse routes by the configured backend
        with using_backend("torch"):
            den = st.StreamingDenoiser(w, implementation=case.option("implementation"),
                                       backend="torch", device=x.device)
            return torch.cat([den.denoise(blk) for blk in blocks], dim=-1)

    _through(out, "denoise", fn, DENOISE, launches, serves, launches, plain,
             TOL_STREAM_TIERS if entry == "class" else TOL_F32, on_card,
             mode="modwt_denoise_stream")


def _mesh(case, device):
    from vectorwave_tpu_torch import parallel

    axes = dict(case.option("mesh"))
    return parallel.make_mesh(axes, devices=[device] * math.prod(axes.values()))


def _tiled(case, x, w, out, on_card) -> None:
    """``modwt_multilevel_tiled`` / ``imodwt_multilevel_tiled`` on a mesh of
    virtual shards of one device, or the host x chip facades
    (``facade='multihost'``): one external-halo launch each way where
    ``tiled._resolve_tiled_backend`` takes the kernel route (all shards of a
    device are one call), none on the plain route; ``kernel`` refuses the
    symmetric boundary.  Held to the plain route, and (the JAX tests'
    property) to the single-device transform and its inverse."""
    from vectorwave_tpu_torch import parallel
    from vectorwave_tpu_torch.parallel import tiled

    levels, b = case.levels, case.boundary
    if case.option("facade") == "multihost":
        mesh = parallel.make_multihost_mesh(n_hosts=2, chips_per_host=4,
                                            devices=[x.device] * 8)
        axis, batch_axis, world = "chip", "host", False

        def analysis(backend):
            return parallel.modwt_multilevel_multihost(x, w, levels=levels, mesh=mesh,
                                                       boundary=b, backend=backend)

        def synthesis(res, backend):
            return parallel.imodwt_multilevel_multihost(res, w, mesh=mesh, boundary=b,
                                                        backend=backend)
    else:
        mesh = _mesh(case, x.device)
        axis, batch_axis, world = "signal", case.option("batch_axis"), True
        kw = dict(mesh=mesh, axis=axis, boundary=b, batch_axis=batch_axis)

        def analysis(backend):
            return parallel.modwt_multilevel_tiled(x, w, levels=levels, backend=backend, **kw)

        def synthesis(res, backend):
            return parallel.imodwt_multilevel_tiled(res, w, backend=backend, **kw)

    def route():
        tiles = tiled._tiles(mesh, axis, batch_axis, tuple(x.shape), -1, world=world)
        return 1 if tiled._resolve_tiled_backend("auto", b, tiles, x.dtype, w.filter_length,
                                                 levels) == "kernel" else 0

    def serves():
        return x.device.type == "cpu" or kernel_serves(x, w, levels, b, False)

    def result(planes):
        return vt.MultiLevelMODWTResult(tuple(planes[:levels]), planes[levels])

    plain = None
    if on_card:
        plain = analysis("torch")
    design = None
    if b == "symmetric":
        design = ("the tiled kernel route serves periodic and zero",
                  ErrorCode.CFG_UNSUPPORTED_BOUNDARY)
    res = _through(out, "analysis", lambda: _planes(analysis(vt.get_backend())), ANALYSIS,
                   route, serves, lambda: 1, lambda: _planes(plain), TOL_F32, on_card,
                   refused_by_design=design, mode="modwt_analysis_external")
    if plain is None:
        plain = result(res)
    y = _through(out, "synthesis", lambda: synthesis(plain, vt.get_backend()), SYNTHESIS,
                 route, serves, lambda: 1, lambda: synthesis(plain, "torch"), TOL_F32,
                 on_card, refused_by_design=design, mode="modwt_synthesis_external")
    single = vt.modwt_multilevel(x, w, levels=levels, boundary=b, backend="torch")
    out.bound("auto planes against one device", _err(res, _planes(single)), TOL_F32)
    out.bound("auto inverse against one device",
              _err(y, vt.imodwt_multilevel(plain, w, boundary=b, backend="torch")), TOL_F32)
    if b == "periodic":
        out.bound("periodic round trip", _err(y, x), TOL_F32)


def _tiled_exact(case, x, w, out, on_card) -> None:
    """The sharded exact tier on eight virtual shards of one device: the
    exact pair's launches each way, as many as its launch plan has
    (``exact_launches``; the tier takes no backend, so ``auto`` and
    ``kernel`` run alike), each in the mode the tier takes: the halo's
    load rule for a plan of one window, the plain launches for a split plan
    or where a periodic span of at least the signal gathers it; hi +
    lo held to the plain float64 cascade within 1e-13, the round trip (the
    zero edge's interior) within 1e-10 RMSE of x."""
    from vectorwave_tpu_torch import parallel
    from vectorwave_tpu_torch.parallel import tiled

    levels, b = case.levels, case.boundary
    mesh = _mesh(case, x.device)
    want = _planes(vt.modwt_multilevel(x.double(), w, levels=levels, boundary=b,
                                       backend="torch"))
    span = (w.filter_length - 1) * ((1 << levels) - 1)
    gathered = b == "periodic" and span >= tiled._tiles(mesh, "signal", None,
                                                       tuple(x.shape), -1).n
    plans = []
    for shared, key in ((mc.exact_analysis_shared_bytes, "modwt_exact_analysis"),
                        (mc.exact_synthesis_shared_bytes, "modwt_exact_synthesis")):
        plan = mc.exact_launches(shared, w.filter_length, levels)
        halo = not gathered and mc._one_window(plan)
        plans.append((len(plan), (key, f"{key}_halo"), f"{key}_halo" if halo else key))
    for backend in ("auto", "kernel"):
        with using_backend(backend):
            count, names, mode = plans[0]
            (details, approx), n = _counted(lambda: parallel.modwt_multilevel_tiled_exact(
                x, w, levels=levels, mesh=mesh, boundary=b), names, out,
                f"{backend} analysis", mode)
            out.route(backend, "analysis", n, count, on_card)
            out.bound(f"{backend} hi + lo", _err([h.double() + lo.double() for h, lo in
                                                  (*details, approx)], want), TOL_EXACT)
            count, names, mode = plans[1]
            (hi, lo), n = _counted(lambda: parallel.imodwt_multilevel_tiled_exact(
                details, approx, w, mesh=mesh, boundary=b), names, out,
                f"{backend} synthesis", mode)
            out.route(backend, "synthesis", n, count, on_card)
        cut = 0 if b == "periodic" else (w.filter_length - 1) * ((1 << levels) - 1)
        err = (hi.double() + lo.double() - x.double())[..., cut:x.shape[-1] - cut]
        out.bound(f"{backend} round trip rmse", float(err.pow(2).mean().sqrt()),
                  EXACT_RT_RMSE)


def _tiled2d(case, x, w, out, on_card) -> None:
    """``modwt2_multilevel_tiled`` / ``imodwt2_multilevel_tiled`` along H on
    virtual shards of one device.  The symmetric edge and a periodic span of
    at least H take the whole image (``tiled2d.py``'s gather path), which
    routes as ``modwt2_multilevel`` does: ``levels`` launches each way
    where ``modwt2_kernel_eligible`` admits it, ``kernel`` refused where
    ``kernel_refusal`` says; the slab path is plain PyTorch."""
    from vectorwave_tpu_torch import parallel

    levels, b = case.levels, case.boundary
    mesh = _mesh(case, x.device)
    kw = dict(mesh=mesh, boundary=b, batch_axis=case.option("batch_axis"))
    span = (w.filter_length - 1) * ((1 << levels) - 1)
    whole = b == "symmetric" or (b == "periodic" and span >= x.shape[-2])

    def launches():
        return levels if whole and k2.modwt2_kernel_eligible(x, w, levels, b) else 0

    def serves():
        return x.device.type == "cpu" or not whole or k2.kernel_refusal(x, w, levels, b) is None

    def forced():
        return levels if whole else 0

    def analysis():
        return _planes2(parallel.modwt2_multilevel_tiled(x, w, levels=levels, **kw))

    def result(planes):
        details = tuple(tuple(planes[3 * j:3 * j + 3]) for j in range(levels))
        return vt.MultiLevelMODWT2Result(details, planes[-1])

    plain = result(_plain(analysis)) if on_card else None
    res = _through(out, "analysis", analysis, ANALYSIS_2D, launches, serves, forced,
                   lambda: _planes2(plain), TOL_F32, on_card)
    if plain is None:
        plain = result(res)

    def synthesis():
        return parallel.imodwt2_multilevel_tiled(plain, w, **kw)

    y = _through(out, "synthesis", synthesis, SYNTHESIS_2D, launches, serves, forced,
                 lambda: _plain(synthesis), TOL_2D_ROUND_TRIP, on_card)
    single = vt.modwt2_multilevel(x, w, levels=levels, boundary=b, backend="torch")
    out.bound("auto levels against one device", _err(res, _planes2(single)), TOL_F32)
    if b == "periodic":
        out.bound("periodic round trip", _err(y, x), TOL_2D_ROUND_TRIP)


def _window(case, x, w, out, on_card) -> None:
    """The window transforms: a ``SlidingStreamingTransform`` fed the whole
    stream then flushed (``entry='sliding'``), or a ``StreamIngest`` fed the
    JAX test's random chunks and drained after each (``'ingest'``); each
    window (each drain, its windows batched) is one ``modwt_multilevel``
    call, routed by ``_kernel_eligible``."""
    from vectorwave_tpu_torch import streaming as st

    levels, b = case.levels, case.boundary
    size, entry = case.option("buffer"), case.option("entry")
    channels = x.shape[-1] if entry == "ingest" and x.dim() == 2 else 1
    step = st.step_size(size, w, levels=levels)
    host = x.cpu().numpy()
    chunks = [len(host)]
    if case.option("chunks_seed") is not None:  # the JAX test's push sizes
        rng = np.random.default_rng(case.option("chunks_seed"))
        rng.standard_normal(len(host))
        chunks, i = [], 0
        while i < len(host):
            n = int(rng.integers(1, 300))
            chunks.append(min(n, len(host) - i))
            i += n

    def fn():
        if entry == "sliding":
            t = st.SlidingStreamingTransform(w, buffer_size=size, levels=levels, boundary=b,
                                             dtype=x.dtype, device=x.device)
            res = t.process(x)
            tail = t.flush()
            res += [tail] if tail is not None else []
            return tuple(torch.stack(ps) for ps in zip(*(_planes(r) for r in res)))
        ing = st.StreamIngest(w, buffer_size=size, levels=levels, boundary=b,
                              channels=channels, capacity=2 * len(host), device=x.device)
        outs, i = [], 0
        for n in chunks:
            ing.push(host[i:i + n])
            i += n
            got = ing.drain()
            if got is not None:
                outs.append(got)
        return tuple(torch.cat(ps) for ps in zip(*(_planes(r) for r in outs)))

    def calls():
        if entry == "sliding":  # the windows the stream fills, and the flush's
            return 1 + (len(host) - size) // step + bool((len(host) - size) % step)
        count, fed, done = 0, 0, 0
        for n in chunks:
            fed += n
            ready = 0 if fed < size else 1 + (fed - size) // step
            count += ready > done
            done = ready
        return count

    like = torch.zeros((1, channels, size) if channels > 1 else (1, size), dtype=x.dtype,
                       device=x.device)

    def launches():
        return calls() if ml._kernel_eligible(like, w, levels, b) else 0

    _through(out, "analysis", fn, ANALYSIS, launches,
             lambda: kernel_serves(like, w, levels, b, False), calls, lambda: _plain(fn),
             TOL_F32, on_card)


def tier_cases() -> list[Case]:
    """Phase 2d's cases: every kernel-reaching case of the streaming and
    parallel tiers' mirrors (``tests/test_torch_streaming_mirror.py``,
    ``tests/test_torch_parallel_mirror.py``), at the JAX tests' shapes and
    seeds (float64 inputs cast to float32)."""
    out = []
    sm = "test_streaming.py"
    for name, levels in (("haar", 3), ("db4", 3), ("sym8", 2)):
        for block in (64, 100, 256):
            out.append(Case(f"stream zero {name} J={levels} 512 blocks {block}", "stream",
                            f"{sm}::test_streaming_matches_whole_signal_zero_boundary", name,
                            levels, (512,), "zero", ("composite", 0.3),
                            options=(("block", block),)))
    out.append(Case("stream symmetric db4 J=3 512 blocks 128", "stream",
                    f"{sm}::test_streaming_symmetric_matches_whole_signal_interior", "db4", 3,
                    (512,), "symmetric", ("composite", 0.2), options=(("block", 128),)))
    out.append(Case("stream periodic db4 J=2 256 blocks 128", "stream",
                    f"{sm}::test_streaming_periodic_is_per_block", "db4", 2, (256,),
                    "periodic", ("composite", 0.0), options=(("block", 128),)))
    out.append(Case("stream flush db4 J=2 128", "stream", f"{sm}::test_flush_drains_history",
                    "db4", 2, (128,), "zero", ("composite", 0.0),
                    options=(("block", 128), ("flush", True))))
    out.append(Case("stream batched db4 J=2 3x128", "stream", f"{sm}::test_streaming_batched",
                    "db4", 2, (3, 128), "zero", ("rows", 0.1, (0, 1, 2)),
                    options=(("block", 128),)))
    out.append(Case("StreamingTransform db4 J=3 512 blocks 128", "stream",
                    f"{sm}::test_streaming_transform_class", "db4", 3, (512,), "zero",
                    ("composite", 0.2),
                    options=(("block", 128), ("entry", "class"), ("flush", True))))
    out.append(Case("StreamingDenoiser quality db4 2048 blocks 256", "stream_denoise",
                    f"{sm}::test_streaming_denoiser_reduces_noise", "db4", 4, (2048,),
                    data=("signal", "denoiser_noisy"),
                    options=(("block", 256), ("entry", "class"),
                             ("implementation", "quality"))))
    out.append(Case("stream denoise fixed sigma haar J=1 128", "stream_denoise",
                    f"{sm}::test_streaming_denoiser_fixed_sigma", "haar", 1, (128,),
                    data=("composite", 0.5),
                    options=(("block", 128), ("estimation", "fixed"), ("sigma", 0.5))))

    sk = "test_streaming_denoise_kernel.py"
    for batch, nblk, levels, mode in (((3,), 2048, 4, "soft"), ((), 1024, 3, "hard"),
                                      ((2,), 512, 2, "soft")):
        shape = batch + (3 * nblk,)
        out.append(Case(f"stream denoise db4 J={levels} {mode} "
                        f"{'x'.join(map(str, batch + (nblk,)))} x3 blocks", "stream_denoise",
                        f"{sk}::test_kernel_streaming_denoiser_matches_jnp", "db4", levels,
                        shape, data=("blocks", 0, 3),
                        options=(("block", nblk), ("mode", mode))))
    out.append(Case("stream denoise db4 J=2 200 x2 blocks", "stream_denoise",
                    f"{sk}::test_kernel_streaming_denoiser_fallback_shape", "db4", 2, (400,),
                    data=("blocks", 1, 2), options=(("block", 200),)))
    for est, sigma in (("std", None), ("fixed", 0.5)):
        out.append(Case(f"stream denoise {est} sym4 J=3 2x1024", "stream_denoise",
                        f"{sk}::test_kernel_streaming_denoiser_estimators", "sym4", 3,
                        (2, 1024), data=("normal", 2),
                        options=(("block", 1024), ("estimation", est), ("sigma", sigma))))
    out.append(Case("StreamingDenoiser kernel backend db4 2048 blocks 512", "stream_denoise",
                    f"{sk}::test_streaming_denoiser_class_kernel_backend", "db4", 4, (2048,),
                    data=("signal", "denoiser_sine"),
                    options=(("block", 512), ("entry", "class"),
                             ("implementation", "quality"))))
    for name, levels, nblk in (("sym8", 5, 4096), ("coif3", 3, 1536), ("db2", 6, 8192)):
        out.append(Case(f"stream denoise family {name} J={levels} 2x{nblk} x4 blocks",
                        "stream_denoise",
                        f"{sk}::test_kernel_streaming_denoiser_family_sweep", name, levels,
                        (2, 4 * nblk), data=("blocks", 7, 4), options=(("block", nblk),)))
    out.append(Case("stream denoise blocks db4 J=3 4x2x1024", "stream_denoise",
                    f"{sk}::test_kernel_streaming_denoiser_scan_compatible", "db4", 3,
                    (4, 2, 1024), data=("normal", 11), options=(("entry", "blocks"),)))

    sl = "test_sliding.py"
    out.append(Case("sliding symmetric db4 J=3 400 buffer 256", "window",
                    f"{sl}::test_multilevel_window_and_flush", "db4", 3, (400,), "symmetric",
                    ("composite", 0.0), options=(("entry", "sliding"), ("buffer", 256))))
    ni = "test_native_ingest.py"
    out.append(Case("StreamIngest db4 J=3 4096 buffer 256", "window",
                    f"{ni}::test_stream_ingest_matches_sliding_transform", "db4", 3, (4096,),
                    data=("normal", 0),
                    options=(("entry", "ingest"), ("buffer", 256), ("chunks_seed", 0))))
    out.append(Case("StreamIngest db2 J=2 1024x4 buffer 128", "window",
                    f"{ni}::test_stream_ingest_multichannel", "db2", 2, (1024, 4),
                    data=("normal", 5), options=(("entry", "ingest"), ("buffer", 128))))

    pl = "test_parallel.py"
    signal8 = (("mesh", (("signal", 8),)),)
    grid = (("mesh", (("data", 2), ("signal", 4))),)
    for b in ("periodic", "zero", "symmetric"):
        out.append(Case(f"tiled {b} db4 J=4 1024 on 8", "tiled",
                        f"{pl}::test_tiled_forward_equals_single_device", "db4", 4, (1024,), b,
                        ("composite", 0.3), options=signal8))
    out.append(Case("tiled periodic sym8 J=2 1024 on 8", "tiled",
                    f"{pl}::test_tiled_roundtrip_periodic_exact", "sym8", 2, (1024,),
                    data=("composite", 0.2), options=signal8))
    out.append(Case("tiled zero db4 J=3 512 on 8", "tiled",
                    f"{pl}::test_tiled_inverse_matches_single_device_zero", "db4", 3, (512,),
                    "zero", ("composite", 0.2), options=signal8))
    for name, levels in (("db4", 3), ("sym8", 1), ("haar", 4)):
        out.append(Case(f"tiled symmetric {name} J={levels} 512 on 8", "tiled",
                        f"{pl}::test_tiled_symmetric_inverse_matches_single_device", name,
                        levels, (512,), "symmetric", ("composite", 0.2), options=signal8))
    for levels in (5, 6):
        out.append(Case(f"tiled symmetric deep halo db4 J={levels} 512 on 8", "tiled",
                        f"{pl}::test_tiled_symmetric_deep_halo_matches_single_device", "db4",
                        levels, (512,), "symmetric", ("composite", 0.3), options=signal8))
    out.append(Case("tiled multi-hop db8 J=4 256 on 8", "tiled", f"{pl}::test_multihop_halo",
                    "db8", 4, (256,), data=("composite", 0.1), options=signal8))
    out.append(Case("tiled db4 J=3 4x512 on 2x4", "tiled", f"{pl}::test_batched_tiled_2d_mesh",
                    "db4", 3, (4, 512), data=("rows", 0.1, (0, 1, 2, 3)), options=grid))
    for b in ("periodic", "zero", "symmetric"):
        out.append(Case(f"multihost {b} db4 J=3 4x512 on 2x4", "tiled",
                        f"{pl}::test_multihost_mesh_and_parity", "db4", 3, (4, 512), b,
                        ("rows", 0.2, (0, 1, 2, 3)), options=(("facade", "multihost"),)))
    out.append(Case("multihost haar J=2 4x512 on 2x4", "tiled",
                    f"{pl}::test_multihost_batch_stays_sharded", "haar", 2, (4, 512),
                    data=("rows", 0.0, (0, 1, 2, 3)), options=(("facade", "multihost"),)))
    for b in ("periodic", "zero"):
        out.append(Case(f"tiled kernel route {b} db4 J=3 2048 on 8", "tiled",
                        f"{pl}::test_tiled_pallas_matches_fused_kernel", "db4", 3, (2048,), b,
                        ("composite", 0.3), options=signal8))
    out.append(Case("tiled kernel route db8 J=4 4x512 on 2x4 (batch axis)", "tiled",
                    f"{pl}::test_tiled_pallas_deep_halo_and_batch", "db8", 4, (4, 512),
                    data=("normal", 5), options=grid + (("batch_axis", "data"),)))
    out.append(Case("sharded batch db4 J=3 4x256 on 2x4", "batch",
                    f"{pl}::test_sharded_batch_facade", "db4", 3, (4, 256),
                    data=("rows", 0.0, (0, 1, 2, 3)), options=grid))

    t2 = "test_tiled2d.py"
    rows4 = (("mesh", (("rows", 4),)),)
    for name, levels in (("db4", 3), ("haar", 4)):
        out.append(Case(f"tiled 2-D symmetric {name} J={levels} 2x128x96 on 4", "tiled2d",
                        f"{t2}::test_tiled2d_analysis_matches_single_device", name, levels,
                        (2, 128, 96), "symmetric", ("normal", 0), options=rows4))
    out.append(Case("tiled 2-D symmetric db4 J=3 128x96 on 4", "tiled2d",
                    f"{t2}::test_tiled2d_roundtrip_matches_single_device", "db4", 3, (128, 96),
                    "symmetric", ("normal", 1), options=rows4))
    out.append(Case("tiled 2-D multi-wrap periodic db4 J=4 64x128 on 4", "tiled2d",
                    f"{t2}::test_tiled2d_periodic_multiwrap_span", "db4", 4, (64, 128),
                    data=("normal", 4), options=rows4))

    te = "test_tiled_exact.py"
    for label, test, name, levels, n, b, seed in (
            ("db4 J=4 8192", "test_tiled_exact_roundtrip_below_1e10", "db4", 4, 8192,
             "periodic", 0),
            ("sym8 J=3 4096", "test_tiled_exact_matches_f64_oracle", "sym8", 3, 4096,
             "periodic", 1),
            ("zero db4 J=3 4096", "test_tiled_exact_zero_boundary", "db4", 3, 4096, "zero", 2),
            ("multi-wrap db8 J=6 1024", "test_tiled_exact_multi_wrap_periodic", "db8", 6, 1024,
             "periodic", 4)):
        out.append(Case(f"tiled exact {label} on 8", "tiled_exact", f"{te}::{test}", name,
                        levels, (n,), b, ("normal", seed), options=signal8))
    out.append(Case("exact symmetric analysis db4 J=3 2x2048", "exact",
                    f"{te}::test_exact_symmetric_analysis_matches_f64", "db4", 3, (2, 2048),
                    "symmetric", ("normal", 3), options=(("precision", "exact"),)))
    return out


# -- the CWT family: the CWT's inverses, the wavelet variance and its stream,
#    the financial analyzers ----------------------------------------------------------


def _relative_each(got, want) -> float:
    """The largest error of each output over that output's largest value."""
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    if len(got) != len(want):
        return math.inf
    return max(_relative(g, v) for g, v in zip(got, want))


def _cwt_inverse(case, x, w, out, on_card) -> None:
    """``cwt`` of a real wavelet with a periodic boundary, then ``icwt``
    (``entry='icwt'``), ``reconstruct_band`` (``'band'``, the JAX test's
    band around the 32-sample tone) or ``reconstruct_frequency_band``
    (``'frequency band'``): the bank launches of the coefficients
    (``cwt_launches``: under ``auto`` none past ``AUTO_KERNEL_DIRECT_MAX_HALF``,
    under ``kernel`` one a chunk of the leading scales whose support fits
    in N).  The coefficients and the reconstruction are held to the FFT
    path within 2e-5 of each one's largest value."""
    name, scales, entry = case.wavelet, case.option("scales"), case.option("entry")
    fc = cwt_mod._resolve_continuous(name).center_frequency

    def rebuild(res):
        if entry == "icwt":
            return vt.icwt(res, name)
        if entry == "band":
            return vt.reconstruct_band(res, name, fc * 16, fc * 64)
        return vt.reconstruct_frequency_band(res, name, 1 / 48, 1 / 22)

    def fn():
        res = vt.cwt(x, scales, name, boundary="periodic")
        return res.coeffs, rebuild(res)

    def launches():
        return cwt_launches(x, scales, name)

    _through(out, entry, fn, BANK_ANALYSIS, launches, lambda: cwt_serves(x, scales, name),
             launches, lambda: _plain(fn), TOL_F32, on_card, err=_relative_each)


#: each statistic's transforms: one periodic ``modwt_multilevel`` a series
#: (the correlation's covariance takes two, each variance one more)
VARIANCE_TRANSFORMS = {"variance": 1, "covariance": 2, "correlation": 4}


def _variance(case, x, w, out, on_card) -> None:
    """``wavelet_variance`` (``entry='variance'``, its estimate and
    interval), ``wavelet_covariance`` or ``wavelet_correlation`` of the
    case's two rows, or of x with itself (``pair='same'``) or with -x
    (``'opposite'``): one periodic cascade analysis launch a transform
    (:data:`VARIANCE_TRANSFORMS`) where ``_kernel_eligible`` admits the
    series; held to the plain route within 2e-5 of each output's largest
    value."""
    levels, entry = case.levels, case.option("entry", "variance")
    unbiased, pair = case.option("unbiased", True), case.option("pair")
    if entry == "variance":
        a, b = x, None
    elif pair == "same":
        a, b = x, x
    elif pair == "opposite":
        a, b = x, -x
    else:
        a, b = x[0], x[1]
    transforms = VARIANCE_TRANSFORMS[entry]

    def fn():
        if entry == "variance":
            r = vt.wavelet_variance(a, w, levels, unbiased=unbiased)
            return r.variance, r.ci_low, r.ci_high
        call = vt.wavelet_covariance if entry == "covariance" else vt.wavelet_correlation
        return call(a, b, w, levels, unbiased=unbiased)[0]

    _through(out, entry, fn, ANALYSIS,
             lambda: transforms * ml._kernel_eligible(a, w, levels, "periodic"),
             lambda: kernel_serves(a, w, levels, "periodic", False), lambda: transforms,
             lambda: _plain(fn), TOL_F32, on_card, err=_relative_each, mode="modwt_analysis")


def _variance_stream(case, x, w, out, on_card) -> None:
    """The variance stream on the kernel-tier step: zero-boundary blocks
    through ``modwt_stream_block_kernel``, each folded by
    ``variance_stream_update``; one external-edge analysis launch a block
    where ``stream.use_stream_kernel`` routes it.  The estimate and its
    interval held to the same stream on the plain versions within 2e-5 of
    each one's largest value, and (the JAX test's guarantee) the estimate
    under ``auto`` to the plain route's whole-signal ``wavelet_variance``."""
    from vectorwave_tpu_torch import streaming as st

    levels = case.levels
    blocks = _blocks(x, case.option("block"))
    batch = tuple(x.shape[:-1])

    def fn():
        state = st.kernel_streaming_init(w, levels, batch_shape=batch, dtype=x.dtype,
                                         device=x.device)
        acc = vt.variance_stream_init(w, levels, batch_shape=batch, dtype=x.dtype,
                                      device=x.device)
        for blk in blocks:
            state, res = st.modwt_stream_block_kernel(state, blk, w, levels=levels,
                                                      boundary="zero")
            acc = vt.variance_stream_update(acc, res.details, w)
        r = vt.variance_stream_result(acc)
        return r.variance, r.ci_low, r.ci_high

    def launches():
        return stream_launches(blocks, w, levels, vt.get_backend())

    def serves():
        return x.device.type == "cpu" or mc.analysis_tile(w.filter_length, levels) is not None

    got = _through(out, "variance stream", fn, ANALYSIS, launches, serves, launches,
                   lambda: _plain(fn), TOL_F32, on_card, err=_relative_each,
                   mode="modwt_analysis_external")
    whole = _plain(lambda: vt.wavelet_variance(x, w, levels).variance)
    out.bound("auto stream against the whole signal", _relative(got[0], whole), TOL_F32)


def _tensors(*values) -> tuple:
    return tuple(torch.as_tensor(np.asarray(v, dtype=np.float64)) for v in values)


def _finance(case, x, w, out, on_card) -> None:
    """The financial analyzers built on a MODWT, on float32 prices (or
    returns) on the case's device: ``wavelet_sharpe_ratio`` and
    ``analyze_market`` (the fused denoise, one launch where
    ``denoiser.fused_denoise_serves`` takes the call) and
    ``calculate_wavelet_indicators`` (sym8 to J=5 periodic, one cascade
    analysis launch).  Each side's count is the router's own decision under
    that backend.  Held to the plain route within 2e-5 of each output's
    largest value: the Sharpe ratio, the indicators (the momentum within
    :data:`TOL_MOMENTUM`), and the market view's figures, its regimes and
    anomalies equal."""
    from vectorwave_tpu_torch import finance as fin

    entry, n = case.option("entry"), x.shape[-1]
    err = _relative_each
    if entry in ("sharpe", "market"):
        name = "db4"
        levels = (max(1, min(4, vt.max_levels(n, name))) if entry == "sharpe"
                  else max(1, min(3, vt.max_levels(n, name))))
        wd = vt.wavelet(name)
        probe = x if entry == "sharpe" else x.to(torch.get_default_dtype())
        names, mode = DENOISE + ANALYSIS + SYNTHESIS, "modwt_denoise"

        def launches():
            return int(denoiser.fused_denoise_serves(probe, wd, levels, "universal", "soft",
                                                     "periodic"))

        def serves():
            return x.device.type == "cpu" or mc.denoise_tile(wd.filter_length,
                                                            levels) is not None
    else:
        wd, levels = vt.wavelet("sym8"), max(2, min(5, vt.max_levels(n, "sym8")))
        names, mode = ANALYSIS, "modwt_analysis"

        def launches():
            return int(ml._kernel_eligible(x, wd, levels, "periodic"))

        def serves():
            return kernel_serves(x, wd, levels, "periodic", False)

    if entry == "sharpe":
        def fn():
            return fin.wavelet_sharpe_ratio(x)
    elif entry == "indicators":
        def fn():
            ind = fin.calculate_wavelet_indicators(x)
            return _tensors(ind.trend_strength, ind.volatility_index, ind.support_resistance,
                            ind.momentum)

        def err(g, v):
            """In units of the case's bound: the momentum's error is scaled
            by TOL_F32 / TOL_MOMENTUM."""
            if len(g) != len(v):
                return math.inf
            return max(_relative_each(g[:3], v[:3]),
                       _relative(g[3], v[3]) * TOL_F32 / TOL_MOMENTUM)
    else:
        def fn():
            m = fin.analyze_market(x)
            regimes = [(k, list(type(v)).index(v)) for k, v in sorted(m.regime_map.items())]
            return _tensors([m.current_risk_level, m.max_drawdown], regimes,
                            list(m.regime_changes), [a.time_index for a in m.anomalies])

        def err(g, v):
            if any(a.shape != b.shape or not torch.equal(a, b) for a, b in zip(g[1:], v[1:])):
                return math.inf
            return _relative(g[0], v[0])

    _through(out, entry, fn, names, launches, serves, launches, lambda: _plain(fn),
             TOL_F32, on_card, err=err, mode=mode)


def analysis_cases() -> list[Case]:
    """Phase 2e's cases: every kernel-reaching case of the CWT family's
    mirrors (``tests/test_torch_cwt_mirror.py``,
    ``tests/test_torch_analysis_mirror.py``), at the JAX tests' shapes and
    seeds (float64 inputs cast to float32): the CWT's periodic inverses of
    ``tests/test_cwt.py``, the wavelet variance, covariance, correlation and
    variance stream of ``tests/test_variance_xwt.py`` and the analyzers of
    ``tests/test_finance.py`` that reach a kernel.  The coherence, the
    ridge, the significance tests, ``cwt2``, the SST, matching pursuit, the
    crash asymmetry (haar J=1, below the cascade kernels' two-level floor
    under either backend) and the tick stream take the FFT path or host
    code on the card and reach none."""
    out = []
    cw = "test_cwt.py"
    scales60 = (("scales", cwt_mod.scales_log(2, 256, 60)),)
    for name in ("morl", "mexh"):
        out.append(Case(f"cwt {name} periodic 1024, 60 scales, icwt", "cwt_inverse",
                        f"{cw}::test_icwt_periodic_near_exact", name, 0, (1024,),
                        data=("two_tone",), options=scales60 + (("entry", "icwt"),)))
    out.append(Case("cwt morl periodic 1024, 60 scales, reconstruct_band", "cwt_inverse",
                    f"{cw}::test_band_reconstruction_separates_components", "morl", 0,
                    (1024,), data=("two_tone",), options=scales60 + (("entry", "band"),)))
    out.append(Case("cwt morl periodic 1024, 60 scales, reconstruct_frequency_band",
                    "cwt_inverse", f"{cw}::test_reconstruct_frequency_band", "morl", 0,
                    (1024,), data=("two_tone",),
                    options=scales60 + (("entry", "frequency band"),)))

    vx = "test_variance_xwt.py"
    out.append(Case("wavelet_variance db4 J=6 65536", "variance",
                    f"{vx}::test_white_noise_variance_halves_per_level", "db4", 6, (1 << 16,),
                    data=("scaled", 0, 2.0)))
    out.append(Case("wavelet_variance biased sym5 J=5 4096", "variance",
                    f"{vx}::test_biased_estimator_energy_identity", "sym5", 5, (4096,),
                    data=("normal", 1), options=(("unbiased", False),)))
    for pair, other in (("same", "x"), ("opposite", "-x")):
        out.append(Case(f"wavelet_correlation db4 J=4 4096, x with {other}", "variance",
                        f"{vx}::test_correlation_identical_and_opposite", "db4", 4,
                        (4096,), data=("normal", 3),
                        options=(("entry", "correlation"), ("pair", pair))))
    out.append(Case("wavelet_covariance db4 J=4 2x16384", "variance",
                    f"{vx}::test_covariance_of_independent_series_is_small", "db4", 4,
                    (2, 1 << 14), data=("normal", 4), options=(("entry", "covariance"),)))
    out.append(Case("wavelet_variance db4 J=4 3x4096", "variance",
                    f"{vx}::test_variance_batch_and_jit", "db4", 4, (3, 4096),
                    data=("normal", 5)))
    out.append(Case("variance stream db4 J=4 1024 blocks 128", "variance_stream",
                    f"{vx}::test_variance_stream_matches_whole_signal", "db4", 4, (1024,),
                    data=("normal", 7), options=(("block", 128),)))
    out.append(Case("variance stream haar J=3 3x512 blocks 64", "variance_stream",
                    f"{vx}::test_variance_stream_batched_and_jittable", "haar", 3, (3, 512),
                    data=("normal", 8), options=(("block", 64),)))

    fi = "test_finance.py"
    out.append(Case("wavelet_sharpe_ratio db4 J=4 2048", "finance",
                    f"{fi}::test_wavelet_sharpe_denoises", "db4", 4, (2048,),
                    data=("sharpe_returns",), options=(("entry", "sharpe"),)))
    out.append(Case("analyze_market db4 J=3 1024", "finance", f"{fi}::test_analyze_market",
                    "db4", 3, (1024,), data=("prices", 6, 700), options=(("entry", "market"),)))
    out.append(Case("calculate_wavelet_indicators sym8 J=5 512", "finance",
                    f"{fi}::test_wavelet_indicators", "sym8", 5, (512,),
                    data=("prices", 8, None), options=(("entry", "indicators"),)))
    return out


#: the block denoise's bound against the plain route, of its largest value
#: (PERF.md section 2): its window energies are differences of one float32
#: prefix sum, which cancel, so a plane's last bits move a block's factor
TOL_BLOCK = 1e-4


def _hurst(case, x, w, out, on_card) -> None:
    """``hurst_exponent`` (its model and level window from the case): one
    ``wavelet_variance``, so one periodic cascade analysis launch where
    ``_kernel_eligible`` admits the series; the estimate and the per-level
    variances held to the plain route within 2e-5 of each one's largest
    value."""
    levels = case.levels
    kw = dict(model=case.option("model", "fgn"), min_level=case.option("min_level", 1),
              max_level=case.option("max_level"))

    def fn():
        r = vt.hurst_exponent(x, w, levels, **kw)
        return r.hurst, r.variance

    _through(out, "hurst", fn, ANALYSIS,
             lambda: int(ml._kernel_eligible(x, w, levels, "periodic")),
             lambda: kernel_serves(x, w, levels, "periodic", False), lambda: 1,
             lambda: _plain(fn), TOL_F32, on_card, err=_relative_each, mode="modwt_analysis")


def _block_denoise(case, x, w, out, on_card) -> None:
    """``denoise_block``: one periodic cascade analysis and one synthesis
    launch where ``_kernel_eligible`` admits each direction, the block
    shrinkage between them plain; held to the plain route within
    :data:`TOL_BLOCK` of the output's largest value."""
    levels = case.levels

    def fn():
        return vt.denoise_block(x, w, levels=levels)

    def launches():
        return sum(_pair_launches_1d(x, w, levels))

    def serves():
        return (kernel_serves(x, w, levels, "periodic", False)
                and kernel_serves(x, w, levels, "periodic", True))

    _through(out, "denoise_block", fn, ANALYSIS + SYNTHESIS, launches, serves, lambda: 2,
             lambda: _plain(fn), TOL_BLOCK, on_card, err=_relative)


def decimated_cases() -> list[Case]:
    """Phase 2f's cases: every kernel-reaching case of the 1-D analysis
    modules' mirrors (``tests/test_torch_decimated_mirror.py``,
    ``tests/test_torch_spectral_mirror.py``), at the JAX tests' shapes and
    seeds (float64 inputs cast to float32): ``hurst_exponent`` of
    ``tests/test_longmemory.py`` (a wavelet variance, so one cascade
    analysis), and ``denoise_block`` and ``denoise_multilevel`` (universal
    and FDR) of ``tests/test_block_fdr.py``.  The DWT's rolls (``wavedec``,
    so ``multifractal_spectrum`` and ``variance_change_test``), lifting,
    the FFT banks of the EWT and the scattering networks, ``block_shrink``
    and ``fdr_threshold`` reach no kernel on the card."""
    out = []
    lm = "test_longmemory.py"
    big = (1 << 15,)
    out.append(Case("hurst_exponent db4 J=8 32768, white noise", "hurst",
                    f"{lm}::test_hurst_white_noise_is_half", "db4", 8, big, data=("normal", 0)))
    out.append(Case("hurst_exponent db4 J=8 32768, random walk, fbm from level 3", "hurst",
                    f"{lm}::test_hurst_random_walk_is_half_fbm", "db4", 8, big,
                    data=("walk", 1), options=(("model", "fbm"), ("min_level", 3))))
    for h in (0.65, 0.85):
        out.append(Case(f"hurst_exponent db4 J=8 32768, fgn H {h}", "hurst",
                        f"{lm}::test_hurst_recovers_synthesized_fgn", "db4", 8, big,
                        data=("fgn", h, int(h * 100))))
    out.append(Case("hurst_exponent haar J=6 4x4096", "hurst",
                    f"{lm}::test_hurst_batched_and_jittable", "haar", 6, (4, 4096),
                    data=("normal", 3)))
    out.append(Case("hurst_exponent db4 J=6 8192, levels 2-5", "hurst",
                    f"{lm}::test_hurst_level_window_and_validation", "db4", 6, (8192,),
                    data=("normal", 4), options=(("min_level", 2), ("max_level", 5))))

    bf = "test_block_fdr.py"
    out.append(Case("denoise_multilevel db4 J=3 fdr 3x512", "denoise_method",
                    f"{bf}::test_fdr_batch_shapes_and_dispatch", "db4", 3, (3, 512),
                    data=("normal", 2), options=(("method", "fdr"),)))
    for n in (1000, 1024):
        out.append(Case(f"denoise_block sym8 J=5 {n}", "block_denoise",
                        f"{bf}::test_denoise_block_beats_universal_on_doppler", "sym8", 5,
                        (n,), data=("doppler", 5, 0.3)))
        out.append(Case(f"denoise_multilevel sym8 J=5 universal soft {n}", "denoise_method",
                        f"{bf}::test_denoise_block_beats_universal_on_doppler", "sym8", 5,
                        (n,), data=("doppler", 5, 0.3)))
    out.append(Case("denoise_block db4 J=4 2x512", "block_denoise",
                    f"{bf}::test_denoise_block_batched", "db4", 4, (2, 512),
                    data=("doppler", 6, 0.25)))
    return out


#: a FISTA solve's bound against the plain route, of its largest value
#: (PERF.md section 2): the solve is K float32 steps of a nonexpansive
#: iteration, and each step carries the last one's round-off (the kernels'
#: and the plain route's sums differ by a few ulps a step) into the next
TOL_SOLVE = 1e-4


def sines(n: int = 512, noise: float = 0.0, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """``tests/test_sparse.py::_sines``: (clean, noisy) two-tone sines."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, n, endpoint=False)
    clean = np.sin(2 * np.pi * 5 * t) + 0.5 * np.sin(2 * np.pi * 13 * t + 0.7)
    return clean, clean + noise * rng.standard_normal(n)


def compressed_sensing() -> tuple[np.ndarray, np.ndarray]:
    """``tests/test_sparse.py::test_sparse_recover_compressed_sensing``'s
    problem: a db4 J=4 signal on 256 samples with three active coefficients
    in each of the two finest detail planes (float32), and a 128 x 256
    Gaussian projection (float64, as the JAX test's float32 draw over a
    float64 square root is), drawn in the JAX test's order."""
    rng = np.random.default_rng(1)
    n, m = 256, 128
    planes = []
    for k in range(5):
        v = np.zeros(n, np.float32)
        if k < 2:
            v[rng.choice(n, 3, replace=False)] = 2.0 * rng.standard_normal(3)
        planes.append(torch.from_numpy(v))
    x_true = vt.imodwt_multilevel(vt.MultiLevelMODWTResult(tuple(planes[:4]), planes[4]),
                                  "db4", backend="torch")
    a_mat = rng.standard_normal((m, n)).astype(np.float32) / np.sqrt(m)
    return x_true.numpy(), a_mat


def inpaint2_problem() -> tuple[np.ndarray, np.ndarray]:
    """``tests/test_sparse.py::test_inpaint2_fills_missing_pixels``'s image
    (32 x 32) and mask (seed 1)."""
    rng = np.random.default_rng(1)
    yy, xx = np.meshgrid(np.linspace(0, 1, 32), np.linspace(0, 1, 32), indexing="ij")
    img = np.sin(2 * np.pi * 2 * xx) * np.cos(2 * np.pi * yy) + 0.5 * np.sin(2 * np.pi * (xx + yy))
    return img, (rng.random((32, 32)) > 0.3).astype(np.float32)


def gaussian_kernel(width: float, taps: int) -> np.ndarray:
    """``tests/test_deconvolve.py::_gaussian_kernel``: peak near index 0."""
    t = np.arange(taps) - taps // 2
    k = np.exp(-0.5 * (t / width) ** 2)
    return np.fft.ifftshift(k / k.sum())


def blur(x: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``tests/test_deconvolve.py::_blur``: circular blur of the last axis."""
    n = x.shape[-1]
    return np.fft.ifft(np.fft.fft(x) * np.fft.fft(kernel, n=n)).real


def gaussian_psf(width: float, taps: int, shape: tuple) -> np.ndarray:
    """``tests/test_deconvolve.py::_gaussian_psf`` padded to ``shape`` with
    its peak at (0, 0), as ``_blur2`` returns it."""
    t = np.arange(taps) - taps // 2
    g = np.exp(-0.5 * (t / width) ** 2)
    pad = np.zeros(shape)
    pad[:taps, :taps] = np.outer(g, g) / np.outer(g, g).sum()
    return np.roll(pad, (-(taps // 2), -(taps // 2)), axis=(0, 1))


def deconvolve_image(h: int = 64, w: int = 64) -> np.ndarray:
    """``tests/test_deconvolve.py::_test_image``: two cosines and an edge."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.sin(2 * np.pi * yy / 16) + 0.7 * np.cos(2 * np.pi * xx / 10)
    img[h // 2:, :] += 1.2
    return img


def synthetic_ticks(n: int = 5000, seed: int = 21) -> np.ndarray:
    """``tests/test_examples_and_fixtures.py::_synthetic_ticks``' prices."""
    rng = np.random.default_rng(seed)
    rets = rng.normal(0, 2e-4, n)
    jumps = rng.random(n) < 0.001
    rets[jumps] += rng.normal(0, 5e-3, jumps.sum())
    mid = 100 * np.exp(np.cumsum(rets))
    return mid * (1 + rng.normal(0, 5e-4, n))


def _solver_input(case: "Case") -> np.ndarray:
    kind = case.data[0]
    if kind == "sines":  # rows of (noise, seed) noisy sines
        return np.stack([sines(case.shape[-1], noise, seed)[1] for noise, seed in case.data[1]])
    if kind == "compressed_sensing":  # the signal to recover
        return compressed_sensing()[0]
    if kind == "inpaint2":  # the image at the observed pixels, zero elsewhere
        img, mask = inpaint2_problem()
        return img * mask
    if kind == "blurred":  # composite_sin rows blurred by a Gaussian, plus rng(42) noise
        _, (width, taps), sigma, seeds = case.data
        n = case.shape[-1]
        clean = np.stack([composite_sin(n, seed=s) for s in seeds]).reshape(case.shape)
        kernel = gaussian_kernel(width, taps) if taps else np.array([1.0])
        return blur(clean, kernel) + sigma * np.random.default_rng(42).standard_normal(case.shape)
    if kind == "blurred2":  # the test image blurred by a Gaussian PSF, plus rng(42) noise
        _, (width, taps), sigma = case.data
        h, w = case.shape[-2:]
        psf = gaussian_psf(width, taps, (h, w))
        blurred = np.fft.ifft2(np.fft.fft2(deconvolve_image(h, w)) * np.fft.fft2(psf)).real
        return np.broadcast_to(blurred, case.shape) + sigma * np.random.default_rng(
            42).standard_normal(case.shape)
    if kind == "ticks":
        return synthetic_ticks(case.shape[-1], case.data[1])
    if kind == "texture":  # tests/test_packets2d.py's weave plus rng(42) noise
        h, w = case.shape
        yy, xx = np.mgrid[0:h, 0:w]
        clean = np.sin(2 * np.pi * (27 * xx + 23 * yy) / w)
        return clean + 0.5 * np.random.default_rng(42).standard_normal((h, w))
    raise ValueError(f"unknown input {case.data!r}")


def _rms(a, b) -> float:
    return float(((a.double() - b.double()) ** 2).mean().sqrt())


def _solver(case, x, w, out, on_card) -> None:
    """The FISTA solvers (``entry``): ``bpdn`` (the batch, and each row's
    own solve), ``sparse_recover`` (the JAX test's projection, a matrix on
    the device) and ``inpaint2``.  A 1-D solve launches one cascade analysis
    for its first coefficients, a synthesis and (its backward, for the
    gradient) an analysis each step, and a synthesis at its end, where
    ``_kernel_eligible`` admits each direction; ``inpaint2`` launches the 2-D
    pair for its one-level probe, its first coefficients and its end, its
    steps' gradient running the plain 2-D cascade.  Held to the plain route
    within :data:`TOL_SOLVE` of the largest value, and to the JAX test's own
    check on the ``auto`` output."""
    levels, steps, entry = case.levels, case.option("steps"), case.option("entry")
    n = x.shape[-1]
    if entry == "bpdn":
        def fn():
            return vt.bpdn(x, w, levels=levels, steps=steps).signal
    elif entry == "sparse_recover":
        a_mat = torch.from_numpy(compressed_sensing()[1]).to(x.device)

        def forward(v):  # float64 measurements, as the JAX test's promotion gives
            return a_mat @ v.to(a_mat.dtype)

        def fn():
            return vt.sparse_recover(forward(x), forward, w, signal_shape=(n,), lam=1e-4,
                                     lam_init=1.0, steps=steps, levels=levels).signal
    else:
        mask = torch.from_numpy(inpaint2_problem()[1]).to(x.device)

        def fn():
            return vt.inpaint2(x, mask, w, levels=levels, steps=steps)

    def launches():
        if entry == "inpaint2":
            return (_pair_launches_2d(x, w, 1) + 2 * _pair_launches_2d(x, w, levels))
        a, s = _pair_launches_1d(x, w, levels)
        return (a + s) * (steps + 1)

    def serves():
        if entry == "inpaint2":
            return x.device.type == "cpu" or k2.kernel_refusal(x, w, levels, "periodic") is None
        return (kernel_serves(x, w, levels, "periodic", False)
                and kernel_serves(x, w, levels, "periodic", True))

    names = ANALYSIS_2D + SYNTHESIS_2D if entry == "inpaint2" else ANALYSIS + SYNTHESIS
    got = _through(out, entry, fn, names, launches, serves, launches, lambda: _plain(fn),
                   TOL_SOLVE, on_card, err=_relative)
    if entry == "bpdn" and x.dim() > 1:
        with using_backend("auto"):
            rows = torch.stack([vt.bpdn(x[k], w, levels=levels, steps=steps).signal
                                for k in range(x.shape[0])])
        out.bound("auto batch rows against their own solves", _err(got, rows), TOL_F32)
    elif entry == "sparse_recover":  # the JAX test's recovery, measured 0.087
        rel = float(torch.linalg.vector_norm(got - x) / torch.linalg.vector_norm(x))
        out.bound("auto relative recovery error", rel, 0.15)
    elif entry == "inpaint2":
        img, mask_np = inpaint2_problem()
        miss = torch.from_numpy(mask_np == 0).to(x.device)
        clean = torch.from_numpy(img).to(x.device)
        moved = float((got - x)[~miss].abs().max())
        if moved:
            out.faults.append(f"auto inpaint2: the observed pixels moved, by {moved:.3e}")
        rel = _rms(got[miss], clean[miss]) / float(clean.std())
        out.bound("auto missing pixels' relative error", rel, 0.1)


def _deconvolve(case, x, w, out, on_card) -> None:
    """ForWaRD deconvolution, ``deconvolve`` (1-D, the Gaussian ``kernel``
    of the case or the identity) or ``deconvolve2`` (the Gaussian PSF): the
    one-level noise probe (plain in 1-D, below the cascade's two levels; the
    2-D pair where ``modwt2_kernel_eligible`` admits one level), then the
    wavelet step's analysis and synthesis, each where its gate admits it.
    Held to the plain route within 2e-5 of the largest value (the hard
    threshold is a function of the probe's sigma, which both routes share,
    so only a coefficient within round-off of its threshold could flip)."""
    levels, two_d = case.levels, case.option("entry") == "deconvolve2"
    width, taps = case.data[1]
    sigma = case.option("sigma")
    if two_d:
        kernel = gaussian_psf(width, taps, tuple(x.shape[-2:]))

        def fn():
            return vt.deconvolve2(x, kernel, w, levels=levels).signal

        def launches():
            return _pair_launches_2d(x, w, 1) + 2 * _pair_launches_2d(x, w, levels)

        def serves():
            return x.device.type == "cpu" or k2.kernel_refusal(x, w, levels, "periodic") is None

        names = ANALYSIS_2D + SYNTHESIS_2D
    else:
        kernel = gaussian_kernel(width, taps) if taps else np.array([1.0])

        def fn():
            return vt.deconvolve(x, kernel, w, levels=levels, sigma=sigma).signal

        def launches():
            return sum(_pair_launches_1d(x, w, levels))

        def serves():
            return (kernel_serves(x, w, levels, "periodic", False)
                    and kernel_serves(x, w, levels, "periodic", True))

        names = ANALYSIS + SYNTHESIS
    _through(out, case.option("entry"), fn, names, launches, serves, launches,
             lambda: _plain(fn), TOL_F32, on_card, err=_relative)


def _calibrate(case, x, w, out, on_card) -> None:
    """``cost_model.calibrate`` on the case's device at its sizes, batch and
    depth, not persisted: one warm-up and ten timed round trips a size, each
    a cascade analysis and a synthesis launch where ``_kernel_eligible``
    admits each.  Its rate must be positive and finite on each route."""
    from vectorwave_tpu_torch import cost_model

    sizes, batch = case.shape[-1:], case.shape[0]

    def fn():
        rate = cost_model.calibrate(sizes=sizes, batch=batch, levels=case.levels,
                                    wavelet=case.wavelet, persist=False, device=x.device)
        return torch.tensor(rate, dtype=torch.float64)

    def launches():
        a, s = _pair_launches_1d(x, w, case.levels)
        return 11 * (a + s) * len(sizes)

    def positive(g, v):
        return 0.0 if all(math.isfinite(float(r)) and float(r) > 0 for r in (g, v)) else math.inf

    _through(out, "calibrate", fn, ANALYSIS + SYNTHESIS, launches,
             lambda: kernel_serves(x, w, case.levels, "periodic", False), launches,
             lambda: _plain(fn), TOL_F32, on_card, err=positive)


def _modwt_icwt(case, x, w, out, on_card) -> None:
    """``modwt_based_icwt``: ``cwt`` (morl, periodic, the case's scales: the
    FFT path under ``auto`` above ``AUTO_KERNEL_DIRECT_MAX_HALF``, the bank
    a chunk under ``kernel``), the approximation of a ``modwt_multilevel``
    (one cascade analysis where ``_kernel_eligible`` admits it) and the
    inverse's ``imodwt_multilevel`` at the depth the scales map to (its
    synthesis where admitted).  The reconstruction held to the plain route
    within 2e-5 of its largest value and, under ``auto``, to the JAX test's
    NRMSE of 0.15."""
    from vectorwave_tpu_torch.transforms.cwt_modwt_inverse import modwt_based_icwt

    scales = case.option("scales")
    icwt_levels = max(2, min(vt.max_levels(x.shape[-1], w), int(math.log2(max(scales)))))

    def fn():
        res = vt.cwt(x, scales, "morl", boundary="periodic")
        ref = vt.modwt_multilevel(x, w, levels=case.levels)
        return modwt_based_icwt(res, "morl", modwt_wavelet=case.wavelet, approx=ref.approx)

    def launches():
        return (cwt_launches(x, scales) + _pair_launches_1d(x, w, case.levels)[0]
                + _pair_launches_1d(x, w, icwt_levels)[1])

    got = _through(out, "modwt_based_icwt", fn, ANALYSIS + BANK_ANALYSIS + SYNTHESIS, launches,
                   lambda: cwt_serves(x, scales), launches, lambda: _plain(fn), TOL_F32,
                   on_card, err=_relative)
    out.bound("auto NRMSE against x", _rms(got, x) / float(x.double().std()), 0.15)


def _checkpoint(case, x, w, out, on_card) -> None:
    """A kernel-tier block stream checkpointed after its first block: the
    carry written with ``np.savez``, read back onto the device and stepped;
    the restored stream's second block must equal the live one's bit for bit.
    One external-edge analysis launch a block step (three) where
    ``stream.use_stream_kernel`` routes it; the blocks held to the
    whole-signal plain transform within 2e-5 of the largest value."""
    from vectorwave_tpu_torch import streaming as st

    levels, b = case.levels, case.boundary
    blocks = _blocks(x, case.option("block"))

    def step(state, block):
        return st.modwt_stream_block_kernel(state, block, w, levels=levels, boundary=b)

    def fn():
        state = st.kernel_streaming_init(w, levels, batch_shape=tuple(x.shape[:-1]),
                                         dtype=x.dtype, device=x.device)
        state, first = step(state, blocks[0])
        buf = io.BytesIO()
        np.savez(buf, history=state.history.cpu().numpy(), blocks=state.blocks_processed)
        buf.seek(0)
        saved = np.load(buf)
        restored = type(state)(torch.from_numpy(saved["history"]).to(x.device),
                               int(saved["blocks"]))
        live, resumed = step(state, blocks[1])[1], step(restored, blocks[1])[1]
        if not all(torch.equal(p, q) for p, q in zip(_planes(live), _planes(resumed))):
            out.faults.append(f"{vt.get_backend()}: the restored stream's block differs")
        return _joined([first, live])

    def launches():
        return stream_launches([blocks[0], blocks[1], blocks[1]], w, levels, vt.get_backend())

    def serves():
        return x.device.type == "cpu" or mc.analysis_tile(w.filter_length, levels) is not None

    _through(out, "analysis", fn, ANALYSIS, launches, serves, launches,
             lambda: _planes(vt.modwt_multilevel(x, w, levels=levels, boundary=b,
                                                 backend="torch")),
             TOL_F32, on_card, err=_relative, mode="modwt_analysis_external")


def solver_cases() -> list[Case]:
    """Phase 2g's cases: every kernel-reaching case of the mirrors of the
    2-D trees, the solvers and the infrastructure
    (``tests/test_torch_trees2d_mirror.py``,
    ``tests/test_torch_solvers_mirror.py``), at the JAX tests' shapes and
    seeds (float64 inputs cast to float32): the FISTA solvers and the
    deconvolutions of ``tests/test_sparse.py`` and
    ``tests/test_deconvolve.py``, the cost model's calibration and the
    MODWT-based inverse CWT of ``tests/test_infrastructure.py``, the tick
    denoise and the checkpointed stream of
    ``tests/test_examples_and_fixtures.py`` (the stream on its kernel tier:
    the JAX test's plain block step reaches none), and ``denoise2`` of
    ``tests/test_packets2d.py``.  The solves at the default depth on 256 or
    512 samples (db8 J=5-6, db4 J=6: ``bpdn`` and ``inpaint`` of
    ``test_sparse.py``) keep the plain cascade under either backend, their
    halo past N; the dual tree and the quadtree (decimated rolls), the
    facade's convolutions, ``fista`` alone, the level responses and the
    incremental finance stream reach no kernel."""
    out = []
    sp = "test_sparse.py"
    out.append(Case("bpdn db4 J=4 2x512, 40 steps", "solver",
                    f"{sp}::test_bpdn_batched_equals_individual", "db4", 4, (2, 512),
                    data=("sines", ((0.3, 1), (0.5, 2))),
                    options=(("entry", "bpdn"), ("steps", 40))))
    out.append(Case("sparse_recover db4 J=4 256, 400 steps", "solver",
                    f"{sp}::test_sparse_recover_compressed_sensing", "db4", 4, (256,),
                    data=("compressed_sensing",),
                    options=(("entry", "sparse_recover"), ("steps", 400))))
    out.append(Case("inpaint2 db4 J=2 32x32, 80 steps", "solver",
                    f"{sp}::test_inpaint2_fills_missing_pixels", "db4", 2, (32, 32),
                    data=("inpaint2",), options=(("entry", "inpaint2"), ("steps", 80))))

    dc = "test_deconvolve.py"
    for label, test, levels, n, kernel, sigma, given in (
            ("sym8 J=4 2048", "test_deconvolve_beats_blurred_input", 4, 2048, (4.0, 33),
             0.05, None),
            ("sym8 J=4 1024, sigma given", "test_deconvolve_beats_naive_inverse", 4, 1024,
             (6.0, 65), 0.05, 0.05),
            ("sym8 J=4 1024, noiseless", "test_noiseless_recovery_is_tight", 4, 1024,
             (2.0, 17), 0.0, 1e-8),
            ("sym8 J=4 1024, identity kernel", "test_identity_kernel_reduces_to_denoising", 4,
             1024, (None, 0), 0.3, None)):
        out.append(Case(f"deconvolve {label}", "deconvolve", f"{dc}::{test}", "sym8", levels,
                        (n,), data=("blurred", kernel, sigma, (7,)),
                        options=(("entry", "deconvolve"), ("sigma", given))))
    out.append(Case("deconvolve db4 J=3 2x512", "deconvolve", f"{dc}::test_batched_and_jitted",
                    "db4", 3, (2, 512), data=("blurred", (3.0, 17), 0.05, (7, 9)),
                    options=(("entry", "deconvolve"),)))
    out.append(Case("deconvolve2 sym4 J=3 64x64", "deconvolve",
                    f"{dc}::test_deconvolve2_beats_blurred_input", "sym4", 3, (64, 64),
                    data=("blurred2", (1.8, 11), 0.05), options=(("entry", "deconvolve2"),)))
    out.append(Case("deconvolve2 db4 J=2 2x32x32", "deconvolve",
                    f"{dc}::test_deconvolve2_batched_jit", "db4", 2, (2, 32, 32),
                    data=("blurred2", (1.2, 7), 0.03), options=(("entry", "deconvolve2"),)))

    inf = "test_infrastructure.py"
    out.append(Case("cost_model.calibrate db4 J=3 2x1024", "calibrate",
                    f"{inf}::test_cost_model_estimate_and_calibration", "db4", 3, (2, 1024),
                    data=("zeros",)))
    out.append(Case("modwt_based_icwt morl 48 scales, sym4 J=5 1024", "modwt_icwt",
                    f"{inf}::test_modwt_based_icwt", "sym4", 5, (1024,), data=("two_tone",),
                    options=(("scales", cwt_mod.scales_log(2, 256, 48)),)))

    ef = "test_examples_and_fixtures.py"
    out.append(Case("denoise_multilevel sym8 J=5 universal 5000 ticks", "denoise_method",
                    f"{ef}::test_tick_data_denoising_recovers_mid_price", "sym8", 5, (5000,),
                    data=("ticks", 21), options=(("method", "universal"), ("relative", True))))
    out.append(Case("checkpoint kernel stream db4 J=3 zero 1024 blocks 512", "checkpoint",
                    f"{ef}::test_streaming_state_checkpoint_roundtrip", "db4", 3, (1024,),
                    "zero", data=("ticks", 21), options=(("block", 512),)))

    out.append(Case("denoise2 sym8 J=3 64x64, texture", "twod_denoise",
                    "test_packets2d.py::test_denoise_packet2_beats_pyramid_on_texture", "sym8",
                    3, (64, 64), data=("texture",)))
    return out


RUNNERS = {"pair": _pair, "exact": _exact, "denoise": _denoise, "roundtrip": _roundtrip,
           "nrmse": _nrmse, "packets": _packets, "packet_tools": _packet_tools,
           "dual_tree": _dual_tree,
           "dual_tree_denoise": _dual_tree_denoise, "cwt": _cwt, "twod": _twod,
           "twod_denoise": _twod_denoise, "fused_symmetric": _fused_symmetric,
           "symmetric_gradient": _symmetric_gradient, "denoise_method": _denoise_method,
           "batch": _batch_facade, "stream": _stream, "stream_denoise": _stream_denoise,
           "window": _window, "tiled": _tiled, "tiled_exact": _tiled_exact,
           "tiled2d": _tiled2d, "cwt_inverse": _cwt_inverse, "variance": _variance,
           "variance_stream": _variance_stream, "finance": _finance, "hurst": _hurst,
           "block_denoise": _block_denoise, "solver": _solver, "deconvolve": _deconvolve,
           "calibrate": _calibrate, "modwt_icwt": _modwt_icwt, "checkpoint": _checkpoint}


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


#: phase 2d's cases by the mirror file that holds them
TIER_KINDS = {"streaming": ("stream", "stream_denoise", "window"),
              "parallel": ("tiled", "batch", "tiled2d", "tiled_exact", "exact")}


def tier_labels(tier: str) -> list[str]:
    """The labels of ``tier``'s phase 2d cases (a key of :data:`TIER_KINDS`)."""
    return [c.label for c in tier_cases() if c.kind in TIER_KINDS[tier]]


#: phase 2e's cases by the mirror file that holds them
ANALYSIS_KINDS = {"cwt": ("cwt_inverse",),
                  "analysis": ("variance", "variance_stream", "finance")}


def analysis_labels(group: str) -> list[str]:
    """The labels of ``group``'s phase 2e cases (a key of :data:`ANALYSIS_KINDS`)."""
    return [c.label for c in analysis_cases() if c.kind in ANALYSIS_KINDS[group]]


#: phase 2f's cases by the mirror file that holds them (the spectral
#: mirror's EWT and scattering networks reach no kernel)
DECIMATED_KINDS = {"decimated": ("hurst", "denoise_method", "block_denoise")}


def decimated_labels(group: str) -> list[str]:
    """The labels of ``group``'s phase 2f cases (a key of :data:`DECIMATED_KINDS`)."""
    return [c.label for c in decimated_cases() if c.kind in DECIMATED_KINDS[group]]


#: phase 2g's cases by the mirror file that holds them (the trees' mirror
#: reaches a kernel only through ``denoise2``, held with the solvers)
SOLVER_KINDS = {"solvers": ("solver", "deconvolve", "calibrate", "modwt_icwt",
                            "denoise_method", "checkpoint", "twod_denoise")}


def solver_labels(group: str) -> list[str]:
    """The labels of ``group``'s phase 2g cases (a key of :data:`SOLVER_KINDS`)."""
    return [c.label for c in solver_cases() if c.kind in SOLVER_KINDS[group]]


def cpu_problems(label: str) -> list[str]:
    """Run the phase 2c, 2d, 2e, 2f or 2g case ``label`` on CPU tensors and
    return what is wrong: its faults, any route that is not the plain one (a
    CPU tensor launches nothing and ``backend='kernel'`` refuses nothing),
    and any launch counted."""
    case = next(c for c in family_cases() + tier_cases() + analysis_cases()
                + decimated_cases() + solver_cases() if c.label == label)
    before = dict(mc.LAUNCHES)
    out = run_case(case, "cpu")
    problems = list(out.faults)
    problems += [f"{k}: {v}" for k, v in out.routes.items()
                 if v != "plain" and not v.startswith("raised (")]
    if mc.LAUNCHES != before:
        problems.append("a launch was counted")
    return problems


def summary(outcomes: list[Outcome]) -> dict:
    """Cases, cases on a kernel and on the plain route under ``auto``,
    refusals under ``kernel`` (and refusals by design, which the runner
    names), and the worst error against each bound."""
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
        "refused_by_design": sum(any(v.startswith("raised (") for v in o.routes.values())
                                 for o in outcomes),
        "worst": {f"{b:g}": e for b, e in sorted(worst.items())},
        "faults": sum(len(o.faults) for o in outcomes),
    }
