"""The kernel-reaching cases of the MODWT core's test mirrors, run on the card.

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

Bounds (PERF.md section 2): a float32 kernel against the float32 plain route
2e-5 max abs (fp32 in another summation order, values of order 1; the plain
periodic route of a CUDA tensor may take the FFT, which differs by 3.3e-6);
the exact tier's hi + lo against the plain float64 cascade 1e-13 and its
round trip within 1e-10 RMSE of the input; the symmetric round trip's
interior NRMSE within 10% above the JAX tests' committed baseline
(``tests/baselines/symmetric_nrmse_baseline.json``).
"""

from __future__ import annotations

import json
import math
import pathlib
from typing import NamedTuple

import numpy as np
import torch

import vectorwave_tpu_torch as vt
from vectorwave_tpu_torch.errors import InvalidArgumentError
from vectorwave_tpu_torch.kernels import modwt_composite as mc
from vectorwave_tpu_torch.kernels import modwt_symmetric as ms
from vectorwave_tpu_torch.ops.thresholds import apply_threshold, mad_sigma, universal_threshold
from vectorwave_tpu_torch.transforms import multilevel as ml

TOL_F32 = 2e-5
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
    ``nrmse`` (the symmetric round trip's interior NRMSE guard).  ``source``
    names the JAX test it mirrors; ``data`` how its input is made."""

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
        raise ValueError(f"unknown input {case.data!r}")
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


def _err(got, want) -> float:
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    return max(float((g.double() - v.double()).abs().max()) for g, v in zip(got, want))


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

    def route(self, backend: str, direction: str, launches: int, expected: bool,
              on_card: bool) -> None:
        """Record a direction's route; on the card a launch must come exactly
        where ``expected``, on the CPU never."""
        self.routes[f"{backend} {direction}"] = "kernel" if launches else "plain"
        want = expected and on_card
        if bool(launches) != want:
            self.faults.append(f"{backend} {direction}: {launches} launches where the gate "
                               f"says {'kernel' if want else 'plain'}")

    def refused(self, backend: str, direction: str, serves: bool, on_card: bool) -> None:
        self.routes[f"{backend} {direction}"] = "raised"
        if serves or not on_card:
            self.faults.append(f"{backend} {direction}: refused a call the kernels serve")

    @property
    def ok(self) -> bool:
        return not self.faults


def _pair(case, x, w, out, on_card) -> None:
    prec, tol = case.option("precision"), case.option("tolerance")
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
    out.bound("auto planes", _err(_planes(res), _planes(plain)), TOL_F32)
    out.bound("auto inverse", _err(y, plain_y), TOL_F32)
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
        out.bound(f"kernel {direction}", _err(got, want), TOL_F32)
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
        rmse = float((y.double() - x.double()).pow(2).mean().sqrt())
        out.bound(f"{backend} round trip rmse", rmse, EXACT_RT_RMSE)


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
    eligible = (ml._kernel_eligible(x, w, case.levels, case.boundary) and case.levels >= 2
                and mc.denoise_tile(w.filter_length, case.levels) is not None)
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


RUNNERS = {"pair": _pair, "exact": _exact, "denoise": _denoise, "roundtrip": _roundtrip,
           "nrmse": _nrmse}


def run_case(case: Case, device) -> Outcome:
    """Run one case on ``device`` (module docstring); never raises for a
    fault of the port: the faults are in the outcome."""
    x = torch.from_numpy(case_input(case)).to(device)
    w = vt.wavelet(case.wavelet)
    out = Outcome(case)
    with torch.no_grad():
        RUNNERS[case.kind](case, x, w, out, x.device.type == "cuda")
    return out


def summary(outcomes: list[Outcome]) -> dict:
    """Cases, cases on a kernel and on the plain route under ``auto``,
    refusals under ``kernel``, and the worst error against each bound."""
    auto = [o for o in outcomes if any(k.startswith("auto") for k in o.routes)]
    on_kernel = sum(any(v == "kernel" for k, v in o.routes.items() if k.startswith("auto"))
                    for o in auto)
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
