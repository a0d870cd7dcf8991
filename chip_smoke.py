#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU and check it.

Run from the root of a checkout, with one Hopper card visible:

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is not 0:

0. device: print ``nvidia-smi``'s name and power limit; stop if
   ``torch.cuda.is_available()`` is false;
1. build: compile the five CUDA kernels from ``vectorwave_tpu_torch/kernels/csrc``
   (one nvcc per source, all started together);
2. kernels against their plain PyTorch versions on the card (db4, 6 levels):
   analysis, synthesis and denoise (none/soft/hard) at 128x65536 periodic,
   3x5000 zero and 2x300 periodic in float32, and once in bfloat16; the
   exact fp64 analysis and synthesis at the same three shapes, with a lo
   word, from a first level above 1, with the levels split over two
   launches (sym8, 10 levels), and with levels too deep for shared memory
   read straight from device memory (db38, 9 levels);
3. the main path through the public entry points at 128x65536 float32:
   ``modwt_multilevel`` -> ``imodwt_multilevel`` at every precision tier,
   ``modwt_roundtrip_fused`` and ``denoise_multilevel``, with the launch
   counters reset just before and read just after; then the gradients of
   analysis and synthesis against plain autograd, and a small input against
   the float64 plain cascade on the CPU; then the exact path, with its own
   reset and reading of the counters: ``precision='exact'`` and
   ``tolerance=1e-10`` round trips (RMSE of hi + lo against x <= 1e-10), the
   exact symmetric analysis against the float64 plain cascade on the CPU,
   and an input that requires grad, which must raise;
4. timing with CUDA events (3 warm-ups, median of 20 runs) of each kernel
   beside its plain version and of the public entry points.

The last two lines are a JSON object with one entry per kernel and the
device line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

SEED = 0
BATCH, N, LEVELS, WAVELET = 128, 65536, 6, "db4"
#: float32 kernel vs plain version: both compute in fp32 and differ only in
#: summation order and fused multiply-adds, a few ulps of values of order 1.
TOL_F32 = 2e-5
#: bfloat16: both round the same fp32 values to bfloat16, so they may differ
#: by one bfloat16 ulp, at most 2^-7 of the largest output.
BF16_ULP = 2.0**-7
#: public round trip against x (the float32 tier's contract at this shape)
RT_RMSE, RT_MAX = 3e-7, 3e-6
#: exact kernels vs their plain versions, on hi + lo: both compute in fp64
#: and differ only in fused multiply-adds, for unit-variance data.
TOL_EXACT = 1e-13
#: the exact tier's round trip (BASELINE.json's parity bar), and its
#: symmetric analysis against the float64 plain cascade.
EXACT_RMSE, EXACT_SYM = 1e-10, 1e-12

KERNELS = {
    "modwt_analysis": (
        "vectorwave_tpu_torch/kernels/csrc/modwt_analysis.cu",
        "vectorwave_tpu/kernels/modwt_mxu.py:688",
    ),
    "modwt_synthesis": (
        "vectorwave_tpu_torch/kernels/csrc/modwt_synthesis.cu",
        "vectorwave_tpu/kernels/modwt_mxu.py:910",
    ),
    "modwt_denoise": (
        "vectorwave_tpu_torch/kernels/csrc/modwt_denoise.cu",
        "vectorwave_tpu/kernels/modwt_mxu.py:1338",
    ),
    "modwt_exact_analysis": (
        "vectorwave_tpu_torch/kernels/csrc/modwt_exact_analysis.cu",
        "vectorwave_tpu/kernels/modwt_exact.py:241",
    ),
    "modwt_exact_synthesis": (
        "vectorwave_tpu_torch/kernels/csrc/modwt_exact_synthesis.cu",
        "vectorwave_tpu/kernels/modwt_exact.py:386",
    ),
}
MAIN_PATH = ("modwt_analysis", "modwt_synthesis", "modwt_denoise")
EXACT_PATH = ("modwt_exact_analysis", "modwt_exact_synthesis")


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    print(f"  {'ok  ' if ok else 'FAIL'} {what}", flush=True)
    if not ok:
        raise SmokeFailure(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def gap_thresholds(planes, levels):
    """[B, J] thresholds, each in the widest gap between consecutive sorted
    |d| values between the 50th and 95th percentile of its (signal, level):
    fp32 summation-order differences between two implementations cannot
    then flip a hard-threshold decision."""
    cols = []
    for j in range(levels):
        s = torch.sort(planes[j].abs().float(), dim=-1).values
        n = s.shape[-1]
        lo, hi = n // 2, max(int(0.95 * n), n // 2 + 2)
        i = torch.argmax(s[:, lo + 1 : hi] - s[:, lo : hi - 1], dim=-1, keepdim=True) + lo
        cols.append((torch.gather(s, 1, i) + torch.gather(s, 1, i + 1)) / 2)
    return torch.cat(cols, dim=1).contiguous()


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def pair_err(got, want) -> float:
    """Max |hi + lo - (hi' + lo')| over plane pairs, combined in float64."""
    return max((g[0].double() + g[1].double() - w[0].double() - w[1].double())
               .abs().max().item() for g, w in zip(got, want))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a "
              "CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import vectorwave_tpu_torch as vt
    from vectorwave_tpu_torch.denoise.denoiser import _fused_sigma
    from vectorwave_tpu_torch.kernels import _build
    from vectorwave_tpu_torch.kernels import modwt_composite as mc
    from vectorwave_tpu_torch.kernels.modwt_fused import _kernel_filters
    from vectorwave_tpu_torch.ops.thresholds import universal_threshold

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    smi = nvidia_smi()

    print("phase 0: device", flush=True)
    print(smi, flush=True)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"capability {torch.cuda.get_device_capability(0)}", flush=True)

    print("phase 1: build", flush=True)
    t0 = time.perf_counter()
    lib = _build.library()
    print(f"  built {os.path.basename(lib._name)} from "
          f"{len([p for p in _build.sources() if p.suffix == '.cu'])} sources in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    print("phase 2: kernels against their plain versions (db4, 6 levels)", flush=True)
    w = vt.wavelet(WAVELET)
    fd, fr = _kernel_filters(w, synthesis=False), _kernel_filters(w, synthesis=True)
    worst = {name: 0.0 for name in KERNELS}
    worst_bf16 = {name: 0.0 for name in KERNELS}
    cases = [
        (BATCH, N, True, torch.float32),
        (3, 5000, False, torch.float32),
        (2, 300, True, torch.float32),
        (BATCH, N, True, torch.bfloat16),
    ]
    for b, n, periodic, dtype in cases:
        x = torch.randn(b, n, device=dev, generator=gen).to(dtype)
        label = f"{b}x{n} {'periodic' if periodic else 'zero'} {str(dtype)[6:]}"
        plain = mc.analysis_plain(x, LEVELS, fd, periodic)
        results = [
            ("modwt_analysis", "", mc.analysis(x, LEVELS, fd, periodic), plain),
            ("modwt_synthesis", "",
             mc.synthesis(plain, LEVELS, fr, periodic),
             mc.synthesis_plain(plain, LEVELS, fr, periodic)),
        ]
        th = gap_thresholds(mc._analysis_cascade(x, LEVELS, fd, periodic), LEVELS)
        for mode in ("none", "soft", "hard"):
            results.append((
                "modwt_denoise", f" {mode}",
                mc.denoise(x, th, LEVELS, fd, fr, periodic, mode),
                mc.denoise_plain(x, th, LEVELS, fd, fr, periodic, mode),
            ))
        torch.cuda.synchronize()
        for name, tag, got, want in results:
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max(max_err(g, p) for g, p in zip(got, want))
            if dtype == torch.float32:
                tol = TOL_F32
                worst[name] = max(worst[name], err)
            else:
                tol = BF16_ULP * max(p.float().abs().max().item() for p in want)
                worst_bf16[name] = max(worst_bf16[name], err)
            check(err <= tol, f"{name}{tag} {label}: max |kernel - plain| "
                              f"{err:.3e} <= {tol:.3e}")

    # exact fp64 kernels: (wavelet, batch, n, periodic, first level, levels, lo word)
    exact_cases = [
        (WAVELET, BATCH, N, True, 1, LEVELS, False),
        (WAVELET, 3, 5000, False, 1, LEVELS, False),
        (WAVELET, 2, 300, True, 1, LEVELS, False),
        (WAVELET, 8, 65536, True, 1, LEVELS, True),
        (WAVELET, 4, 8192, False, 3, 2, True),
        ("sym8", 2, 16384, True, 1, 10, False),  # two launches each
        ("db38", 2, 32768, False, 1, 9, False),  # levels 8-9 run direct
    ]
    for name, b, n, periodic, first, levels, with_lo in exact_cases:
        wx = vt.wavelet(name)
        ed, er = _kernel_filters(wx, synthesis=False), _kernel_filters(wx, synthesis=True)
        x = torch.randn(b, n, device=dev, generator=gen)
        x_lo = (x * 2.0**-26 * torch.randn(b, n, device=dev, generator=gen)
                if with_lo else None)
        label = (f"{name} {b}x{n} {'periodic' if periodic else 'zero'} levels "
                 f"{first}..{first + levels - 1}{' with lo' if with_lo else ''}")
        before = dict(mc.LAUNCHES)
        want = mc.exact_analysis_plain(x, x_lo, levels, ed, periodic, first)
        got = mc.exact_analysis(x, x_lo, levels, ed, periodic, first)
        y_want = mc.exact_synthesis_plain(want, levels, er, periodic, first)
        y_got = mc.exact_synthesis(want, levels, er, periodic, first)
        torch.cuda.synchronize()
        launched = {k: mc.LAUNCHES[k] - before[k] for k in EXACT_PATH}
        for kname, err in (("modwt_exact_analysis", pair_err(got, want)),
                           ("modwt_exact_synthesis", pair_err((y_got,), (y_want,)))):
            worst[kname] = max(worst[kname], err)
            check(err <= TOL_EXACT and launched[kname] >= 1,
                  f"{kname} {label}: max |kernel - plain| {err:.3e} <= {TOL_EXACT:.0e} "
                  f"({launched[kname]} launches)")

    print(f"phase 3: main path through the public entry points, "
          f"{BATCH}x{N} float32", flush=True)
    x = torch.randn(BATCH, N, device=dev, generator=gen)
    t = torch.arange(N, device=dev, dtype=torch.float32)
    clean = (torch.sin(2 * math.pi * t / 32.0) + 0.5 * torch.sin(2 * math.pi * t / 8.0)
             + 0.25 * torch.sin(2 * math.pi * t / 128.0 + 0.6)).expand(BATCH, N)
    noisy = (clean + 0.5 * torch.randn(BATCH, N, device=dev, generator=gen)).contiguous()
    mc.reset_launches()
    for tier in ("float32", "bf16_3x", "bf16"):
        res = vt.modwt_multilevel(x, WAVELET, levels=LEVELS, precision=tier)
        y = vt.imodwt_multilevel(res, WAVELET, precision=tier)
        rmse = (y - x).pow(2).mean().sqrt().item()
        check(rmse <= RT_RMSE and max_err(y, x) <= RT_MAX,
              f"round trip {tier}: rmse {rmse:.3e} <= {RT_RMSE:.0e}, "
              f"max {max_err(y, x):.3e} <= {RT_MAX:.0e}")
    y = vt.modwt_roundtrip_fused(x, WAVELET, levels=LEVELS)
    rmse = (y - x).pow(2).mean().sqrt().item()
    check(rmse <= RT_RMSE and max_err(y, x) <= RT_MAX,
          f"modwt_roundtrip_fused: rmse {rmse:.3e}, max {max_err(y, x):.3e}")
    den = vt.denoise_multilevel(noisy, WAVELET, levels=LEVELS, method="universal",
                                mode="soft")
    torch.cuda.synchronize()
    launches = dict(mc.LAUNCHES)
    print(f"  launches during the main path: {launches}", flush=True)
    for name in MAIN_PATH:
        check(launches[name] > 0, f"{name} launched {launches[name]} times")

    sigma = _fused_sigma(noisy, w, "periodic")
    ths = torch.cat([universal_threshold(N, sigma / math.sqrt(2.0**j)).float()
                     for j in range(1, LEVELS + 1)], dim=-1).contiguous()
    den_plain = mc.denoise_plain(noisy, ths, LEVELS, fd, fr, True, "soft")
    check(den.shape == noisy.shape and bool(torch.isfinite(den).all()),
          f"denoise_multilevel output finite, shape {tuple(den.shape)}")
    check(max_err(den, den_plain) <= TOL_F32,
          f"denoise_multilevel vs plain path: {max_err(den, den_plain):.3e}")

    weights = [torch.randn(BATCH, N, device=dev, generator=gen) for _ in range(LEVELS + 1)]
    xg = x.clone().requires_grad_(True)
    grads = []
    for backend in ("kernel", "torch"):
        res = vt.modwt_multilevel(xg, WAVELET, levels=LEVELS, backend=backend)
        loss = sum((p * wt).sum() for p, wt in zip((*res.details, res.approx), weights))
        grads.append(torch.autograd.grad(loss, xg)[0])
    check(max_err(*grads) <= TOL_F32,
          f"analysis gradient, kernel vs plain autograd: {max_err(*grads):.3e}")
    planes = [p.detach().clone().requires_grad_(True) for p in mc.analysis(x, LEVELS, fd, True)]
    grads = []
    for backend in ("kernel", "torch"):
        y = vt.imodwt_multilevel(
            vt.MultiLevelMODWTResult(tuple(planes[:LEVELS]), planes[LEVELS]),
            WAVELET, backend=backend)
        grads.append(torch.autograd.grad((y * weights[0]).sum(), planes))
    err = max(max_err(a, b) for a, b in zip(*grads))
    check(err <= TOL_F32, f"synthesis gradient, kernel vs plain autograd: {err:.3e}")

    small = torch.randn(4, 8192, device=dev, generator=gen)
    got = vt.modwt_multilevel(small, WAVELET, levels=LEVELS, backend="kernel")
    ref = vt.modwt_multilevel(small.cpu().double(), WAVELET, levels=LEVELS, backend="torch")
    err = max(max_err(g.cpu().double(), r) for g, r in
              zip((*got.details, got.approx), (*ref.details, ref.approx)))
    check(err <= TOL_F32, f"4x8192 kernel analysis vs float64 CPU cascade: {err:.3e}")

    print(f"  the exact path, {BATCH}x{N} float32", flush=True)
    mc.reset_launches()
    for how in ({"precision": "exact"}, {"tolerance": 1e-10}):
        res = vt.modwt_multilevel(x, WAVELET, levels=LEVELS, **how)
        y = vt.imodwt_multilevel(res, WAVELET, **how)
        hi, lo = vt.imodwt_multilevel_exact(
            tuple(zip(res.details, res.details_lo)), (res.approx, res.approx_lo), WAVELET)
        torch.cuda.synchronize()
        check(isinstance(res, vt.ExactMODWTResult) and res.approx.device == dev,
              f"{how}: an ExactMODWTResult on {res.approx.device}")
        rmse = (hi.double() + lo.double() - x.double()).pow(2).mean().sqrt().item()
        same = (y == x).double().mean().item()
        check(rmse <= EXACT_RMSE and bool(torch.equal(hi, y)),
              f"exact round trip {how}: rmse of hi + lo {rmse:.3e} <= {EXACT_RMSE:.0e}, "
              f"share of hi words equal to x {same:.6f}")
    exact_launches = dict(mc.LAUNCHES)
    print(f"  launches during the exact path: {exact_launches}", flush=True)
    for name in EXACT_PATH:
        check(exact_launches[name] > 0, f"{name} launched {exact_launches[name]} times")
    launches.update({name: exact_launches[name] for name in EXACT_PATH})

    sym = vt.modwt_multilevel_exact(small, "sym8", levels=4, boundary="symmetric")
    ref = vt.modwt_multilevel(small.cpu().double(), "sym8", levels=4,
                              boundary="symmetric", backend="torch")
    err = max((h.cpu().double() + l.cpu().double() - r).abs().max().item()
              for (h, l), r in zip((*sym[0], sym[1]), (*ref.details, ref.approx)))
    check(err <= EXACT_SYM, f"4x8192 sym8 exact symmetric analysis vs float64 CPU "
                            f"cascade: {err:.3e} <= {EXACT_SYM:.0e}")
    try:
        vt.modwt_multilevel(x.clone().requires_grad_(True), WAVELET, levels=LEVELS,
                            precision="exact")
        refused = False
    except vt.InvalidArgumentError:
        refused = True
    check(refused, "an exact request on an input that requires grad raises")

    print("phase 4: timing (CUDA events, 3 warm-ups, median of 20)", flush=True)
    print(smi, flush=True)
    samples = BATCH * N
    planes = mc.analysis(x, LEVELS, fd, True)
    th = torch.full((BATCH, LEVELS), 0.1, device=dev)
    timed = {
        "modwt_analysis": (lambda: mc.analysis(x, LEVELS, fd, True),
                           lambda: mc.analysis_plain(x, LEVELS, fd, True)),
        "modwt_synthesis": (lambda: mc.synthesis(planes, LEVELS, fr, True),
                            lambda: mc.synthesis_plain(planes, LEVELS, fr, True)),
        "modwt_denoise": (lambda: mc.denoise(x, th, LEVELS, fd, fr, True, "soft"),
                          lambda: mc.denoise_plain(x, th, LEVELS, fd, fr, True, "soft")),
        "modwt_exact_analysis": (
            lambda: mc.exact_analysis(x, None, LEVELS, fd, True),
            lambda: mc.exact_analysis_plain(x, None, LEVELS, fd, True)),
        "modwt_exact_synthesis": (
            lambda: mc.exact_synthesis(pairs, LEVELS, fr, True),
            lambda: mc.exact_synthesis_plain(pairs, LEVELS, fr, True)),
    }
    pairs = mc.exact_analysis(x, None, LEVELS, fd, True)
    #: bytes each kernel must move per sample (inputs read once, outputs written once)
    bytes_per_sample = {"modwt_analysis": 4 * (LEVELS + 2), "modwt_synthesis": 4 * (LEVELS + 2),
                        "modwt_denoise": 8, "modwt_exact_analysis": 4 + 8 * (LEVELS + 1),
                        "modwt_exact_synthesis": 8 * (LEVELS + 2)}
    ms = {}
    for name, (kernel, plain) in timed.items():
        ms[name] = (median_ms(kernel), median_ms(plain))
        print(f"  {name}: kernel {ms[name][0]:.4f} ms "
              f"({samples / ms[name][0] / 1e3:.1f} Msamples/s, "
              f"{samples * bytes_per_sample[name] / ms[name][0] / 1e6:.1f} GB/s), plain "
              f"{ms[name][1]:.4f} ms ({samples / ms[name][1] / 1e3:.1f} Msamples/s)",
              flush=True)

    def public_round_trip(**how):
        return vt.imodwt_multilevel(
            vt.modwt_multilevel(x, WAVELET, levels=LEVELS, **how), WAVELET, **how)

    for label, fn in (
        ("modwt_multilevel + imodwt_multilevel", public_round_trip),
        ("modwt_multilevel + imodwt_multilevel, precision='exact'",
         lambda: public_round_trip(precision="exact")),
        ("modwt_roundtrip_fused", lambda: vt.modwt_roundtrip_fused(x, WAVELET, levels=LEVELS)),
        ("denoise_multilevel universal soft", lambda: vt.denoise_multilevel(
            noisy, WAVELET, levels=LEVELS, method="universal", mode="soft")),
    ):
        t_ms = median_ms(fn)
        print(f"  {label}: {t_ms:.4f} ms ({samples / t_ms / 1e3:.1f} Msamples/s)",
              flush=True)

    report = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": worst[name],
            **({"max_abs_err_bf16": worst_bf16[name]} if name in MAIN_PATH else {}),
            "ms": ms[name][0],
            "plain_ms": ms[name][1],
        }
        for name, (source, replaces) in KERNELS.items()
    ]}
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
