#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU and check it.

Run from the root of a checkout, with one Hopper card visible:

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is not 0:

0. device: print ``nvidia-smi``'s name and power limit; stop if
   ``torch.cuda.is_available()`` is false;
1. build: compile the CUDA kernels from ``vectorwave_tpu_torch/kernels/csrc``
   (one nvcc per source, all started together);
2. kernels against their plain PyTorch versions on the card (db4, 6 levels):
   analysis, synthesis and denoise (none/soft/hard) at 128x65536 periodic,
   3x5000 zero and 2x300 periodic in float32, and once in bfloat16; the
   exact fp64 analysis and synthesis at the same three shapes, with a lo
   word, from a first level above 1, with the levels split over two
   launches (sym8, 10 levels), and with levels too deep for shared memory
   read straight from device memory (db38, 9 levels); the symmetric
   synthesis kernel (forward and adjoint) and the analysis kernel with a
   head splice, at db4 J=6 and sym8 J=4 128x65536, db4 J=6 3x5000, haar J=4,
   a long filter that needs a smaller tile (db36 J=8), and once in bfloat16;
   the cascade pair (``run_analysis_mxu`` / ``run_synthesis_mxu``) in each
   edge mode (periodic, zero, and the analysis's per-level mirror) at db4
   J=6 and sym8 J=4 128x65536, db4 J=6 3x5000, db4 J=6 2x300 and sym8 J=4
   2x150 (N shorter than the span; the mirror's window outlasts the
   signal), haar J=5, db36 J=8 (the mirror at its 9088 tile, where the
   second block's window starts before the signal) and once in bfloat16;
   the 2-D analysis and synthesis level kernels, every band, in each edge
   mode (periodic, zero, symmetric with the inverse's per-filter offsets),
   at levels 1 and 4 of db4 and 1 and 6 of sym8 at 8x2048x2048, at db4 level
   3 on 3x200x328, haar level 5 on 1x24x40 and db20 level 4 on 2x1024x1024;
3. the main path through the public entry points at 128x65536 float32:
   ``modwt_multilevel`` -> ``imodwt_multilevel`` at every precision tier,
   ``modwt_roundtrip_fused`` and ``denoise_multilevel``, with the launch
   counters reset just before and read just after; then the gradients of
   analysis and synthesis against plain autograd, and a small input against
   the float64 plain cascade on the CPU; then the exact path, with its own
   reset and reading of the counters: ``precision='exact'`` and
   ``tolerance=1e-10`` round trips (RMSE of hi + lo against x <= 1e-10), the
   exact symmetric analysis against the float64 plain cascade on the CPU,
   and an input that requires grad, which must raise; then the probe's path
   (``tools/perf_probe_mxu.py``): ``run_analysis_mxu`` -> ``run_synthesis_mxu``
   db4 J=6 periodic at each precision, each round trip with its own reset
   and reading of the counters (one launch each way, RMSE <= 3e-7); then the
   symmetric path, with its own reset and reading of the counters: the db4
   J=6 symmetric round trip at 128x65536 (exactly one mirror-mode analysis
   and one symmetric synthesis launch, and no zero-mode analysis launch in
   the whole symmetric path) against the plain cascade on the card,
   ``swt_denoise`` sym8 J=4 soft universal at 128x65536 and 1x16384 against
   the plain path, the symmetric gradients of both directions against plain
   autograd (their backward launches the synthesis kernel and the adjoint),
   and a short input against the float64 plain cascade on the CPU; then the
   gradient of the fused denoise (db4 J=6 soft at 128x65536, in x and in
   the thresholds) against plain autograd, with its own reset and reading of
   the counters (two analysis launches and one synthesis launch), and
   ``denoise_multilevel`` on an input that requires grad; then the 2-D path
   at 8x2048x2048, each public call with its own reset and reading of the
   counters (one 2-D kernel launch per level and direction):
   ``modwt2_multilevel`` -> ``imodwt2_multilevel`` db4 J=4 and J=6 periodic
   (every band against the plain path, the round trip against x within
   5e-5), db4 J=4 zero and sym8 J=4 symmetric round trips and ``denoise2``
   db4 J=4 universal soft against the plain path, a small input in each edge
   mode against the float64 plain cascade on the CPU, and a 2-D input that
   requires grad, which must raise;
4. timing with CUDA events (3 warm-ups, median of 20 runs) of each kernel
   beside its plain version and one PyTorch library call that computes the
   same function (``F.conv1d`` with the composite filters; not for the
   denoise; ``F.conv2d`` with the outer products of a level's taps for the
   2-D kernels, which are timed at level 1 and at level 6; the cascade
   analysis also in mirror mode), with the least time the card could take (bytes over 3.35 TB/s
   or operations over the peak rate, the larger), and of the public entry
   points (the 2-D ones, the fused denoise's backward and the probe's round
   trip at each precision included).

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
import torch.nn.functional as F

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
#: swt_denoise, kernel path against plain path: soft shrinkage is continuous,
#: so thresholds a few ulps apart move the output by a few ulps of its scale.
TOL_SWT = 1e-4
#: the fused denoise's threshold gradient, a sum over 65536 samples per
#: signal and level: relative to its largest value.
TOL_DTH = 1e-3
#: the card's peaks (NVIDIA H100 SXM data sheet): device memory bytes/s and
#: fp32 / fp64 FLOP/s outside the tensor cores, an FMA counted as 2 FLOP.
HBM_BPS, FP32_FLOPS, FP64_FLOPS = 3.35e12, 67e12, 34e12

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
    "modwt_symmetric_synthesis": (
        "vectorwave_tpu_torch/kernels/csrc/modwt_symmetric_synthesis.cu",
        "vectorwave_tpu/kernels/modwt_symmetric.py:261",
    ),
    "modwt_symmetric_adjoint": (
        "vectorwave_tpu_torch/kernels/csrc/modwt_symmetric_synthesis.cu",
        "vectorwave_tpu/kernels/modwt_symmetric.py:186",
    ),
    "modwt2_analysis": (
        "vectorwave_tpu_torch/kernels/csrc/modwt2_analysis.cu",
        "vectorwave_tpu/kernels/modwt2_pallas.py:161",
    ),
    "modwt2_synthesis": (
        "vectorwave_tpu_torch/kernels/csrc/modwt2_synthesis.cu",
        "vectorwave_tpu/kernels/modwt2_pallas.py:423",
    ),
    "modwt_mxu_analysis": (
        "vectorwave_tpu_torch/kernels/csrc/modwt_analysis.cu",
        "vectorwave_tpu/kernels/modwt_mxu.py:267",
    ),
    "modwt_mxu_synthesis": (
        "vectorwave_tpu_torch/kernels/csrc/modwt_synthesis.cu",
        "vectorwave_tpu/kernels/modwt_mxu.py:407",
    ),
}
MAIN_PATH = ("modwt_analysis", "modwt_synthesis", "modwt_denoise")
EXACT_PATH = ("modwt_exact_analysis", "modwt_exact_synthesis")
SYMMETRIC_PATH = ("modwt_mxu_analysis", "modwt_symmetric_synthesis",
                  "modwt_symmetric_adjoint")
MXU_PATH = ("modwt_mxu_analysis", "modwt_mxu_synthesis")
BF16_ROWS = MAIN_PATH + ("modwt_symmetric_synthesis", "modwt_symmetric_adjoint") + MXU_PATH
#: the tile tools/perf_probe_mxu.py passes the TPU pair; a layout hint that
#: the port's wrappers accept and ignore
PROBE_TILE = 8192
TWOD_PATH = ("modwt2_analysis", "modwt2_synthesis")
#: the 2-D path's images (the TPU bench's 2-D shape) and its round-trip bound
#: (the JAX package's 2-D kernel test bound, tests/test_modwt2_pallas.py).
IMG = (8, 2048, 2048)
RT2_MAX = 5e-5


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
    return (a.double() - b.double()).abs().max().item()


def pair_err(got, want) -> float:
    """Max |hi + lo - (hi' + lo')| over plane pairs, combined in float64."""
    return max((g[0].double() + g[1].double() - w[0].double() - w[1].double())
               .abs().max().item() for g, w in zip(got, want))


def composite_bank(filters, levels, device, dtype):
    """The [J+1, span+1] causal composite filters, reversed for conv1d (a
    correlation), as one tensor."""
    import numpy as np
    from vectorwave_tpu_torch.kernels import modwt_composite as mc

    comps = mc.composite_plane_filters(np.array(filters[0]), np.array(filters[1]), levels)
    k = max(len(c) for c in comps)
    bank = np.zeros((len(comps), k))
    for i, c in enumerate(comps):
        bank[i, k - len(c):] = c[::-1]
    return torch.tensor(bank, dtype=dtype, device=device)


def symmetric_bank(filters, ops, device):
    """The rebased composed symmetric filters [J+1, K] (zero-padded to one
    length) and G: out[t] = sum_p sum_tau f'_p[tau] plane_p[t + tau - G]."""
    from vectorwave_tpu_torch.kernels.modwt_symmetric import _rebase, plane_filters

    dense, g, d_max = _rebase(plane_filters(filters, ops))
    k = max(len(f) for f in dense)
    bank = torch.zeros(len(dense), k, device=device)
    for i, f in enumerate(dense):
        bank[i, : len(f)] = torch.tensor(f, device=device)
    return bank, g, d_max


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a "
              "CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import vectorwave_tpu_torch as vt
    from vectorwave_tpu_torch.denoise.denoiser import _fused_sigma
    from vectorwave_tpu_torch.kernels import _build
    from vectorwave_tpu_torch.kernels import modwt2 as k2
    from vectorwave_tpu_torch.kernels import modwt_cascade as mx
    from vectorwave_tpu_torch.kernels import modwt_composite as mc
    from vectorwave_tpu_torch.kernels import modwt_symmetric as ms
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

    # the symmetric kernel pair and the analysis head splice:
    # (wavelet, levels, batch, n, dtype); planes from an analysis of x, so the
    # outputs are of the order of x
    sym_cases = [
        (WAVELET, LEVELS, BATCH, N, torch.float32),
        ("sym8", 4, BATCH, N, torch.float32),
        (WAVELET, LEVELS, 3, 5000, torch.float32),
        ("haar", 4, 2, 4096, torch.float32),
        ("db36", 8, 2, N, torch.float32),  # windows too wide for a 2048 tile
        (WAVELET, LEVELS, BATCH, N, torch.bfloat16),
    ]
    for name, levels, b, n, dtype in sym_cases:
        ws = vt.wavelet(name)
        sd, sr = _kernel_filters(ws, synthesis=False), _kernel_filters(ws, synthesis=True)
        ops = ms.symmetric_level_ops(ws, levels)
        x = torch.randn(b, n, device=dev, generator=gen).to(dtype)
        cut = min(mc.composite_halo_samples(ws.filter_length, levels), n)
        head = torch.stack(ms._symmetric_cascade(x[:, :cut].float(), sd, levels)).contiguous()
        planes = mc.analysis_plain(x, levels, sd, False, head)
        span_l, span_r, _, _ = ms.synthesis_windows(ws.filter_length, ops)
        hd = torch.randn(b, span_l, device=dev, generator=gen)
        tl = torch.randn(b, span_r, device=dev, generator=gen)
        c = torch.randn(b, n, device=dev, generator=gen).to(dtype)
        label = (f"{name} J={levels} {b}x{n} {str(dtype)[6:]} (tiles "
                 f"{mc.symmetric_tile(ws.filter_length, ops, False)}/"
                 f"{mc.symmetric_tile(ws.filter_length, ops, True)})")
        results = [
            ("modwt_analysis", " with head splice",
             mc.analysis(x, levels, sd, False, head), planes),
            ("modwt_symmetric_synthesis", "",
             mc.symmetric_synthesis(planes, hd, tl, levels, sr, ops),
             mc.symmetric_synthesis_plain(planes, hd, tl, levels, sr, ops)),
            ("modwt_symmetric_adjoint", "",
             mc.symmetric_adjoint(c, levels, sr, ops),
             mc.symmetric_adjoint_plain(c, levels, sr, ops)),
        ]
        torch.cuda.synchronize()
        for kname, tag, got, want in results:
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max(max_err(g, p) for g, p in zip(got, want))
            if dtype == torch.float32:
                tol = TOL_F32
                worst[kname] = max(worst[kname], err)
            else:
                tol = BF16_ULP * max(p.float().abs().max().item() for p in want)
                worst_bf16[kname] = max(worst_bf16[kname], err)
            check(err <= tol, f"{kname}{tag} {label}: max |kernel - plain| "
                              f"{err:.3e} <= {tol:.3e}")

    # the cascade pair in each edge mode: (wavelet, levels, batch, n, dtype);
    # the synthesis runs on the plain analysis planes of the same edge (zero
    # for the mirror's)
    cascade_cases = [
        (WAVELET, LEVELS, BATCH, N, torch.float32),
        ("sym8", 4, BATCH, N, torch.float32),
        (WAVELET, LEVELS, 3, 5000, torch.float32),
        (WAVELET, LEVELS, 2, 300, torch.float32),  # reach 224 <= N < span 441
        ("sym8", 4, 2, 150, torch.float32),  # reach 120 <= N < span 225
        ("haar", 5, 2, 4096, torch.float32),
        ("db36", 8, 2, N, torch.float32),  # the mirror's tile 71 * 128 < span
        (WAVELET, LEVELS, BATCH, N, torch.bfloat16),
    ]
    for name, levels, b, n, dtype in cascade_cases:
        wc = vt.wavelet(name)
        cd, cr = _kernel_filters(wc, synthesis=False), _kernel_filters(wc, synthesis=True)
        x = torch.randn(b, n, device=dev, generator=gen).to(dtype)
        for edge in ("periodic", "zero", "mirror"):
            periodic, mirror = edge == "periodic", edge == "mirror"
            used = mc.analysis_tile(wc.filter_length, levels, mirror)
            label = f"{name} J={levels} {b}x{n} {edge} {str(dtype)[6:]} (tile {used})"
            want = mx.analysis_plain(x, levels, cd, edge)
            results = [
                ("modwt_mxu_analysis", mx.run_analysis_mxu(
                    x, levels, cd, periodic, PROBE_TILE, "float32", False,
                    symmetric=mirror),
                 want),
                ("modwt_mxu_synthesis",
                 mx.run_synthesis_mxu(want, levels, cr, periodic, PROBE_TILE, "float32",
                                      False),
                 mc.synthesis_plain(want, levels, cr, periodic)),
            ]
            torch.cuda.synchronize()
            for kname, got, ref in results:
                got = got if isinstance(got, tuple) else (got,)
                ref = ref if isinstance(ref, tuple) else (ref,)
                err = max(max_err(g, p) for g, p in zip(got, ref))
                if dtype == torch.float32:
                    tol = TOL_F32
                    worst[kname] = max(worst[kname], err)
                else:
                    tol = BF16_ULP * max(p.float().abs().max().item() for p in ref)
                    worst_bf16[kname] = max(worst_bf16[kname], err)
                check(err <= tol, f"{kname} {label}: max |kernel - plain| "
                                  f"{err:.3e} <= {tol:.3e}")
            del want, results

    # the 2-D level kernels: (wavelet, level, shape), each in the three edge
    # modes; the synthesis planes are independent unit-variance images
    img_cases = [
        (WAVELET, 1, IMG), (WAVELET, 4, IMG), ("sym8", 1, IMG), ("sym8", 6, IMG),
        (WAVELET, 3, (3, 200, 328)), ("haar", 5, (1, 24, 40)), ("db20", 4, (2, 1024, 1024)),
    ]
    for name, level, shape in img_cases:
        wi = vt.wavelet(name)
        s = 1 << (level - 1)
        fa, fs = _kernel_filters(wi, synthesis=False), _kernel_filters(wi, synthesis=True)
        xi = torch.randn(*shape, device=dev, generator=gen)
        planes = [torch.randn(*shape, device=dev, generator=gen) for _ in range(4)]
        for edge in ("periodic", "zero", "symmetric"):
            ops = k2.synthesis_ops(wi, level, edge)[level - 1]
            label = f"{name} level {level} {'x'.join(map(str, shape))} {edge}"
            got = k2.analysis2_level(xi, fa, s, edge)
            want = k2.analysis2_level_plain(xi, fa, s, edge)
            torch.cuda.synchronize()
            err = max(max_err(g, p) for g, p in zip(got, want))
            worst["modwt2_analysis"] = max(worst["modwt2_analysis"], err)
            check(err <= TOL_F32, f"modwt2_analysis {label}, every band: max |kernel - "
                                  f"plain| {err:.3e} <= {TOL_F32:.0e}")
            del got, want
            got = k2.synthesis2_level(*planes, fs, s, ops, edge)
            want = k2.synthesis2_level_plain(*planes, fs, s, ops, edge)
            torch.cuda.synchronize()
            err = max_err(got, want)
            worst["modwt2_synthesis"] = max(worst["modwt2_synthesis"], err)
            check(err <= TOL_F32, f"modwt2_synthesis {label}, ops {ops}: max |kernel - "
                                  f"plain| {err:.3e} <= {TOL_F32:.0e}")
            del got, want
        del xi, planes

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

    print(f"  the probe's path (run_analysis_mxu -> run_synthesis_mxu), {BATCH}x{N} "
          "float32", flush=True)
    for tier in mx.PRECISIONS:
        mc.reset_launches()
        planes = mx.run_analysis_mxu(x, LEVELS, fd, True, PROBE_TILE, tier, False)
        y = mx.run_synthesis_mxu(planes, LEVELS, fr, True, PROBE_TILE, tier, False)
        torch.cuda.synchronize()
        got = {k: v for k, v in mc.LAUNCHES.items() if v}
        check(got == dict.fromkeys(MXU_PATH, 1), f"probe round trip {tier}: launches {got}")
        for name in MXU_PATH:
            launches[name] += got[name]
        rmse = (y - x).pow(2).mean().sqrt().item()
        check(rmse <= RT_RMSE and max_err(y, x) <= RT_MAX,
              f"probe round trip {tier}: rmse {rmse:.3e} <= {RT_RMSE:.0e}, "
              f"max {max_err(y, x):.3e} <= {RT_MAX:.0e}")
    del planes

    print(f"  the symmetric path, {BATCH}x{N} float32", flush=True)
    mc.reset_launches()
    res = vt.modwt_multilevel(x, WAVELET, levels=LEVELS, boundary="symmetric")
    y = vt.imodwt_multilevel(res, WAVELET, boundary="symmetric")
    torch.cuda.synchronize()
    rt_launches = {k: v for k, v in mc.LAUNCHES.items() if v}
    check(rt_launches == {"modwt_mxu_analysis": 1, "modwt_symmetric_synthesis": 1},
          f"symmetric round trip launches {rt_launches}")
    ref = vt.modwt_multilevel(x, WAVELET, levels=LEVELS, boundary="symmetric",
                              backend="torch")
    y_ref = vt.imodwt_multilevel(ref, WAVELET, boundary="symmetric", backend="torch")
    err = max(max_err(a, b) for a, b in zip((*res.details, res.approx),
                                            (*ref.details, ref.approx)))
    check(err <= TOL_F32, f"symmetric analysis vs plain cascade: {err:.3e}")
    check(max_err(y, y_ref) <= TOL_F32,
          f"symmetric synthesis vs plain cascade: {max_err(y, y_ref):.3e}")
    for b, n in ((BATCH, N), (1, 16384)):
        xs = noisy[:b, :n].contiguous()
        got = vt.swt_denoise(xs, "sym8", levels=4, boundary="symmetric")
        vt.set_backend("torch")
        try:
            want = vt.swt_denoise(xs, "sym8", levels=4, boundary="symmetric")
        finally:
            vt.set_backend("auto")
        check(got.shape == xs.shape and bool(torch.isfinite(got).all())
              and max_err(got, want) <= TOL_SWT,
              f"swt_denoise sym8 J=4 symmetric {b}x{n} vs plain path: "
              f"{max_err(got, want):.3e} <= {TOL_SWT:.0e}")
    xg = x.clone().requires_grad_(True)
    grads = []
    for backend in ("kernel", "torch"):
        r = vt.modwt_multilevel(xg, WAVELET, levels=LEVELS, boundary="symmetric",
                                backend=backend)
        loss = sum((p * wt).sum() for p, wt in zip((*r.details, r.approx), weights))
        grads.append(torch.autograd.grad(loss, xg)[0])
    check(max_err(*grads) <= TOL_F32,
          f"symmetric analysis gradient, kernel vs plain autograd: {max_err(*grads):.3e}")
    planes = [p.detach().clone().requires_grad_(True) for p in (*ref.details, ref.approx)]
    grads = []
    for backend in ("kernel", "torch"):
        yy = vt.imodwt_multilevel(
            vt.MultiLevelMODWTResult(tuple(planes[:LEVELS]), planes[LEVELS]),
            WAVELET, boundary="symmetric", backend=backend)
        grads.append(torch.autograd.grad((yy * weights[0]).sum(), planes))
    err = max(max_err(a, b) for a, b in zip(*grads))
    check(err <= TOL_F32, f"symmetric synthesis gradient, kernel vs plain autograd: "
                          f"{err:.3e}")
    got = vt.modwt_multilevel(small, WAVELET, levels=LEVELS, boundary="symmetric",
                              backend="kernel")
    ref = vt.modwt_multilevel(small.cpu().double(), WAVELET, levels=LEVELS,
                              boundary="symmetric", backend="torch")
    err = max(max_err(g.cpu().double(), r) for g, r in
              zip((*got.details, got.approx), (*ref.details, ref.approx)))
    y_got = vt.imodwt_multilevel(got, WAVELET, boundary="symmetric", backend="kernel")
    y_ref = vt.imodwt_multilevel(
        vt.MultiLevelMODWTResult(tuple(g.cpu().double() for g in got.details),
                                 got.approx.cpu().double()),
        WAVELET, boundary="symmetric", backend="torch")
    err_y = max_err(y_got.cpu().double(), y_ref)
    check(err <= TOL_F32 and err_y <= TOL_F32,
          f"4x8192 symmetric kernels vs float64 CPU cascade: analysis {err:.3e}, "
          f"synthesis {err_y:.3e}")
    torch.cuda.synchronize()
    sym_launches = dict(mc.LAUNCHES)
    print(f"  launches during the symmetric path: {sym_launches}", flush=True)
    for name in SYMMETRIC_PATH + ("modwt_synthesis",):
        check(sym_launches[name] > 0, f"{name} launched {sym_launches[name]} times "
                                      "in the symmetric path")
    check(sym_launches["modwt_analysis"] == 0,
          f"modwt_analysis launched {sym_launches['modwt_analysis']} times in the "
          "symmetric path (its analysis is the mirror mode)")
    for name in SYMMETRIC_PATH:
        launches[name] += sym_launches[name]

    print(f"  the fused denoise's gradient, {BATCH}x{N} float32", flush=True)
    th = gap_thresholds(mc._analysis_cascade(noisy, LEVELS, fd, True), LEVELS)
    grads = []
    for fused in (True, False):
        xg, tg = noisy.clone().requires_grad_(True), th.clone().requires_grad_(True)
        if fused:
            y = vt.fused_denoise_multilevel(xg, WAVELET, levels=LEVELS, thresholds=tg,
                                            mode="soft")
            mc.reset_launches()
        else:
            y = mc.denoise_plain(xg, tg, LEVELS, fd, fr, True, "soft")
        grads.append(torch.autograd.grad((y * weights[0]).sum(), (xg, tg)))
        if fused:
            torch.cuda.synchronize()
            grad_launches = {k: v for k, v in mc.LAUNCHES.items() if v}
    check(grad_launches == {"modwt_analysis": 2, "modwt_synthesis": 1},
          f"fused denoise backward launches {grad_launches}")
    for name, count in grad_launches.items():
        launches[name] += count
    (gx, gt), (px, pt) = grads
    err_t = max_err(gt, pt) / pt.abs().max().item()
    check(max_err(gx, px) <= TOL_F32 and err_t <= TOL_DTH,
          f"fused denoise gradient vs plain autograd: d/dx {max_err(gx, px):.3e} <= "
          f"{TOL_F32:.0e}, d/dthreshold {err_t:.3e} <= {TOL_DTH:.0e} of its largest")
    xg = noisy.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(vt.denoise_multilevel(xg, WAVELET, levels=LEVELS).pow(2).sum(),
                               xg)
    check(bool(torch.isfinite(g).all()) and g.abs().max().item() > 0,
          "denoise_multilevel differentiates on the card")

    print(f"  the 2-D path, {'x'.join(map(str, IMG))} float32", flush=True)
    twod_launches = dict.fromkeys(TWOD_PATH, 0)

    def counted(label, expect, fn):
        """Run fn with the counters set to 0 just before and read just after."""
        mc.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = {k: v for k, v in mc.LAUNCHES.items() if v}
        check(got == expect, f"{label}: launches {got}")
        for k in TWOD_PATH:
            twod_launches[k] += got.get(k, 0)
        return out

    img = torch.randn(*IMG, device=dev, generator=gen)

    def bands(res):
        return [p for trip in res.details for p in trip] + [res.approx]

    for name, levels, boundary in ((WAVELET, 4, "periodic"), (WAVELET, 6, "periodic"),
                                   (WAVELET, 4, "zero"), ("sym8", 4, "symmetric")):
        label = f"{name} J={levels} {boundary}"
        each = {"modwt2_analysis": levels}
        res = counted(f"modwt2_multilevel {label}", each, lambda: vt.modwt2_multilevel(
            img, name, levels=levels, boundary=boundary))
        y = counted(f"imodwt2_multilevel {label}", {"modwt2_synthesis": levels},
                    lambda: vt.imodwt2_multilevel(res, name, boundary=boundary))
        ref = vt.modwt2_multilevel(img, name, levels=levels, boundary=boundary,
                                   backend="torch")
        err = max(max_err(g, r) for g, r in zip(bands(res), bands(ref)))
        y_ref = vt.imodwt2_multilevel(ref, name, boundary=boundary, backend="torch")
        check(err <= TOL_F32 and max_err(y, y_ref) <= TOL_F32,
              f"2-D {label} vs plain path: every band {err:.3e}, inverse "
              f"{max_err(y, y_ref):.3e} <= {TOL_F32:.0e}")
        if boundary == "periodic":
            rmse = (y - img).pow(2).mean().sqrt().item()
            check(max_err(y, img) <= RT2_MAX,
                  f"2-D round trip {label}: rmse {rmse:.3e}, max {max_err(y, img):.3e} "
                  f"<= {RT2_MAX:.0e}")
        del res, y, ref, y_ref
    rows = torch.arange(IMG[1], device=dev, dtype=torch.float32)[:, None]
    cols = torch.arange(IMG[2], device=dev, dtype=torch.float32)[None, :]
    noisy_img = (torch.sin(2 * math.pi * rows / 64.0) * torch.cos(2 * math.pi * cols / 48.0)
                 + 0.5 * torch.randn(*IMG, device=dev, generator=gen)).contiguous()
    den2 = counted("denoise2 db4 J=4 universal soft",
                   {"modwt2_analysis": 4, "modwt2_synthesis": 4},
                   lambda: vt.denoise2(noisy_img, WAVELET, levels=4))
    vt.set_backend("torch")
    try:
        want = vt.denoise2(noisy_img, WAVELET, levels=4)
    finally:
        vt.set_backend("auto")
    check(den2.shape == noisy_img.shape and bool(torch.isfinite(den2).all())
          and max_err(den2, want) <= TOL_SWT,
          f"denoise2 db4 J=4 vs plain path: {max_err(den2, want):.3e} <= {TOL_SWT:.0e}")
    del den2, want
    small2 = torch.randn(2, 96, 80, device=dev, generator=gen)
    for boundary in ("periodic", "zero", "symmetric"):
        got = counted(f"modwt2_multilevel sym8 J=2 {boundary} 2x96x80",
                      {"modwt2_analysis": 2}, lambda: vt.modwt2_multilevel(
                          small2, "sym8", levels=2, boundary=boundary))
        ref = vt.modwt2_multilevel(small2.cpu().double(), "sym8", levels=2,
                                   boundary=boundary, backend="torch")
        err = max(max_err(g.cpu(), r) for g, r in zip(bands(got), bands(ref)))
        y = counted(f"imodwt2_multilevel sym8 J=2 {boundary} 2x96x80",
                    {"modwt2_synthesis": 2},
                    lambda: vt.imodwt2_multilevel(got, "sym8", boundary=boundary))
        y_ref = vt.imodwt2_multilevel(
            vt.MultiLevelMODWT2Result(tuple(tuple(p.cpu().double() for p in t)
                                            for t in got.details),
                                      got.approx.cpu().double()),
            "sym8", boundary=boundary, backend="torch")
        check(err <= TOL_F32 and max_err(y.cpu(), y_ref) <= TOL_F32,
              f"2x96x80 sym8 J=2 {boundary} 2-D kernels vs float64 CPU cascade: "
              f"analysis {err:.3e}, synthesis {max_err(y.cpu(), y_ref):.3e}")
    try:
        vt.modwt2_multilevel(small2.clone().requires_grad_(True), "db4", levels=2)
        refused = False
    except vt.InvalidArgumentError:
        refused = True
    check(refused, "a 2-D input that requires grad raises on the card")
    print(f"  launches during the 2-D path: {twod_launches}", flush=True)
    for name in TWOD_PATH:
        check(twod_launches[name] > 0, f"{name} launched {twod_launches[name]} times")
        launches[name] = twod_launches[name]

    print("phase 4: timing (CUDA events, 3 warm-ups, median of 20)", flush=True)
    print(smi, flush=True)
    samples = BATCH * N
    planes = mc.analysis(x, LEVELS, fd, True)
    th = torch.full((BATCH, LEVELS), 0.1, device=dev)
    pairs = mc.exact_analysis(x, None, LEVELS, fd, True)
    ops = ms.symmetric_level_ops(w, LEVELS)
    span_l, span_r, _, _ = ms.synthesis_windows(w.filter_length, ops)
    sym_res = vt.modwt_multilevel(x, WAVELET, levels=LEVELS, boundary="symmetric")
    sym_planes = (*sym_res.details, sym_res.approx)
    noisy_16k = noisy[:1, :16384].contiguous()
    hd, tl = torch.zeros(BATCH, span_l, device=dev), torch.zeros(BATCH, span_r, device=dev)
    c = torch.randn(BATCH, N, device=dev, generator=gen)
    span = mc.composite_halo_samples(w.filter_length, LEVELS)
    bank_d = composite_bank(fd, LEVELS, dev, torch.float32)
    bank_r = composite_bank(fr, LEVELS, dev, torch.float32).flip(-1)
    sbank, g_sym, d_sym = symmetric_bank(fr, ops, dev)
    stacked = torch.stack(planes, dim=1)
    sym_stacked = torch.stack(sym_planes, dim=1)
    x64, stacked64 = x.double()[:, None], stacked.double()
    timed = {
        "modwt_analysis": (
            lambda: mc.analysis(x, LEVELS, fd, True),
            lambda: mc.analysis_plain(x, LEVELS, fd, True),
            lambda: F.conv1d(F.pad(x[:, None], (span, 0), mode="circular"), bank_d[:, None])),
        "modwt_synthesis": (
            lambda: mc.synthesis(planes, LEVELS, fr, True),
            lambda: mc.synthesis_plain(planes, LEVELS, fr, True),
            lambda: F.conv1d(F.pad(stacked, (0, span), mode="circular"), bank_r[None])),
        "modwt_denoise": (
            lambda: mc.denoise(x, th, LEVELS, fd, fr, True, "soft"),
            lambda: mc.denoise_plain(x, th, LEVELS, fd, fr, True, "soft"),
            None),
        "modwt_exact_analysis": (
            lambda: mc.exact_analysis(x, None, LEVELS, fd, True),
            lambda: mc.exact_analysis_plain(x, None, LEVELS, fd, True),
            lambda: F.conv1d(F.pad(x64, (span, 0), mode="circular"), bank_d.double()[:, None])),
        "modwt_exact_synthesis": (
            lambda: mc.exact_synthesis(pairs, LEVELS, fr, True),
            lambda: mc.exact_synthesis_plain(pairs, LEVELS, fr, True),
            lambda: F.conv1d(F.pad(stacked64, (0, span), mode="circular"),
                             bank_r.double()[None])),
        "modwt_symmetric_synthesis": (
            lambda: mc.symmetric_synthesis(sym_planes, hd, tl, LEVELS, fr, ops),
            lambda: mc.symmetric_synthesis_plain(sym_planes, hd, tl, LEVELS, fr, ops),
            lambda: F.conv1d(F.pad(sym_stacked, (g_sym, max(d_sym, 0))), sbank[None])),
        "modwt_symmetric_adjoint": (
            lambda: mc.symmetric_adjoint(c, LEVELS, fr, ops),
            lambda: mc.symmetric_adjoint_plain(c, LEVELS, fr, ops),
            lambda: F.conv1d(F.pad(c[:, None], (sbank.shape[1] - 1 - g_sym, g_sym)),
                             sbank.flip(-1)[:, None])),
        # the probe's call; the library call is rows 3 and 4's (the mirror is
        # no convolution)
        "modwt_mxu_analysis": (
            lambda: mx.run_analysis_mxu(x, LEVELS, fd, True, PROBE_TILE, "float32", False),
            lambda: mx.analysis_plain(x, LEVELS, fd, "periodic"),
            lambda: F.conv1d(F.pad(x[:, None], (span, 0), mode="circular"), bank_d[:, None])),
        "modwt_mxu_synthesis": (
            lambda: mx.run_synthesis_mxu(planes, LEVELS, fr, True, PROBE_TILE, "float32",
                                         False),
            lambda: mc.synthesis_plain(planes, LEVELS, fr, True),
            lambda: F.conv1d(F.pad(stacked, (0, span), mode="circular"), bank_r[None])),
    }
    #: bytes each kernel must move (each input read once, each output written
    #: once) and the FMAs its cascade does, per sample of one 128 x 65536 call
    plane_bytes = 4 * (LEVELS + 1)
    taps = w.filter_length
    per_sample = {  # (bytes, FMAs, FLOP/s of their type)
        "modwt_analysis": (4 + plane_bytes, 2 * taps * LEVELS, FP32_FLOPS),
        "modwt_synthesis": (plane_bytes + 4, 2 * taps * LEVELS, FP32_FLOPS),
        "modwt_denoise": (8, 4 * taps * LEVELS, FP32_FLOPS),
        "modwt_exact_analysis": (4 + 2 * plane_bytes, 2 * taps * LEVELS, FP64_FLOPS),
        "modwt_exact_synthesis": (2 * plane_bytes + 8, 2 * taps * LEVELS, FP64_FLOPS),
        "modwt_symmetric_synthesis": (plane_bytes + 4, 2 * taps * LEVELS, FP32_FLOPS),
        "modwt_symmetric_adjoint": (4 + plane_bytes, 2 * taps * LEVELS, FP32_FLOPS),
        "modwt_mxu_analysis": (4 + plane_bytes, 2 * taps * LEVELS, FP32_FLOPS),
        "modwt_mxu_synthesis": (plane_bytes + 4, 2 * taps * LEVELS, FP32_FLOPS),
    }
    extra_bytes = {"modwt_symmetric_synthesis": 4 * BATCH * (span_l + span_r)}
    ms_of, bound = {}, {}
    for name, (kernel, plain, library_call) in timed.items():
        ms_of[name] = (median_ms(kernel), median_ms(plain),
                       None if library_call is None else median_ms(library_call))
        nbytes, fmas, rate = per_sample[name]
        t_bytes = (samples * nbytes + extra_bytes.get(name, 0)) / HBM_BPS * 1e3
        t_ops = samples * fmas * 2 / rate * 1e3
        bound[name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
        k_ms, p_ms, l_ms = ms_of[name]
        print(f"  {name}: kernel {k_ms:.4f} ms "
              f"({samples / k_ms / 1e3:.1f} Msamples/s, "
              f"{samples * nbytes / k_ms / 1e6:.1f} GB/s), plain {p_ms:.4f} ms, library "
              f"{'-' if l_ms is None else f'{l_ms:.4f} ms'}, bound {bound[name][0]:.4f} ms "
              f"({bound[name][1]}; {100 * bound[name][0] / k_ms:.1f}% of it)", flush=True)
    # the cascade analysis in both edges the card's paths use (the mirror is
    # the symmetric route's launch); "ms" is the probe's periodic call
    modes = {edge: median_ms(lambda edge=edge: mx.cascade_analysis(x, LEVELS, fd, edge))
             for edge in ("periodic", "mirror")}
    print(f"  modwt_mxu_analysis by edge: {modes} ms", flush=True)

    # the 2-D level kernels at level 1 and at level 6 of db4 on the 2-D path's
    # images, periodic; library call: F.conv2d of the circularly padded input
    # with the [4, 1, L, L] outer products of the level's taps (synthesis:
    # [1, 4, L, L] on the four padded planes) at dilation 2^(j-1)
    import numpy as np

    fa2, fs2 = _kernel_filters(w, synthesis=False), _kernel_filters(w, synthesis=True)
    planes4 = [torch.randn(*IMG, device=dev, generator=gen) for _ in range(4)]
    stacked4 = torch.stack(planes4, dim=1)
    lo_a, hi_a = np.array(fa2[0]), np.array(fa2[1])
    lo_s, hi_s = np.array(fs2[0]), np.array(fs2[1])
    # (H filter, W filter) of ll, lh, hl, hh
    bank_a = torch.tensor(np.stack([np.outer(fh[::-1], fw[::-1]) for fh, fw in (
        (lo_a, lo_a), (lo_a, hi_a), (hi_a, lo_a), (hi_a, hi_a))]),
        dtype=torch.float32, device=dev)[:, None]
    bank_s = torch.tensor(np.stack([np.outer(fh, fw) for fh, fw in (
        (lo_s, lo_s), (lo_s, hi_s), (hi_s, lo_s), (hi_s, hi_s))]),
        dtype=torch.float32, device=dev)[None]
    pixels = math.prod(IMG)
    # each input read once and each output written once: one plane in and
    # four out (analysis) or four in and one out (synthesis); 6 L FMAs a pixel
    t_bytes2 = 20 * pixels / HBM_BPS * 1e3
    t_ops2 = 12 * taps * pixels / FP32_FLOPS * 1e3
    bound2 = (max(t_bytes2, t_ops2), "bytes" if t_bytes2 >= t_ops2 else "operations")
    deep = {}
    for level in (1, LEVELS):
        sp = 1 << (level - 1)
        pad = sp * (taps - 1)
        twod = {
            "modwt2_analysis": (
                lambda: k2.analysis2_level(img, fa2, sp, "periodic"),
                lambda: k2.analysis2_level_plain(img, fa2, sp, "periodic"),
                lambda: F.conv2d(F.pad(img[:, None], (pad, 0, pad, 0), mode="circular"),
                                 bank_a, dilation=sp)),
            "modwt2_synthesis": (
                lambda: k2.synthesis2_level(*planes4, fs2, sp, k2.FORWARD_OPS, "periodic"),
                lambda: k2.synthesis2_level_plain(*planes4, fs2, sp, k2.FORWARD_OPS,
                                                  "periodic"),
                lambda: F.conv2d(F.pad(stacked4, (0, pad, 0, pad), mode="circular"),
                                 bank_s, dilation=sp)),
        }
        lib_err = max(max_err(twod["modwt2_analysis"][2]()[:, 0],
                              twod["modwt2_analysis"][0]()[0]),
                      max_err(twod["modwt2_synthesis"][2]()[:, 0],
                              twod["modwt2_synthesis"][0]()))
        check(lib_err <= 1e-4, f"level {level}: F.conv2d computes the 2-D kernels' "
                               f"function ({lib_err:.3e})")
        for name, (kernel, plain, library_call) in twod.items():
            times = (median_ms(kernel), median_ms(plain), median_ms(library_call))
            if level == 1:
                ms_of[name], bound[name] = times, bound2
            else:
                deep[name] = {"level": level, "ms": times[0], "plain_ms": times[1],
                              "library_ms": times[2], "bound_ms": bound2[0]}
            print(f"  {name} level {level}: kernel {times[0]:.4f} ms "
                  f"({20 * pixels / times[0] / 1e6:.1f} GB/s), plain {times[1]:.4f} ms, "
                  f"library {times[2]:.4f} ms, bound {bound2[0]:.4f} ms ({bound2[1]}; "
                  f"{100 * bound2[0] / times[0]:.1f}% of it)", flush=True)
    del planes4, stacked4

    def public_round_trip(**how):
        return vt.imodwt_multilevel(
            vt.modwt_multilevel(x, WAVELET, levels=LEVELS, **how), WAVELET, **how)

    def round_trip_2d(levels):
        return vt.imodwt2_multilevel(vt.modwt2_multilevel(img, WAVELET, levels=levels),
                                     WAVELET)

    xg = noisy.clone().requires_grad_(True)
    y_fused = vt.fused_denoise_multilevel(xg, WAVELET, levels=LEVELS, thresholds=th,
                                          mode="soft")

    def probe_round_trip(precision):
        return mx.run_synthesis_mxu(
            mx.run_analysis_mxu(x, LEVELS, fd, True, PROBE_TILE, precision, False),
            LEVELS, fr, True, PROBE_TILE, precision, False)

    for label, fn, count in (
        ("modwt_multilevel + imodwt_multilevel", public_round_trip, samples),
        *((f"run_analysis_mxu + run_synthesis_mxu, precision='{p}'",
           lambda p=p: probe_round_trip(p), samples) for p in mx.PRECISIONS),
        ("modwt_multilevel + imodwt_multilevel, precision='exact'",
         lambda: public_round_trip(precision="exact"), samples),
        ("modwt_multilevel + imodwt_multilevel, boundary='symmetric'",
         lambda: public_round_trip(boundary="symmetric"), samples),
        ("modwt_roundtrip_fused", lambda: vt.modwt_roundtrip_fused(x, WAVELET, levels=LEVELS),
         samples),
        ("denoise_multilevel universal soft", lambda: vt.denoise_multilevel(
            noisy, WAVELET, levels=LEVELS, method="universal", mode="soft"), samples),
        (f"swt_denoise sym8 J=4 symmetric {BATCH}x{N}", lambda: vt.swt_denoise(
            noisy, "sym8", levels=4, boundary="symmetric"), samples),
        ("swt_denoise sym8 J=4 symmetric 1x16384", lambda: vt.swt_denoise(
            noisy_16k, "sym8", levels=4, boundary="symmetric"), 16384),
        ("fused_denoise_multilevel soft, backward alone", lambda: torch.autograd.grad(
            y_fused, xg, weights[0], retain_graph=True), samples),
        ("modwt2_multilevel + imodwt2_multilevel db4 J=4 8x2048x2048",
         lambda: round_trip_2d(4), pixels),
        ("modwt2_multilevel + imodwt2_multilevel db4 J=6 8x2048x2048",
         lambda: round_trip_2d(LEVELS), pixels),
        ("denoise2 db4 J=4 universal soft 8x2048x2048",
         lambda: vt.denoise2(noisy_img, WAVELET, levels=4), pixels),
    ):
        t_ms = median_ms(fn)
        print(f"  {label}: {t_ms:.4f} ms ({count / t_ms / 1e3:.1f} Msamples/s)",
              flush=True)

    report = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": worst[name],
            **({"max_abs_err_bf16": worst_bf16[name]} if name in BF16_ROWS else {}),
            "ms": ms_of[name][0],
            "plain_ms": ms_of[name][1],
            "bound_ms": bound[name][0],
            "bound_by": bound[name][1],
            "library_ms": ms_of[name][2],
            **({"deepest": deep[name]} if name in deep else {}),
            **({"ms_by_edge": modes} if name == "modwt_mxu_analysis" else {}),
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
