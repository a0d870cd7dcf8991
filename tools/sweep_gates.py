#!/usr/bin/env python3
"""Re-derive the MODWT routing gates of the PyTorch/CUDA port on one GPU.

Run from the root of a checkout, with a CUDA card visible:

    python3 tools/sweep_gates.py            # all four sweeps
    python3 tools/sweep_gates.py floor fft  # only those named

Each sweep is timed with CUDA events (2 warm-ups, the median of 7 runs) and
on the host clock (the same runs, each synchronised), since the plain route
is a chain of small launches at these sizes.  The kernels run with the
floors lifted (wherever their windows fit), the plain route under
``set_backend('torch')``, on CUDA tensors, and the two are checked against
each other:

``floor``
    The round trip ``modwt_multilevel`` -> ``imodwt_multilevel`` at N = 128,
    256, 512, 1024, 2048, 3000, 4096 and 8192, batch 1 and 128, db4 at J =
    2, 4 and 6 and sym8 at J = 4, periodic, zero and symmetric
    (``multilevel.KERNEL_MIN_N``).
``denoise``
    ``denoise_multilevel`` (universal soft) the same way, periodic and zero:
    the fused denoise kernel against the plain three-call path.
``symmetric``
    The symmetric boundary a direction at a time, to N = 131072: the
    analysis (the cascade kernel's mirror mode) and the synthesis (the
    symmetric synthesis kernel, whose head and tail windows run plain;
    ``multilevel.SYMMETRIC_SYNTHESIS_MIN_SAMPLES``).
``samples``
    The symmetric synthesis alone at batch 1, 8, 32 and 128, each at 2^20
    ... 2^24 samples (batch x N): whether its floor is one on the samples
    of a call, whatever their split into rows.
``fft``
    The FFT crossover of the plain periodic MODWT (``facade.should_use_fft``
    for CUDA tensors): ``fft_analysis_pair`` against the rolled
    ``atrous_analysis_pair`` for db4, sym8, coif5, db20, db32 and db38 (8,
    16, 30, 40, 64 and 76 taps), N = 2^8 ... 2^20, batch 1 and 128, float32
    and float64, with the routes' largest difference.
``fft_cold``
    The same crossover with the filter spectra's cache emptied before every
    call (a first call), for ``fft_analysis_pair`` at N = 256 ... 2^20 and
    for the plain ``modwt_multilevel`` at J = 10, whose levels each take a
    spectrum of their own; and J = 10 cascades of db4 and sym8 at two sizes
    one after the other, which hold more spectra than the cache keeps.  The
    rolled route is the plain cascade with the FFT thresholds lifted.

Each sweep prints its cases and what its rule gives, and everything goes to
``gate_sweeps/<sweeps>.json`` (listed in ``.gitignore``).  The rules: a
floor is the smallest swept N, or batch x N, from which the kernels are no
slower than the plain route in every case that they serve (by CUDA events,
and by the host clock beside it); the FFT thresholds are the (taps, N)
corner of the largest region, among the swept values, where the FFT is no
slower in every case.
"""

from __future__ import annotations

import json
import math
import os
import pathlib
import subprocess
import sys
import time

FLOOR_NS = (128, 256, 512, 1024, 2048, 3000, 4096, 8192)
SYMMETRIC_NS = (16384, 32768, 65536, 131072)
BATCHES = (1, 128)
FLOOR_CASES = (("db4", 2), ("db4", 4), ("db4", 6), ("sym8", 4))
BOUNDARIES = ("periodic", "zero", "symmetric")
FFT_WAVELETS = ("db4", "sym8", "coif5", "db20", "db32", "db38")
FFT_NS = tuple(1 << k for k in range(8, 21))
SAMPLES = tuple(1 << k for k in range(20, 25))
SAMPLE_BATCHES = (1, 8, 32, 128)
COLD_NS = (256, 4096, 65536, 1 << 20)
#: (batch, N) of the J = 10 cascades; the first two and the last two are
#: each run one after the other as well
CASCADE_SHAPES = ((1, 8192), (1, 1 << 20), (128, 8192), (128, 65536))
DTYPES = ("float32", "float64")
WARMUP, REPS = 2, 7
#: kernels against the plain route, float32 of unit-variance data
TOL_F32 = 2e-5
OUT_DIR = pathlib.Path("gate_sweeps")


def timed(fn, warmup: int = WARMUP, reps: int = REPS) -> tuple[float, float]:
    """Median CUDA-event ms and median host-clock ms of ``fn``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev, wall = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        end.synchronize()
        wall.append(1e3 * (time.perf_counter() - t0))
        ev.append(start.elapsed_time(end))
    ev.sort()
    wall.sort()
    return ev[reps // 2], wall[reps // 2]


def device_launches(fn) -> int:
    """Kernel launches on the card during one call of ``fn`` (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return int(sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0))


def write(report) -> pathlib.Path:
    """Save the sweeps run so far, as ``gate_sweeps/<names>.json``."""
    OUT_DIR.mkdir(exist_ok=True)
    out = OUT_DIR / f"{'_'.join(report['sweeps'])}.json"
    out.write_text(json.dumps(report, indent=1))
    return out


def lowest_floor(rows, key, size=lambda r: r["n"]) -> int | None:
    """The smallest swept ``size`` (N, or batch x N) from which every row
    that the kernels serve has ``key`` (kernel ms) no larger than the plain
    route's."""
    floor = None
    for n in sorted({size(r) for r in rows}, reverse=True):
        served = [r for r in rows if size(r) >= n and r["kernel_launches"]]
        if any(r[f"kernel_{key}"] > r[f"plain_{key}"] for r in served):
            break
        floor = n
    return floor


def floors_of(rows, boundaries) -> dict:
    """Each boundary's lowest floor in N and in samples (batch x N), by
    CUDA events and by the host clock."""
    return {b: {f"{unit} ({key})": lowest_floor([r for r in rows if r["boundary"] == b],
                                                key, size)
                for unit, size in (("N", lambda r: r["n"]),
                                   ("samples", lambda r: r["n"] * r["batch"]))
                for key in ("ms", "wall_ms")}
            for b in boundaries}


def route_sweep(vt, dev, gen, kind: str, boundaries, shapes) -> list:
    """Time ``kind`` (``round_trip``, ``denoise``, ``analysis`` or
    ``synthesis``) on the kernels (the floors lifted, ``auto``) and on the
    plain route (``backend='torch'``), with the launch counts of each, at
    each (batch, N) of ``shapes``."""
    import torch
    from vectorwave_tpu_torch.errors import InvalidArgumentError
    from vectorwave_tpu_torch.kernels import modwt_composite as mc
    from vectorwave_tpu_torch.transforms import multilevel as ml

    rows = []
    for name, levels in FLOOR_CASES:
        for boundary in boundaries:
            launches = {}
            for batch, n in shapes:
                try:
                    ml._check_level_fits(vt.wavelet(name), levels, n)
                except InvalidArgumentError:
                    continue  # the level's filter outgrows the signal
                x = torch.randn(batch, n, device=dev, generator=gen)
                planes = vt.modwt_multilevel(x, name, levels=levels, boundary=boundary,
                                             backend="torch")

                def call():
                    if kind == "denoise":
                        return vt.denoise_multilevel(x, name, levels=levels,
                                                     boundary=boundary)
                    if kind == "analysis":
                        return torch.stack(vt.modwt_multilevel(
                            x, name, levels=levels, boundary=boundary).details)
                    if kind == "synthesis":
                        return vt.imodwt_multilevel(planes, name, boundary=boundary)
                    return vt.imodwt_multilevel(
                        vt.modwt_multilevel(x, name, levels=levels, boundary=boundary),
                        name, boundary=boundary)

                row = {"wavelet": name, "levels": levels, "boundary": boundary,
                       "n": n, "batch": batch}
                outs = {}
                for route in ("kernel", "plain"):
                    vt.set_backend("auto" if route == "kernel" else "torch")
                    try:
                        mc.reset_launches()
                        outs[route] = call()
                        torch.cuda.synchronize()
                        row[f"{route}_launches"] = sum(mc.LAUNCHES.values())
                        row[f"{route}_ms"], row[f"{route}_wall_ms"] = timed(call)
                        if (route, n) not in launches and batch == 1:
                            launches[(route, n)] = device_launches(call)
                        row[f"{route}_device_launches"] = launches.get((route, n))
                    finally:
                        vt.set_backend("auto")
                if row["kernel_launches"]:
                    err = (outs["kernel"] - outs["plain"]).abs().max().item()
                    scale = max(1.0, outs["plain"].abs().max().item())
                    row["max_abs_err"] = err
                    # a denoise's thresholds come from a sigma; a few ulps
                    # of it move soft-shrunk outputs by a few ulps more
                    tol = 1e-4 if kind == "denoise" else TOL_F32
                    if err > tol * scale:
                        raise RuntimeError(f"kernel and plain route disagree: {row}")
                rows.append(row)
                print(f"  {kind} {name} J={levels} {boundary} {batch}x{n}: kernel "
                      f"{row['kernel_ms']:.4f} ms (wall {row['kernel_wall_ms']:.4f}, "
                      f"{row['kernel_launches']} kernel launches, "
                      f"{row['kernel_device_launches']} on the card) | plain "
                      f"{row['plain_ms']:.4f} ms (wall {row['plain_wall_ms']:.4f}, "
                      f"{row['plain_device_launches']} on the card)", flush=True)
    return rows


def fft_sweep(vt, dev, gen) -> tuple[list, dict]:
    import torch
    from vectorwave_tpu_torch.ops.convolve import atrous_analysis_pair, fft_analysis_pair

    rows = []
    inv = 1.0 / math.sqrt(2.0)
    for name in FFT_WAVELETS:
        w = vt.wavelet(name)
        low, high = w.dec_lo * inv, w.dec_hi * inv
        for n in FFT_NS:
            for batch in BATCHES:
                for dtype in DTYPES:
                    x = torch.randn(batch, n, device=dev, generator=gen,
                                    dtype=getattr(torch, dtype))
                    big = batch * n >= (1 << 24)
                    reps = (1, 3) if big else (WARMUP, REPS)

                    def fft():
                        return fft_analysis_pair(x, low, high, spacing=1)

                    def rolled():
                        return atrous_analysis_pair(x, low, high, spacing=1,
                                                    boundary="periodic")

                    a_f, d_f = fft()
                    fft_ms, fft_wall = timed(fft, *reps)
                    try:
                        a_r, d_r = rolled()
                        err = max((a_f - a_r).abs().max().item(),
                                  (d_f - d_r).abs().max().item())
                        del a_r, d_r
                        roll_ms, roll_wall = timed(rolled, *reps)
                    except torch.OutOfMemoryError:
                        # the rolled pair holds its L rolled copies at once
                        err = roll_ms = roll_wall = None
                    del a_f, d_f
                    row = {"wavelet": name, "taps": w.filter_length, "n": n,
                           "batch": batch, "dtype": dtype, "fft_ms": fft_ms,
                           "fft_wall_ms": fft_wall, "rolled_ms": roll_ms,
                           "rolled_wall_ms": roll_wall, "max_abs_diff": err}
                    rows.append(row)
                    rolled_text = ("out of device memory" if roll_ms is None else
                                   f"{roll_ms:.4f} ms (wall {roll_wall:.4f}) | diff {err:.2e}")
                    print(f"  {name} ({w.filter_length} taps) {batch}x{n} {dtype}: fft "
                          f"{fft_ms:.4f} ms (wall {fft_wall:.4f}) | rolled {rolled_text}",
                          flush=True)
                    del x
                    torch.cuda.empty_cache()
    best = None
    for taps in sorted({r["taps"] for r in rows}):
        for n in FFT_NS:
            inside = [r for r in rows if r["taps"] >= taps and r["n"] >= n]
            if not inside or any(r["rolled_ms"] is not None and r["fft_ms"] > r["rolled_ms"]
                                 for r in inside):
                continue
            if best is None or len(inside) > best[2]:
                best = (taps, n, len(inside))
    return rows, ({"min_taps": best[0], "min_signal": best[1], "cases": best[2]}
                  if best else {"min_taps": None, "min_signal": None, "cases": 0})


def fft_cold_sweep(vt, dev, gen) -> tuple[list, list]:
    """First calls of the FFT route (its spectra's cache emptied before each
    call) against the rolled one: the analysis pair, J = 10 cascades, and
    J = 10 cascades of two wavelets at two sizes one after the other."""
    import torch
    from vectorwave_tpu_torch.ops import convolve, facade
    from vectorwave_tpu_torch.ops.convolve import (
        atrous_analysis_pair, effective_length, fft_analysis_pair)

    def cold(fn):
        def call():
            convolve._SPECTRA.clear()
            return fn()
        return call

    def rolled(fn):
        def call():
            taps = facade.CUDA_FFT_MIN_TAPS
            facade.CUDA_FFT_MIN_TAPS = 1 << 30
            try:
                return fn()
            finally:
                facade.CUDA_FFT_MIN_TAPS = taps
        return call

    def cascade(x, name):
        return lambda: vt.modwt_multilevel(x, name, levels=10, backend="torch")

    def planes(r):
        return [p for res in (r if isinstance(r, list) else [r])
                for p in (*res.details, res.approx)]

    def measure(label, row, fft, plain, diff):
        row["cold_ms"], row["cold_wall_ms"] = timed(cold(fft))
        row["warm_ms"], row["warm_wall_ms"] = timed(fft)
        row["rolled_ms"], row["rolled_wall_ms"] = timed(plain)
        row["max_abs_diff"] = diff
        print(f"  {label}: fft cold {row['cold_ms']:.4f} ms (wall {row['cold_wall_ms']:.4f}) | "
              f"fft warm {row['warm_ms']:.4f} ms (wall {row['warm_wall_ms']:.4f}) | rolled "
              f"{row['rolled_ms']:.4f} ms (wall {row['rolled_wall_ms']:.4f}) | diff {diff:.2e}",
              flush=True)
        return row

    rows, cycles = [], []
    inv = 1.0 / math.sqrt(2.0)
    for name in FFT_WAVELETS:
        w = vt.wavelet(name)
        low, high = w.dec_lo * inv, w.dec_hi * inv
        for n in COLD_NS:
            for batch in BATCHES:
                if batch * n > (1 << 24):
                    continue
                for dtype in DTYPES:
                    x = torch.randn(batch, n, device=dev, generator=gen,
                                    dtype=getattr(torch, dtype))

                    def fft():
                        return fft_analysis_pair(x, low, high, spacing=1)

                    def plain():
                        return atrous_analysis_pair(x, low, high, spacing=1,
                                                    boundary="periodic")

                    diff = max((a - b).abs().max().item() for a, b in zip(fft(), plain()))
                    row = {"kind": "pair", "wavelet": name, "taps": w.filter_length, "n": n,
                           "batch": batch, "dtype": dtype}
                    rows.append(measure(f"pair {name} ({w.filter_length} taps) {batch}x{n} "
                                        f"{dtype}", row, fft, plain, diff))
    for dtype in DTYPES:
        for shapes in (CASCADE_SHAPES[:2], CASCADE_SHAPES[2:]):
            xs = {shape: torch.randn(*shape, device=dev, generator=gen,
                                     dtype=getattr(torch, dtype)) for shape in shapes}
            for name in ("db4", "sym8", "db20"):
                w = vt.wavelet(name)
                for (batch, n), x in xs.items():
                    if effective_length(w.filter_length, 10) > n:
                        continue
                    fft, plain = cascade(x, name), rolled(cascade(x, name))
                    diff = max((a - b).abs().max().item()
                               for a, b in zip(planes(fft()), planes(plain())))
                    row = {"kind": "cascade J=10", "wavelet": name, "taps": w.filter_length,
                           "n": n, "batch": batch, "dtype": dtype}
                    rows.append(measure(f"cascade J=10 {name} ({w.filter_length} taps) "
                                        f"{batch}x{n} {dtype}", row, fft, plain, diff))
            calls = [cascade(x, name) for x in xs.values() for name in ("db4", "sym8")]

            def cycle():
                return [call() for call in calls]

            def cycle_rolled():
                return [rolled(call)() for call in calls]

            diff = max((a - b).abs().max().item()
                       for a, b in zip(planes(cycle()), planes(cycle_rolled())))
            label = (f"cycle db4, sym8 J=10 at {' and '.join(f'{b}x{n}' for b, n in shapes)} "
                     f"{dtype}")
            row = {"kind": "cycle", "shapes": shapes, "dtype": dtype}
            row["ms"], row["wall_ms"] = timed(cycle)
            row["rolled_ms"], row["rolled_wall_ms"] = timed(cycle_rolled)
            row["max_abs_diff"] = diff
            row["cached_spectra"] = len(convolve._SPECTRA)
            cycles.append(row)
            print(f"  {label}: fft {row['ms']:.4f} ms (wall {row['wall_ms']:.4f}, "
                  f"{row['cached_spectra']} spectra held) | rolled {row['rolled_ms']:.4f} ms "
                  f"(wall {row['rolled_wall_ms']:.4f}) | diff {diff:.2e}", flush=True)
            del xs
            torch.cuda.empty_cache()
    return rows, cycles


def main(argv=None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("sweep_gates: needs a CUDA device", file=sys.stderr)
        return 1
    which = (argv if argv is not None else sys.argv[1:]) or ["floor", "denoise", "symmetric",
                                                             "samples", "fft", "fft_cold"]
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import vectorwave_tpu_torch as vt
    from vectorwave_tpu_torch.kernels import _build
    from vectorwave_tpu_torch.transforms import multilevel as ml

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    _build.library()
    print(f"built the kernels in {time.perf_counter() - t0:.1f} s", flush=True)
    report = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
              "sweeps": which}
    floors = (ml.KERNEL_MIN_N, ml.SYMMETRIC_SYNTHESIS_MIN_SAMPLES)
    ml.KERNEL_MIN_N = ml.SYMMETRIC_SYNTHESIS_MIN_SAMPLES = 1
    def grid(ns):
        return [(batch, n) for n in ns for batch in BATCHES]

    sweeps = {
        "floor": (("round_trip",), BOUNDARIES, grid(FLOOR_NS)),
        "denoise": (("denoise",), BOUNDARIES[:2], grid(FLOOR_NS)),
        "symmetric": (("analysis", "synthesis"), BOUNDARIES[2:], grid(FLOOR_NS + SYMMETRIC_NS)),
        "samples": (("synthesis",), BOUNDARIES[2:],
                    [(batch, s // batch) for s in SAMPLES for batch in SAMPLE_BATCHES]),
    }
    try:
        for name, (kinds, boundaries, shapes) in sweeps.items():
            if name not in which:
                continue
            print(f"{name}: the kernels against the plain route", flush=True)
            report[name] = {}
            for k in kinds:
                rows = route_sweep(vt, dev, gen, k, boundaries, shapes)
                report[name][k] = {"rows": rows, "floors": floors_of(rows, boundaries)}
                if name == "samples":
                    report[name][k]["floors by batch"] = {
                        batch: floors_of([r for r in rows if r["batch"] == batch], boundaries)
                        for batch in SAMPLE_BATCHES}
                print(f"{name} {k}: {report[name][k]['floors']}", flush=True)
                if name == "samples":
                    print(f"{name} {k} by batch: {report[name][k]['floors by batch']}",
                          flush=True)
            write(report)
    finally:
        ml.KERNEL_MIN_N, ml.SYMMETRIC_SYNTHESIS_MIN_SAMPLES = floors
    if "fft" in which:
        print("fft: the FFT analysis pair against the rolled one", flush=True)
        rows, gate = fft_sweep(vt, dev, gen)
        report["fft"] = {"rows": rows, **gate}
        print(f"fft: CUDA_FFT_MIN_TAPS = {gate['min_taps']}, CUDA_FFT_MIN_SIGNAL = "
              f"{gate['min_signal']} ({gate['cases']} cases inside)", flush=True)
    if "fft_cold" in which:
        print("fft_cold: first calls of the FFT route against the rolled one", flush=True)
        from vectorwave_tpu_torch.ops import facade

        rows, cycles = fft_cold_sweep(vt, dev, gen)
        gated = [r for r in rows if r["taps"] >= facade.CUDA_FFT_MIN_TAPS
                 and r["n"] >= facade.CUDA_FFT_MIN_SIGNAL]
        losses = [r for r in gated if r["cold_ms"] > r["rolled_ms"]]
        losses += [r for r in cycles if r["ms"] > r["rolled_ms"]]
        report["fft_cold"] = {"rows": rows, "cycles": cycles, "losses": losses}
        cases = len(gated) + len(cycles)
        print(f"fft_cold: {cases - len(losses)} of {cases} cases inside the CUDA thresholds have the FFT "
              f"route no slower on a first call or in the cycle; losses: {losses}", flush=True)
    print(f"wrote {write(report)}", flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
