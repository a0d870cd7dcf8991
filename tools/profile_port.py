#!/usr/bin/env python3
"""Profile the PyTorch/CUDA port's public entry points on one GPU.

Run from the root of a checkout, with a CUDA card visible:

    python3 tools/profile_port.py

For the main-path shape (128 x 65536 float32, db4, 6 levels) it times each
entry point on the host clock (synchronised), traces 10 calls with
``torch.profiler``, and prints per call: wall ms, device (kernel) ms, the
device's busy share of the wall time, the number of kernel launches, and the
device kernels that take the most time.  The calls are the periodic round
trip, the probe's round trip through the cascade pair (``run_analysis_mxu``
-> ``run_synthesis_mxu``, float32, with the arguments ``tools/perf_probe_mxu.py``
gives the JAX pair; the port ignores their tile), the exact round trip
(``precision='exact'``), the fused round trip, the denoise, the symmetric round
trip (its analysis the cascade kernel's mirror mode), and
``swt_denoise`` (sym8, 4 levels, symmetric, universal soft) at 128 x 65536
and 1 x 16384, the fused denoise's forward and backward (db4, 6 levels,
soft, 128 x 65536), the gradient of the symmetric inverse with respect to its
planes (db4, 6 levels, 128 x 65536: the forward and the backward, whose
symmetric adjoint kernel is one launch), and at the 2-D shape (8 x 2048 x 2048 float32) the db4
round trips ``modwt2_multilevel`` -> ``imodwt2_multilevel`` at 4 and 6
levels and ``denoise2`` (db4, 4 levels, universal soft), and for the packet
and dual-tree family (sym8, float32, 64 x 16384 and 128 x 65536) ``modwpt``
-> ``imodwpt`` at depth 4 and ``dtcwt`` -> ``idtcwt`` at 5 levels under each
backend (``kernel``: the whole tree in one bank launch; ``auto``: the route
the package chooses; ``torch``: the plain cascade), and ``denoise_packet``
and ``dtcwt_denoise`` at 8 x 16384, and the two streaming rows (db4, 6
levels, 128 streams x 8 blocks x 8192 float32): block streaming with the
zero and the symmetric boundary, one ``modwt_stream_block_kernel`` step a
block, and the streaming denoiser, one ``streaming_denoise_block_kernel``
step a block and ``streaming_denoise_blocks_kernel`` with the 8 blocks in
one launch, and the tiled tier at the main-path shape over 4 and 8 virtual
shards of the card: ``modwt_multilevel_tiled`` -> ``imodwt_multilevel_tiled``
(one external-halo launch each way), the exact tiled round trip and the
symmetric tiled round trip (the plain route), and the CWT (morl, periodic)
at config #5's single row (2^20 samples, 64 scales 2-4096) and at 128 x
65536 with 32 scales 2-64: ``cwt`` under ``auto`` (the kernel-direct tier on
the bank kernel for the small scales, the FFT path for the rest) and on the
plain route, ``cwt`` -> ``icwt`` and ``modwt_based_icwt`` (the argument
``"cwt morl"`` selects them), and what is built on the CWT: ``cwt_tiled`` at
config #5 over 4 and 8 virtual shards (zero and periodic) and
``cwt_tiled_2d`` on a 2 x 4 host x chip mesh of the card,
``wavelet_coherence`` (32 scales x 32768), ``extract_ridge`` (32 scales x
65536, the blocked Viterbi), ``synchrosqueeze`` -> ``isst`` (32 scales x
16384), ``significant_power`` and ``coherence_significance`` (64
surrogates, 32 scales x 32768), ``matching_pursuit`` (8 x 16384, mexh, 16
scales, 32 steps), ``wavelet_sharpe_ratio`` (1 x 10240 and 512 x 4096),
``analyze_market`` (10240 prices) and ``analyze_ticks_incremental`` (512
ticks; a call is about 25000 launches), the default-depth round trip
(db4 and sym8 with no ``levels``, J = 9, and db4 J=10, 128 x 65536), and the
1-D analysis modules and the 2-D CWT (the argument ``analysis`` selects
them): ``wavelet_variance`` (128 x 65536 default depth, 1 x 2^20 J=6),
``wavelet_correlation``, ``hurst_exponent``, the variance stream on the
kernel step (128 streams x 8 x 8192), ``variance_change_test``,
``multifractal_spectrum`` (2^20), the lifting round trips, the EWT,
``scattering1d`` (8 x 16384), ``cwt2`` -> ``icwt2`` (256 x 256 and 1 x 1024
x 1024) and ``scattering2d`` (128 x 128), and the sparse solvers, the
deconvolutions, the block denoise and the decimated 2-D trees at
``chip_smoke.py``'s shapes (the argument ``optimize`` selects them; one
warm-up and 3 calls each, since ``inpaint2`` takes 2.5 s).  For the
streaming, tiled and optimisation rows it also prints the host side: the self CPU time of the traced ops per
call and the ops that take the most (the trace's own cost included).  Exits
non-zero without a CUDA device.

With arguments, only the calls whose label holds one of them are profiled:
``python3 tools/profile_port.py tiled`` profiles the tiled rows alone, and
run from another checkout's root it profiles that checkout's package, so
two versions can be compared in one session on the card.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

REPS = 10


def main() -> int:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_port: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import vectorwave_tpu_torch as vt
    from vectorwave_tpu_torch import parallel as par
    from vectorwave_tpu_torch import streaming as st
    from vectorwave_tpu_torch.kernels import modwt_cascade as mx
    from vectorwave_tpu_torch.kernels.modwt_fused import _kernel_filters

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(128, 65536, device=dev, generator=gen)
    x16k = x[:1, :16384].contiguous()
    img = torch.randn(8, 2048, 2048, device=dev, generator=gen)
    xg = x.clone().requires_grad_(True)
    ths = torch.full((128, 6), 0.5, device=dev)
    w = vt.wavelet("db4")
    fd, fr = _kernel_filters(w, synthesis=False), _kernel_filters(w, synthesis=True)

    def fused_backward():
        y = vt.fused_denoise_multilevel(xg, "db4", levels=6, thresholds=ths, mode="soft")
        return torch.autograd.grad(y.sum(), xg)

    sym = vt.modwt_multilevel(x, "db4", levels=6, boundary="symmetric")
    sym_planes = [p.detach().clone().requires_grad_(True) for p in (*sym.details, sym.approx)]

    def symmetric_planes_gradient():
        y = vt.imodwt_multilevel(
            vt.MultiLevelMODWTResult(tuple(sym_planes[:-1]), sym_planes[-1]), "db4",
            boundary="symmetric")
        return torch.autograd.grad(y, sym_planes, x)

    calls = {
        "modwt_multilevel + imodwt_multilevel": lambda: vt.imodwt_multilevel(
            vt.modwt_multilevel(x, "db4", levels=6), "db4"),
        "run_analysis_mxu + run_synthesis_mxu, float32": lambda: mx.run_synthesis_mxu(
            mx.run_analysis_mxu(x, 6, fd, True, 8192, "float32", False), 6, fr, True,
            8192, "float32", False),
        "modwt_multilevel + imodwt_multilevel, precision='exact'": lambda: vt.imodwt_multilevel(
            vt.modwt_multilevel(x, "db4", levels=6, precision="exact"), "db4",
            precision="exact"),
        "modwt_roundtrip_fused": lambda: vt.modwt_roundtrip_fused(x, "db4", levels=6),
        "denoise_multilevel universal soft": lambda: vt.denoise_multilevel(
            x, "db4", levels=6, method="universal", mode="soft"),
        "modwt_multilevel + imodwt_multilevel, symmetric": lambda: vt.imodwt_multilevel(
            vt.modwt_multilevel(x, "db4", levels=6, boundary="symmetric"), "db4",
            boundary="symmetric"),
        "swt_denoise sym8 J=4 symmetric 128x65536": lambda: vt.swt_denoise(
            x, "sym8", levels=4, boundary="symmetric"),
        "swt_denoise sym8 J=4 symmetric 1x16384": lambda: vt.swt_denoise(
            x16k, "sym8", levels=4, boundary="symmetric"),
        "fused_denoise_multilevel soft, forward + backward": fused_backward,
        "imodwt_multilevel symmetric, gradient w.r.t. the planes (forward + backward)":
            symmetric_planes_gradient,
        "modwt2_multilevel + imodwt2_multilevel db4 J=4 8x2048x2048":
            lambda: vt.imodwt2_multilevel(vt.modwt2_multilevel(img, "db4", levels=4), "db4"),
        "modwt2_multilevel + imodwt2_multilevel db4 J=6 8x2048x2048":
            lambda: vt.imodwt2_multilevel(vt.modwt2_multilevel(img, "db4", levels=6), "db4"),
        "denoise2 db4 J=4 universal soft 8x2048x2048":
            lambda: vt.denoise2(img, "db4", levels=4, method="universal", mode="soft"),
    }

    def under(backend, fn):
        def run():
            vt.set_backend(backend)
            try:
                return fn()
            finally:
                vt.set_backend("auto")
        return run

    for b, n in ((64, 16384), (128, 65536)):
        xp = x[:b, :n].contiguous()
        for backend in ("kernel", "auto", "torch"):
            calls[f"modwpt + imodwpt sym8 depth 4 {b}x{n}, backend {backend}"] = under(
                backend, lambda xp=xp: vt.imodwpt(vt.modwpt(xp, "sym8", 4), "sym8"))
            calls[f"dtcwt + idtcwt sym8 5 levels {b}x{n}, backend {backend}"] = under(
                backend, lambda xp=xp: vt.idtcwt(vt.dtcwt(xp, "sym8", levels=5), "sym8"))
    x8 = x[:8, :16384].contiguous()
    calls["denoise_packet sym8 depth 4 8x16384"] = lambda: vt.denoise_packet(x8, "sym8", 4)
    calls["dtcwt_denoise sym8 5 levels 8x16384"] = lambda: vt.dtcwt_denoise(
        x8, "sym8", levels=5)
    blocks = x[:, :8 * 8192].reshape(128, 8, 8192).transpose(0, 1).contiguous()

    def stream_row(boundary):
        state = st.kernel_streaming_init("db4", 6, batch_shape=(128,))
        for blk in blocks:
            state, res = st.modwt_stream_block_kernel(state, blk, "db4", levels=6,
                                                      boundary=boundary)
        return res

    def denoise_row(multiblock):
        state = st.kernel_streaming_denoiser_init("db4", levels=6, batch_shape=(128,))
        if multiblock:
            return st.streaming_denoise_blocks_kernel(state, blocks, "db4", levels=6)
        for blk in blocks:
            state, out = st.streaming_denoise_block_kernel(state, blk, "db4", levels=6)
        return out

    stream = "128 streams x 8 x 8192 db4 J=6"
    for boundary in ("zero", "symmetric"):
        calls[f"block streaming {boundary} {stream}, a step a block"] = (
            lambda boundary=boundary: stream_row(boundary))
    calls[f"streaming denoise {stream}, a step a block"] = lambda: denoise_row(False)
    calls[f"streaming denoise {stream}, 8 blocks a launch"] = lambda: denoise_row(True)
    for shards in (4, 8):
        mesh = par.make_mesh({"signal": shards}, devices=[dev] * shards)
        calls[f"tiled round trip db4 J=6 128x65536, {shards} shards"] = (
            lambda mesh=mesh: par.imodwt_multilevel_tiled(par.modwt_multilevel_tiled(
                x, "db4", levels=6, mesh=mesh), "db4", mesh=mesh))
        calls[f"tiled exact round trip db4 J=6 128x65536, {shards} shards"] = (
            lambda mesh=mesh: par.imodwt_multilevel_tiled_exact(
                *par.modwt_multilevel_tiled_exact(x, "db4", levels=6, mesh=mesh), "db4",
                mesh=mesh))
    calls["tiled round trip symmetric db4 J=6 128x65536, 8 shards"] = (
        lambda mesh=mesh: par.imodwt_multilevel_tiled(par.modwt_multilevel_tiled(
            x, "db4", levels=6, mesh=mesh, boundary="symmetric"), "db4", mesh=mesh,
            boundary="symmetric"))
    # the CWT (morl, periodic): config #5's single row (2^20 samples, 64
    # scales 2-4096) and the main batch with 32 scales 2-64, under auto (the
    # kernel-direct tier and the FFT path) and on the plain route
    x5 = torch.randn(1 << 20, device=dev, generator=gen)
    cfg5 = tuple(np.geomspace(2.0, 4096.0, 64).tolist())
    main = tuple(np.geomspace(2.0, 64.0, 32).tolist())
    res_main = vt.cwt(x, main, "morl", boundary="periodic")
    for label, xc, scales in (("config #5 1x1048576, 64 scales", x5, cfg5),
                              ("128x65536, 32 scales", x, main)):
        for backend in ("auto", "torch"):
            calls[f"cwt morl periodic {label}, backend {backend}"] = under(
                backend, lambda xc=xc, scales=scales: vt.cwt(xc, scales, "morl",
                                                             boundary="periodic"))
        calls[f"cwt -> icwt morl periodic {label}, backend auto"] = (
            lambda xc=xc, scales=scales: vt.icwt(vt.cwt(xc, scales, "morl",
                                                        boundary="periodic"), "morl"))
    calls["modwt_based_icwt morl 128x65536, 32 scales"] = (
        lambda: vt.modwt_based_icwt(res_main, "morl"))
    # what is built on the CWT
    for shards in (4, 8):
        mesh = par.make_mesh({"signal": shards}, devices=[dev] * shards)
        for boundary in ("zero", "periodic"):
            calls[f"cwt_tiled morl config #5 1x1048576, 64 scales, {shards} shards, "
                  f"{boundary}"] = (lambda mesh=mesh, boundary=boundary: par.cwt_tiled(
                      x5, cfg5, "morl", mesh=mesh, boundary=boundary))
    hosts = par.make_multihost_mesh(n_hosts=2, chips_per_host=4, devices=[dev] * 8)
    calls["cwt_tiled_2d morl config #5 1x1048576, 64 scales, 2x4 host x chip"] = (
        lambda: par.cwt_tiled_2d(x5, cfg5, "morl", mesh=hosts))
    s32 = tuple(np.geomspace(2.0, 64.0, 32).tolist())
    x32k, y32k = x[0, :32768].contiguous(), x[1, :32768].contiguous()
    calls["wavelet_coherence morl 32 scales x 32768"] = (
        lambda: vt.wavelet_coherence(x32k, y32k, s32, "morl"))
    ridge_in = vt.cwt(x[0], s32, "morl", analytic=True)
    calls["extract_ridge 32 scales x 65536 (blocked Viterbi)"] = (
        lambda: vt.extract_ridge(ridge_in))
    x16 = x[2, :16384].contiguous()
    calls["synchrosqueeze -> isst morl 32 scales x 16384"] = (
        lambda: vt.isst(vt.synchrosqueeze(x16, s32, "morl"), "morl"))
    res32 = vt.cwt(x32k, s32, "morl", analytic=True)
    calls["significant_power morl 32 scales x 32768"] = (
        lambda: vt.significant_power(res32, x32k, "morl"))
    calls["coherence_significance morl 64 surrogates, 32 scales x 32768"] = (
        lambda: vt.coherence_significance(x32k, y32k, s32, "morl", n_surrogates=64))
    s16 = tuple(np.geomspace(2.0, 64.0, 16).tolist())
    x8mp = x[:8, :16384].contiguous()
    calls["matching_pursuit mexh 8x16384, 16 scales, 32 steps"] = (
        lambda: vt.matching_pursuit(x8mp, s16, "mexh", steps=32))
    rets = 0.01 * torch.randn(1, 10240, device=dev, generator=gen)
    rets512 = 0.01 * x[:, :16384].reshape(512, 4096)
    calls["wavelet_sharpe_ratio db4 1x10240"] = lambda: vt.finance.wavelet_sharpe_ratio(rets)
    calls["wavelet_sharpe_ratio db4 512x4096"] = lambda: vt.finance.wavelet_sharpe_ratio(
        rets512)
    prices = 100.0 * torch.exp(torch.cumsum(rets[0], 0))
    calls["analyze_market 10240 prices"] = lambda: vt.finance.analyze_market(prices)
    ticks = prices[:512].contiguous()
    calls["analyze_ticks_incremental 512 ticks"] = (
        lambda: vt.finance.analyze_ticks_incremental(ticks))
    # the default-depth MODWT (no levels: J = 9) and db4 J=10, and the 1-D
    # analysis modules and the 2-D CWT at the phase-3 shapes of chip_smoke.py
    for name, levels in (("db4", None), ("sym8", None), ("db4", 10)):
        depth = "no levels" if levels is None else f"J={levels}"
        calls[f"default depth {name} {depth} round trip 128x65536"] = (
            lambda name=name, levels=levels: vt.imodwt_multilevel(
                vt.modwt_multilevel(x, name, levels=levels), name))
    y = 0.6 * x + 0.8 * torch.randn(128, 65536, device=dev, generator=gen)
    x1m = torch.randn(1 << 20, device=dev, generator=gen)
    calls["analysis wavelet_variance db4 128x65536 no levels"] = (
        lambda: vt.wavelet_variance(x, "db4"))
    calls["analysis wavelet_variance db4 J=6 1x1048576"] = (
        lambda: vt.wavelet_variance(x1m, "db4", 6))
    calls["analysis wavelet_correlation db4 128x65536"] = (
        lambda: vt.wavelet_correlation(x, y, "db4"))
    calls["analysis hurst_exponent fgn db4 128x65536"] = lambda: vt.hurst_exponent(x, "db4")

    def variance_stream():
        state = st.kernel_streaming_init("db4", 6, batch_shape=(128,))
        acc = vt.variance_stream_init("db4", 6, batch_shape=(128,))
        for blk in blocks:
            state, res = st.modwt_stream_block_kernel(state, blk, "db4", levels=6)
            acc = vt.variance_stream_update(acc, res.details, "db4")
        return vt.variance_stream_result(acc)

    calls[f"analysis variance stream {stream}"] = variance_stream
    calls["analysis variance_change_test db4 level 1 128x65536"] = (
        lambda: vt.variance_change_test(x, "db4", level=1))
    walk = torch.cumsum(x1m, 0)
    calls["analysis multifractal_spectrum db3 1x1048576"] = (
        lambda: vt.multifractal_spectrum(walk, "db3"))
    calls["analysis lifting cdf97 J=6 round trip 128x65536"] = (
        lambda: vt.lifting_waverec(vt.lifting_wavedec(x, "cdf97", levels=6), "cdf97"))
    ints = torch.randint(-(1 << 15), 1 << 15, (128, 65536), device=dev, generator=gen,
                         dtype=torch.int32)
    calls["analysis lifting_int legall53 J=6 round trip 128x65536"] = (
        lambda: vt.lifting_waverec_int(vt.lifting_wavedec_int(ints, "legall53", levels=6),
                                       "legall53"))
    bounds = (0.05, 0.15, 0.35)
    calls["analysis ewt -> iewt 4 bands 1x16384"] = (
        lambda: vt.iewt(vt.ewt(x16k, bounds), bounds))
    calls["analysis ewt -> iewt 4 bands 128x65536"] = lambda: vt.iewt(vt.ewt(x, bounds), bounds)
    calls["analysis ewt_boundaries 3 bands 128x65536"] = lambda: vt.ewt_boundaries(x, 3)
    calls["analysis scattering1d order 2 8x16384 J=6 Q=8"] = (
        lambda: vt.scattering1d(x[:8, :16384].contiguous()))
    angles = tuple(np.linspace(0.0, np.pi, 8, endpoint=False).tolist())
    img256, img1k = img[0, :256, :256].contiguous(), img[:1, :1024, :1024].contiguous()
    for label, im, count in (("256x256", img256, 8), ("1x1024x1024", img1k, 16)):
        scales2 = tuple(np.geomspace(2.5, 30.0, count).tolist())
        calls[f"analysis cwt2 -> icwt2 morl2 {label}, {count} scales x 8 angles"] = (
            lambda im=im, scales2=scales2: vt.icwt2(vt.cwt2(im, scales2, "morl2",
                                                            angles=angles), "morl2"))
    calls["analysis scattering2d order 2 128x128 J=3 L=6"] = (
        lambda: vt.scattering2d(img[:1, :128, :128].contiguous(), J=3, L=6))
    import chip_smoke

    for label, fn in chip_smoke.optimize_calls(chip_smoke.optimize_inputs(dev, gen)).items():
        calls[f"optimize {label}"] = fn
    words = sys.argv[1:]
    if words:
        calls = {k: v for k, v in calls.items() if any(word in k for word in words)}
    for label, fn in calls.items():
        # the optimisation rows run up to 2.5 s a call: one warm-up, 3 calls
        warm, reps = (1, 3) if label.startswith("optimize") else (3, REPS)
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3 / reps
        # device-side events only: the CPU op that launched a kernel reports
        # the same time as its own device time
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
        launches = sum(e.count for e in kernels) / reps
        print(f"{label}: wall {wall_ms:.4f} ms, device {device_ms:.4f} ms, "
              f"busy {100 * device_ms / wall_ms:.1f}%, {launches:.0f} kernel launches per call")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
            print(f"    {e.self_device_time_total / 1e3 / reps:8.4f} ms "
                  f"x{e.count // reps:<3d} {e.key[:90]}")
        if "stream" in label or "tiled" in label or label.startswith("optimize"):
            # where the host time goes: the self CPU time of the traced ops
            # (aten ops, CUDA runtime calls) per call, and what is left of
            # the traced wall time, the Python between them
            ops = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0]
            op_ms = sum(e.self_cpu_time_total for e in ops) / 1e3 / reps
            print(f"    host: {op_ms:.4f} ms self CPU in {sum(e.count for e in ops) / reps:.0f} "
                  f"traced ops per call (traced wall {traced_ms:.4f} ms)")
            for e in sorted(ops, key=lambda e: -e.self_cpu_time_total)[:8]:
                print(f"    {e.self_cpu_time_total / 1e3 / reps:8.4f} ms host "
                      f"x{e.count // reps:<4d} {e.key[:80]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
