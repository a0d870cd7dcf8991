#!/usr/bin/env python3
"""Time two versions of the port's cascade, denoise, exact, symmetric, bank and 2-D kernels
on one GPU, in turns, in one process.

Run from the root of a checkout, with one Hopper card visible and an older
checkout's kernel sources unpacked under a directory (for example the parent
commit: ``git archive HEAD vectorwave_tpu_torch/kernels | tar -x -C DIR``):

    python3 tools/ab_port_kernels.py --parent DIR [pair] [ptiles] [pvariants]
                                     [denoise] [dtiles] [dvariants]
                                     [exactsyn] [xtiles] [xvariants]
                                     [symsyn] [stiles] [svariants]
                                     [symadj] [adjtiles] [adjvariants]
                                     [exactana] [etiles] [evariants]
                                     [banksyn] [twoda] [probea] [probea_new]
                                     [atiles] [avariants]

``DIR``'s ``vectorwave_tpu_torch/kernels/csrc/*.cu`` are built into a
library of their own (one nvcc per source, all started together) and called
with that version's C interface and the plan its wrapper would use; the
checkout's kernels are called through their C interface too, with the plan
their wrapper would use, and both with their outputs allocated once; the
wrapper's own time is printed beside them.  Each case runs parent, change,
change, parent (CUDA-event medians) after both have been held against the
plain version; ptxas's registers and spills of the compared kernels are
printed first.

* ``pair``: the cascade pair (``modwt_analysis.cu``, ``modwt_synthesis.cu``,
  whose C interfaces the change keeps) at BASELINE config #2, db4 J=6
  128x65536, the parent at its tile and the change at its own: the analysis
  periodic, zero, mirror, external (halo of 441) and with the head splice,
  the synthesis periodic, zero and with right halos of 441, both in
  bfloat16; each with ``F.conv1d`` (TF32 off) and its
  bound beside it; then both at short rows (``SHORT_ROWS``, where the
  change's tile is the row); ``ptiles`` (with ``pair``) times the change at
  the preferred tiles ``PAIR_TILES``, and ``pvariants`` builds of the change
  with text replaced (``PAIR_VARIANTS``: no detail staging, other launch
  bounds, probes without loads or stores).

* ``denoise``: the fused denoise (``modwt_denoise.cu``, whose C interface
  the change keeps) at config #2 in soft, hard and none, periodic
  and zero, the stream mode with 8 blocks of 8192 for 128 streams in one
  launch (halos of the span) and periodic soft in bfloat16, each with its
  bound (4 L J fp32 FMAs a sample, or 2 x 4 B); ``dtiles`` times the change
  at the preferred tiles ``DENOISE_TILES`` and ``dvariants`` builds with
  other launch bounds (``DENOISE_VARIANTS``);
* ``exactsyn``: the exact synthesis (``modwt_exact_synthesis.cu``, whose C
  interface the change keeps) at config #2 periodic, zero and with
  right halo pairs of 441, and the sym8 J=10 plan of two launches at
  128x65536, each with its byte bound; ``xtiles`` times the change at
  ``EXACT_TILES`` and ``xvariants`` builds with other launch bounds and
  other run lengths (``EXACT_VARIANTS``); the periodic case also checks the
  round trip from the plain float64 planes against x (RMSE of hi + lo <=
  1e-10; the hi words that differ from x and the largest such |x|);
* ``symsyn``: the symmetric synthesis (``modwt_symmetric_synthesis.cu``,
  whose C interface and plan the change keeps) at config #2's symmetric
  call, db4 J=6 128x65536 in float32 and bfloat16, and sym8 J=4, the parent
  at the gates' tile and the change at its library's; ``stiles`` times the
  change at ``SYMMETRIC_TILES`` and ``svariants`` builds with other launch
  bounds and run lengths (``SYMMETRIC_VARIANTS``);
* ``symadj``: its adjoint mode (row 6b, the gradient with respect to the
  planes) at 128x65536: db4 J=6 in float32 and bfloat16, sym8 J=4 and sym8
  J=8 (stride 128), the parent at the gates' adjoint tile on the cotangent
  masked beforehand, the change at its library's tile with the interior
  spans, each with its bound; ``adjtiles`` times the change at
  ``ADJOINT_TILES`` and ``adjvariants`` builds with three blocks an SM, no
  detail staging, and pair runs on other levels (``ADJOINT_VARIANTS``);
* ``exactana``: the exact analysis (``modwt_exact_analysis.cu``, whose C
  interface the change keeps) at 128x65536: db4 J=6 periodic, zero, with a
  lo word and with a left halo of 441, sym8 J=10's two launches, and
  launches from levels 4 and 9; ``etiles`` times the change at
  ``EXACT_ANALYSIS_TILES`` and ``evariants`` builds with other run lengths
  and launch bounds (``EXACT_ANALYSIS_VARIANTS``).

Targets for a parent whose bank synthesis takes per-plane (offset, value)
tap lists and whose 2-D analysis takes a first-fit tile:

* ``banksyn``: the bank synthesis on the sym8 depth-4 packet tree's leaves
  and a level-4 pair (as ``imodwpt`` calls it) at 64x16384 and 128x65536,
  and ``dtcwt``'s whole-tree synthesis bank (sym8, 5 levels) at 64x16384,
  each with ``F.conv1d`` (TF32 off) beside it, and the change also with one
  window buffer (``stages`` = 1);
* ``twoda``: the 2-D analysis at db4 levels 1-6, 8x2048x2048, periodic,
  with ``F.conv2d`` (TF32 off) beside it; ``atiles`` (with ``twoda``) times
  the change with every tile of ``modwt2.PLAN_TILES`` that fits, and
  ``avariants`` (with ``twoda``) the same for builds that hold 4 or 2
  blocks to an SM (``ANALYSIS_VARIANTS``);
* ``probea``: the parent's 2-D analysis split into phases by probe builds of
  its source: the loads and stores alone (both passes reduced to a copy),
  with the W pass, and the whole kernel, at levels 1-6; ``probea_new`` the
  same split of the checkout's kernel (with ``twoda``).

Targets for a parent from before the bank analysis and the 2-D synthesis
were redesigned (a bank analysis with per-plane tap lists, a 2-D synthesis
with a first-fit tile): ``bank``, ``twod``, ``probe``,
``probe_new``, ``tiles`` and ``pitch4`` (the bank analysis and the 2-D
synthesis the same way; ``tiles`` times every ``modwt2.PLAN_TILES`` plan of
the synthesis).

Prints the card's name and power limit first, and one JSON line of every
time last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

IMG = (8, 2048, 2048)
BANK_SHAPES = ((64, 16384), (128, 65536))
#: the parent's 2-D synthesis tiles, first fit, and its shared-memory rule
PARENT_TILES = ((16, 128), (8, 128), (8, 64), (4, 64), (4, 32), (2, 32), (1, 32))
SHARED_LIMIT = 232448
#: probe builds of the parent's 2-D synthesis: text replaced in its source
PROBE_W = (
    "      for (int l = 0; l < L; ++l) acc = fmaf(f[l], in[w_sign * s * l], acc);",
    "      acc = in[0];",
)
#: probe builds of the change's 2-D synthesis
PROBE_NEW_W = (
    """    filter_line<kW>(acc, win_a + i * pitch + c + off_a, s, g_a, L);
    if (win_b != nullptr) filter_line<kW>(acc, win_b + i * pitch + c + off_b, s, g_b, L);""",
    "    acc[0] = win_a[i * pitch + c + off_a];",
)
PROBE_NEW_H = (
    "    h_pass(oacc, rowbuf, rpitch, h ? g_hi : g_lo, th, tw, L);",
    "    oacc[0][0] += rowbuf[threadIdx.x];",
)
PROBE_H = (
    """    for (int l = 0; l < L; ++l) {
      v = fmaf(s_lo[l], a[ops.lo_sign * l * tw], v);
      v = fmaf(s_hi[l], d[ops.hi_sign * l * tw], v);
    }""",
    "    v = a[0] + d[0];",
)
#: probe builds of the parent's 2-D analysis: its W-pass and H-pass loops
PROBE_A_W = (
    """    for (int l = 0; l < L; ++l) {
      const float v = src[-s * l];
      a = fmaf(s_lo[l], v, a);
      d = fmaf(s_hi[l], v, d);
    }""",
    "    a = src[0];\n    d = a;",
)
PROBE_A_H = (
    """    for (int l = 0; l < L; ++l) {
      const int i = (k + L - 1 - l) * tw + c;
      const float a = aw[i];
      const float d = dw[i];
      v_ll = fmaf(s_lo[l], a, v_ll);
      v_hl = fmaf(s_hi[l], a, v_hl);
      v_lh = fmaf(s_lo[l], d, v_lh);
      v_hh = fmaf(s_hi[l], d, v_hh);
    }""",
    "    v_ll = aw[(k + L - 1) * tw + c];\n    v_lh = dw[(k + L - 1) * tw + c];",
)
#: variant builds of the change's 2-D analysis (target ``avariants``): the
#: blocks an SM must hold, and so the registers a thread may take
ANALYSIS_VARIANTS = {
    "min4": (("__launch_bounds__(kThreads, 3)", "__launch_bounds__(kThreads, 4)"),),
    "min2": (("__launch_bounds__(kThreads, 3)", "__launch_bounds__(kThreads, 2)"),),
}
#: probe builds of the change's 2-D analysis
PROBE_NEW_A_W = (
    "    filter_line2<kW>(a, d, win + i * pitch + c, s, g_lo, g_hi, L);",
    "    a[0] = win[i * pitch + c];\n    d[0] = a[0];",
)
PROBE_NEW_A_H = (
    """      filter_line2<kH>(ll, hl, a_col, rpitch, g_lo, g_hi, L);
      filter_line2<kH>(lh, hh, d_col, rpitch, g_lo, g_hi, L);""",
    "      ll[0] = a_col[0];\n      lh[0] = d_col[0];",
)


def median_ms(fn, warmup=3, reps=20, queue=1):
    """Median ms of one call.  queue=1 times each call from an idle card, so
    the host's launch time is inside it; a larger queue times that many
    calls back to back and divides, the card's own time once the host runs
    ahead of it."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(queue):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / queue)
    times.sort()
    return times[len(times) // 2]


#: calls timed back to back for a device time (median_ms's queue)
QUEUE = 8


SHOWN = ("modwt_analysis", "modwt_synthesis", "modwt_bank_analysis",
         "modwt_bank_synthesis", "modwt2_analysis", "modwt2_synthesis", "modwt_denoise",
         "modwt_exact_synthesis", "modwt_exact_analysis", "modwt_symmetric_synthesis")
#: config #2 and the cascade pair's tiles and variant builds (target ``pair``)
PAIR_SHAPE = (128, 65536)
#: the parent's own tile at config #2 (its rule: 2048, halved until a block
#: fits; the mirror at least (L-1) 2^(J-1) = 224)
PARENT_PAIR_TILE = 2048
PAIR_TILES = (1024, 1870, 2048, 2087, 3072, 4096, 4174, 4391, 6478, 8192)
#: rows shorter than the preferred tile: (batch, n), the same samples as
#: config #2 at n = 1024 and 2048 and a row of 3000
SHORT_ROWS = ((8192, 1024), (4096, 2048), (2048, 3000))
#: probe patches of the analysis: no window copy; stores that never happen
#: (on values the compiler must still compute)
A_NO_LOAD = ("  copy_row_window(cur + before, row + g0 + before, width - before);\n", "")
A_NO_STORE = (
    ("      if (o >= 0 && o < n_out) {",
     "      if (o >= 0 && o < n_out && v == 1.2345e30f) {"),
    ("    aj[o] = from_f32<T>(",
     "    if (cur[span + o] == 1.2345e30f) aj[o] = from_f32<T>("),
)
PAIR_VARIANTS = {
    "modwt_analysis": {
        "nostage": (("const bool stage_here = staged != nullptr && s < kStagedStride;",
                     "const bool stage_here = false;"),),
        "bounds4": (("__launch_bounds__(kThreads, 3)", "__launch_bounds__(kThreads, 4)"),),
        "bounds2": (("__launch_bounds__(kThreads, 3)", "__launch_bounds__(kThreads, 2)"),),
        "guarded": (("          if (lim == kRunBlock && lp == L) {", "          if (false) {"),),
        "noload": (A_NO_LOAD,),
        "nostore": A_NO_STORE,
        "computeonly": (A_NO_LOAD, *A_NO_STORE),
    },
    "modwt_synthesis": {
        "guarded": (("        if (lim == kRunBlock && lp == L) {", "        if (false) {"),),
        "noload": (("    copy_row_window(dst, row + t0, inside);\n", ""),),
        "nostore": (("dst[o] = from_f32<T>(cur[o]);",
                     "if (cur[o] == 1.2345e30f) dst[o] = from_f32<T>(cur[o]);"),),
        "bounds3": (("__launch_bounds__(kThreads, 4)", "__launch_bounds__(kThreads, 3)"),),
    },
}


def build(sources, out_dir: pathlib.Path, name: str, defines=()):
    """Compile each source with its own nvcc, all at once, and link them;
    print ptxas's registers and spills of the two kernels compared."""
    from vectorwave_tpu_torch.kernels import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    objs, cmds = [], []
    for src in sources:
        obj = out_dir / f"{name}_{src.stem}.o"
        cmds.append([_build.nvcc(), *_build.NVCC_FLAGS, *defines, "-Xptxas", "-v", "-c",
                     "-o", str(obj), str(src)])
        objs.append(obj)
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    for c, p in zip(cmds, procs):
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{' '.join(c)}\n{out}")
        for line in out.splitlines():
            if ("registers" in line or "spill" in line or "properties" in line) and any(
                    k in c[-1] for k in SHOWN):
                print(f"  [{name} {pathlib.Path(c[-1]).stem}] {line.strip()}", flush=True)
    lib = out_dir / f"lib{name}.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
                    *map(str, objs)], check=True)
    return ctypes.CDLL(str(lib))


def parent_synthesis_tile(taps, spacing):
    rows = lambda th: th + taps - 1  # noqa: E731
    for th, tw in PARENT_TILES:
        width = tw + spacing * (taps - 1)
        if 4 * (2 * taps + rows(th) * width + 2 * rows(th) * tw + rows(th) + width) <= SHARED_LIMIT:
            return th, tw
    raise RuntimeError("no parent tile")


def parent_analysis_tile(taps, spacing):
    """The first-fit tile of a 2-D analysis with index tables."""
    for th, tw in PARENT_TILES:
        rows, width = th + taps - 1, tw + spacing * (taps - 1)
        if 4 * (2 * taps + rows * width + 2 * rows * tw + rows + width) <= SHARED_LIMIT:
            return th, tw
    raise RuntimeError("no parent tile")


def parent_bank_tile(span):
    """The tile of a bank synthesis that stages its taps in 1024-tap chunks."""
    tile = 2048
    while tile >= 256:
        if 4 * (tile + span) + 8 * 1024 <= SHARED_LIMIT:
            return tile
        tile //= 2
    raise RuntimeError("no parent tile")


def split(name, csrc, text, patches, build_dir, fn_name, argtypes):
    """A probe build of one kernel source with text replaced."""
    for before, after in patches:
        assert before in text, before
        text = text.replace(before, after)
    src = csrc / f"{name}.cu"
    src.write_text(text)
    fn = getattr(build([src], build_dir, name), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def declare_synthesis(lib):
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = lib.vw_modwt2_synthesis_level
    fn.argtypes = [ptr] * 6 + [i64] * 3 + [i32] * 9 + [ptr]
    fn.restype = i32
    return fn


def pair_target(args, parent, work, turns):
    """The cascade pair, parent vs change, at config #2 (target ``pair``)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    import vectorwave_tpu_torch as vt
    from vectorwave_tpu_torch.kernels import _build
    from vectorwave_tpu_torch.kernels import modwt_composite as mc
    from vectorwave_tpu_torch.kernels import modwt_symmetric as ms
    from vectorwave_tpu_torch.kernels.modwt_composite import _device_taps, _stream
    from vectorwave_tpu_torch.kernels.modwt_fused import _kernel_filters

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    new_lib = _build.library()
    for name in ("vw_modwt_analysis", "vw_modwt_synthesis"):  # one declaration for both
        fn, new_fn = getattr(parent, name), getattr(new_lib, name)
        fn.argtypes, fn.restype = new_fn.argtypes, new_fn.restype
    levels, (b, n) = 6, PAIR_SHAPE
    w = vt.wavelet("db4")
    fd, fr = _kernel_filters(w, synthesis=False), _kernel_filters(w, synthesis=True)
    taps = len(fd[0])
    span = mc.composite_halo_samples(taps, levels)
    tap_d = _device_taps(tuple(fd[0]) + tuple(fd[1]), dev.index)
    tap_r = _device_taps(tuple(fr[0]) + tuple(fr[1]), dev.index)
    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*[q.data_ptr() for q in ts])  # noqa: E731
    samples = b * n
    bound = 32 * samples / 3.35e12 * 1e3  # x and 7 planes, 4 bytes each
    comp = [torch.tensor(f, dtype=torch.float32, device=dev)
            for f in mc.composite_plane_filters(np.array(fd[0]), np.array(fd[1]), levels)]
    k = max(len(f) for f in comp)
    bank = torch.zeros(levels + 1, k, device=dev)
    for i, f in enumerate(comp):
        bank[i, : len(f)] = f
    bank_d = bank.flip(-1)[:, None].contiguous()
    comp_r = [torch.tensor(f, dtype=torch.float32, device=dev)
              for f in mc.composite_plane_filters(np.array(fr[0]), np.array(fr[1]), levels)]
    bank_r = torch.zeros(levels + 1, k, device=dev)
    for i, f in enumerate(comp_r):
        bank_r[i, : len(f)] = f

    def analysis_call(fn, x, outs, edge, tile, head=None, halo=None):
        def call():
            err = fn(x.data_ptr(), ptrs(outs), tap_d.data_ptr(),
                     None if head is None else head.data_ptr(),
                     0 if head is None else head.shape[-1],
                     None if halo is None else halo.data_ptr(),
                     0 if halo is None else halo.shape[-1], *x.shape, levels, taps, tile,
                     mc.EDGES[edge], mc._DTYPE_CODES[x.dtype], _stream(dev))
            if err:
                raise RuntimeError(f"kernel launch failed with CUDA error {err}")
            return outs
        return call

    def synthesis_call(fn, planes, out, periodic, tile, halo=None):
        def call():
            err = fn(ptrs(planes), None if halo is None else ptrs(halo),
                     0 if halo is None else halo[0].shape[-1], out.data_ptr(),
                     tap_r.data_ptr(), *out.shape, levels, taps, tile, int(periodic),
                     mc._DTYPE_CODES[out.dtype], _stream(dev))
            if err:
                raise RuntimeError(f"kernel launch failed with CUDA error {err}")
            return out
        return call

    def check_with(want):
        def check(f):
            got = f()
            torch.cuda.synchronize()
            got = got if isinstance(got, (list, tuple)) else (got,)
            ref = want if isinstance(want, (list, tuple)) else (want,)
            return max(float((g.float() - r.float()).abs().max()) for g, r in zip(got, ref))
        return check

    variants = {}
    if "pvariants" in args.what:
        here = ROOT / "vectorwave_tpu_torch" / "kernels" / "csrc"
        var_src = work / "pair_variants"
        var_src.mkdir(parents=True, exist_ok=True)
        for header in here.glob("*.cuh"):
            shutil.copy(header, var_src / header.name)
        for kernel, builds in PAIR_VARIANTS.items():
            text = (here / f"{kernel}.cu").read_text()
            for name, patches in builds.items():
                variants[(kernel, name)] = split(
                    f"{name}_{kernel}", var_src, text, patches, work, f"vw_{kernel}",
                    getattr(new_lib, f"vw_{kernel}").argtypes)

    rows = []
    if "platency" in args.what:
        # the change's time against the number of blocks: one block an SM
        # (batch 4 at tile 2048: 128 blocks) gives a block's latency
        for rows_b in (4, 8, 12, 16, 32, 64, 128):
            xb = torch.randn(rows_b, n, device=dev, generator=gen)
            ob = [torch.empty_like(xb) for _ in range(levels + 1)]
            tile = new_lib.vw_modwt_analysis_tile(taps, levels, n, mc.ANALYSIS_TILE, 1)

            def call_a(xb=xb, ob=ob, rows_b=rows_b):
                err = new_lib.vw_modwt_analysis(
                    xb.data_ptr(), ptrs(ob), tap_d.data_ptr(), None, 0, None, 0, rows_b, n,
                    levels, taps, tile, mc.EDGES["periodic"], 0, _stream(dev))
                assert err == 0

            def call_s(xb=xb, ob=ob, rows_b=rows_b):
                err = new_lib.vw_modwt_synthesis(
                    ptrs(ob), None, 0, xb.data_ptr(), tap_r.data_ptr(), rows_b, n, levels,
                    taps, tile, 1, 0, _stream(dev))
                assert err == 0
            blocks = rows_b * -(-n // tile)
            print(f"  {rows_b}x{n} ({blocks} blocks of {tile}): analysis "
                  f"{median_ms(call_a, queue=QUEUE):.4f} ms, synthesis "
                  f"{median_ms(call_s, queue=QUEUE):.4f} ms ({QUEUE} queued)",
                  flush=True)
            del xb, ob
        # the change at two tiles on the streaming tier's blocks (128 x 8192)
        # and a tiled call's shards (1024 x 8192)
        for rows_b, nb in ((128, 8192), (1024, 8192)):
            xb = torch.randn(rows_b, nb, device=dev, generator=gen)
            ob = [torch.empty_like(xb) for _ in range(levels + 1)]
            line = []
            for tile in (2048, 4096):
                def call_a(xb=xb, ob=ob, rows_b=rows_b, nb=nb, tile=tile):
                    err = new_lib.vw_modwt_analysis(
                        xb.data_ptr(), ptrs(ob), tap_d.data_ptr(), None, 0, None, 0, rows_b,
                        nb, levels, taps, tile, mc.EDGES["zero"], 0, _stream(dev))
                    assert err == 0

                def call_s(xb=xb, ob=ob, rows_b=rows_b, nb=nb, tile=tile):
                    err = new_lib.vw_modwt_synthesis(
                        ptrs(ob), None, 0, xb.data_ptr(), tap_r.data_ptr(), rows_b, nb,
                        levels, taps, tile, 0, 0, _stream(dev))
                    assert err == 0
                line.append(f"tile {tile}: analysis {median_ms(call_a, queue=QUEUE):.4f}, "
                            f"synthesis {median_ms(call_s, queue=QUEUE):.4f}")
            print(f"  {rows_b}x{nb}: " + "; ".join(line) + f" ms ({QUEUE} queued)", flush=True)
            del xb, ob
        # the change's time against the depth, one block an SM and config #2
        for rows_b in (4, 128):
            xb = torch.randn(rows_b, n, device=dev, generator=gen)
            ob = [torch.empty_like(xb) for _ in range(11)]
            line = []
            for depth in range(1, 11):
                tile = new_lib.vw_modwt_analysis_tile(taps, depth, n, mc.ANALYSIS_TILE, 1)

                def call_d(xb=xb, ob=ob, rows_b=rows_b, depth=depth, tile=tile):
                    err = new_lib.vw_modwt_analysis(
                        xb.data_ptr(), ptrs(ob[: depth + 1]), tap_d.data_ptr(), None, 0, None,
                        0, rows_b, n, depth, taps, tile, mc.EDGES["periodic"], 0,
                        _stream(dev))
                    assert err == 0
                line.append(f"J={depth} {median_ms(call_d, queue=QUEUE):.4f}")
            print(f"  analysis {rows_b}x{n} by depth: " + ", ".join(line) + " ms", flush=True)
            del xb, ob
    print(f"cascade pair: parent vs change, db4 J={levels}, {b}x{n}", flush=True)
    x32 = torch.randn(b, n, device=dev, generator=gen)
    halo = torch.randn(b, span, device=dev, generator=gen)
    head = torch.stack(ms._symmetric_cascade(x32[:, :span], fd, levels)).contiguous()
    tile_a = new_lib.vw_modwt_analysis_tile(taps, levels, n, mc.ANALYSIS_TILE, 1)
    cases_a = [("periodic", x32, "periodic", None, None), ("zero", x32, "zero", None, None),
               ("mirror", x32, "mirror", None, None),
               ("external halo 441", x32, "external", None, halo),
               ("external with head splice", x32, "external", head, halo),
               ("periodic bfloat16", x32.bfloat16(), "periodic", None, None)]
    for label, x, edge, hd, hl in cases_a:
        outs = [torch.empty_like(x) for _ in range(levels + 1)]
        if edge == "mirror":
            want = ms._symmetric_cascade(x, fd, levels)
        else:
            want = mc.analysis_plain(x, levels, fd, edge == "periodic", hd,
                                     None if hl is None else hl.to(x.dtype))
        tile = new_lib.vw_modwt_analysis_tile(taps, levels, n, mc.ANALYSIS_TILE,
                                              mc.EDGES[edge])
        hl = None if hl is None else hl.to(x.dtype)
        check = check_with(want)
        row = turns(f"analysis {label} (tiles {PARENT_PAIR_TILE} / {tile})",
                    analysis_call(parent.vw_modwt_analysis, x, outs, edge, PARENT_PAIR_TILE,
                                  hd, hl),
                    analysis_call(new_lib.vw_modwt_analysis, x, outs, edge, tile, hd, hl),
                    check)
        row["kernel"], row["bound_ms"] = "modwt_analysis", bound
        if label == "periodic":
            row["wrapper_ms"] = median_ms(lambda: mc.analysis(x, levels, fd, True))
            row["library_ms"] = median_ms(lambda: F.conv1d(
                F.pad(x[:, None], (span, 0), mode="circular"), bank_d))
            print(f"    the wrapper {row['wrapper_ms']:.4f} ms, F.conv1d "
                  f"{row['library_ms']:.4f} ms, bound {bound:.4f} ms (bytes)", flush=True)
            if "ptiles" in args.what:
                row["tiles"] = {}
                for alt in PAIR_TILES:
                    call = analysis_call(new_lib.vw_modwt_analysis, x, outs, edge, alt)
                    used = new_lib.vw_modwt_analysis_tile(taps, levels, n, alt, 1)
                    row["tiles"][alt] = (median_ms(call, queue=QUEUE), check(call),
                                         new_lib.vw_modwt_analysis_shared_bytes(
                                             taps, levels, used))
                print("    tiles: " + ", ".join(f"{k} {v[0]:.4f} ms ({v[2]} B, err {v[1]:.1e})"
                                                 for k, v in row["tiles"].items()), flush=True)
            for (kernel, name), fn in variants.items():
                if kernel == "modwt_analysis":
                    row[f"variant_{name}"] = {}
                    for alt in (tile_a, *PAIR_TILES) if "ptiles" in args.what else (tile_a,):
                        call = analysis_call(fn, x, outs, edge, alt)
                        row[f"variant_{name}"][alt] = (median_ms(call, queue=QUEUE),
                                                       check(call))
                    print(f"    variant {name}: " + ", ".join(
                        f"{k} {v[0]:.4f} ms (err {v[1]:.1e})"
                        for k, v in row[f"variant_{name}"].items()), flush=True)
        rows.append(row)
        del outs, want

    planes32 = list(mc.analysis_plain(x32, levels, fd, True))
    rhalo = [torch.randn(b, span, device=dev, generator=gen) for _ in range(levels + 1)]
    tile_s = new_lib.vw_modwt_synthesis_tile(taps, levels, n, mc.SYNTHESIS_TILE)
    cases_s = [("periodic", planes32, True, None), ("zero", planes32, False, None),
               ("right halos 441", planes32, False, rhalo),
               ("periodic bfloat16", [q.bfloat16() for q in planes32], True, None)]
    for label, planes, periodic, hl in cases_s:
        out = torch.empty_like(planes[0])
        want = mc.synthesis_plain(planes, levels, fr, periodic, hl)
        check = check_with(want)
        row = turns(f"synthesis {label} (tiles {PARENT_PAIR_TILE} / {tile_s})",
                    synthesis_call(parent.vw_modwt_synthesis, planes, out, periodic,
                                   PARENT_PAIR_TILE, hl),
                    synthesis_call(new_lib.vw_modwt_synthesis, planes, out, periodic, tile_s, hl),
                    check)
        row["kernel"], row["bound_ms"] = "modwt_synthesis", bound
        if label == "periodic":
            stacked = torch.stack(planes, dim=1)
            row["wrapper_ms"] = median_ms(lambda: mc.synthesis(planes, levels, fr, True))
            row["library_ms"] = median_ms(lambda: F.conv1d(
                F.pad(stacked, (0, span), mode="circular"), bank_r[None]))
            print(f"    the wrapper {row['wrapper_ms']:.4f} ms, F.conv1d "
                  f"{row['library_ms']:.4f} ms, bound {bound:.4f} ms (bytes)", flush=True)
            del stacked
            if "ptiles" in args.what:
                row["tiles"] = {}
                for alt in PAIR_TILES:
                    call = synthesis_call(new_lib.vw_modwt_synthesis, planes, out, periodic, alt)
                    used = new_lib.vw_modwt_synthesis_tile(taps, levels, n, alt)
                    row["tiles"][alt] = (median_ms(call, queue=QUEUE), check(call),
                                         new_lib.vw_modwt_synthesis_shared_bytes(
                                             taps, levels, used))
                print("    tiles: " + ", ".join(f"{k} {v[0]:.4f} ms ({v[2]} B, err {v[1]:.1e})"
                                                 for k, v in row["tiles"].items()), flush=True)
            for (kernel, name), fn in variants.items():
                if kernel == "modwt_synthesis":
                    row[f"variant_{name}"] = {}
                    for alt in (tile_s, *PAIR_TILES) if "ptiles" in args.what else (tile_s,):
                        call = synthesis_call(fn, planes, out, periodic, alt)
                        row[f"variant_{name}"][alt] = (median_ms(call, queue=QUEUE),
                                                       check(call))
                    print(f"    variant {name}: " + ", ".join(
                        f"{k} {v[0]:.4f} ms (err {v[1]:.1e})"
                        for k, v in row[f"variant_{name}"].items()), flush=True)
        rows.append(row)
        del out, want

    for rows_b, nb in SHORT_ROWS:
        # rows shorter than the preferred tile: the change's block reserves
        # shared memory for its row, the parent's for its tile of 2048
        xb = torch.randn(rows_b, nb, device=dev, generator=gen)
        outs = [torch.empty_like(xb) for _ in range(levels + 1)]
        want = mc.analysis_plain(xb, levels, fd, True)
        used = new_lib.vw_modwt_analysis_tile(taps, levels, nb, mc.ANALYSIS_TILE, 1)
        row = turns(f"analysis periodic {rows_b}x{nb} (tiles {PARENT_PAIR_TILE} / {used})",
                    analysis_call(parent.vw_modwt_analysis, xb, outs, "periodic",
                                  PARENT_PAIR_TILE),
                    analysis_call(new_lib.vw_modwt_analysis, xb, outs, "periodic",
                                  mc.ANALYSIS_TILE),
                    check_with(want))
        row["kernel"], row["bound_ms"] = "modwt_analysis", 32 * xb.numel() / 3.35e12 * 1e3
        rows.append(row)
        out = torch.empty_like(xb)
        used = new_lib.vw_modwt_synthesis_tile(taps, levels, nb, mc.SYNTHESIS_TILE)
        row = turns(f"synthesis periodic {rows_b}x{nb} (tiles {PARENT_PAIR_TILE} / {used})",
                    synthesis_call(parent.vw_modwt_synthesis, list(want), out, True,
                                   PARENT_PAIR_TILE),
                    synthesis_call(new_lib.vw_modwt_synthesis, list(want), out, True,
                                   mc.SYNTHESIS_TILE),
                    check_with(mc.synthesis_plain(list(want), levels, fr, True)))
        row["kernel"], row["bound_ms"] = "modwt_synthesis", 32 * xb.numel() / 3.35e12 * 1e3
        rows.append(row)
        del xb, outs, out, want
    return rows


#: the denoise's preferred tiles (target ``dtiles``), the exact synthesis's
#: (``xtiles``); the parent's denoise tile at config #2 (its rule: 1024,
#: halved until a block fits) and the stream shape: 8 blocks of 8192 for
#: 128 streams in one launch, with halos of the span
DENOISE_TILES = (512, 1024, 1536, 2048, 2560, 3072, 4096)
EXACT_TILES = (1024, 2048, 3072, 4096)
PARENT_DENOISE_TILE = 1024
STREAM_SHAPE = (8 * 128, 8192)
#: variant builds of the change (targets ``dvariants``, ``xvariants``)
DENOISE_VARIANTS = {
    "bounds2": (("__launch_bounds__(kThreads, 3)", "__launch_bounds__(kThreads, 2)"),),
    "bounds4": (("__launch_bounds__(kThreads, 3)", "__launch_bounds__(kThreads, 4)"),),
    # probes (wrong results, timed alone): the window copy and the analysis
    # half with its plane stores, no synthesis; the synthesis half on
    # whatever the plane rows hold, no analysis
    "probe_analysis": (("  for (int j = levels; j >= 1; --j) {",
                        "  for (int j = levels; j >= 1 && n < 0; --j) {"),),
    "probe_synthesis": (("  for (int j = 1; j <= levels; ++j) {",
                         "  for (int j = 1; j <= levels && n < 0; ++j) {"),),
}
EXACT_VARIANTS = {
    "bounds3": (("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 3)"),),
    "block3": (("constexpr int kExactBlock = 9;", "constexpr int kExactBlock = 3;"),),
    "block5": (("constexpr int kExactBlock = 9;", "constexpr int kExactBlock = 5;"),),
}


def variant_builds(kernel, builds, new_fn, work):
    """Builds of the checkout's `kernel` source with text replaced, beside a
    copy of its headers: {name: C entry point}."""
    here = ROOT / "vectorwave_tpu_torch" / "kernels" / "csrc"
    var_src = work / f"{kernel}_variants"
    var_src.mkdir(parents=True, exist_ok=True)
    for header in here.glob("*.cuh"):
        shutil.copy(header, var_src / header.name)
    text = (here / f"{kernel}.cu").read_text()
    return {name: split(f"{name}_{kernel}", var_src, text, patches, work, f"vw_{kernel}",
                        new_fn.argtypes)
            for name, patches in builds.items()}


def denoise_target(args, parent, work, turns):
    """The fused denoise, parent vs change, at config #2 (target ``denoise``):
    soft, hard and none in periodic and zero, the stream mode with K = 8
    blocks of 8192 for 128 streams in one launch, and bfloat16; ``dtiles``
    times the change at DENOISE_TILES, ``dvariants`` its variant builds."""
    import torch

    import vectorwave_tpu_torch as vt
    from chip_smoke import gap_thresholds
    from vectorwave_tpu_torch.kernels import _build
    from vectorwave_tpu_torch.kernels import modwt_composite as mc
    from vectorwave_tpu_torch.kernels.modwt_composite import _device_taps, _stream
    from vectorwave_tpu_torch.kernels.modwt_fused import _kernel_filters

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2)
    new_lib = _build.library()
    fn, new_fn = parent.vw_modwt_denoise, new_lib.vw_modwt_denoise
    fn.argtypes, fn.restype = new_fn.argtypes, new_fn.restype
    variants = (variant_builds("modwt_denoise", DENOISE_VARIANTS, new_fn, work)
                if "dvariants" in args.what else {})
    levels, (b, n) = 6, PAIR_SHAPE
    w = vt.wavelet("db4")
    fd, fr = _kernel_filters(w, synthesis=False), _kernel_filters(w, synthesis=True)
    taps = len(fd[0])
    span = mc.composite_halo_samples(taps, levels)
    tap_t = _device_taps(tuple(fd[0]) + tuple(fd[1]) + tuple(fr[0]) + tuple(fr[1]),
                         dev.index)

    def bound(x):
        """Each input read once, each output written once, against 4 L J
        fp32 FMAs a sample."""
        t_bytes = 2 * x.element_size() * x.numel() / 3.35e12 * 1e3
        t_ops = 2 * 4 * taps * levels * x.numel() / 67e12 * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    def call(f, x, out, th, periodic, mode, tile, halo=None):
        def run():
            err = f(x.data_ptr(), out.data_ptr(), th.data_ptr(), tap_t.data_ptr(),
                    None if halo is None else halo.data_ptr(),
                    0 if halo is None else halo.shape[-1], *x.shape, levels, taps, tile,
                    int(periodic), mc._MODES[mode], mc._DTYPE_CODES[x.dtype], _stream(dev))
            if err:
                raise RuntimeError(f"kernel launch failed with CUDA error {err}")
            return out
        return run

    def check_with(want):
        def check(f):
            got = f()
            torch.cuda.synchronize()
            return float((got.float() - want.float()).abs().max())
        return check

    print(f"fused denoise: parent vs change, db4 J={levels}", flush=True)
    x32 = torch.randn(b, n, device=dev, generator=gen)
    xs = torch.randn(*STREAM_SHAPE, device=dev, generator=gen)
    hs = torch.randn(STREAM_SHAPE[0], span, device=dev, generator=gen)
    cases = [(f"{mode} {'periodic' if periodic else 'zero'} {b}x{n}", x32, periodic, mode, None)
             for periodic in (True, False) for mode in ("soft", "hard", "none")]
    cases += [(f"soft stream K=8, {STREAM_SHAPE[0]}x{STREAM_SHAPE[1]} with halos of {span}",
               xs, False, "soft", hs),
              (f"soft periodic {b}x{n} bfloat16", x32.bfloat16(), True, "soft", None)]
    rows = []
    for label, x, periodic, mode, halo in cases:
        planes = (mc._analysis_cascade(x, levels, fd, periodic) if halo is None
                  else mc._external_cascade(x, halo, levels, fd))
        th = gap_thresholds(planes, levels)
        del planes
        out = torch.empty_like(x)
        want = mc.denoise_plain(x, th, levels, fd, fr, periodic, mode, halo)
        check = check_with(want)
        row = turns(label, call(fn, x, out, th, periodic, mode, PARENT_DENOISE_TILE, halo),
                    call(new_fn, x, out, th, periodic, mode, mc.DENOISE_LAUNCH_TILE, halo),
                    check)
        row["kernel"] = "modwt_denoise"
        row["bound_ms"], row["bound_by"] = bound(x)
        used = new_lib.vw_modwt_denoise_tile(taps, levels, x.shape[1],
                                             mc.DENOISE_LAUNCH_TILE)
        row["tile"] = used
        print(f"    bound {row['bound_ms']:.4f} ms ({row['bound_by']}); the change's tile "
              f"{used}, {new_lib.vw_modwt_denoise_shared_bytes(taps, levels, used)} B",
              flush=True)
        if x.dtype == torch.float32 and mode == "soft" and (periodic or halo is not None):
            if "dtiles" in args.what:
                row["tiles"] = {}
                for alt in DENOISE_TILES:
                    f = call(new_fn, x, out, th, periodic, mode, alt, halo)
                    got = new_lib.vw_modwt_denoise_tile(taps, levels, x.shape[1], alt)
                    row["tiles"][alt] = (median_ms(f, queue=QUEUE), check(f),
                                         new_lib.vw_modwt_denoise_shared_bytes(
                                             taps, levels, got))
                print("    tiles: " + ", ".join(
                    f"{k} {v[0]:.4f} ms ({v[2]} B, err {v[1]:.1e})"
                    for k, v in row["tiles"].items()), flush=True)
            for name, vfn in variants.items():
                row[f"variant_{name}"] = {}
                for alt in (DENOISE_TILES if "dtiles" in args.what
                            else (mc.DENOISE_LAUNCH_TILE,)):
                    f = call(vfn, x, out, th, periodic, mode, alt, halo)
                    row[f"variant_{name}"][alt] = (median_ms(f, queue=QUEUE), check(f))
                print(f"    variant {name}: " + ", ".join(
                    f"{k} {v[0]:.4f} ms (err {v[1]:.1e})"
                    for k, v in row[f"variant_{name}"].items()), flush=True)
        rows.append(row)
        del out, want
    return rows


def exactsyn_target(args, parent, work, turns):
    """The exact synthesis, parent vs change (target ``exactsyn``): config #2
    periodic, zero and with right halo pairs of 441, and sym8 J=10, a plan
    of two launches, at 128x65536; ``xtiles`` times the change at
    EXACT_TILES, ``xvariants`` its variant builds."""
    import torch

    import vectorwave_tpu_torch as vt
    from vectorwave_tpu_torch.kernels import _build
    from vectorwave_tpu_torch.kernels import modwt_composite as mc
    from vectorwave_tpu_torch.kernels.modwt_composite import _device_taps, _stream
    from vectorwave_tpu_torch.kernels.modwt_fused import _kernel_filters

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    new_lib = _build.library()
    fn, new_fn = parent.vw_modwt_exact_synthesis, new_lib.vw_modwt_exact_synthesis
    fn.argtypes, fn.restype = new_fn.argtypes, new_fn.restype
    variants = (variant_builds("modwt_exact_synthesis", EXACT_VARIANTS, new_fn, work)
                if "xvariants" in args.what else {})
    b, n = PAIR_SHAPE
    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*[q.data_ptr() for q in ts])  # noqa: E731
    rows = []
    print("exact synthesis: parent vs change", flush=True)
    for name, levels in (("db4", 6), ("sym8", 10)):
        w = vt.wavelet(name)
        fd, fr = _kernel_filters(w, synthesis=False), _kernel_filters(w, synthesis=True)
        taps = len(fr[0])
        span = mc.composite_halo_samples(taps, levels)
        tap_t = _device_taps(tuple(fr[0]) + tuple(fr[1]), dev.index, torch.float64)
        x = torch.randn(b, n, device=dev, generator=gen)
        pairs = mc.exact_analysis_plain(x, None, levels, fd, True)
        plan = mc.exact_launches(mc.exact_synthesis_shared_bytes, taps, levels)
        halo = [tuple(torch.randn(b, span, device=dev, generator=gen) * 2.0**k
                      for k in (0, -26)) for _ in range(levels + 1)]
        outs = [(torch.empty_like(x), torch.empty_like(x)) for _ in plan]
        cases = [("periodic", True, None), ("zero", False, None)]
        if len(plan) == 1:
            cases.append((f"zero with right halo pairs of {span}", False, halo))

        def call(f, periodic, hl, tile):
            """The plan's launches; a window launch of the change at `tile`
            (the parent at the plan's)."""
            def run():
                cur = pairs[levels]
                for (first, count, t, direct), (o_hi, o_lo) in zip(reversed(plan), outs):
                    ins = [q for pair in (*pairs[first - 1: first - 1 + count], cur)
                           for q in pair]
                    err = f(ptrs(ins), None if hl is None else ptrs([q for p in hl for q in p]),
                            0 if hl is None else span, o_hi.data_ptr(), o_lo.data_ptr(),
                            tap_t.data_ptr(), b, n, first, count, taps,
                            t if tile is None or direct else tile, int(periodic),
                            int(direct),
                            _stream(dev))
                    if err:
                        raise RuntimeError(f"kernel launch failed with CUDA error {err}")
                    cur = (o_hi, o_lo)
                return cur
            return run

        for label, periodic, hl in cases:
            want = mc.exact_synthesis_plain(pairs, levels, fr, periodic, 1, hl)

            def check(f, want=want):
                hi, lo = f()
                torch.cuda.synchronize()
                return float((hi.double() + lo.double() - want[0].double()
                              - want[1].double()).abs().max())
            label = f"{name} J={levels} {label} {b}x{n}, plan {plan}"
            row = turns(label, call(fn, periodic, hl, None),
                        call(new_fn, periodic, hl, mc.EXACT_SYNTHESIS_LAUNCH_TILE), check)
            row["kernel"] = "modwt_exact_synthesis"
            nbytes = (8 * (levels + 1) + 8) * b * n + (0 if hl is None else
                                                       8 * (levels + 1) * b * span)
            t_bytes = nbytes / 3.35e12 * 1e3
            t_ops = 2 * 2 * taps * levels * b * n / 34e12 * 1e3
            row["bound_ms"] = max(t_bytes, t_ops)
            row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            row["tiles_used"] = [new_lib.vw_modwt_exact_synthesis_tile(
                taps, first, count, n, mc.EXACT_SYNTHESIS_LAUNCH_TILE)
                for first, count, _, _ in plan]
            print(f"    bound {row['bound_ms']:.4f} ms ({row['bound_by']}); the change's "
                  f"tiles {row['tiles_used']}, " + ", ".join(
                      f"{new_lib.vw_modwt_exact_synthesis_shared_bytes(taps, first, count, u)} B"
                      for (first, count, _, _), u in zip(plan, row["tiles_used"])),
                  flush=True)
            if label.startswith("db4") and periodic:
                # the planes carry about 48 bits, so hi + lo returns x to about
                # 1e-14; the hi word then rounds back to x except where |x| is
                # below about 2^25 times that error (its half ulp is smaller)
                y = call(new_fn, periodic, hl, mc.EXACT_SYNTHESIS_LAUNCH_TILE)()
                torch.cuda.synchronize()
                e = y[0].double() + y[1].double() - x.double()
                rmse, worst = float(e.pow(2).mean().sqrt()), float(e.abs().max())
                unequal = y[0] != x
                row["round_trip"] = (rmse, worst, int(unequal.sum()),
                                     float(x[unequal].abs().max()) if unequal.any() else 0.0)
                print(f"    periodic round trip from the plain float64 planes: RMSE of hi + lo "
                      f"{rmse:.3e} <= 1e-10: {rmse <= 1e-10}; max error {worst:.3e}; "
                      f"{row['round_trip'][2]} hi words differ from x, the largest such |x| "
                      f"{row['round_trip'][3]:.3e} (2^25 x the max error: "
                      f"{2.0**25 * worst:.3e})", flush=True)
                if "xtiles" in args.what:
                    row["tiles"] = {}
                    for alt in EXACT_TILES:
                        f = call(new_fn, periodic, hl, alt)
                        row["tiles"][alt] = (median_ms(f, queue=QUEUE), check(f))
                    print("    tiles: " + ", ".join(f"{k} {v[0]:.4f} ms (err {v[1]:.1e})"
                                                    for k, v in row["tiles"].items()),
                          flush=True)
                for vname, vfn in variants.items():
                    row[f"variant_{vname}"] = {}
                    for alt in (EXACT_TILES if "xtiles" in args.what
                                else (mc.EXACT_SYNTHESIS_LAUNCH_TILE,)):
                        f = call(vfn, periodic, hl, alt)
                        row[f"variant_{vname}"][alt] = (median_ms(f, queue=QUEUE), check(f))
                    print(f"    variant {vname}: " + ", ".join(
                        f"{k} {v[0]:.4f} ms (err {v[1]:.1e})"
                        for k, v in row[f"variant_{vname}"].items()), flush=True)
            rows.append(row)
            del want
        del pairs, outs, halo, x
    return rows


#: the symmetric synthesis's preferred tiles (target ``stiles``) and variant
#: builds of the change (``svariants``): other launch bounds and run lengths
#: (a run of K outputs steps through the taps K - 1 at a time, read as
#: 16-byte pieces: K - 1 divides the padded step of 8 and, in fp32, is a
#: multiple of 4, so K = 5 or 9; in fp64 also 3)
SYMMETRIC_TILES = (1024, 2048, 3072, 4096, 8192)
SYMMETRIC_VARIANTS = {
    "bounds3": (("__launch_bounds__(kThreads, 4)", "__launch_bounds__(kThreads, 3)"),),
    "block5": (("constexpr int kSymBlock = kRunBlock;", "constexpr int kSymBlock = 5;"),),
}
#: the exact analysis's preferred tiles (``etiles``) and variant builds
#: (``evariants``): run lengths 9, 5 and 3, other launch bounds
EXACT_ANALYSIS_TILES = (2048, 3072, 4096)
#: pair runs that read each tap pair from shared memory as the sums need it,
#: in place of modwt_common.cuh's 16-byte tap broadcasts ahead of the sums
LAZY_TAP_RUNS = (
    "// Strides whose details are staged",
    """template <bool kUnit, bool kGuard, typename V, int kBlock, typename Src>
__device__ __forceinline__ void lazy_pair_step(V (&a)[kBlock], V (&d)[kBlock],
                                               V (&fresh)[kBlock - 1],
                                               const V (&old)[kBlock - 1], const Src& src,
                                               int m0, int s, const V* lo, const V* hi,
                                               int m_lo, int m_hi) {
  constexpr int C = kBlock - 1;
#pragma unroll
  for (int e = 0; e < C; ++e) {
    const int m = m0 + e;
    fresh[e] = !kGuard || (m >= m_lo && m < m_hi) ? run_sample<kUnit>(src, m, s) : V(0);
  }
#pragma unroll
  for (int t = 0; t < C; ++t) {
    const V tl = lo[t], th = hi[t];
#pragma unroll
    for (int r = 0; r < kBlock; ++r) {
      const int e = r - t + C - 1;
      const V v = e < C ? fresh[e] : old[e - C];
      a[r] = fma_of(tl, v, a[r]);
      d[r] = fma_of(th, v, d[r]);
    }
  }
}

template <bool kUnit, bool kGuard, typename V, int kBlock, typename Src>
__device__ __forceinline__ void lazy_pair_run(V (&a)[kBlock], V (&d)[kBlock], const Src& src,
                                              int s, const V* lo, const V* hi, int taps,
                                              int m_lo, int m_hi) {
  constexpr int C = kBlock - 1;
  V u[C], v[C];
#pragma unroll
  for (int e = 0; e < C; ++e) {
    v[e] = !kGuard || e + 1 < m_hi ? run_sample<kUnit>(src, e + 1, s) : V(0);
  }
  int i0 = 0;
  for (; i0 + 2 * C <= taps; i0 += 2 * C) {
    lazy_pair_step<kUnit, kGuard>(a, d, u, v, src, -(i0 + C - 1), s, lo + i0, hi + i0,
                                  m_lo, m_hi);
    lazy_pair_step<kUnit, kGuard>(a, d, v, u, src, -(i0 + 2 * C - 1), s, lo + i0 + C,
                                  hi + i0 + C, m_lo, m_hi);
  }
  if (i0 < taps) {
    lazy_pair_step<kUnit, kGuard>(a, d, u, v, src, -(i0 + C - 1), s, lo + i0, hi + i0,
                                  m_lo, m_hi);
  }
}

// Strides whose details are staged""",
)
LAZY_CALLS = tuple((f"pair_run<{a}, {b}>(a, d,", f"lazy_pair_run<{a}, {b}>(a, d,")
                   for a in ("true", "false") for b in ("true", "false"))
EXACT_ANALYSIS_VARIANTS = {
    "block9": (("constexpr int kExactAnalysisBlock = 5;",
                "constexpr int kExactAnalysisBlock = 9;"),),
    "block3": (("constexpr int kExactAnalysisBlock = 5;",
                "constexpr int kExactAnalysisBlock = 3;"),),
    "bounds3": (("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 3)"),),
    "lazy5": (LAZY_TAP_RUNS, *LAZY_CALLS),
    "lazy9": (LAZY_TAP_RUNS, *LAZY_CALLS, ("constexpr int kExactAnalysisBlock = 5;",
                                           "constexpr int kExactAnalysisBlock = 9;")),
    "lazy5_bounds3": (LAZY_TAP_RUNS, *LAZY_CALLS, ("__launch_bounds__(kThreads, 2)",
                                                   "__launch_bounds__(kThreads, 3)")),
}


def symsyn_target(args, parent, work, turns):
    """The symmetric synthesis, parent vs change (target ``symsyn``): the
    forward kernel at config #2's symmetric call (db4 J=6, 128x65536) in
    float32 and bfloat16 and at sym8 J=4 128x65536, each with its bound
    (the adjoint is ``symadj``'s).  The parent launches at the gates' tile
    (``symmetric_tile``) and its plan; the change at its library's tile for
    ``SYMMETRIC_LAUNCH_TILE``; ``stiles`` times the change at
    SYMMETRIC_TILES, ``svariants`` its variant builds."""
    import torch

    import vectorwave_tpu_torch as vt
    from vectorwave_tpu_torch.kernels import _build
    from vectorwave_tpu_torch.kernels import modwt_composite as mc
    from vectorwave_tpu_torch.kernels import modwt_symmetric as ms
    from vectorwave_tpu_torch.kernels.modwt_composite import _device_taps, _stream
    from vectorwave_tpu_torch.kernels.modwt_fused import _kernel_filters

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4)
    new_lib = _build.library()
    fn, new_fn = parent.vw_modwt_symmetric_synthesis, new_lib.vw_modwt_symmetric_synthesis
    fn.argtypes, fn.restype = new_fn.argtypes, new_fn.restype
    variants = (variant_builds("modwt_symmetric_synthesis", SYMMETRIC_VARIANTS, new_fn, work)
                if "svariants" in args.what else {})
    preferred = mc.SYMMETRIC_LAUNCH_TILE
    b, n = PAIR_SHAPE
    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*[q.data_ptr() for q in ts])  # noqa: E731
    rows = []
    print("symmetric synthesis: parent vs change", flush=True)
    for name, levels, dtype in (("db4", 6, torch.float32), ("db4", 6, torch.bfloat16),
                                ("sym8", 4, torch.float32)):
        w = vt.wavelet(name)
        fd, fr = _kernel_filters(w, synthesis=False), _kernel_filters(w, synthesis=True)
        taps = len(fr[0])
        ops = ms.symmetric_level_ops(w, levels)
        span_l, span_r = mc.symmetric_spans(taps, ops)
        tap_t = _device_taps(tuple(fr[0]) + tuple(fr[1]), dev.index)
        x = torch.randn(b, n, device=dev, generator=gen).to(dtype)
        planes = mc.analysis_plain(x, levels, fd, False)
        head = torch.randn(b, span_l, device=dev, generator=gen)
        tail = torch.randn(b, span_r, device=dev, generator=gen)
        out = torch.empty_like(x)
        code = mc._DTYPE_CODES[dtype]

        def call(f, tile):
            plan, width = mc.symmetric_plan(taps, ops, tile, False)
            plan_t = _device_taps(plan, dev.index, torch.int32)
            in_ptrs = ptrs(planes)

            def run():
                err = f(in_ptrs, out.data_ptr(), head.data_ptr(), tail.data_ptr(),
                        tap_t.data_ptr(), plan_t.data_ptr(), b, n, levels, taps, tile, width,
                        span_l, span_r, 0, code, _stream(dev))
                if err:
                    raise RuntimeError(f"kernel launch failed with CUDA error {err}")
                return out
            return run

        def tile_of(alt):
            return new_lib.vw_modwt_symmetric_synthesis_tile(taps, levels, n, alt)

        want = mc.symmetric_synthesis_plain(planes, head, tail, levels, fr, ops)

        def check(f, want=want):
            got = f()
            torch.cuda.synchronize()
            return float((got.float() - want.float()).abs().max())

        old_tile, new_tile = mc.symmetric_tile(taps, ops, False), tile_of(preferred)
        label = f"{name} J={levels} {b}x{n} {str(dtype)[6:]}"
        row = turns(label, call(fn, old_tile), call(new_fn, new_tile), check)
        row["kernel"], row["tiles"] = "modwt_symmetric_synthesis", (old_tile, new_tile)
        size = x.element_size()
        t_bytes = (size * (levels + 2) * b * n + 4 * b * (span_l + span_r)) / 3.35e12 * 1e3
        t_ops = 2 * 2 * taps * levels * b * n / 67e12 * 1e3
        row["bound_ms"] = max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        print(f"    bound {row['bound_ms']:.4f} ms ({row['bound_by']}); tiles: parent "
              f"{old_tile}, change {new_tile}", flush=True)
        if dtype == torch.float32:
            if "stiles" in args.what:
                row["tile_sweep"] = {}
                for alt in SYMMETRIC_TILES:
                    f = call(new_fn, tile_of(alt))
                    row["tile_sweep"][alt] = (tile_of(alt), median_ms(f, queue=QUEUE),
                                              check(f))
                print("    tiles: " + ", ".join(f"{k} ({v[0]}) {v[1]:.4f} ms (err {v[2]:.1e})"
                                                for k, v in row["tile_sweep"].items()),
                      flush=True)
            for vname, vfn in variants.items():
                f = call(vfn, new_tile)
                row[f"variant_{vname}"] = (median_ms(f, queue=QUEUE), check(f))
                print(f"    variant {vname}: {row[f'variant_{vname}'][0]:.4f} ms (err "
                      f"{row[f'variant_{vname}'][1]:.1e})", flush=True)
        rows.append(row)
        del planes, want, x, out
    return rows


#: the adjoint's cases (target ``symadj``): (wavelet, levels, dtype), all at
#: 128 x 65536; its preferred tiles (``adjtiles``) and variant builds of the
#: change (``adjvariants``): three blocks an SM, no detail staging, every level
#: as two runs (one for v_j, one for grad d_j), every level whose two ranges
#: overlap as one pair run, and pair runs only below stride 8 or up to 32
ADJOINT_CASES = (("db4", 6, "float32"), ("db4", 6, "bfloat16"), ("sym8", 4, "float32"),
                 ("sym8", 8, "float32"))
ADJOINT_TILES = (2048, 3072, 4096, 8192)
ADJOINT_BOUNDS = "__launch_bounds__(kThreads, 2)\nsymmetric_adjoint_kernel"
ADJOINT_RULE = "if (8 * (p1 - p0) <= 5 * (v_len + n_out)) {"
ADJOINT_VARIANTS = {
    "bounds3": ((ADJOINT_BOUNDS, ADJOINT_BOUNDS.replace("2)", "3)")),),
    "nostage": (("const bool stage_here = stage_buf != nullptr && (1 << shift) < "
                 "kAdjointStagedStride;", "const bool stage_here = false;"),),
    "nomerge": ((ADJOINT_RULE, "if (false) {"),),
    "allmerge": ((ADJOINT_RULE, "if (delta > -n_out && delta < v_len) {"),),
    "merge_staged": ((ADJOINT_RULE, ADJOINT_RULE.replace(
        ") {", " && (1 << shift) < kAdjointStagedStride) {")),),
    "merge_s32": ((ADJOINT_RULE, ADJOINT_RULE.replace(") {", " && shift <= 5) {")),),
}


def symadj_target(args, parent, work, turns):
    """The symmetric synthesis's adjoint (row 6b), parent vs change (target
    ``symadj``), at ADJOINT_CASES: the gradient of the symmetric body with
    respect to the planes, c -> J+1 planes.  The parent launches at the
    gates' adjoint tile (``symmetric_tile(..., True)``) and its plan, on the
    cotangent masked to the interior beforehand (it reads no spans); the
    change at its library's tile for ``SYMMETRIC_ADJOINT_LAUNCH_TILE``, on
    the unmasked cotangent with the interior spans.  Both are held against
    ``symmetric_adjoint_plain`` with the spans.  ``adjtiles`` times the
    change at ADJOINT_TILES, ``adjvariants`` its variant builds."""
    import torch

    import vectorwave_tpu_torch as vt
    from vectorwave_tpu_torch.kernels import _build
    from vectorwave_tpu_torch.kernels import modwt_composite as mc
    from vectorwave_tpu_torch.kernels import modwt_symmetric as ms
    from vectorwave_tpu_torch.kernels.modwt_composite import _device_taps, _stream
    from vectorwave_tpu_torch.kernels.modwt_fused import _kernel_filters

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    new_lib = _build.library()
    fn, new_fn = parent.vw_modwt_symmetric_synthesis, new_lib.vw_modwt_symmetric_synthesis
    fn.argtypes, fn.restype = new_fn.argtypes, new_fn.restype
    variants = (variant_builds("modwt_symmetric_synthesis", ADJOINT_VARIANTS, new_fn, work)
                if "adjvariants" in args.what else {})
    b, n = PAIR_SHAPE
    rows = []
    print("symmetric adjoint: parent vs change", flush=True)
    for name, levels, dtype_name in ADJOINT_CASES:
        dtype = getattr(torch, dtype_name)
        w = vt.wavelet(name)
        fr = _kernel_filters(w, synthesis=True)
        taps = len(fr[0])
        ops = ms.symmetric_level_ops(w, levels)
        span_l, span_r = mc.symmetric_spans(taps, ops)
        tap_t = _device_taps(tuple(fr[0]) + tuple(fr[1]), dev.index)
        c = torch.randn(b, n, device=dev, generator=gen).to(dtype)
        masked = mc._interior(c, span_l, span_r).contiguous()
        outs = [torch.empty_like(c) for _ in range(levels + 1)]
        out_ptrs = (ctypes.c_void_p * len(outs))(*[o.data_ptr() for o in outs])
        code = mc._DTYPE_CODES[dtype]

        def call(f, tile, spans):
            plan, width = mc.symmetric_plan(taps, ops, tile, True)
            plan_t = _device_taps(plan, dev.index, torch.int32)
            src = c if spans else masked
            sl, sr = (span_l, span_r) if spans else (0, 0)

            def run():
                err = f(out_ptrs, src.data_ptr(), None, None, tap_t.data_ptr(),
                        plan_t.data_ptr(), b, n, levels, taps, tile, width, sl, sr, 1, code,
                        _stream(dev))
                if err:
                    raise RuntimeError(f"kernel launch failed with CUDA error {err}")
                return outs
            return run

        def tile_of(alt):
            return new_lib.vw_modwt_symmetric_adjoint_tile(taps, levels, n, alt)

        want = mc.symmetric_adjoint_plain(c, levels, fr, ops, span_l, span_r)

        def check(f, want=want):
            got = f()
            torch.cuda.synchronize()
            return max(float((g.float() - p.float()).abs().max()) for g, p in zip(got, want))

        old_tile = mc.symmetric_tile(taps, ops, True)
        new_tile = tile_of(mc.SYMMETRIC_ADJOINT_LAUNCH_TILE)
        label = f"adjoint {name} J={levels} {b}x{n} {dtype_name}"
        row = turns(label, call(fn, old_tile, False), call(new_fn, new_tile, True), check)
        row["kernel"], row["tiles"] = "modwt_symmetric_adjoint", (old_tile, new_tile)
        size = c.element_size()
        t_bytes = size * (levels + 2) * b * n / 3.35e12 * 1e3
        t_ops = 2 * 2 * taps * levels * b * n / 67e12 * 1e3
        row["bound_ms"] = max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        print(f"    bound {row['bound_ms']:.4f} ms ({row['bound_by']}); tiles: parent "
              f"{old_tile}, change {new_tile}", flush=True)
        if dtype == torch.float32:
            if "adjtiles" in args.what:
                row["tile_sweep"] = {}
                for alt in ADJOINT_TILES:
                    f = call(new_fn, tile_of(alt), True)
                    row["tile_sweep"][alt] = (tile_of(alt), median_ms(f, queue=QUEUE),
                                              check(f))
                print("    tiles: " + ", ".join(f"{k} ({v[0]}) {v[1]:.4f} ms (err {v[2]:.1e})"
                                                for k, v in row["tile_sweep"].items()),
                      flush=True)
            for vname, vfn in variants.items():
                f = call(vfn, new_tile, True)
                row[f"variant_{vname}"] = (median_ms(f, queue=QUEUE), check(f))
                print(f"    variant {vname}: {row[f'variant_{vname}'][0]:.4f} ms (err "
                      f"{row[f'variant_{vname}'][1]:.1e})", flush=True)
        rows.append(row)
        del c, masked, outs, want
    return rows


def main() -> int:
    import torch
    import torch.nn.functional as F

    import vectorwave_tpu_torch as vt
    from vectorwave_tpu_torch.kernels import modwt2 as k2
    from vectorwave_tpu_torch.kernels import modwt_bank as mb
    from vectorwave_tpu_torch.kernels.modwt_composite import _device_taps, _stream
    from vectorwave_tpu_torch.kernels.modwt_fused import _kernel_filters
    from vectorwave_tpu_torch.transforms import dtcwt as td
    from vectorwave_tpu_torch.transforms import packets as tp

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, type=pathlib.Path)
    ap.add_argument("what", nargs="*", default=["pair", "ptiles", "pvariants"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    csrc = args.parent / "vectorwave_tpu_torch" / "kernels" / "csrc"
    work = args.parent / "_ab_build"
    parent = build(sorted(csrc.glob("*.cu")), work, "parent")
    mb.library()  # the change's build, before any timing
    build([ROOT / "vectorwave_tpu_torch" / "kernels" / "csrc" / f"{k}.cu" for k in SHOWN],
          work, "change")  # for ptxas's figures of the change's two kernels
    results = {"card": smi.stdout.strip()}

    def turns(label, old, new, check):
        err_old, err_new = check(old), check(new)
        t = [median_ms(old), median_ms(new), median_ms(new), median_ms(old)]
        q = [median_ms(f, queue=QUEUE) for f in (old, new, new, old)]
        row = {"case": label, "parent_ms": [t[0], t[3]], "change_ms": [t[1], t[2]],
               "parent_device_ms": [q[0], q[3]], "change_device_ms": [q[1], q[2]],
               "parent_err": err_old, "change_err": err_new}
        print(f"  {label}: parent {t[0]:.4f} / {t[3]:.4f} ms, change {t[1]:.4f} / "
              f"{t[2]:.4f} ms (a call from idle); {QUEUE} queued: parent {q[0]:.4f} / "
              f"{q[3]:.4f}, change {q[1]:.4f} / {q[2]:.4f} ms; max |kernel - plain| "
              f"parent {err_old:.3e}, change {err_new:.3e}", flush=True)
        return row

    if "pair" in args.what:
        results["pair"] = pair_target(args, parent, work, turns)
    if "denoise" in args.what:
        results["denoise"] = denoise_target(args, parent, work, turns)
    if "exactsyn" in args.what:
        results["exactsyn"] = exactsyn_target(args, parent, work, turns)
    if "symsyn" in args.what:
        results["symsyn"] = symsyn_target(args, parent, work, turns)
    if "symadj" in args.what:
        results["symadj"] = symadj_target(args, parent, work, turns)
    if "exactana" in args.what:
        results["exactana"] = exactana_target(args, parent, work, turns)

    if "bank" in args.what:
        print("bank analysis: parent vs change", flush=True)
        fn = parent.vw_modwt_bank_analysis
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [ptr, ctypes.POINTER(ctypes.c_void_p), ptr, ptr, ptr, i64, i64, i32,
                       i32, i32, i32, i32, i32, ptr]
        fn.restype = i32
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        w = vt.wavelet("sym8")
        low, high = w.dec_lo / math.sqrt(2.0), w.dec_hi / math.sqrt(2.0)
        cases = []
        for b, n in BANK_SHAPES:
            cases.append((f"sym8 depth-4 tree {b}x{n}", tp._tree_dense(w, 4, True), b, n, 1))
            cases.append((f"sym8 level-4 pair {8 * b}x{n}", tp._pair_dense(low, high, 8),
                          8 * b, n, 8))
        cases.append(("dtcwt sym8 5-level whole tree 64x16384",
                      td._dual_tree_bank(w, 5)[0], 64, 16384, 1))

        def change_bank(vfn, x, dense):
            """The change's launch (modwt_bank._launch_analysis) through vfn,
            its outputs allocated once."""
            taps = mb.bank_taps(dense)
            runs = mb.bank_runs(taps)
            b, n = x.shape
            outs = [torch.empty_like(x) for _ in range(taps.planes)]
            optrs = (ctypes.c_void_p * taps.planes)(*[o.data_ptr() for o in outs])
            plane_runs, shifts, _, run_table, values = mb.runs_pointers(runs, dev)
            p = taps.planes
            bounds = mb.group_bounds(runs, mb.plane_groups(b * -(-n // mb.TILE), p, sms))
            cb = (i32 * len(bounds))(*bounds)

            def call():
                err = vfn(x.data_ptr(), optrs, plane_runs, shifts, run_table, values, cb,
                          len(bounds) - 1, b, n, p, taps.span, 1, 0, _stream(dev))
                if err:
                    raise RuntimeError(f"kernel launch failed with CUDA error {err}")
                return outs
            return call

        rows = []
        for label, dense, b, n, dil in cases:
            taps = mb.bank_taps(dense)
            x = torch.randn(b, n, device=dev, generator=gen)
            tile = parent_bank_tile(taps.span)
            groups = max(1, min(taps.planes, -(-2 * sms // (b * -(-n // tile)))))
            # that analysis's table: [starts | spans | offsets] and the values
            ints = torch.tensor(taps.starts + taps.spans + taps.offsets, dtype=torch.int32,
                                device=dev)
            tvals = torch.tensor(taps.values, dtype=torch.float32, device=dev)
            starts = ints.data_ptr()
            offsets = starts + 4 * (2 * taps.planes + 1)
            values = tvals.data_ptr()
            outs = [torch.empty_like(x) for _ in range(taps.planes)]
            optrs = (ctypes.c_void_p * taps.planes)(*[o.data_ptr() for o in outs])

            def old(x=x, taps=taps, tile=tile, groups=groups, starts=starts,
                    offsets=offsets, values=values, optrs=optrs, outs=outs, b=b, n=n):
                err = fn(x.data_ptr(), optrs, starts, offsets, values, b, n, taps.planes,
                         groups, taps.span, tile, 1, 0, _stream(dev))
                if err:
                    raise RuntimeError(f"kernel launch failed with CUDA error {err}")
                return outs

            new = change_bank(mb.library().vw_modwt_bank_analysis, x, dense)

            want = mb.bank_analysis_plain(x, dense, True)

            def check(f, want=want):
                got = f()
                torch.cuda.synchronize()
                return max(float((g - p).abs().max()) for g, p in zip(got, want))

            row = turns(label, old, new, check)
            row["wrapper_ms"] = median_ms(lambda x=x, dense=dense: mb.bank_analysis(
                x, dense, True))
            print(f"    the wrapper (bank_analysis): {row['wrapper_ms']:.4f} ms", flush=True)
            k = max(len(f) for f in dense)
            wt = torch.zeros(taps.planes, k, device=dev)
            for i, f in enumerate(dense):
                wt[i, : len(f)] = torch.tensor(f, device=dev)
            wt = wt[:, ::dil].flip(-1)[:, None].contiguous()
            span = dil * (wt.shape[-1] - 1)
            row["library_ms"] = median_ms(lambda: F.conv1d(
                F.pad(x[:, None], (span, 0), mode="circular"), wt, dilation=dil))
            t_ops = b * n * taps.nonzeros * 2 / 67e12 * 1e3
            t_bytes = b * n * 4 * (1 + taps.planes) / 3.35e12 * 1e3
            row["bound_ms"] = max(t_ops, t_bytes)
            row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
            print(f"    F.conv1d {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']})", flush=True)
            rows.append(row)
            del x, outs, want
        results["bank"] = rows

    if "twod" in args.what or "probe" in args.what:
        w = vt.wavelet("db4")
        fs = _kernel_filters(w, synthesis=True)
        taps = len(fs[0])
        planes = [torch.randn(*IMG, device=dev, generator=gen) for _ in range(4)]
        out = torch.empty_like(planes[0])
        tap_t = _device_taps(tuple(fs[0]) + tuple(fs[1]), dev.index)
        pixels = math.prod(IMG)

        def parent_call(fn, level):
            s = 1 << (level - 1)
            th, tw = parent_synthesis_tile(taps, s)

            def call():
                err = fn(*(p.data_ptr() for p in planes), out.data_ptr(), tap_t.data_ptr(),
                         *IMG, taps, s, *k2.FORWARD_OPS, k2.EDGES["periodic"], th, tw,
                         _stream(dev))
                if err:
                    raise RuntimeError(f"kernel launch failed with CUDA error {err}")
                return out
            return call

    def change_call(fn, level, plan):
        """The change's 2-D synthesis through fn, with an explicit plan."""
        s = 1 << (level - 1)

        def call():
            err = fn(*(p.data_ptr() for p in planes), out.data_ptr(), tap_t.data_ptr(), *IMG,
                     taps, s, *k2.FORWARD_OPS, k2.EDGES["periodic"], *plan.tile, plan.stages,
                     plan.pitch, plan.row_pitch, plan.block, _stream(dev))
            if err:
                raise RuntimeError(f"kernel launch failed with CUDA error {err}")
            return out
        return call

    if "twod" in args.what:
        print("2-D synthesis: parent vs change, db4, 8x2048x2048, periodic", flush=True)
        fn = declare_synthesis(parent)
        new_fn = mb.library().vw_modwt2_synthesis_level
        probes_new = {}
        if "probe_new" in args.what:
            text = (ROOT / "vectorwave_tpu_torch" / "kernels" / "csrc" /
                    "modwt2_synthesis.cu").read_text()
            for name, patches in (("loads", (PROBE_NEW_W, PROBE_NEW_H)),
                                  ("loads_w", (PROBE_NEW_H,))):
                patched = text
                for before, after in patches:
                    assert before in patched, before
                    patched = patched.replace(before, after)
                src = csrc / f"probe_new_{name}_modwt2_synthesis.cu"
                src.write_text(patched)
                lib = build([src], work, f"probe_new_{name}")
                f = lib.vw_modwt2_synthesis_level
                f.argtypes = new_fn.argtypes
                f.restype = ctypes.c_int
                probes_new[name] = f
        stacked = torch.stack(planes, dim=1)
        import numpy as np
        lo, hi = np.array(fs[0]), np.array(fs[1])
        bank_s = torch.tensor(np.stack([np.outer(fh, fw) for fh, fw in (
            (lo, lo), (lo, hi), (hi, lo), (hi, hi))]), dtype=torch.float32, device=dev)[None]
        rows = []
        for level in range(1, 7):
            s = 1 << (level - 1)
            want = k2.synthesis2_level_plain(*planes, fs, s, k2.FORWARD_OPS, "periodic")

            def check(f, want=want):
                got = f()
                torch.cuda.synchronize()
                return float((got - want).abs().max())

            plan = k2.synthesis_plan(taps, s, k2.FORWARD_OPS)
            row = turns(f"level {level} {plan}", parent_call(fn, level),
                        change_call(new_fn, level, plan), check)
            row["wrapper_ms"] = median_ms(lambda s=s: k2.synthesis2_level(
                *planes, fs, s, k2.FORWARD_OPS, "periodic"))
            print(f"    the wrapper (synthesis2_level): {row['wrapper_ms']:.4f} ms", flush=True)
            for name, f in probes_new.items():
                row[f"probe_{name}"] = median_ms(change_call(f, level, plan))
            if probes_new:
                print(f"    change split: loads {row['probe_loads']:.4f} ms, loads + W pass "
                      f"{row['probe_loads_w']:.4f} ms", flush=True)
            if "pitch4" in args.what:
                # the same plan with the window's rows on 16 bytes (bulk copies)
                width = k2.synthesis_window(taps, s, k2.FORWARD_OPS, plan.tile)[1]
                for mod in (4, 8):
                    base4 = -(-width // 4) * 4
                    alt = plan._replace(pitch=base4 + (mod - base4) % 32)
                    call = change_call(new_fn, level, alt)
                    err = check(call)
                    row[f"pitch_{alt.pitch}"] = (median_ms(call), err)
                    print(f"    pitch {alt.pitch}: {row[f'pitch_{alt.pitch}'][0]:.4f} ms "
                          f"(max |kernel - plain| {err:.3e})", flush=True)
            if "tiles" in args.what:
                row["tiles"] = {}
                for tile in k2.PLAN_TILES + ((8, 128),):
                    for stages in (2,):
                        width = k2.synthesis_window(taps, s, k2.FORWARD_OPS, tile)[1]
                        alt = k2._plan(width, s, tile, stages, True)
                        nbytes = k2.plan_shared_bytes(taps, s, k2.FORWARD_OPS, alt)
                        if not k2._serves(alt) or nbytes > SHARED_LIMIT:
                            continue
                        call = change_call(new_fn, level, alt)
                        err = check(call)
                        row["tiles"][f"{tile}x{stages}"] = (median_ms(call), nbytes, err)
                print("    tiles: " + ", ".join(f"{t} {v[0]:.4f} ms ({v[1] // 1024} KB)"
                                                 for t, v in row["tiles"].items()), flush=True)
            pad = s * (taps - 1)
            row["library_ms"] = median_ms(lambda: F.conv2d(
                F.pad(stacked, (0, pad, 0, pad), mode="circular"), bank_s, dilation=s))
            row["bound_ms"] = 20 * pixels / 3.35e12 * 1e3
            print(f"    F.conv2d {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms",
                  flush=True)
            rows.append(row)
            del want
        del stacked
        for key in ("parent_ms", "change_ms"):
            for j in (4, 6):
                total = [sum(r[key][i] for r in rows[:j]) for i in (0, 1)]
                print(f"  sum of levels 1-{j}, {key[:-3]}: {total[0]:.4f} / {total[1]:.4f} ms",
                      flush=True)
        results["twod"] = rows

    if "probe" in args.what:
        print("2-D synthesis, parent split by probe builds (db4, periodic)", flush=True)
        text = (csrc / "modwt2_synthesis.cu").read_text()
        probes = {}
        for name, patches in (("loads", (PROBE_W, PROBE_H)), ("loads_w", (PROBE_H,))):
            patched = text
            for before, after in patches:
                assert before in patched, before
                patched = patched.replace(before, after)
            src = csrc / f"probe_{name}_modwt2_synthesis.cu"
            src.write_text(patched)
            probes[name] = declare_synthesis(build([src], work, f"probe_{name}"))
        probes["whole"] = declare_synthesis(parent)
        rows = []
        for level in range(1, 7):
            row = {"level": level}
            for name, fn in probes.items():
                row[name] = median_ms(parent_call(fn, level))
            print(f"  level {level}: loads {row['loads']:.4f} ms, loads + W pass "
                  f"{row['loads_w']:.4f} ms, whole {row['whole']:.4f} ms", flush=True)
            rows.append(row)
        results["probe"] = rows

    if "banksyn" in args.what:
        print("bank synthesis: parent vs change", flush=True)
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn = parent.vw_modwt_bank_synthesis
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ptr, ptr, ptr, ptr, ptr, i64, i64,
                       i32, i32, i32, i32, i32, ptr]
        fn.restype = i32
        new_fn = mb.library().vw_modwt_bank_synthesis
        w = vt.wavelet("sym8")
        low, high = w.dec_lo / math.sqrt(2.0), w.dec_hi / math.sqrt(2.0)
        cases = []
        for b, n in BANK_SHAPES:
            cases.append((f"sym8 depth-4 tree {b}x{n}", tp._tree_dense(w, 4, False), b, n, 1))
            cases.append((f"sym8 level-4 pair {8 * b}x{n}", tp._pair_dense(low, high, 8),
                          8 * b, n, 8))
        cases.append(("dtcwt sym8 5-level whole tree 64x16384",
                      td._dual_tree_bank(w, 5, 0.5)[0], 64, 16384, 1))
        rows = []
        for label, dense, b, n, dil in cases:
            taps = mb.bank_taps(dense)
            p = taps.planes
            planes = torch.randn(p, b, n, device=dev, generator=gen).unbind(0)
            iptrs = (ctypes.c_void_p * p)(*[q.data_ptr() for q in planes])
            out = torch.empty_like(planes[0])
            # the parent's table: [starts | spans | offsets] and the values
            ints = torch.tensor(taps.starts + taps.spans + taps.offsets, dtype=torch.int32,
                                device=dev)
            vals = torch.tensor(taps.values, dtype=torch.float32, device=dev)
            base = ints.data_ptr()
            tile = parent_bank_tile(taps.span)

            def old(b=b, n=n, p=p, iptrs=iptrs, out=out, base=base, vals=vals, tile=tile,
                    taps=taps):
                err = fn(iptrs, out.data_ptr(), base, base + 4 * (p + 1),
                         base + 4 * (2 * p + 1), vals.data_ptr(), b, n, p, taps.span, tile,
                         1, 0, _stream(dev))
                if err:
                    raise RuntimeError(f"kernel launch failed with CUDA error {err}")
                return out

            runs = mb.bank_runs(taps, one_stride=True)
            pr, _, spans, run_table, values = mb.runs_pointers(runs, dev)

            def change(stages, b=b, n=n, p=p, iptrs=iptrs, out=out, taps=taps, runs=runs,
                       pr=pr, spans=spans, run_table=run_table, values=values):
                def call():
                    err = new_fn(iptrs, out.data_ptr(), pr, spans, run_table, values, b, n, p,
                                 taps.span, runs.shifts[0], stages, 1, 0, _stream(dev))
                    if err:
                        raise RuntimeError(f"kernel launch failed with CUDA error {err}")
                    return out
                return call

            want = mb.bank_synthesis_plain(planes, dense, True)

            def check(f, want=want):
                got = f()
                torch.cuda.synchronize()
                return float((got - want).abs().max())

            row = turns(label, old, change(mb.synthesis_stages(taps.span)), check)
            one = change(1)
            row["change_one_buffer_ms"] = median_ms(one)
            row["change_one_buffer_err"] = check(one)
            row["wrapper_ms"] = median_ms(lambda planes=planes, dense=dense: mb.bank_synthesis(
                planes, dense, True))
            print(f"    one window buffer: {row['change_one_buffer_ms']:.4f} ms; the wrapper "
                  f"(bank_synthesis): {row['wrapper_ms']:.4f} ms", flush=True)
            k = max(len(f) for f in dense)
            ws = torch.zeros(p, k, device=dev)
            for i, f in enumerate(dense):
                ws[i, : len(f)] = torch.tensor(f, device=dev)
            ws = ws[:, ::dil].contiguous()
            span = dil * (ws.shape[-1] - 1)
            stacked = torch.stack(planes, dim=1)
            row["library_ms"] = median_ms(lambda: F.conv1d(
                F.pad(stacked, (0, span), mode="circular"), ws[None], dilation=dil))
            t_ops = b * n * taps.nonzeros * 2 / 67e12 * 1e3
            t_bytes = b * n * 4 * (1 + p) / 3.35e12 * 1e3
            row["bound_ms"] = max(t_ops, t_bytes)
            row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
            print(f"    F.conv1d {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']})", flush=True)
            rows.append(row)
            del planes, out, want, stacked
        results["banksyn"] = rows

    if "twoda" in args.what:
        print("2-D analysis: parent vs change, db4, 8x2048x2048, periodic", flush=True)
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        parent_args = [ptr] * 6 + [i64] * 3 + [i32] * 5 + [ptr]
        fn = parent.vw_modwt2_analysis_level
        fn.argtypes, fn.restype = parent_args, i32
        new_fn = mb.library().vw_modwt2_analysis_level
        w = vt.wavelet("db4")
        fa = _kernel_filters(w, synthesis=False)
        taps = len(fa[0])
        x = torch.randn(*IMG, device=dev, generator=gen)
        outs = [torch.empty_like(x) for _ in range(4)]
        tap_t = _device_taps(tuple(fa[0]) + tuple(fa[1]), dev.index)
        pixels = math.prod(IMG)
        import numpy as np
        lo, hi = np.array(fa[0]), np.array(fa[1])
        bank_a = torch.tensor(np.stack([np.outer(fh[::-1], fw[::-1]) for fh, fw in (
            (lo, lo), (lo, hi), (hi, lo), (hi, hi))]), dtype=torch.float32, device=dev)[:, None]

        def old_call(f, level):
            s = 1 << (level - 1)
            th, tw = parent_analysis_tile(taps, s)

            def call():
                err = f(x.data_ptr(), *(o.data_ptr() for o in outs), tap_t.data_ptr(), *IMG,
                        taps, s, k2.EDGES["periodic"], th, tw, _stream(dev))
                if err:
                    raise RuntimeError(f"kernel launch failed with CUDA error {err}")
                return outs
            return call

        def new_call(f, level, plan):
            s = 1 << (level - 1)

            def call():
                err = f(x.data_ptr(), *(o.data_ptr() for o in outs), tap_t.data_ptr(), *IMG,
                        taps, s, k2.EDGES["periodic"], *plan.tile, plan.pitch,
                        plan.row_pitch, plan.block, _stream(dev))
                if err:
                    raise RuntimeError(f"kernel launch failed with CUDA error {err}")
                return outs
            return call

        # probe and variant builds of the checkout's kernel, beside a copy of
        # its headers
        here = ROOT / "vectorwave_tpu_torch" / "kernels" / "csrc"
        new_src = work / "change_csrc"
        new_src.mkdir(parents=True, exist_ok=True)
        for header in here.glob("*.cuh"):
            shutil.copy(header, new_src / header.name)
        text = (here / "modwt2_analysis.cu").read_text()
        probes_new = {}
        if "probea_new" in args.what:
            for name, patches in (("loads_stores", (PROBE_NEW_A_W, PROBE_NEW_A_H)),
                                  ("loads_w", (PROBE_NEW_A_H,))):
                probes_new[name] = split(f"probea_new_{name}_modwt2_analysis", new_src, text,
                                         patches, work, "vw_modwt2_analysis_level",
                                         new_fn.argtypes)
        variants = {}
        if "avariants" in args.what:
            for name, patches in ANALYSIS_VARIANTS.items():
                variants[name] = split(f"variant_{name}_modwt2_analysis", new_src, text,
                                       patches, work, "vw_modwt2_analysis_level",
                                       new_fn.argtypes)
        rows = []
        for level in range(1, 7):
            s = 1 << (level - 1)
            want = k2.analysis2_level_plain(x, fa, s, "periodic")

            def check(f, want=want):
                got = f()
                torch.cuda.synchronize()
                return max(float((g - p).abs().max()) for g, p in zip(got, want))

            plan = k2.analysis_plan(taps, s)
            row = turns(f"level {level} {plan}", old_call(fn, level),
                        new_call(new_fn, level, plan), check)
            row["wrapper_ms"] = median_ms(lambda s=s: k2.analysis2_level(x, fa, s, "periodic"))
            print(f"    the wrapper (analysis2_level): {row['wrapper_ms']:.4f} ms", flush=True)
            for name, f in probes_new.items():
                row[f"probe_{name}"] = median_ms(new_call(f, level, plan))
            if probes_new:
                print(f"    change split: loads and stores {row['probe_loads_stores']:.4f} ms, "
                      f"with the W pass {row['probe_loads_w']:.4f} ms", flush=True)
            for vname, vfn in [("change", new_fn)] * ("atiles" in args.what) + list(
                    variants.items()):
                row[f"tiles_{vname}"] = {}
                for tile in k2.PLAN_TILES:
                    width = k2.analysis_window(taps, s, tile)[1]
                    alt = k2._plan(width, s, tile, 1, True)
                    nbytes = k2.analysis_shared_bytes(taps, s, alt)
                    if not k2._serves_analysis(alt) or nbytes > SHARED_LIMIT:
                        continue
                    call = new_call(vfn, level, alt)
                    row[f"tiles_{vname}"][str(tile)] = (median_ms(call), nbytes, check(call))
                print(f"    tiles, {vname}: " + ", ".join(
                    f"{t} {v[0]:.4f} ms ({v[1] // 1024} KB, err {v[2]:.1e})"
                    for t, v in row[f"tiles_{vname}"].items()), flush=True)
            pad = s * (taps - 1)
            row["library_ms"] = median_ms(lambda: F.conv2d(
                F.pad(x[:, None], (pad, 0, pad, 0), mode="circular"), bank_a, dilation=s))
            row["bound_ms"] = 20 * pixels / 3.35e12 * 1e3
            print(f"    F.conv2d {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms",
                  flush=True)
            rows.append(row)
            del want
        for key in ("parent_ms", "change_ms"):
            for j in (4, 6):
                total = [sum(r[key][i] for r in rows[:j]) for i in (0, 1)]
                print(f"  sum of levels 1-{j}, {key[:-3]}: {total[0]:.4f} / {total[1]:.4f} ms",
                      flush=True)
        results["twoda"] = rows

        if "probea" in args.what:
            print("2-D analysis, parent split by probe builds (db4, periodic)", flush=True)
            text = (csrc / "modwt2_analysis.cu").read_text()
            probes = {name: split(f"probea_{name}_modwt2_analysis", csrc, text, patches, work,
                                  "vw_modwt2_analysis_level", parent_args)
                      for name, patches in (("loads_stores", (PROBE_A_W, PROBE_A_H)),
                                            ("loads_w", (PROBE_A_H,)))}
            probes["whole"] = fn
            split_rows = []
            for level in range(1, 7):
                row = {"level": level}
                for name, f in probes.items():
                    row[name] = median_ms(old_call(f, level))
                print(f"  level {level}: loads and stores {row['loads_stores']:.4f} ms, with "
                      f"the W pass {row['loads_w']:.4f} ms, whole {row['whole']:.4f} ms",
                      flush=True)
                split_rows.append(row)
            results["probea"] = split_rows
        del x, outs

    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
