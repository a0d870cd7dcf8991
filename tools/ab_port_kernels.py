#!/usr/bin/env python3
"""Time two versions of the port's bank analysis and 2-D synthesis kernels
on one GPU, in turns, in one process.

Run from the root of a checkout, with one Hopper card visible and an older
checkout's kernel sources unpacked under a directory (for example the parent
commit: ``git archive HEAD vectorwave_tpu_torch/kernels | tar -x -C DIR``):

    python3 tools/ab_port_kernels.py --parent DIR [bank] [twod] [probe] [probe_new]
                                     [tiles] [pitch4]

``DIR``'s ``vectorwave_tpu_torch/kernels/csrc/*.cu`` are built into a
library of their own (one nvcc per source, all started together) and called
with that version's C interface: the bank analysis with its tap table, tile
and plane groups, the 2-D synthesis with its first-fit tile.  The checkout's
kernels are called through their C interface too, with the plan their
wrapper would use, and both with their outputs allocated once; the
wrapper's own time is printed beside them.  Each case runs parent, change,
change, parent (CUDA-event medians) after both have been held against the
plain version; ptxas's registers and spills of the two kernels are printed
first.

* ``bank``: the sym8 depth-4 packet tree and a level-4 pair (as ``modwpt``
  calls it) at 64x16384 and 128x65536, and ``dtcwt``'s whole-tree bank (sym8,
  5 levels) at 64x16384, each with ``F.conv1d`` (TF32 off) beside it;
* ``twod``: the 2-D synthesis at db4 levels 1-6, 8x2048x2048, periodic, with
  ``F.conv2d`` (TF32 off) beside it;
* ``probe``: the parent's 2-D synthesis split into phases by probe builds of
  its source: the plane loads alone, the loads and the W pass, the whole
  kernel, at levels 1-6; ``probe_new`` the same split of the checkout's
  kernel (with ``twod``);
* ``tiles`` and ``pitch4`` (with ``twod``): the checkout's 2-D synthesis
  with every tile of ``modwt2.SYNTHESIS_TILES`` that fits, and with its
  window rows on 16 bytes.

Prints the card's name and power limit first, and one JSON line of every
time last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import pathlib
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


def median_ms(fn, warmup=3, reps=20):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


SHOWN = ("modwt_bank_analysis", "modwt2_synthesis")


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
            if ("registers" in line or "spill" in line) and any(
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


def declare_synthesis(lib):
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = lib.vw_modwt2_synthesis_level
    fn.argtypes = [ptr] * 6 + [i64] * 3 + [i32] * 9 + [ptr]
    fn.restype = i32
    return fn


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
    ap.add_argument("what", nargs="*", default=["bank", "twod", "probe"])
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
        row = {"case": label, "parent_ms": [t[0], t[3]], "change_ms": [t[1], t[2]],
               "parent_err": err_old, "change_err": err_new}
        print(f"  {label}: parent {t[0]:.4f} / {t[3]:.4f} ms, change {t[1]:.4f} / "
              f"{t[2]:.4f} ms; max |kernel - plain| parent {err_old:.3e}, change "
              f"{err_new:.3e}", flush=True)
        return row

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
            ints, vals = mb._device_runs(runs, dev.index)
            p = taps.planes
            bounds = mb.group_bounds(runs, mb.plane_groups(b * -(-n // mb.ANALYSIS_TILE),
                                                           p, sms))
            cb = (i32 * len(bounds))(*bounds)
            base = ints.data_ptr()

            def call():
                err = vfn(x.data_ptr(), optrs, base, base + 4 * (p + 1), base + 8 * p + 4,
                          vals.data_ptr(), cb, len(bounds) - 1, b, n, p, taps.span, 1, 0,
                          _stream(dev))
                if err:
                    raise RuntimeError(f"kernel launch failed with CUDA error {err}")
                return outs
            return call

        rows = []
        for label, dense, b, n, dil in cases:
            taps = mb.bank_taps(dense)
            x = torch.randn(b, n, device=dev, generator=gen)
            tile = mb.bank_tile(taps.span)
            groups = max(1, min(taps.planes, -(-2 * sms // (b * -(-n // tile)))))
            starts, _, offsets, values = mb._table_pointers(taps, dev)
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
                for tile in k2.SYNTHESIS_TILES + ((8, 128),):
                    for stages in (2,):
                        alt = k2._plan(taps, s, k2.FORWARD_OPS, tile, stages, True)
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

    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
