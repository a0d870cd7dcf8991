"""One run of one cell: set-up, the measured window, the traced window, the
check against the reference, and the result line.

Everything specific to a configuration, a traffic mix, an entry point or a
metric is found by name under this folder:

* ``BENCHMARK.json`` names each cell's configuration and traffic;
* ``configs/<config>.json``: the wavelet, depth, boundary, signal length,
  rows a call, precision and signal-to-noise ratio;
* ``traffic/<traffic>.json``: distinct batches, the entry point
  (``entries/<entry>.py``) and its arguments, the calls compared and the
  traced window; every mix is a closed loop of one caller;
* ``workloads/<cell>.json``: the limits of the cell's comparison;
* ``metrics/<metric>.py``: a reader, ``read(ctx)``, that returns the
  metric's value or None where it finds nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType, SimpleNamespace

import torch

from . import generator, peaks
from . import trace as tracing

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: Rows of the reference's blocks: a float64 block of 128 x 65536 is 64 MiB.
REFERENCE_ROWS = 128


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    cfg: dict
    mix: dict
    entry: ModuleType
    limits: dict
    end_to_end: tuple
    per_layer: tuple


def load_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str) -> ModuleType:
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name}", path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, bench: dict | None = None) -> Cell:
    bench = manifest() if bench is None else bench
    entry = [w for w in bench["workloads"] if w["name"] == name]
    if not entry:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    (w,) = entry
    mix = load_json("traffic", w["traffic"])
    return Cell(
        name=name,
        chips=w["chips"],
        cfg=load_json("configs", w["config"]),
        mix=mix,
        entry=load_module("entries", mix["entry"]),
        limits=load_json("workloads", name)["limits"],
        end_to_end=tuple(m for m in bench["end_to_end"] if _reports(m, name)),
        per_layer=tuple(m for m in bench["per_layer"] if _reports(m, name)),
    )


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def launch_counts() -> dict:
    from vectorwave_tpu_torch.kernels import modwt_composite

    return dict(modwt_composite.LAUNCHES)


# --- the check -----------------------------------------------------------------


def _as_float64(item, rows: slice) -> torch.Tensor:
    """A block of an output: a tensor, or a (hi, lo) pair read as hi + lo."""
    if isinstance(item, tuple):
        return sum(t[rows].to(torch.float64) for t in item)
    return item[rows].to(torch.float64)


def compare(entry, cfg: dict, mix: dict, x: torch.Tensor, results: list) -> list[dict]:
    """For each of ``results`` (outputs of the entry on ``x``), the worst
    relative error of each output group against the reference on ``x``:
    per output, the largest absolute difference over the largest magnitude
    of the reference's output, computed in blocks of rows.  A non-finite
    output reads infinite."""
    outs = [entry.outputs(r) for r in results]
    worst_diff = [{g: [0.0] * len(items) for g, items in o.items()} for o in outs]
    scale: dict = {}
    for r0 in range(0, x.shape[0], REFERENCE_ROWS):
        rows = slice(r0, r0 + REFERENCE_ROWS)
        ref = entry.reference(x[rows].to(torch.float64), cfg, mix)
        for g, items in ref.items():
            mags = [float(t.abs().max()) for t in items]
            scale[g] = [max(a, b) for a, b in zip(scale.get(g, mags), mags)]
            for o, wd in zip(outs, worst_diff):
                for k, t in enumerate(items):
                    d = float((_as_float64(o[g][k], rows) - t).abs().max())
                    wd[g][k] = d if not math.isfinite(d) else max(wd[g][k], d)
        del ref
    errors = []
    for wd in worst_diff:
        e: dict = {}
        for g, diffs in wd.items():
            for d, s in zip(diffs, scale[g]):
                r = d / s if math.isfinite(d) and s > 0 else math.inf
                e[g] = max(e.get(g, 0.0), r)
        errors.append(e)
    return errors


def check(cell: Cell, inputs: list, kept: dict) -> tuple[dict, int]:
    """``kept`` maps a batch index to the results kept from calls on it.
    Returns the worst error of each limited group and how many kept
    results read past a limit."""
    worst: dict = {g: 0.0 for g in cell.limits}
    failed = 0
    for b, results in sorted(kept.items()):
        if not results:
            continue
        for errors in compare(cell.entry, cell.cfg, cell.mix, inputs[b], results):
            if any(errors.get(g, math.inf) > lim for g, lim in cell.limits.items()):
                failed += 1
            for g in worst:
                worst[g] = max(worst[g], errors.get(g, math.inf))
    return worst, failed


# --- the device ----------------------------------------------------------------


def smi_line() -> str:
    """Name, power limit, clocks, draw and temperature of the card, read
    beside the window."""
    fields = "name,power.limit,clocks.sm,clocks.max.sm,power.draw,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi unavailable: {err}"
    return f"{fields}: {out.stdout.strip()}"


def device_record(device, trace) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        record = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
                  "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
    else:
        record = {"platform": dev.type, "kind": dev.type, "count": 1, "memory_peak_bytes": 0}
    if trace is not None:
        record["busy_s"] = trace.busy_s
        record["window_s"] = trace.window_s
    return record


# --- one run -------------------------------------------------------------------


def _traced_window(cell: Cell, inputs: list, device, seconds: float):
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    calls = 0
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        while True:
            with record_function(tracing.CALL_SPAN):
                result = cell.entry.call(inputs[calls % len(inputs)], cell.cfg, cell.mix)
                sync(device)
            del result
            calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
    trace_dir = HERE / "traces"
    trace_dir.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(trace_dir / f"{cell.name}.json"))
    return tracing.reduce(tracing.events_of(prof), calls)


def run(cell: Cell, seed: int, seconds: float, traced: bool, device, t_start: float,
        log=print) -> dict:
    """One run of ``cell``; ``t_start`` is the process's start on the host
    clock, from which set-up is counted.  ``log`` takes the earlier lines."""
    entry, cfg, mix = cell.entry, cell.cfg, cell.mix
    inputs = generator.make_inputs(cfg, mix, seed, device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    # two calls a batch, each batch's last result held as the window holds
    # it, so that the allocator's pool is at its steady size before the window
    held = {}
    for i in range(2 * len(inputs)):
        held[i % len(inputs)] = entry.call(inputs[i % len(inputs)], cfg, mix)
        sync(device)
    del held
    setup_s = time.perf_counter() - t_start

    pick = generator.kept_call(seed, mix["kept_among_first"])
    kept: dict = {b: [] for b in range(len(inputs))}
    last: dict = {}
    spans = []
    before = launch_counts()
    t_window = time.perf_counter()
    while True:
        i = len(spans)
        b = i % len(inputs)
        t0 = time.perf_counter()
        result = entry.call(inputs[b], cfg, mix)
        t1 = time.perf_counter()
        sync(device)
        t2 = time.perf_counter()
        spans.append((t0, t1, t2))
        if i == pick:
            kept[b].append(result)
        last[b] = result
        del result
        if t2 - t_window >= seconds:
            break
    after = launch_counts()
    smi = smi_line()
    for b, result in last.items():
        if all(r is not result for r in kept[b]):
            kept[b].append(result)
    del last

    summary = None
    if traced:
        summary = _traced_window(cell, inputs, device, mix["trace_seconds"])
    record = device_record(device, summary)

    samples = cfg["rows"] * cfg["n"]
    work = peaks.least(entry.work(cfg, mix))
    ctx = SimpleNamespace(spans=spans, samples_per_call=samples, setup_s=setup_s,
                          trace=summary, work=work)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    durations = sorted(t2 - t0 for t0, _, t2 in spans)
    log(f"# {cell.name} seed {seed}: {len(spans)} calls in {spans[-1][2] - spans[0][0]:.6f} s,"
        f" p50 {durations[len(durations) // 2] * 1e3:.6f} ms, setup {setup_s:.6f} s")
    log("# call ms at p10/p25/p50/p75/p90/p95/p99/max: " + " ".join(
        f"{durations[min(len(durations) - 1, int(q * len(durations)))] * 1e3:.6f}"
        for q in (0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99, 1.0)))
    dispatch = sorted(t1 - t0 for t0, t1, _ in spans)
    log(f"# dispatch ms at p50/p95: {dispatch[len(dispatch) // 2] * 1e3:.6f}"
        f" {dispatch[int(0.95 * len(dispatch))] * 1e3:.6f}")
    for b in range(len(inputs)):
        own = sorted(t2 - t0 for t0, _, t2 in spans[b::len(inputs)])
        log(f"# batch {b}: p50 {own[len(own) // 2] * 1e3:.6f} ms,"
            f" p95 {own[int(0.95 * len(own))] * 1e3:.6f} ms")
    log(f"# memory_peak_bytes {record['memory_peak_bytes']}")
    log(f"# {smi}")
    log("# port LAUNCHES per call: " + json.dumps(
        {k: (after[k] - before[k]) / len(spans) for k in after if after[k] != before[k]}))
    log(f"# work per call: {work['bytes']} bytes, {work['flops']} {work['dtype']} FLOPs;"
        f" least {work['least_s'] * 1e3:.6f} ms, set by {work['bound']}")
    if summary is not None:
        log(f"# traced: {summary.calls} calls, {summary.launches} device ops,"
            f" device {summary.device_s:.6f} s, busy {summary.busy_s:.6f} s"
            f" of {summary.window_s:.6f} s")

    worst, failed = check(cell, inputs, kept)
    correct = failed == 0 and all(worst[g] <= lim for g, lim in cell.limits.items())
    checks = {g: {"value": worst[g], "limit": lim} for g, lim in cell.limits.items()}
    result = {"correct": correct, "attempted": len(spans), "failed": failed,
              "metrics": metrics, "device": record}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = checks
    return result


def check_lines(checks: dict) -> list[str]:
    return [f"check {g}: {c['value']!r} (limit {c['limit']!r})" for g, c in checks.items()]
