"""The correctness gate has teeth: a run of the harness on the CPU at a
tiny size, with the card's look skipped, passes the program as it is and
fails it with the timed path broken underneath; the control (the same
call one precision lower) fails every cell's limits; the trace reduction
reads a known timeline.  CPU only, apart from the last test."""

import dataclasses
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from portbench import control, core, trace

CELLS = [w["name"] for w in core.manifest()["workloads"]]
SEED = 2**31 + 77


def tiny(name):
    cell = core.load_cell(name)
    return dataclasses.replace(cell, cfg={**cell.cfg, "n": 2048, "rows": 4},
                               mix={**cell.mix, "kept_among_first": 2})


def broken(cell, fault):
    """The cell with its entry's call wrapped by ``fault(result, x)``."""
    entry = cell.entry

    def call(x, cfg, mix):
        return fault(entry.call(x, cfg, mix), x)

    return dataclasses.replace(cell, entry=SimpleNamespace(
        call=call, outputs=entry.outputs, reference=entry.reference, work=entry.work))


def _map(result, fn):
    """``fn`` on every tensor of a result, keeping its form."""
    if isinstance(result, torch.Tensor):
        return fn(result)
    if isinstance(result, tuple):
        return type(result)(*[_map(r, fn) for r in result]) if hasattr(result, "_fields") \
            else tuple(_map(r, fn) for r in result)
    return result


def altered(result, x):
    """One answer changed where it is produced: the last output's first
    value moved by a thousandth of its scale."""
    leaf = result if isinstance(result, torch.Tensor) else result[-1]
    leaf[0, 0] += 1e-3 * float(leaf.abs().max())
    return result


def half_left_out(result, x):
    """Half of the batch left out: its rows of every output zero."""
    def cut(t):
        t = t.clone()
        t[t.shape[0] // 2:] = 0
        return t
    return _map(result, cut)


def unchanged(result, x):
    """A step that returns its state unchanged: every output is the input."""
    return _map(result, lambda t: x.to(t.dtype).clone())


def run(cell):
    return core.run(cell, SEED, 0.2, False, "cpu", time.perf_counter(), log=lambda _: None)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result = run(tiny(name))
    assert result["correct"] and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"throughput", "call_ms_p95", "setup_s"}


@pytest.mark.parametrize("fault", [altered, half_left_out, unchanged])
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(name, fault):
    result = run(broken(tiny(name), fault))
    assert not result["correct"] and result["failed"] > 0
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(name):
    cell = tiny(name)
    for reading in control.readings(cell, [SEED, SEED + 1, SEED + 2], "cpu", control=True):
        assert any(reading[g] > lim for g, lim in cell.limits.items()), reading
    for reading in control.readings(cell, [SEED], "cpu", control=False):
        assert all(reading[g] <= lim for g, lim in cell.limits.items()), reading


def test_trace_reduction():
    E = trace.Event
    events = [
        E(False, trace.CALL_SPAN, 0.0, 100.0), E(True, trace.CALL_SPAN, 0.0, 100.0),
        E(False, "aten::sort", 5.0, 40.0), E(False, "cudaLaunchKernel", 10.0, 12.0),
        E(True, "kernel_a", 20.0, 50.0), E(True, "kernel_b", 45.0, 60.0),
        E(True, "kernel_a", 80.0, 90.0), E(False, "aten::add", 60.0, 75.0),
    ]
    s = trace.reduce(events, calls=2)
    assert (s.calls, s.launches) == (2, 3)
    assert s.busy_s == pytest.approx(50e-6) and s.window_s == pytest.approx(100e-6)
    assert s.device_s == pytest.approx(55e-6)
    assert s.device_ops[0] == ["kernel_a", pytest.approx(40e-6)]
    # gaps [0,20] mid 10: the launch; [60,80] mid 70: the add; [90,100]: Python
    assert dict(s.idle_gaps) == pytest.approx({"cudaLaunchKernel": 20e-6, "aten::add": 20e-6,
                                               trace.HOST_PYTHON: 10e-6})
    assert trace.reduce([E(True, "k", 0.0, 1.0)], calls=1) is None


@pytest.mark.cuda
def test_one_cell_on_the_card():
    """One short run of the first cell from the command line, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = core.ROOT
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                          "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                         cwd=root, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
