"""``BENCHMARK.json`` against the contract's form, and the harness's
pieces found by name: configurations, traffic, entries, limits, readers,
work counts and the import guard.  CPU only."""

import json
import math
import re

import pytest

from portbench import core, guard, peaks

BENCH = core.manifest()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ONE_LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells at this length fits its 43200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((core.ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]] + CELLS
                         + [m["name"] for m in METRICS]
                         + [w["traffic"] for w in BENCH["workloads"]])
def test_names(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_form(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_end_to_end():
    names = {m["name"]: m for m in BENCH["end_to_end"]}
    assert {"throughput", "call_ms_p95", "setup_s"} <= set(names)
    assert names["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}


def test_unique_names():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    assert config["file"] == f"portbench/configs/{config['name']}.json"
    data = json.loads((core.ROOT / config["file"]).read_text())
    assert data["name"] == config["name"] and data["reduced"] == config["reduced"]
    # every key changed from the source is in the file and says why
    assert all(key in data and key in data["assumed"] for key in data["reduced"])
    assert data["source"] == config["source"] and ONE_LINE.match(config["source"])
    assert config["source"].startswith("https://")
    assert ONE_LINE.match(config["why"])
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    (w,) = [w for w in BENCH["workloads"] if w["name"] == name]
    assert w["chips"] == 1 and ONE_LINE.match(w["why"])
    cell = core.load_cell(name)
    for fn in ("call", "control", "outputs", "reference", "work"):
        assert callable(getattr(cell.entry, fn))
    assert cell.limits and all(0 < v < 1 for v in cell.limits.values())
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        core.load_module("metrics", m["name"]).read


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_a_metric_its_cells_report(metric):
    assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert ONE_LINE.match(metric["layer"])
    (moved,) = [m for m in BENCH["end_to_end"] if m["name"] == metric["moves"]]
    for cell in metric["workloads"]:
        assert cell in CELLS
        assert cell in moved.get("workloads", CELLS)


SAMPLES = 1024 * 65536
#: bytes and FLOPs a call, worked out by hand from each entry's docstring
WORK = {
    "db4j6-roundtrip-b1024": (SAMPLES * (4 + 7 * 4 + 4), SAMPLES * 2 * 2 * 2 * 8 * 6, "float32"),
    "db4j6-exact-b1024": (SAMPLES * (4 + 7 * 8 + 4), SAMPLES * 2 * 2 * 2 * 8 * 6, "float64"),
}


@pytest.mark.parametrize("name", CELLS)
def test_work_counts(name):
    cell = core.load_cell(name)
    work = peaks.least(cell.entry.work(cell.cfg, cell.mix))
    assert (work["bytes"], work["flops"], work["dtype"]) == WORK[name]
    t_bytes = work["bytes"] / 3.35e12
    t_flops = work["flops"] / (67e12 if work["dtype"] == "float32" else 34e12)
    assert math.isclose(work["least_s"], max(t_bytes, t_flops))
    assert work["bound"] == ("bytes" if t_bytes > t_flops else "flops")


def test_import_guard():
    assert guard.forbidden_modules(["jax", "jaxlib.xla_client", "flax.linen",
                                    "vectorwave_tpu", "vectorwave_tpu.kernels",
                                    "vectorwave_tpu_torch", "vectorwave_tpu_torch.kernels",
                                    "jaxtyping", "numpy"]) == [
        "flax.linen", "jax", "jaxlib.xla_client", "vectorwave_tpu", "vectorwave_tpu.kernels"]


def test_harness_sources_import_no_jax():
    """No file under portbench/ imports JAX or the JAX package."""
    pattern = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|flax|vectorwave_tpu)\b",
                         re.M)
    for path in core.HERE.rglob("*.py"):
        assert not pattern.search(path.read_text()), path
