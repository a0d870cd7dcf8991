"""The parallel tier's examples on the port (``examples/torch/``), run with
``--cpu`` at their own sizes.

Counterpart of ``tests/test_examples_and_fixtures.py::test_example_runs``
for the ported examples; that test's ``examples/*.py`` glob does not reach
``examples/torch/``.  Every parity figure an example prints (against the
single-device transform, a round trip, a sharded call against one call) is
held to float32's bound.
"""

import pathlib
import re
import runpy
import sys

import pytest

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples" / "torch"
#: float32 transforms in another order or over shards, of unit-variance data
TOL_F32 = 1e-5
PARITY = re.compile(r"(?:single-device|round trip|vs one call)[^:]*:? ([0-9.]+e[+-][0-9]+)")


@pytest.mark.parametrize("name,expect", [
    ("multihost_demo.py", ("mesh: {'host': 2, 'chip': 4}", "DCN bytes/host: 0")),
    ("distributed_demo.py", ("sharded batch energies shape: (16, 5)",)),
    ("parallel_denoising.py", ("SURE per-signal RMSE", "sharded over 4 shards")),
])
def test_example_runs_on_the_cpu(name, expect, monkeypatch, capsys):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(sys, "argv", [name, "--cpu"])
    runpy.run_path(str(EXAMPLES / name), run_name="__main__")
    out = capsys.readouterr().out
    for text in expect:
        assert text in out
    figures = [float(f) for f in PARITY.findall(out)]
    assert figures and max(figures) <= TOL_F32, out
    if name == "parallel_denoising.py":
        before, after = map(float, re.search(r"RMSE ([0-9.]+) -> ([0-9.]+)", out).groups())
        assert after < 0.5 * before
