"""Shared by ``tests/test_torch_examples_*.py``: run a port example with
``--cpu`` in this process and hold what it prints against the JAX
example's recording (``tools/example_figures.py``)."""

from tools.example_figures import EXAMPLES, run_and_compare
from vectorwave_tpu_torch import cost_model


def check_example(name: str, monkeypatch, tmp_path) -> None:
    """The example runs on the CPU and matches its recording.  A calibration
    it persists goes to ``tmp_path``, not to the cost model's store."""
    monkeypatch.setattr(cost_model, "_store_path", lambda: str(tmp_path / "performance.json"))
    problems, _ = run_and_compare(name)
    assert not problems, "\n".join(problems)
