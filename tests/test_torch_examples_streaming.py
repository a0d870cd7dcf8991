"""The port's streaming and infrastructure examples (``examples/torch/``),
run with ``--cpu`` and held against the JAX examples' recordings
(``tools/example_figures.py``)."""

import pytest

from .torch_example_check import check_example

NAMES = ["streaming_demo", "checkpoint_resume_demo", "memory_and_flush_demo",
         "native_ingest_demo", "calibration_demo"]


@pytest.mark.parametrize("name", NAMES)
def test_example_matches_the_jax_recording(name, monkeypatch, tmp_path):
    check_example(name, monkeypatch, tmp_path)
