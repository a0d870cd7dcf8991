"""The port's 1-D analysis examples (``examples/torch/``), run with
``--cpu`` and held against the JAX examples' recordings
(``tools/example_figures.py``)."""

import pytest

from .torch_example_check import check_example

NAMES = ["wavelet_variance_demo", "multifractal_demo", "ewt_demo"]


@pytest.mark.parametrize("name", NAMES)
def test_example_matches_the_jax_recording(name, monkeypatch, tmp_path):
    check_example(name, monkeypatch, tmp_path)
