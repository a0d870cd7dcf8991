"""The port's finance examples (``examples/torch/``), run with ``--cpu``
and held against the JAX examples' recordings
(``tools/example_figures.py``)."""

import pytest

from .torch_example_check import check_example

NAMES = ["financial_demo", "portfolio_risk", "realtime_market_monitor", "trading_signals"]


@pytest.mark.parametrize("name", NAMES)
def test_example_matches_the_jax_recording(name, monkeypatch, tmp_path):
    check_example(name, monkeypatch, tmp_path)
