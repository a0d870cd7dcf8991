"""The port's 2-D, tree and solver examples (``examples/torch/``), run with
``--cpu`` and held against the JAX examples' recordings
(``tools/example_figures.py``)."""

import pytest

from .torch_example_check import check_example

NAMES = ["image_processing_2d", "wavelet_packets_demo", "dtcwt_demo",
         "deconvolution_demo", "sparse_recovery_demo", "compression_lifting_demo"]


@pytest.mark.parametrize("name", NAMES)
def test_example_matches_the_jax_recording(name, monkeypatch, tmp_path):
    check_example(name, monkeypatch, tmp_path)
