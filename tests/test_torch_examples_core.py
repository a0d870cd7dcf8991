"""The port's MODWT, SWT and DWT examples (``examples/torch/``), run with
``--cpu`` at their own sizes and held against the recordings of the JAX
examples (``tests/torch_examples_expected/``) by ``tools/example_figures.py``:
integers equal, figures within 1% or one printed digit, round-off figures
within the float32 tier's bound.  Every example, run without ``--cpu`` on a
machine without a card, raises instead of falling back to the CPU."""

import runpy
import sys

import pytest
import torch

from tools.example_figures import RULES, recorded

from .torch_example_check import EXAMPLES, check_example

NAMES = ["basic_transforms", "denoising_demo", "fused_denoise_demo", "swt_demo",
         "swt_best_practices", "padding_demo", "dwt_and_kernels_demo",
         "tolerance_routing_demo", "extended_symlets_demo", "registry_tour",
         "transform_compatibility_demo", "wavelet_selection_guide"]


@pytest.mark.parametrize("name", NAMES)
def test_example_matches_the_jax_recording(name, monkeypatch, tmp_path):
    check_example(name, monkeypatch, tmp_path)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is there")
@pytest.mark.parametrize("path", sorted(EXAMPLES.glob("*.py")), ids=lambda p: p.stem)
def test_example_without_a_card_raises(path, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(sys, "argv", [str(path)])
    with pytest.raises((RuntimeError, AssertionError)):
        runpy.run_path(str(path), run_name="__main__")


def test_the_rules_name_ported_examples_with_recordings():
    names = set(recorded())
    assert names == {p.stem for p in EXAMPLES.glob("*.py")} - {
        "multihost_demo", "distributed_demo", "parallel_denoising"}
    assert len(names) == 37 and set(RULES) <= names
