"""The port's CWT examples (``examples/torch/``), run with ``--cpu`` and held
against the JAX examples' recordings (``tools/example_figures.py``); and
one JAX example run live, as ``tools/record_jax_examples.py`` runs it (its
own process, ``JAX_PLATFORMS=cpu``), against its own recording, which
shows that the recordings are what the JAX examples print."""

import os
import pathlib
import subprocess
import sys

import pytest

from tools.example_figures import compare

from .torch_example_check import check_example

NAMES = ["cwt_analysis_demo", "complex_wavelets_demo", "cross_wavelet_demo",
         "synchrosqueezing_demo", "matching_pursuit_demo", "directional_cwt2_demo",
         "scattering_features_demo"]
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", NAMES)
def test_example_matches_the_jax_recording(name, monkeypatch, tmp_path):
    check_example(name, monkeypatch, tmp_path)


def test_the_jax_example_still_prints_its_recording():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / "cwt_analysis_demo.py")],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
                          check=True)
    problems = compare("cwt_analysis_demo", proc.stdout)
    assert not problems, "\n".join(problems)
