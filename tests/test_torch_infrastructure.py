"""Port parity: the infrastructure names, mirroring the matching tests of
``tests/test_infrastructure.py``: the cost model (its store under the port's
own cache root, in a ``tmp_path``), observability (counters, the throughput
meter, the profiler trace), ``TransformConfig``, ``enable_compilation_cache``
and ``get_performance_info``.  Everything runs with ``device="cpu"``: the
default device is the card, and without one it raises.
"""

import json
import logging
import os

import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from vectorwave_tpu_torch import cost_model, native, observability
from vectorwave_tpu_torch.errors import InvalidArgumentError, InvalidConfigurationError
from vectorwave_tpu_torch.kernels import _build

torch.set_num_threads(1)

NO_CARD = not torch.cuda.is_available()


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setenv("VECTORWAVE_TPU_TORCH_CACHE", str(tmp_path))
    return tmp_path


def test_cost_model_estimate_and_calibration(cache):
    pred = cost_model.estimate_processing_time(65536, levels=6, batch=8, device="cpu")
    assert pred.estimated_seconds > 0 and not pred.calibrated
    assert pred.lower_seconds < pred.estimated_seconds < pred.upper_seconds
    rate = cost_model.calibrate(sizes=(1024,), batch=2, levels=3, device="cpu")
    assert rate > 0
    pred2 = cost_model.estimate_processing_time(65536, levels=6, batch=8, device="cpu")
    assert pred2.calibrated
    assert pred2.upper_seconds / pred2.lower_seconds < pred.upper_seconds / pred.lower_seconds
    # the store is the port's own, keyed by the platform
    store = json.loads((cache / "performance.json").read_text())
    assert set(store) == {"cpu"} and store["cpu"]["samples_per_second"] == rate
    assert not (cache / "xla").exists()


def test_cost_model_without_persisting_keeps_no_store(cache):
    rate = cost_model.calibrate(sizes=(512, 1024), batch=1, levels=2, persist=False, device="cpu")
    assert rate > 0 and not (cache / "performance.json").exists()
    assert not cost_model.estimate_processing_time(4096, device="cpu").calibrated


@pytest.mark.skipif(not NO_CARD, reason="the default device is the card here")
def test_cost_model_default_device_is_the_card(cache):
    with pytest.raises(InvalidArgumentError):
        cost_model.estimate_processing_time(4096)
    with pytest.raises(InvalidArgumentError):
        cost_model.calibrate(sizes=(512,))


def test_observability_stats_meter_and_logger(monkeypatch):
    observability.stats.reset()
    with observability.throughput_meter("unit", samples=1000):
        pass
    snap = observability.stats.snapshot()
    assert snap["unit.samples"] == 1000 and snap["unit.seconds"] >= 0
    observability.stats.add("unit.samples", 24)
    assert observability.stats.get("unit.samples") == 1024
    observability.stats.reset()
    assert observability.stats.get("unit.samples") == 0
    assert observability.logger is logging.getLogger("vectorwave_tpu_torch")
    # the JAX package's registry is its own
    assert observability.stats is not vw.observability.stats


def test_profiler_trace_writes_a_trace(tmp_path):
    x = torch.randn(2, 4096, generator=torch.Generator().manual_seed(0))
    with observability.profiler_trace(str(tmp_path / "trace")) as log_dir:
        vt.imodwt_multilevel(vt.modwt_multilevel(x, "db4", levels=3), "db4")
    files = os.listdir(log_dir)
    assert len(files) == 1 and os.path.getsize(os.path.join(log_dir, files[0])) > 0


def test_transform_config():
    cfg = vt.TransformConfig(boundary="zero", backend="jnp")
    assert cfg.boundary == "zero" and cfg.backend == "torch"
    assert cfg.max_decomposition_levels == 20
    assert vt.TransformConfig().backend == "auto"
    assert vt.TransformConfig(backend="pallas").backend == "kernel"
    with pytest.raises(InvalidConfigurationError):
        vt.TransformConfig(backend="xla")
    with pytest.raises(AttributeError):
        cfg.boundary = "periodic"
    want = vw.TransformConfig(boundary="zero", backend="jnp")
    assert (want.boundary, want.max_decomposition_levels) == (cfg.boundary,
                                                              cfg.max_decomposition_levels)


def test_enable_compilation_cache_points_the_builds(tmp_path, cache, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    where = vt.enable_compilation_cache(str(tmp_path / "builds"))
    assert where == str(tmp_path / "builds") and os.path.isdir(where)
    assert str(_build.BUILD_DIR) == where and str(native.BUILD_DIR) == where
    default = vt.enable_compilation_cache()
    assert default == os.path.join(str(cache), "cuda") and os.path.isdir(default)
    assert str(_build.BUILD_DIR) == default


def test_performance_info():
    info = vt.get_performance_info(device="cpu")
    assert info.platform == "cpu" and info.device_count >= 1 and not info.cuda_kernels
    assert "compute tier" in info.description
    if NO_CARD:
        assert vt.get_performance_info() == info
        with pytest.raises(InvalidArgumentError):
            vt.get_performance_info(device="cuda")
