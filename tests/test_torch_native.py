"""The port's native ingest runtime: ring buffer semantics on both backends,
backend parity, threading, the same frames as the JAX package's ring, and
StreamIngest against the sliding-window transform.

Mirrors ``tests/test_native_ingest.py``.  The port builds its own copy of
``ringbuf.cpp`` (into ``vectorwave_tpu_torch/native/_build/``); everything
here runs on the CPU, with ``device="cpu"`` for the transforms.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from vectorwave_tpu.native import RingBuffer as JaxRingBuffer
from vectorwave_tpu_torch import native
from vectorwave_tpu_torch.errors import (
    InvalidArgumentError,
    InvalidStateError,
    VectorWaveError,
)
from vectorwave_tpu_torch.native import RingBuffer, native_available
from vectorwave_tpu_torch.streaming import SlidingStreamingTransform, StreamIngest

BACKENDS = ["python", "native"]


def test_native_backend_builds_here():
    # the build environment ships g++: the native path must load, so the rest
    # of this file exercises it, not just the fallback
    assert native_available() and native.native_build_error() is None
    assert native.BUILD_DIR.name == "_build"
    assert RingBuffer(4).backend == "native"


@pytest.mark.parametrize("backend", BACKENDS)
def test_push_pop_fifo(backend):
    rb = RingBuffer(64, backend=backend)
    assert rb.backend == backend
    assert rb.push(np.arange(10.0)) == 10
    assert rb.available == 10
    np.testing.assert_array_equal(rb.pop(4), np.arange(4.0, dtype=np.float32))
    np.testing.assert_array_equal(rb.pop(100), np.arange(4.0, 10.0, dtype=np.float32))
    assert rb.available == 0
    assert rb.pop(5).shape == (0,)
    assert rb.push(np.zeros(0)) == 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_wraparound_preserves_order(backend):
    rb = RingBuffer(16, backend=backend)
    fed, popped, k = [], [], 0
    rng = np.random.default_rng(1)
    for _ in range(200):
        n = int(rng.integers(1, 9))
        chunk = np.arange(k, k + n, dtype=np.float64)
        accepted = rb.push(chunk)
        fed.extend(chunk[:accepted].tolist())
        k += n
        popped.extend(rb.pop(int(rng.integers(1, 12))).tolist())
    popped.extend(rb.pop(100).tolist())
    assert popped == fed[: len(popped)]
    assert rb.dropped > 0  # a buffer this small must have refused some pushes


@pytest.mark.parametrize("backend", BACKENDS)
def test_full_buffer_rejects_and_counts(backend):
    rb = RingBuffer(8, backend=backend)
    assert rb.push(np.arange(20.0)) == 8
    assert rb.dropped == 12
    np.testing.assert_array_equal(rb.peek_latest(3), np.array([5, 6, 7], dtype=np.float32))
    assert rb.available == 8  # peek does not consume


@pytest.mark.parametrize("backend", BACKENDS)
def test_pop_frames_overlap_semantics(backend):
    rb = RingBuffer(256, backend=backend)
    rb.push(np.arange(100.0))
    frames = rb.pop_frames(16, 10)
    assert frames.shape == (9, 16)
    for f in range(9):
        np.testing.assert_array_equal(frames[f], np.arange(10.0 * f, 10.0 * f + 16,
                                                           dtype=np.float32))
    assert rb.available == 10  # the overlap of the 10th window stays queued
    rb.push(np.arange(100.0, 106.0))
    more = rb.pop_frames(16, 10, max_frames=1)
    np.testing.assert_array_equal(more, np.arange(90.0, 106.0, dtype=np.float32)[None])
    assert rb.pop_frames(16, 10).shape == (0, 16)


@pytest.mark.parametrize("backend", BACKENDS)
def test_multichannel_frames(backend):
    rb = RingBuffer(64, channels=3, dtype=np.float64, backend=backend)
    ticks = np.arange(60.0).reshape(20, 3)
    assert rb.push(ticks) == 20
    frames = rb.pop_frames(8, 4)
    assert frames.shape == (4, 8, 3)
    np.testing.assert_array_equal(frames[1], ticks[4:12])


def _random_program(rings, seed):
    """Drive every ring with the same random pushes, pops and frame pops and
    hold their outputs and counters equal."""
    rng = np.random.default_rng(seed)
    for _ in range(300):
        op = rng.integers(0, 3)
        if op == 0:
            chunk = rng.standard_normal((int(rng.integers(0, 15)), 2))
            assert len({rb.push(chunk) for rb in rings}) == 1
        elif op == 1:
            n = int(rng.integers(1, 20))
            outs = [rb.pop(n) for rb in rings]
        else:
            fl = int(rng.integers(2, 12))
            hop = int(rng.integers(1, fl + 1))
            outs = [rb.pop_frames(fl, hop, 3) for rb in rings]
        if op:
            for out in outs[1:]:
                np.testing.assert_array_equal(out, outs[0])
        assert len({rb.available for rb in rings}) == 1
        assert len({rb.dropped for rb in rings}) == 1


def test_backend_parity_random_program():
    _random_program([RingBuffer(37, channels=2, backend="native"),
                     RingBuffer(37, channels=2, backend="python")], seed=7)


def test_same_frames_as_the_jax_package_ring():
    """The port's two backends and the JAX package's ring hold the same
    frames through the same program."""
    _random_program([RingBuffer(37, channels=2, backend="native"),
                     RingBuffer(37, channels=2, backend="python"),
                     JaxRingBuffer(37, channels=2, backend="python")], seed=8)


@pytest.mark.parametrize("backend", BACKENDS)
def test_threaded_producer_consumer_lossless(backend):
    total = 200_000
    rb = RingBuffer(4096, backend=backend)
    data = np.arange(total, dtype=np.float32)
    got = []

    def producer():
        i = 0
        rng = np.random.default_rng(3)
        while i < total:
            n = min(int(rng.integers(1, 700)), total - i)
            i += rb.push(data[i:i + n])  # retry the refused tail (backpressure)

    t = threading.Thread(target=producer)
    t.start()
    while True:
        chunk = rb.pop(1024)
        if chunk.shape[0]:
            got.append(chunk)
        elif not t.is_alive() and rb.available == 0:
            break
    t.join(timeout=60)
    assert not t.is_alive()
    np.testing.assert_array_equal(np.concatenate(got), data)


def test_validation():
    with pytest.raises(VectorWaveError):
        RingBuffer(16, dtype=np.int32)
    with pytest.raises(VectorWaveError):
        RingBuffer(0)
    with pytest.raises(VectorWaveError):
        RingBuffer(16, channels=0)
    with pytest.raises(VectorWaveError):
        RingBuffer(16, backend="rust")
    rb = RingBuffer(16)
    with pytest.raises(InvalidArgumentError):
        rb.pop_frames(32, 4)  # a frame longer than the capacity
    with pytest.raises(InvalidArgumentError):
        rb.pop_frames(8, 0)
    with pytest.raises(InvalidArgumentError):
        rb.push(np.zeros((4, 2)))  # channel mismatch
    rb.close()
    with pytest.raises(InvalidStateError):
        rb.push(np.zeros(2))
    rb.close()  # idempotent


@pytest.mark.parametrize("levels", [1, 3])
def test_stream_ingest_matches_sliding_transform(levels):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(4096).astype(np.float32)
    ing = StreamIngest("db4", buffer_size=256, levels=levels, capacity=8192, device="cpu")
    outs = []
    i = 0
    while i < len(x):
        n = int(rng.integers(1, 300))
        ing.push(x[i:i + n])
        i += n
        out = ing.drain()
        if out is not None:
            outs.append(out)
    assert ing.ring.dropped == 0 and ing.statistics["backend"] == "native"
    ref = SlidingStreamingTransform("db4", buffer_size=256, levels=levels, device="cpu")
    windows = ref.process(x)
    assert ing.windows_emitted == len(windows)
    if levels == 1:
        got = [torch.cat([o[f] for o in outs]) for f in range(2)]
        want = [torch.stack([w[f] for w in windows]) for f in range(2)]
    else:
        got = [torch.cat([o.details[j] for o in outs]) for j in range(levels)]
        got.append(torch.cat([o.approx for o in outs]))
        want = [torch.stack([w.details[j] for w in windows]) for j in range(levels)]
        want.append(torch.stack([w.approx for w in windows]))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_stream_ingest_drain_and_stats():
    ing = StreamIngest("haar", buffer_size=64, capacity=64 * 64, device="cpu")
    ing.push(np.zeros(64 + ing.step * 5))
    assert ing.ready == 6
    assert ing.latest_window().shape == (64,)
    out = ing.drain()
    assert all(t.shape[0] == 6 for t in out)  # no padding to a power of two
    assert ing.drain() is None
    assert ing.statistics["windows_emitted"] == 6
    assert ing.statistics["samples_transformed"] == 6 * 64
    assert ing.latest_window() is None  # only the overlap tick remains queued
    with pytest.raises(InvalidArgumentError):
        StreamIngest("haar", buffer_size=64, capacity=32, device="cpu")


def test_stream_ingest_multichannel():
    from vectorwave_tpu_torch import modwt_multilevel

    rng = np.random.default_rng(5)
    x = rng.standard_normal((1024, 4)).astype(np.float32)
    ing = StreamIngest("db2", buffer_size=128, levels=2, channels=4, device="cpu")
    ing.push(x)
    out = ing.drain()
    assert out.details[0].shape[1:] == (4, 128)  # windows x channels x time
    direct = modwt_multilevel(torch.from_numpy(x[:128, 2]), "db2", levels=2)
    torch.testing.assert_close(out.details[0][0, 2], direct.details[0], rtol=0, atol=1e-6)
