"""Port parity: the plain tiers of streaming against vectorwave_tpu's jnp
tier, in float64 within 1e-12 (the same arithmetic in another order).

Mirrors ``tests/test_streaming.py`` and ``tests/test_sliding.py``: block
outputs against the whole-signal transform (zero and symmetric), periodic
blocks, the flush, sliding windows against the direct transform, the plain
streaming denoiser, the stateful wrappers, and a JAX state carried into the
port mid-stream.  Every state here is made with ``device="cpu"``; the
default device is the card, which raises without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from vectorwave_tpu import streaming as jst
from vectorwave_tpu_torch import convert
from vectorwave_tpu_torch import streaming as st
from vectorwave_tpu_torch.errors import InvalidArgumentError

from .conftest import composite_sin

torch.set_num_threads(1)

TOL = 1e-12
F64 = torch.float64


def _np(a):
    return a.detach().double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, tol=TOL):
    got, want = _np(got), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert float(np.max(np.abs(got - want), initial=0.0)) <= tol


def _stream_both(x, name, levels, boundary, block):
    """The same blocks through both plain tiers: (port outputs, JAX outputs,
    final port state, final JAX state)."""
    batch = x.shape[:-1]
    s_p = st.streaming_init(name, levels, batch_shape=batch, dtype=F64, device="cpu")
    s_j = jst.streaming_init(name, levels, batch_shape=batch, dtype=jnp.float64)
    outs_p, outs_j = [], []
    for start in range(0, x.shape[-1], block):
        blk = x[..., start:start + block]
        s_p, r_p = st.modwt_stream_block(s_p, torch.from_numpy(blk), name,
                                         boundary=boundary)
        s_j, r_j = jst.modwt_stream_block(s_j, jnp.asarray(blk), name, boundary=boundary)
        outs_p.append(r_p)
        outs_j.append(r_j)
    return outs_p, outs_j, s_p, s_j


def _cat(outs, j=None):
    pick = (lambda o: o.approx) if j is None else (lambda o: o.details[j])
    return np.concatenate([_np(pick(o)) for o in outs], axis=-1)


@pytest.mark.parametrize("block_size", [64, 100, 256])
@pytest.mark.parametrize("name,levels", [("haar", 3), ("db4", 3), ("sym8", 2)])
@pytest.mark.parametrize("boundary", ["zero", "symmetric"])
def test_blocks_match_jax_and_the_whole_signal(name, levels, block_size, boundary):
    x = composite_sin(512, noise_std=0.3)
    outs_p, outs_j, s_p, s_j = _stream_both(x, name, levels, boundary, block_size)
    whole = vt.modwt_multilevel(torch.from_numpy(x), name, levels=levels,
                                boundary=boundary, backend="torch")
    for j in range(levels):
        _close(_cat(outs_p, j), _cat(outs_j, j))
        _close(_cat(outs_p, j), _np(whole.details[j]))
    _close(_cat(outs_p), _np(whole.approx))
    assert s_p.blocks_processed == int(s_j.blocks_processed)
    for hp, hj in zip(s_p.histories, s_j.histories):
        _close(hp, hj)


def test_symmetric_block_shorter_than_the_history():
    """The first block's mirror tiles its reflections when the block is
    shorter than a level's history (sym8 level 3: 28 samples)."""
    x = composite_sin(200, noise_std=0.2)
    outs_p, outs_j, _, _ = _stream_both(x, "sym8", 3, "symmetric", 20)
    for j in range(3):
        _close(_cat(outs_p, j), _cat(outs_j, j))
    _close(_cat(outs_p), _cat(outs_j))


def test_periodic_is_per_block():
    x = composite_sin(256)
    outs_p, outs_j, s_p, _ = _stream_both(x, "db4", 2, "periodic", 128)
    expected = vt.modwt_multilevel(torch.from_numpy(x[:128]), "db4", levels=2,
                                   boundary="periodic", backend="torch")
    _close(outs_p[0].details[0], expected.details[0])
    _close(_cat(outs_p, 0), _cat(outs_j, 0))
    assert s_p.blocks_processed == 2
    with pytest.raises(InvalidArgumentError):
        st.modwt_stream_block(s_p, torch.zeros(8, dtype=F64), "db4", boundary="reflect")


def test_flush_drains_history_as_jax_does():
    levels = 2
    tail = st.suggest_flush_tail_length("db4", levels)
    assert tail == jst.suggest_flush_tail_length("db4", levels) == 14
    assert st.stream.history_length(8, 2) == 14
    x = composite_sin(128)
    s_p = st.streaming_init("db4", levels, dtype=F64, device="cpu")
    s_j = jst.streaming_init("db4", levels, dtype=jnp.float64)
    s_p, _ = st.modwt_stream_block(s_p, torch.from_numpy(x), "db4")
    s_j, _ = jst.modwt_stream_block(s_j, jnp.asarray(x), "db4")
    _, r_p = st.modwt_stream_flush(s_p, "db4")
    _, r_j = jst.modwt_stream_flush(s_j, "db4")
    assert r_p.approx.shape[-1] == tail and float(r_p.approx.abs().max()) > 0
    _close(r_p.approx, r_j.approx)
    _close(r_p.details[1], r_j.details[1])


def test_batched_state_and_levels_gate():
    batch = np.stack([composite_sin(256, seed=s, noise_std=0.1) for s in range(3)])
    s_p = st.streaming_init("db4", 2, batch_shape=(3,), dtype=F64, device="cpu")
    _, res = st.modwt_stream_block(s_p, torch.from_numpy(batch[:, :128]), "db4")
    assert res.approx.shape == (3, 128)
    with pytest.raises(InvalidArgumentError):
        st.streaming_init("db4", 0, device="cpu")


def test_streaming_transform_class():
    x = composite_sin(512, noise_std=0.2)
    t = st.StreamingTransform("db4", levels=3, dtype=F64, device="cpu")
    assert t.backend == "torch"  # auto on the CPU: the plain tier
    outs = [t.process(x[i:i + 128]) for i in range(0, 512, 128)]
    whole = vw.modwt_multilevel(jnp.asarray(x), "db4", levels=3, boundary="zero",
                                backend="jnp")
    _close(_cat(outs, 0), whole.details[0])
    assert t.statistics == {"samples_processed": 512, "blocks_processed": 4}
    assert t.flush().approx.shape[-1] == st.suggest_flush_tail_length("db4", 3)
    t.reset()
    assert t.statistics["blocks_processed"] == 0 and t.state.blocks_processed == 0


def test_default_device_is_the_card():
    """Entry points that create state default to the card; without one they
    raise rather than carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (lambda: st.StreamingTransform("db4"),
                 lambda: st.StreamingDenoiser("db4"),
                 lambda: st.SlidingStreamingTransform("db4"),
                 lambda: st.StreamIngest("db4"),
                 lambda: st.streaming_init("db4", 2),
                 lambda: st.kernel_streaming_denoiser_init("db4", levels=2),
                 lambda: convert.streaming_state_from_arrays([np.zeros(7)], 0)):
        with pytest.raises(InvalidArgumentError, match="no CUDA device"):
            make()


# --- sliding windows ------------------------------------------------------------------


def test_step_size_matches_reference_overlap():
    assert st.step_size(512, "db4") == jst.step_size(512, "db4") == 505
    assert st.step_size(512, "haar") == 511
    assert st.step_size(512, "db4", levels=3) == 512 - 49
    with pytest.raises(InvalidArgumentError):
        st.step_size(40, "db4", levels=3)


def test_window_tracks_stream_tail():
    state = st.sliding_init(16, dtype=F64, device="cpu")
    stream = torch.arange(1.0, 41.0, dtype=F64)
    state = st.sliding_push(state, stream[:16])
    assert torch.equal(state.window, stream[:16])
    state = st.sliding_push(state, stream[16:25])
    assert torch.equal(state.window, stream[9:25]) and state.samples_seen == 25
    state = st.sliding_push(state, stream[:40])  # longer than the window
    assert torch.equal(state.window, stream[24:40])
    with pytest.raises(InvalidArgumentError):
        st.sliding_init(50_000_000, device="cpu")  # 200 MB of f32 > 100 MB cap
    with pytest.raises(InvalidArgumentError):
        st.sliding_init(1, device="cpu")


@pytest.mark.parametrize("levels,boundary", [(1, "periodic"), (3, "symmetric")])
def test_sliding_windows_match_jax(levels, boundary):
    buffer_size = 128
    stream = composite_sin(1000, noise_std=0.2)
    port = st.SlidingStreamingTransform("db4", buffer_size=buffer_size, levels=levels,
                                        boundary=boundary, dtype=F64, device="cpu")
    ref = jst.SlidingStreamingTransform("db4", buffer_size=buffer_size, levels=levels,
                                        boundary=boundary, dtype=jnp.float64)
    got, want = port.process(stream), ref.process(stream)
    step = st.step_size(buffer_size, "db4", levels=levels)
    assert len(got) == len(want) == 1 + (1000 - buffer_size) // step
    for i, (g, w) in enumerate(zip(got, want)):
        for a, b in zip(g, w):
            _close(torch.stack(list(a)) if isinstance(a, tuple) else a,
                   np.stack(b) if isinstance(b, tuple) else b)
        end = buffer_size + i * step
        window = torch.from_numpy(stream[end - buffer_size:end])
        direct = (vt.modwt(window, "db4", boundary=boundary) if levels == 1 else
                  vt.modwt_multilevel(window, "db4", levels=levels, boundary=boundary))
        _close(g[0] if levels == 1 else g.approx,
               _np(direct[0] if levels == 1 else direct.approx))
    assert port.statistics == {"samples_processed": 1000, "windows_emitted": len(got),
                               "buffer_size": 128, "overlap": 128 - step}
    tail_p, tail_j = port.flush(), ref.flush()
    assert port.statistics["samples_processed"] == 1000
    _close(tail_p[0] if levels == 1 else tail_p.approx,
           tail_j[0] if levels == 1 else tail_j.approx)
    port.reset()
    assert port.statistics["windows_emitted"] == 0 and port.process(stream[:10]) == []
    assert port.flush() is not None and st.SlidingStreamingTransform(
        "db4", device="cpu").flush() is None


def test_per_sample_equals_chunked_and_batches():
    stream = composite_sin(300, seed=3, noise_std=0.1)
    chunked = st.SlidingStreamingTransform("haar", buffer_size=64, device="cpu")
    per_sample = st.SlidingStreamingTransform("haar", buffer_size=64, device="cpu")
    res_a = chunked.process(stream)
    res_b = [o for o in (per_sample.process_sample(float(s)) for s in stream)
             if o is not None]
    assert len(res_a) == len(res_b)
    assert all(torch.equal(a.approx, b.approx) for a, b in zip(res_a, res_b))
    t = st.SlidingStreamingTransform("db2", buffer_size=64, batch_shape=(3,),
                                     dtype=F64, device="cpu")
    block = np.stack([composite_sin(64, seed=s) for s in range(3)])
    (res,) = t.process(block)
    _close(res.detail, vw.modwt(jnp.asarray(block), "db2").detail)
    state = st.sliding_init(64, batch_shape=(3,), dtype=F64, device="cpu")
    state, one = st.sliding_step_multilevel(state, torch.from_numpy(block), "db2", levels=2)
    _close(one.approx, vw.modwt_multilevel(jnp.asarray(block), "db2", levels=2).approx)


# --- the plain streaming denoiser -----------------------------------------------------


@pytest.mark.parametrize("est,kw", [("mad", {}), ("std", {}), ("fixed", {"fixed_sigma": 0.5})])
@pytest.mark.parametrize("mode,levels", [("soft", 4), ("hard", 1)])
def test_plain_denoiser_matches_jax(est, kw, mode, levels):
    rng = np.random.default_rng(0)
    s_p = st.streaming_denoiser_init("db4", levels=levels, batch_shape=(2,), dtype=F64,
                                     device="cpu")
    s_j = jst.streaming_denoiser_init("db4", levels=levels, batch_shape=(2,),
                                      dtype=jnp.float64)
    for n in (256, 100, 256):
        blk = rng.standard_normal((2, n))
        s_p, out_p = st.streaming_denoise_block(s_p, torch.from_numpy(blk), "db4",
                                                threshold_mode=mode, noise_estimation=est,
                                                **kw)
        s_j, out_j = jst.streaming_denoise_block(s_j, jnp.asarray(blk), "db4",
                                                 threshold_mode=mode,
                                                 noise_estimation=est, **kw)
        _close(out_p, out_j)
        _close(s_p.noise_window, s_j.noise_window)
        assert (s_p.window_pos, s_p.window_fill) == (int(s_j.window_pos),
                                                     int(s_j.window_fill))


def test_plain_denoiser_errors_and_class():
    state = st.streaming_denoiser_init("haar", levels=1, dtype=F64, device="cpu")
    x = torch.from_numpy(composite_sin(128, noise_std=0.5))
    state, out = st.streaming_denoise_block(state, x, "haar", noise_estimation="fixed",
                                            fixed_sigma=0.5)
    assert out.shape == x.shape
    with pytest.raises(InvalidArgumentError):
        st.streaming_denoise_block(state, x, "haar", noise_estimation="fixed")
    with pytest.raises(InvalidArgumentError):
        st.streaming_denoise_block(state, x, "haar", noise_estimation="bogus")

    rng = np.random.default_rng(0)
    n = 2048
    clean = composite_sin(n)
    noisy = clean + rng.normal(0, 1.0, n)
    den = st.StreamingDenoiser("db4", implementation="quality", dtype=F64, device="cpu")
    ref = jst.StreamingDenoiser("db4", implementation="quality", dtype=jnp.float64,
                                backend="jnp")
    assert den.backend == "torch" and den.levels == 4
    outs = []
    for s in range(0, n, 256):
        outs.append(_np(den.denoise(noisy[s:s + 256])))
        _close(outs[-1], ref.denoise(noisy[s:s + 256]))
    out = np.concatenate(outs)
    sl = slice(512, n)
    assert np.mean((out[sl] - clean[sl]) ** 2) < np.mean((noisy[sl] - clean[sl]) ** 2)
    assert den.statistics == {"samples_processed": n, "blocks_processed": 8}
    den.reset()
    assert den.statistics["blocks_processed"] == 0


def test_denoiser_state_restore_validates_backend():
    d = st.StreamingDenoiser("db4", backend="jnp", device="cpu")
    assert d.backend == "torch"
    good = d.state
    with pytest.raises(InvalidArgumentError, match="resolved backend"):
        d.state = st.kernel_streaming_denoiser_init(d.wavelet, levels=d.levels,
                                                    device="cpu")
    d.state = good
    d.denoise(np.zeros(256, np.float32))


# --- state carried across from JAX ------------------------------------------------------


def test_jax_plain_states_resume_in_the_port():
    """A stream and a denoiser checkpointed in JAX after two blocks continue
    in the port to the outputs the JAX run gives."""
    x = composite_sin(768, noise_std=0.3)
    s_j = jst.streaming_init("sym8", 3, dtype=jnp.float64)
    for start in (0, 256):
        s_j, _ = jst.modwt_stream_block(s_j, jnp.asarray(x[start:start + 256]), "sym8",
                                        boundary="symmetric")
    s_p = convert.streaming_state_from_arrays([np.asarray(h) for h in s_j.histories],
                                              np.asarray(s_j.blocks_processed),
                                              device="cpu")
    assert s_p.blocks_processed == 2 and s_p.histories[0].dtype == F64
    _, r_j = jst.modwt_stream_block(s_j, jnp.asarray(x[512:]), "sym8",
                                    boundary="symmetric")
    _, r_p = st.modwt_stream_block(s_p, torch.from_numpy(x[512:]), "sym8",
                                   boundary="symmetric")
    _close(r_p.approx, r_j.approx)
    _close(r_p.details[2], r_j.details[2])

    d_j = jst.streaming_denoiser_init("db4", levels=2, dtype=jnp.float64)
    for start in (0, 256):
        d_j, _ = jst.streaming_denoise_block(d_j, jnp.asarray(x[start:start + 256]), "db4")
    d_p = convert.streaming_denoiser_state_from_arrays(
        [np.asarray(h) for h in d_j.transform.histories],
        np.asarray(d_j.transform.blocks_processed), np.asarray(d_j.noise_window),
        np.asarray(d_j.window_pos), np.asarray(d_j.window_fill), device="cpu")
    _, want = jst.streaming_denoise_block(d_j, jnp.asarray(x[512:]), "db4")
    _, got = st.streaming_denoise_block(d_p, torch.from_numpy(x[512:]), "db4")
    _close(got, want)
    with pytest.raises(InvalidArgumentError):
        convert.kernel_streaming_state_from_arrays(np.zeros(7), np.zeros(2), device="cpu")


def test_streaming_exports_match_the_jax_package():
    assert st.__all__ == jst.__all__
    assert all(hasattr(st, name) for name in st.__all__)
    assert "streaming" in vt.__all__ and "native" in vt.__all__
