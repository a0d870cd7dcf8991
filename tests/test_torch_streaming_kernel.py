"""Port parity: the external edge of the analysis kernel, the stream mode of
the denoise kernel, and the kernel tiers of block streaming and of the
streaming denoiser, against vectorwave_tpu.

The same seeded numpy inputs go through the JAX package's
``run_analysis_composite(halo=)`` / ``run_denoise_composite_stream`` (their
Pallas kernels in interpret mode) and its kernel-tier streaming steps, and
through the port's wrappers, which on the CPU run their plain versions.
Tolerances, with their reasons:

* the two kernel modes' plain versions against the JAX kernels, float32:
  2e-5 max abs (fp32 in another summation order, values of order 1, the
  JAX composite filters summed as banded products);
* the kernel tiers of the streaming steps against the JAX kernel tiers:
  1e-4 max abs, the JAX package's own bound between its kernel and jnp
  tiers (``tests/test_streaming_denoise_kernel.py``); the noise windows
  hold the same samples, computed in float32 on both sides;
* the multiblock step against K single steps: bit for bit.

The JAX kernels run at a few shapes only (db4 J=3 at 2x1024 and 2x2048,
sym8 J=4 at 2x1024), each compiling once in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from vectorwave_tpu import streaming as jst
from vectorwave_tpu.kernels.modwt_mxu import (
    run_analysis_composite as jax_analysis,
    run_denoise_composite_stream as jax_denoise_stream,
)
from vectorwave_tpu_torch import convert
from vectorwave_tpu_torch import streaming as st
from vectorwave_tpu_torch.errors import InvalidArgumentError, InvalidConfigurationError
from vectorwave_tpu_torch.kernels import modwt_composite as mc
from vectorwave_tpu_torch.kernels.modwt_fused import _kernel_filters

torch.set_num_threads(1)

TOL_KERNEL = 2e-5
TOL_TIER = 1e-4


def _filters(name):
    w = vt.wavelet(name)
    return _kernel_filters(w, synthesis=False), _kernel_filters(w, synthesis=True)


def _signal(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _maxdiff(got, want):
    return max(float(np.max(np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64))))
               for g, w in zip(got, want))


def _np(t):
    return t.detach().double().numpy()


# --- the two kernel modes: plain versions against the JAX kernels -------------------


@pytest.mark.parametrize("name,levels", [("db4", 3), ("sym8", 4)])
@pytest.mark.parametrize("halo_kind", ["short", "span", "long"])
def test_external_edge_matches_jax_kernel(name, levels, halo_kind):
    """A halo shorter than the span (zeros before it), equal to it, and
    longer (only its last span samples count)."""
    fd, _ = _filters(name)
    span = mc.composite_halo_samples(len(fd[0]), levels)
    h = {"short": span // 3, "span": span, "long": span + 300}[halo_kind]
    x, halo = _signal((2, 1024)), _signal((2, h), seed=1)
    want = jax_analysis(jnp.asarray(x), levels, fd, False, 65536, "float32", True,
                        halo=jnp.asarray(halo))
    got = mc.analysis(torch.from_numpy(x), levels, fd, False, halo=torch.from_numpy(halo))
    assert _maxdiff([_np(g) for g in got], want) <= TOL_KERNEL


def test_external_edge_halo_longer_than_span_reads_only_its_tail():
    fd, _ = _filters("db4")
    span = mc.composite_halo_samples(8, 3)
    x, halo = torch.from_numpy(_signal((2, 300))), torch.from_numpy(_signal((2, 400), 1))
    full = mc.analysis(x, 3, fd, False, halo=halo)
    tail = mc.analysis(x, 3, fd, False, halo=halo[:, -span:].contiguous())
    assert all(torch.equal(a, b) for a, b in zip(full, tail))
    with pytest.raises(InvalidArgumentError, match="periodic"):
        mc.analysis(x, 3, fd, True, halo=halo)


def test_external_edge_with_head_splice():
    """The symmetric first block's launch: external edge and head splice in
    one call; the head replaces each plane's first H outputs."""
    fd, _ = _filters("db4")
    x, halo = torch.from_numpy(_signal((2, 600))), torch.zeros(2, 49)
    head = torch.from_numpy(_signal((4, 2, 49), 2))
    got = mc.analysis(x, 3, fd, False, head=head, halo=halo)
    plain = mc.analysis(x, 3, fd, False)
    for j in range(4):
        assert torch.equal(got[j][:, :49], head[j])
        assert torch.equal(got[j][:, 49:], plain[j][:, 49:])


@pytest.mark.parametrize("mode", ["soft", "hard"])
def test_stream_mode_matches_jax_kernel(mode):
    fd, fr = _filters("db4")
    x, halo = _signal((2, 2048)), _signal((2, 49), seed=1)
    planes = mc.analysis(torch.from_numpy(x), 3, fd, False, halo=torch.from_numpy(halo))
    # thresholds at the median |d| of each (row, level): half the samples shrink
    ths = np.stack([np.median(np.abs(_np(p)), axis=-1) for p in planes[:3]],
                   axis=-1).astype(np.float32)
    want = jax_denoise_stream(jnp.asarray(x), jnp.asarray(halo), jnp.asarray(ths), 3,
                              fd, fr, 65536, mode, "float32", True)
    assert want is not None  # the JAX kernel serves this shape
    got = mc.denoise(torch.from_numpy(x), torch.from_numpy(ths), 3, fd, fr, False, mode,
                     halo=torch.from_numpy(halo))
    assert _maxdiff([_np(got)], [want]) <= TOL_KERNEL


def test_stream_mode_plain_version_is_its_definition():
    """float64: zero-boundary analysis of [halo | x] sliced to the block,
    shrunk, then the block-local zero-boundary inverse of the JAX jnp path."""
    w = vw.wavelet("sym4")
    fd, fr = _filters("sym4")
    x = np.random.default_rng(3).standard_normal((2, 300))
    halo = np.random.default_rng(4).standard_normal((2, 80))
    ths = np.array([[0.3, 0.2, 0.1], [0.5, 0.4, 0.0]])
    res = vw.modwt_multilevel(jnp.asarray(np.concatenate([halo, x], -1)), w, levels=3,
                              boundary="zero", backend="jnp")
    shrunk = tuple(vw.apply_threshold(d[..., 80:], jnp.asarray(ths[:, j:j + 1]), "soft")
                   for j, d in enumerate(res.details))
    want = vw.imodwt_multilevel(vw.MultiLevelMODWTResult(shrunk, res.approx[..., 80:]),
                                w, boundary="zero", backend="jnp")
    got = mc.denoise(torch.from_numpy(x), torch.from_numpy(ths), 3, fd, fr, False,
                     "soft", halo=torch.from_numpy(halo))
    assert _maxdiff([_np(got)], [want]) <= 1e-12


# --- the kernel tier of block streaming -------------------------------------------


def _stream_jax(x, name, levels, boundary, block):
    state = jst.kernel_streaming_init(name, levels, batch_shape=x.shape[:-1])
    outs = []
    for s in range(0, x.shape[-1], block):
        state, res = jst.modwt_stream_block_kernel(
            state, jnp.asarray(x[..., s:s + block]), name, levels=levels,
            boundary=boundary, interpret=True, precision="float32")
        outs.append(res)
    return state, outs


def _stream_port(x, name, levels, boundary, block, state=None, start=0, backend="kernel"):
    if state is None:
        state = st.kernel_streaming_init(name, levels, batch_shape=x.shape[:-1],
                                         dtype=torch.from_numpy(x).dtype, device="cpu")
    outs = []
    for s in range(start, x.shape[-1], block):
        state, res = st.modwt_stream_block_kernel(
            state, torch.from_numpy(x[..., s:s + block]), name, levels=levels,
            boundary=boundary, backend=backend)
        outs.append(res)
    return state, outs


def _arr(a):
    return _np(a) if isinstance(a, torch.Tensor) else np.asarray(a, np.float64)


def _planes(outs, levels):
    """The concatenated planes of a stream's block results, d_1..d_J, a_J."""
    return [np.concatenate([_arr(o.details[j]) for o in outs], -1)
            for j in range(levels)] + [np.concatenate([_arr(o.approx) for o in outs], -1)]


@pytest.mark.parametrize("boundary", ["zero", "symmetric"])
def test_kernel_stream_matches_jax_kernel_tier_and_whole_signal(boundary):
    x = _signal((2, 4096), seed=5)
    _, want = _stream_jax(x, "db4", 3, boundary, 1024)
    state, got = _stream_port(x, "db4", 3, boundary, 1024)
    assert state.blocks_processed == 4
    assert _maxdiff(_planes(got, 3), _planes(want, 3)) <= TOL_TIER
    whole = vw.modwt_multilevel(jnp.asarray(x, jnp.float64), "db4", levels=3,
                                boundary=boundary, backend="jnp")
    assert _maxdiff(_planes(got, 3), [*whole.details, whole.approx]) <= TOL_KERNEL


@pytest.mark.parametrize("name,levels,block", [
    ("db4", 3, 100),     # blocks shorter than the span's 128-multiple
    ("db4", 6, 300),     # blocks shorter than the span (441)
    ("sym8", 4, 1000),
    ("haar", 5, 64),
])
@pytest.mark.parametrize("boundary", ["zero", "symmetric"])
def test_kernel_stream_concatenates_to_the_whole_signal_in_float64(name, levels, block,
                                                                  boundary):
    span = mc.composite_halo_samples(vt.wavelet(name).filter_length, levels)
    x = np.random.default_rng(6).standard_normal((2, 3000))
    if boundary == "symmetric":
        # the first block covers the span; later blocks may be any length
        first = max(block, span)
        state, outs = _stream_port(x[..., :first], name, levels, boundary, first)
        state, rest = _stream_port(x, name, levels, boundary, block, state, first)
        outs += rest
    else:
        _, outs = _stream_port(x, name, levels, boundary, block)
    whole = vt.modwt_multilevel(torch.from_numpy(x), name, levels=levels,
                                boundary=boundary, backend="torch")
    assert _maxdiff(_planes(outs, levels), [_np(p) for p in (*whole.details,
                                                             whole.approx)]) <= 1e-12


def test_symmetric_first_block_gate_on_both_sides():
    span = mc.composite_halo_samples(8, 4)  # 105
    x = np.random.default_rng(7).standard_normal((1, 2 * span))
    state = st.kernel_streaming_init("db4", 4, batch_shape=(1,), dtype=torch.float64,
                                     device="cpu")
    with pytest.raises(InvalidArgumentError, match="first block"):
        st.modwt_stream_block_kernel(state, torch.from_numpy(x[:, :span - 1]), "db4",
                                     levels=4, boundary="symmetric")
    state, a = st.modwt_stream_block_kernel(state, torch.from_numpy(x[:, :span]), "db4",
                                            levels=4, boundary="symmetric")
    state, b = st.modwt_stream_block_kernel(state, torch.from_numpy(x[:, span:span + 7]),
                                            "db4", levels=4, boundary="symmetric")
    whole = vt.modwt_multilevel(torch.from_numpy(x[:, :span + 7]), "db4", levels=4,
                                boundary="symmetric", backend="torch")
    got = torch.cat([a.approx, b.approx], -1)
    assert float((got - whole.approx).abs().max()) <= 1e-12


def test_kernel_stream_periodic_is_per_block_and_stateless():
    x = _signal((1, 1024), seed=8)
    state = st.kernel_streaming_init("db4", 2, batch_shape=(1,), device="cpu")
    new, res = st.modwt_stream_block_kernel(state, torch.from_numpy(x), "db4", levels=2,
                                            boundary="periodic", backend="kernel")
    assert new.history is state.history and new.blocks_processed == 1
    whole = vw.modwt_multilevel(jnp.asarray(x), "db4", levels=2, boundary="periodic",
                                backend="jnp")
    assert _maxdiff([_np(res.approx)], [whole.approx]) <= TOL_KERNEL


def test_kernel_stream_backends_agree_and_bfloat16_casts_the_halo():
    x = _signal((2, 2048), seed=9)
    _, a = _stream_port(x, "db4", 3, "zero", 512, backend="kernel")
    _, b = _stream_port(x, "db4", 3, "zero", 512, backend="torch")
    _, c = _stream_port(x, "db4", 3, "zero", 512, backend="auto")
    assert _planes(a, 3)[0].tolist() == _planes(b, 3)[0].tolist() == _planes(c, 3)[0].tolist()
    state = st.kernel_streaming_init("db4", 3, batch_shape=(2,), device="cpu")
    blk = torch.from_numpy(x[:, :512]).to(torch.bfloat16)
    state, res = st.modwt_stream_block_kernel(state, blk, "db4", levels=3)
    assert res.approx.dtype == torch.bfloat16 and state.history.dtype == torch.float32


def test_kernel_gates_on_both_sides():
    """The port's stream kernels serve any N whose window fits shared
    memory; the sizes that do not, per kernel."""
    assert mc.analysis_tile(38, 9) is not None and mc.analysis_tile(38, 10) is None
    assert mc.denoise_tile(8, 6) is not None and mc.denoise_tile(40, 8) is None
    x = torch.zeros(1, 100)
    assert not st.stream.use_stream_kernel(x, None, True)  # a CPU tensor
    assert st.stream.use_stream_kernel(x, "kernel", False)
    assert not st.stream.use_stream_kernel(x, "jnp", True)
    cpu = torch.device("cpu")
    assert st.stream.resolve_tier(None, cpu, torch.float32) == (False, "auto")
    assert st.stream.resolve_tier("pallas", cpu, torch.float64, False) == (True, "kernel")
    assert st.stream.resolve_tier("jnp", cpu, torch.float32) == (False, "auto")


def test_streaming_transform_kernel_backend_facade():
    x = _signal((2048,), seed=10)
    t = st.StreamingTransform("db4", levels=2, backend="pallas", device="cpu")
    assert t.backend == "kernel"
    outs = [t.process(x[s:s + 512]) for s in range(0, 2048, 512)]
    whole = vw.modwt_multilevel(jnp.asarray(x), "db4", levels=2, boundary="zero",
                                backend="jnp")
    assert _maxdiff([np.concatenate([_np(o.approx) for o in outs])],
                    [whole.approx]) <= TOL_KERNEL
    assert t.statistics["blocks_processed"] == 4
    assert st.suggest_flush_tail_length("db4", 2) == 14
    assert t.flush().approx.shape == (14,)
    sym = st.StreamingTransform("db4", levels=4, boundary="symmetric", backend="kernel",
                                device="cpu")
    assert sym.flush(10).approx.shape == (10,)  # padded to the span, cut back


# --- the kernel tier of the streaming denoiser ---------------------------------------


def test_kernel_denoiser_matches_jax_kernel_tier():
    rng = np.random.default_rng(11)
    st_j = jst.kernel_streaming_denoiser_init("db4", levels=3, batch_shape=(2,))
    st_p = st.kernel_streaming_denoiser_init("db4", levels=3, batch_shape=(2,),
                                             device="cpu")
    for _ in range(3):
        blk = rng.standard_normal((2, 2048)).astype(np.float32)
        st_j, out_j = jst.streaming_denoise_block_kernel(
            st_j, jnp.asarray(blk), "db4", levels=3, precision="float32", interpret=True)
        st_p, out_p = st.streaming_denoise_block_kernel(
            st_p, torch.from_numpy(blk), "db4", levels=3, backend="kernel")
        np.testing.assert_allclose(_np(st_p.noise_window),
                                   np.asarray(st_j.noise_window, np.float64), atol=1e-6)
        assert st_p.window_pos == int(st_j.window_pos)
        assert st_p.window_fill == int(st_j.window_fill)
        assert _maxdiff([_np(out_p)], [out_j]) <= TOL_TIER


@pytest.mark.parametrize("est,kw", [("mad", {}), ("std", {}), ("fixed", {"fixed_sigma": 0.5})])
@pytest.mark.parametrize("mode", ["soft", "hard"])
def test_kernel_denoiser_matches_the_plain_tier(est, kw, mode):
    """The kernel tier (on the CPU, its plain version) against the port's
    plain tier, zero boundary, as the JAX package holds its two tiers."""
    rng = np.random.default_rng(12)
    st_p = st.streaming_denoiser_init("sym4", levels=3, batch_shape=(2,), device="cpu")
    st_k = st.kernel_streaming_denoiser_init("sym4", levels=3, batch_shape=(2,),
                                             device="cpu")
    for n in (300, 1024, 40):  # a block shorter than the span (49) last
        blk = torch.from_numpy(rng.standard_normal((2, n)).astype(np.float32))
        st_p, out_p = st.streaming_denoise_block(st_p, blk, "sym4", threshold_mode=mode,
                                                 noise_estimation=est, **kw)
        st_k, out_k = st.streaming_denoise_block_kernel(
            st_k, blk, "sym4", levels=3, threshold_mode=mode, noise_estimation=est, **kw)
        assert torch.equal(st_p.noise_window, st_k.noise_window)
        assert float((out_p - out_k).abs().max()) <= 5e-5


@pytest.mark.parametrize("est,kw", [("mad", {}), ("std", {}), ("fixed", {"fixed_sigma": 0.7})])
def test_multiblock_matches_sequential_bit_for_bit(est, kw):
    rng = np.random.default_rng(13)
    k, b, nb, lev = 5, 3, 1024, 4
    blocks = torch.from_numpy(rng.standard_normal((k, b, nb)).astype(np.float32))
    st0 = st.kernel_streaming_denoiser_init("db4", levels=lev, batch_shape=(b,),
                                            device="cpu")
    st_s, outs = st0, []
    for i in range(k):
        st_s, o = st.streaming_denoise_block_kernel(st_s, blocks[i], "db4", levels=lev,
                                                    noise_estimation=est, **kw)
        outs.append(o)
    st_m, out_m = st.streaming_denoise_blocks_kernel(st0, blocks, "db4", levels=lev,
                                                     noise_estimation=est, **kw)
    assert torch.equal(torch.stack(outs), out_m)
    assert torch.equal(st_s.history, st_m.history)
    assert torch.equal(st_s.noise_window, st_m.noise_window)
    assert (st_s.window_pos, st_s.window_fill) == (st_m.window_pos, st_m.window_fill)


def test_multiblock_short_blocks_and_two_calls():
    rng = np.random.default_rng(14)
    blocks = torch.from_numpy(rng.standard_normal((3, 2, 256)).astype(np.float32))
    st0 = st.kernel_streaming_denoiser_init("db4", levels=6, batch_shape=(2,),
                                            device="cpu")
    assert st0.history.shape[-1] > 256  # genuinely short: the sequential steps
    st_s, outs = st0, []
    for i in range(3):
        st_s, o = st.streaming_denoise_block_kernel(st_s, blocks[i], "db4", levels=6)
        outs.append(o)
    st_m, out_m = st.streaming_denoise_blocks_kernel(st0, blocks, "db4", levels=6)
    assert torch.equal(torch.stack(outs), out_m)
    assert torch.equal(st_s.history, st_m.history)
    blocks = torch.from_numpy(rng.standard_normal((6, 2, 1024)).astype(np.float32))
    st0 = st.kernel_streaming_denoiser_init("sym4", levels=3, batch_shape=(2,),
                                            device="cpu")
    st_a, out_a = st.streaming_denoise_blocks_kernel(st0, blocks[:3], "sym4", levels=3)
    st_a, out_b = st.streaming_denoise_blocks_kernel(st_a, blocks[3:], "sym4", levels=3)
    st_c, out_c = st.streaming_denoise_blocks_kernel(st0, blocks, "sym4", levels=3)
    assert torch.equal(torch.cat([out_a, out_b]), out_c)
    assert torch.equal(st_a.history, st_c.history)


def test_jax_kernel_state_resumes_in_the_port():
    """A stream checkpointed in JAX after two blocks continues in the port to
    the outputs the JAX stream gives (both kernel tiers), and to the whole
    signal."""
    x = _signal((2, 4096), seed=15)
    st_j, outs_j = _stream_jax(x, "db4", 3, "zero", 1024)
    mid_j, _ = _stream_jax(x[..., :2048], "db4", 3, "zero", 1024)
    state = convert.kernel_streaming_state_from_arrays(
        np.asarray(mid_j.history), np.asarray(mid_j.blocks_processed), device="cpu")
    assert state.blocks_processed == 2
    _, rest = _stream_port(x, "db4", 3, "zero", 1024, state, 2048)
    assert _maxdiff(_planes(rest, 3), _planes(outs_j[2:], 3)) <= TOL_TIER

    d_j = jst.kernel_streaming_denoiser_init("db4", levels=3, batch_shape=(2,))
    blocks = _signal((3, 2, 2048), seed=16)
    for i in range(2):
        d_j, _ = jst.streaming_denoise_block_kernel(d_j, jnp.asarray(blocks[i]), "db4",
                                                    levels=3, precision="float32",
                                                    interpret=True)
    d_p = convert.kernel_streaming_denoiser_state_from_arrays(
        *(np.asarray(a) for a in d_j), device="cpu")
    d_j, want = jst.streaming_denoise_block_kernel(d_j, jnp.asarray(blocks[2]), "db4",
                                                   levels=3, precision="float32",
                                                   interpret=True)
    d_p, got = st.streaming_denoise_block_kernel(d_p, torch.from_numpy(blocks[2]), "db4",
                                                 levels=3)
    assert _maxdiff([_np(got)], [want]) <= TOL_TIER
    assert (d_p.window_pos, d_p.window_fill) == (int(d_j.window_pos), int(d_j.window_fill))


def test_denoiser_class_kernel_backend_and_its_gates():
    rng = np.random.default_rng(17)
    n, blk = 2048, 512
    clean = np.sin(np.linspace(0, 16 * np.pi, n))
    noisy = (clean + 0.4 * rng.standard_normal(n)).astype(np.float32)
    den = st.StreamingDenoiser("db4", implementation="quality", backend="pallas",
                               device="cpu")
    assert den.backend == "kernel"
    assert isinstance(den.state, st.KernelStreamingDenoiserState)
    out = np.concatenate([_np(den.denoise(noisy[s:s + blk])) for s in range(0, n, blk)])
    assert np.mean((out[blk:] - clean[blk:]) ** 2) < np.mean((noisy[blk:] - clean[blk:]) ** 2)
    assert den.statistics["blocks_processed"] == n // blk
    den.reset()
    assert isinstance(den.state, st.KernelStreamingDenoiserState)
    with pytest.raises(InvalidArgumentError, match="zero boundary"):
        st.StreamingDenoiser("db4", backend="kernel", boundary="symmetric", device="cpu")
    with pytest.raises(InvalidArgumentError, match="zero boundary"):
        st.StreamingDenoiser("db4", backend="kernel", dtype=torch.float64, device="cpu")
    with pytest.raises(InvalidConfigurationError, match="backend"):
        st.StreamingDenoiser("db4", backend="rust", device="cpu")
    auto = st.StreamingDenoiser("db4", device="cpu")
    assert auto.backend == "torch"  # auto on the CPU: the plain tier
