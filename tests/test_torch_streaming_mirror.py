"""Test mirrors of the JAX package's streaming tests, on the port.

Mirrors ``tests/test_streaming.py``, ``tests/test_streaming_denoise_kernel.py``
and ``tests/test_sliding.py`` test by test, under the JAX tests' names, at
their shapes and seeds (blocks of 64-256 samples, where the carry crosses a
block boundary at every level).  ``tests/test_native_ingest.py`` is mirrored
whole by ``tests/test_torch_native.py``; the audit of all four files is in
CHANGES.md.

Most of these JAX tests state a property of the package against itself
(blocks against the whole signal, the kernel tier against the jnp tier,
windows against the direct transform).  Here the port is held to the same
property against its own whole-signal, plain-tier or direct path, which the
earlier parity tests (``test_torch_streaming.py``,
``test_torch_streaming_kernel.py``) hold to JAX; each family is anchored to
the JAX package once more, at a named draw of its mirror, through a
module-scoped fixture (``ANCHOR_*``).  The JAX side runs its jnp path, never
a Pallas kernel.  Tolerances, with their reasons:

* float64 block streams (both tiers) against the whole signal: 1e-12 (the
  same à trous sums, in another order at most);
* the streaming denoiser's kernel tier against its plain tier, float32:
  noise windows bit for bit (both tiers sample the same level-1 details),
  outputs within 5e-5, the JAX tests' bound (1e-4 in the family sweep);
* float32 windows against the direct float32 transform: 1e-6, as in JAX.

The phase 2d cases of these files (``tools/mirror_cases.tier_cases``) run
here on CPU tensors (``mirror_cases.cpu_problems``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from tools import mirror_cases
from vectorwave_tpu import streaming as jst
from vectorwave_tpu_torch import streaming as st
from vectorwave_tpu_torch.errors import InvalidArgumentError

from .conftest import composite_sin

torch.set_num_threads(1)

TOL = 1e-12
TOL_TIERS = 5e-5
F64 = torch.float64
CPU = "cpu"
TIERS = ("plain", "kernel")


def _np(a) -> np.ndarray:
    return a.detach().double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert float(np.max(np.abs(got - want), initial=0.0)) <= tol


def _planes(res) -> list:
    return [*res.details, res.approx]


def _joined(results) -> list:
    return [torch.cat(ps, dim=-1) for ps in zip(*(_planes(r) for r in results))]


def _stream(x, name, levels, boundary, block, tier, dtype=F64):
    """The blocks of ``x`` through one tier's steps (the plain per-level
    histories, or the kernel tier's raw-input carry, on the CPU its plain
    version); returns the block results and the final state."""
    x = torch.as_tensor(x, dtype=dtype)
    batch = tuple(x.shape[:-1])
    if tier == "plain":
        state = st.streaming_init(name, levels, batch_shape=batch, dtype=dtype, device=CPU)
    else:
        state = st.kernel_streaming_init(name, levels, batch_shape=batch, dtype=dtype,
                                         device=CPU)
    outs = []
    for s in range(0, x.shape[-1], block):
        blk = x[..., s:s + block]
        if tier == "plain":
            state, res = st.modwt_stream_block(state, blk, name, boundary=boundary)
        else:
            state, res = st.modwt_stream_block_kernel(state, blk, name, levels=levels,
                                                      boundary=boundary)
        outs.append(res)
    return outs, state


def _whole(x, name, levels, boundary):
    return _planes(vt.modwt_multilevel(torch.as_tensor(x, dtype=F64), name, levels=levels,
                                       boundary=boundary, backend="torch"))


# --- the anchors: each family against the JAX package once ---------------------------


@pytest.fixture(scope="module")
def anchor_stream():
    """JAX's plain block stream at test_streaming_matches_whole_signal_zero_boundary's
    db4 J=3 draw in blocks of 256 (ANCHOR_STREAM)."""
    x = composite_sin(512, noise_std=0.3)
    state = jst.streaming_init("db4", 3, dtype=jnp.float64)
    outs = []
    for s in range(0, 512, 256):
        state, res = jst.modwt_stream_block(state, jnp.asarray(x[s:s + 256]), "db4",
                                            boundary="zero")
        outs.append(res)
    return x, [np.concatenate([np.asarray(p) for p in ps], -1)
               for ps in zip(*([*o.details, o.approx] for o in outs))]


def test_anchor_block_stream_matches_jax(anchor_stream):
    x, want = anchor_stream
    for got in (_whole(x, "db4", 3, "zero"),
                _joined(_stream(x, "db4", 3, "zero", 256, "kernel")[0])):
        for g, w in zip(got, want):
            _close(g, w)


@pytest.fixture(scope="module")
def anchor_denoiser():
    """JAX's jnp streaming denoiser at test_kernel_streaming_denoiser_matches_jnp's
    third draw (db4 J=2, 2 x 512, three blocks; float64) (ANCHOR_DENOISER)."""
    rng = np.random.default_rng(0)
    blocks = [rng.standard_normal((2, 512)) for _ in range(3)]
    state = jst.streaming_denoiser_init("db4", levels=2, batch_shape=(2,), dtype=jnp.float64)
    outs = []
    for blk in blocks:
        state, out = jst.streaming_denoise_block(state, jnp.asarray(blk), "db4",
                                                 boundary="zero")
        outs.append(np.asarray(out))
    return blocks, outs, np.asarray(state.noise_window)


def test_anchor_plain_denoiser_matches_jax(anchor_denoiser):
    blocks, want, window = anchor_denoiser
    state = st.streaming_denoiser_init("db4", levels=2, batch_shape=(2,), dtype=F64,
                                       device=CPU)
    for blk, w in zip(blocks, want):
        state, out = st.streaming_denoise_block(state, torch.from_numpy(blk), "db4")
        _close(out, w)
    _close(state.noise_window, window)


@pytest.fixture(scope="module")
def anchor_sliding():
    """JAX's sliding windows at test_multilevel_window_and_flush's draw
    (db4 J=3, buffer 256, symmetric; float64) (ANCHOR_SLIDING)."""
    stream = composite_sin(400, seed=5)
    t = jst.SlidingStreamingTransform("db4", buffer_size=256, levels=3, boundary="symmetric",
                                      dtype=jnp.float64)
    results = t.process(stream) + [t.flush()]
    return stream, [[np.asarray(p) for p in [*r.details, r.approx]] for r in results]


def test_anchor_sliding_windows_match_jax(anchor_sliding):
    stream, want = anchor_sliding
    t = st.SlidingStreamingTransform("db4", buffer_size=256, levels=3, boundary="symmetric",
                                     dtype=F64, device=CPU)
    got = t.process(stream) + [t.flush()]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for a, b in zip(_planes(g), w):
            _close(a, b)


# --- tests/test_streaming.py -----------------------------------------------------------


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("block_size", [64, 100, 256])
@pytest.mark.parametrize("name,levels", [("haar", 3), ("db4", 3), ("sym8", 2)])
def test_streaming_matches_whole_signal_zero_boundary(name, levels, block_size, tier):
    x = composite_sin(512, noise_std=0.3)
    outs, state = _stream(x, name, levels, "zero", block_size, tier)
    for g, w in zip(_joined(outs), _whole(x, name, levels, "zero")):
        _close(g, w)
    assert state.blocks_processed == -(-512 // block_size)


@pytest.mark.parametrize("tier", TIERS)
def test_streaming_symmetric_matches_whole_signal_interior(tier):
    """Every plane, the head included: the first block's mirror gives the
    whole-signal symmetric transform's left edge."""
    x = composite_sin(512, noise_std=0.2)
    outs, _ = _stream(x, "db4", 3, "symmetric", 128, tier)
    for g, w in zip(_joined(outs), _whole(x, "db4", 3, "symmetric")):
        _close(g, w)


@pytest.mark.parametrize("tier", TIERS)
def test_streaming_periodic_is_per_block(tier):
    x = composite_sin(256)
    outs, state = _stream(x, "db4", 2, "periodic", 128, tier)
    for i, res in enumerate(outs):
        for g, w in zip(_planes(res), _whole(x[i * 128:(i + 1) * 128], "db4", 2, "periodic")):
            _close(g, w)
    assert state.blocks_processed == 2


@pytest.mark.parametrize("tier", TIERS)
def test_flush_drains_history(tier):
    """The flush (a zero tail of (L-1)(2^(J-1)) = 14 samples for db4 J=2)
    equals the whole-signal transform's last 14 samples of [x | 0]."""
    levels = 2
    tail = st.suggest_flush_tail_length("db4", levels)
    assert tail == 7 * 2
    x = composite_sin(128)
    outs, state = _stream(x, "db4", levels, "zero", 128, tier)
    if tier == "plain":
        _, res = st.modwt_stream_flush(state, "db4")
    else:
        _, res = st.modwt_stream_block_kernel(state, torch.zeros(tail, dtype=F64), "db4",
                                              levels=levels)
    assert res.approx.shape[-1] == tail and float(res.approx.abs().max()) > 0
    whole = _whole(np.concatenate([x, np.zeros(tail)]), "db4", levels, "zero")
    for g, w in zip(_planes(res), whole):
        _close(g, w[..., -tail:])


@pytest.mark.parametrize("tier", TIERS)
def test_streaming_batched(tier):
    """A batch of three streams: the shape, and each row as its own stream."""
    batch = np.stack([composite_sin(256, seed=s, noise_std=0.1) for s in range(3)])
    outs, _ = _stream(batch[:, :128], "db4", 2, "zero", 128, tier)
    assert outs[0].approx.shape == (3, 128)
    for row in range(3):
        alone, _ = _stream(batch[row, :128], "db4", 2, "zero", 128, tier)
        for g, w in zip(_planes(outs[0]), _planes(alone[0])):
            _close(g[row], w)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_streaming_denoiser_reduces_noise(backend):
    """Both tiers of the class (the plain one in float64, as the JAX test;
    the kernel tier in float32, its only dtype)."""
    rng = np.random.default_rng(0)
    n = 2048
    clean = composite_sin(n)
    noisy = clean + rng.normal(0, 1.0, n)
    dtype = F64 if backend == "torch" else torch.float32
    den = st.StreamingDenoiser("db4", implementation="quality", dtype=dtype, backend=backend,
                               device=CPU)
    assert den.backend == backend
    out = np.concatenate([_np(den.denoise(noisy[s:s + 256])) for s in range(0, n, 256)])
    sl = slice(512, n)  # past the warm-up blocks, where the noise window fills
    assert np.mean((out[sl] - clean[sl]) ** 2) < np.mean((noisy[sl] - clean[sl]) ** 2)
    assert den.statistics == {"samples_processed": n, "blocks_processed": 8}
    den.reset()
    assert den.statistics["blocks_processed"] == 0


@pytest.mark.parametrize("tier", TIERS)
def test_streaming_denoiser_fixed_sigma(tier):
    if tier == "plain":
        state = st.streaming_denoiser_init("haar", levels=1, dtype=F64, device=CPU)
        step, kw = st.streaming_denoise_block, {}
    else:
        state = st.kernel_streaming_denoiser_init("haar", levels=1, device=CPU)
        step, kw = st.streaming_denoise_block_kernel, {"levels": 1}
    dtype = F64 if tier == "plain" else torch.float32
    x = torch.as_tensor(composite_sin(128, noise_std=0.5), dtype=dtype)
    state, out = step(state, x, "haar", noise_estimation="fixed", fixed_sigma=0.5, **kw)
    assert out.shape == x.shape and out.dtype == dtype
    with pytest.raises(InvalidArgumentError):
        step(state, x, "haar", noise_estimation="fixed", **kw)
    with pytest.raises(InvalidArgumentError):
        step(state, x, "haar", noise_estimation="bogus", **kw)


def test_streaming_transform_class():
    """The class on the kernel tier (float64 on the CPU: the kernel's plain
    version); the plain tier's class is ``test_torch_streaming.py``'s."""
    x = composite_sin(512, noise_std=0.2)
    t = st.StreamingTransform("db4", levels=3, dtype=F64, backend="kernel", device=CPU)
    assert t.backend == "kernel"
    outs = [t.process(x[i:i + 128]) for i in range(0, 512, 128)]
    _close(_joined(outs)[0], _whole(x, "db4", 3, "zero")[0])
    assert t.statistics == {"samples_processed": 512, "blocks_processed": 4}
    tail = t.flush()
    assert tail.approx.shape[-1] == st.suggest_flush_tail_length("db4", 3) > 0
    t.reset()
    assert t.statistics["blocks_processed"] == 0


def test_streaming_denoiser_state_restore_validates_backend():
    """A checkpoint of one tier's layout does not restore onto an instance
    of the other, with JAX's error code; the same layout restores."""
    ref = jst.StreamingDenoiser("db4", backend="jnp")
    with pytest.raises(vw.InvalidArgumentError, match="resolved backend") as want:
        ref.state = jst.kernel_streaming_denoiser_init(ref.wavelet, levels=ref.levels)
    for backend in ("torch", "kernel"):
        d = st.StreamingDenoiser("db4", backend=backend, device=CPU)
        assert d.backend == backend
        good = d.state
        init = (st.kernel_streaming_denoiser_init if backend == "torch"
                else st.streaming_denoiser_init)
        with pytest.raises(InvalidArgumentError, match="resolved backend") as got:
            d.state = init(d.wavelet, levels=d.levels, device=CPU)
        assert got.value.code.value == want.value.code.value
        d.state = good
        d.denoise(np.zeros(256, np.float32))


# --- tests/test_streaming_denoise_kernel.py ---------------------------------------------


def _tiers_agree(name, levels, blocks, tol=TOL_TIERS, **kw):
    """The kernel tier (on the CPU, its plain version) against the plain
    tier, zero boundary, block by block: the noise windows bit for bit, the
    outputs within ``tol``."""
    batch = tuple(blocks[0].shape[:-1])
    st_p = st.streaming_denoiser_init(name, levels=levels, batch_shape=batch, device=CPU)
    st_k = st.kernel_streaming_denoiser_init(name, levels=levels, batch_shape=batch,
                                             device=CPU)
    for blk in blocks:
        blk = torch.as_tensor(blk, dtype=torch.float32)
        st_p, out_p = st.streaming_denoise_block(st_p, blk, name, boundary="zero", **kw)
        st_k, out_k = st.streaming_denoise_block_kernel(st_k, blk, name, levels=levels, **kw)
        assert torch.equal(st_p.noise_window, st_k.noise_window)
        assert (st_p.window_pos, st_p.window_fill) == (st_k.window_pos, st_k.window_fill)
        _close(out_k, out_p, tol)


@pytest.mark.parametrize("batch,nblk,levels,mode", [
    ((3,), 2048, 4, "soft"),
    ((), 1024, 3, "hard"),
    ((2,), 512, 2, "soft"),
])
def test_kernel_streaming_denoiser_matches_jnp(batch, nblk, levels, mode):
    rng = np.random.default_rng(0)
    blocks = [rng.standard_normal(batch + (nblk,)) for _ in range(3)]
    _tiers_agree("db4", levels, blocks, threshold_mode=mode)


def test_kernel_streaming_denoiser_fallback_shape():
    """Blocks of 200 samples: the JAX kernel step falls back to jnp there;
    the port's stream kernel serves any N whose window fits (ROADMAP,
    differences by design).  Same state layout, same results."""
    rng = np.random.default_rng(1)
    _tiers_agree("db4", 2, [rng.standard_normal(200) for _ in range(2)])


@pytest.mark.parametrize("est,kw", [("std", {}), ("fixed", {"fixed_sigma": 0.5})])
def test_kernel_streaming_denoiser_estimators(est, kw):
    rng = np.random.default_rng(2)
    _tiers_agree("sym4", 3, [rng.standard_normal((2, 1024))], noise_estimation=est, **kw)


@pytest.mark.slow
@pytest.mark.parametrize("name,levels,nblk", [("sym8", 5, 4096), ("coif3", 3, 1536),
                                              ("db2", 6, 8192)])
def test_kernel_streaming_denoiser_family_sweep(name, levels, nblk):
    rng = np.random.default_rng(7)
    _tiers_agree(name, levels, [rng.standard_normal((2, nblk)) for _ in range(4)], tol=1e-4)


def test_kernel_streaming_denoiser_scan_compatible():
    """The port does not trace, so the JAX test's ``lax.scan`` has no
    counterpart; the serving pattern it stands for (one program over all
    blocks) is ``streaming_denoise_blocks_kernel``: the four blocks in one
    call equal the Python loop of steps, bit for bit (JAX: 1e-5)."""
    rng = np.random.default_rng(11)
    blocks = torch.from_numpy(rng.standard_normal((4, 2, 1024)).astype(np.float32))
    st0 = st.kernel_streaming_denoiser_init("db4", levels=3, batch_shape=(2,), device=CPU)
    state, outs = st0, []
    for i in range(4):
        state, o = st.streaming_denoise_block_kernel(state, blocks[i], "db4", levels=3)
        outs.append(o)
    st_m, out_m = st.streaming_denoise_blocks_kernel(st0, blocks, "db4", levels=3)
    assert torch.equal(out_m, torch.stack(outs))
    assert torch.equal(st_m.noise_window, state.noise_window)
    assert torch.equal(st_m.history, state.history)


# --- tests/test_sliding.py ---------------------------------------------------------------


def test_emitted_windows_match_direct_transform():
    """float32, as the JAX test: each window against the direct transform of
    the last 128 stream samples."""
    buffer_size = 128
    t = st.SlidingStreamingTransform("db4", buffer_size=buffer_size, boundary="periodic",
                                     device=CPU)
    stream = composite_sin(1000, noise_std=0.2)
    results = t.process(stream)
    step = st.step_size(buffer_size, "db4")
    assert len(results) == 1 + (1000 - buffer_size) // step
    for i, res in enumerate(results):
        end = buffer_size + i * step
        window = torch.as_tensor(stream[end - buffer_size:end], dtype=torch.float32)
        direct = vt.modwt(window, "db4", boundary="periodic")
        _close(res.approx, direct.approx, 1e-6)
        _close(res.detail, direct.detail, 1e-6)


def test_multilevel_window_and_flush():
    t = st.SlidingStreamingTransform("db4", buffer_size=256, levels=3, boundary="symmetric",
                                     device=CPU)
    stream = composite_sin(400, seed=5)
    results = t.process(stream)
    assert len(results) >= 1 and results[-1].levels == 3
    direct = vt.modwt_multilevel(torch.as_tensor(stream[:256], dtype=torch.float32), "db4",
                                 levels=3, boundary="symmetric")
    for g, w in zip(_planes(results[0]), _planes(direct)):
        _close(g, w, 1e-6)
    tail = t.flush()
    assert tail is not None and tail.levels == 3
    stats = t.statistics
    assert stats["samples_processed"] == 400
    assert stats["windows_emitted"] == len(results) + 1
    t.reset()
    assert t.statistics["windows_emitted"] == 0
    assert t.process(stream[:10]) == []


# --- phase 2d's cases on the CPU -------------------------------------------------------


@pytest.mark.parametrize("label", mirror_cases.tier_labels("streaming"))
def test_tier_case_runs_its_plain_versions_on_the_cpu(label):
    """Each streaming case phase 2d runs on the card, here on CPU tensors:
    within its bounds of the plain route, no launch, no refusal."""
    assert not mirror_cases.cpu_problems(label)
