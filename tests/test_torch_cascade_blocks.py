"""The cascade pair's CUDA kernels (``csrc/modwt_analysis.cu``,
``csrc/modwt_synthesis.cu``) walked in numpy, thread by thread, and the
routers' gates that send shapes to them.

The kernels cannot run here, so their index arithmetic is replayed as it
stands in the sources: every block's window, every level's chunks and
passes, every thread's ``run_base`` outputs, the samples its register runs
load (all of them, or with ``kGuard`` only those its outputs need, with the
taps zero-padded to whole steps of 8) and the analysis's per-warp detail
staging.  The walk asserts that no loaded sample lies outside the part of
the window that is exact at that level, that every output of a level is
written exactly once, and that its planes equal the plain cascade of
:mod:`vectorwave_tpu_torch.kernels.modwt_composite` (or the plain symmetric
cascade for the mirror edge) in float64 within 1e-12 (the same arithmetic
in another order).  The shapes reach each path of the kernels: J = 9 and
J = 10 (strides of kThreads and above), rows not a multiple of 4 long, a
periodic row shorter than the span, haar, a long filter, ragged last tiles,
halos shorter than the span, and tiles from 128 to the row (the library
clamps its preferred tile to the row and halves it until a block fits, so a
launch may take any of them).  The kernels' own tile and shared-memory
layout live in the library alone; tests on the card hold it to the gates.
"""

import numpy as np
import pytest
import torch

import vectorwave_tpu_torch as vt
from vectorwave_tpu_torch.kernels import modwt_composite as mc
from vectorwave_tpu_torch.kernels import modwt_symmetric as ms
from vectorwave_tpu_torch.kernels.modwt_fused import _kernel_filters

torch.set_num_threads(1)

TOL = 1e-12
#: the kernels' kThreads, kRunBlock (outputs a thread) and kRunChunk (taps a
#: step, to whole steps of which the taps are zero-padded)
THREADS = 256
R = 9
CHUNK = 8


def _filters(name):
    w = vt.wavelet(name)
    return _kernel_filters(w, synthesis=False), _kernel_filters(w, synthesis=True)


def _padded(f):
    out = np.zeros(-(-len(f) // CHUNK) * CHUNK)
    out[: len(f)] = f
    return out


def _tile(n, taps, levels, mirror=False):
    """The launch's tile at these shapes, where a block of the preferred
    tile fits: that tile clamped to the row, the mirror's at least its
    reach."""
    return max(min(mc.ANALYSIS_TILE, n), mc.mirror_reach(taps, levels) if mirror else 1)


def _thread_starts(c0, s):
    """q0 of every thread, one array a pass, for the chunk at c0: run_base
    for s <= kThreads, else s / kThreads passes of consecutive residues."""
    tid = np.arange(THREADS)
    if s <= THREADS:
        shift = s.bit_length() - 1
        return [c0 + (tid & (s - 1)) + ((tid >> shift) << shift) * R]
    return [c0 + p + tid for p in range(0, s, THREADS)]


def _edge_window(x, g, edge, halo):
    """x extended to the samples g (all < n) by the analysis edge rule."""
    n = x.shape[-1]
    if edge == "periodic":
        return x[:, g % n]
    out = np.zeros((x.shape[0], len(g)))
    inside = g >= 0
    out[:, inside] = x[:, g[inside]]
    before = ~inside
    if edge == "mirror":
        src = -1 - g[before]
        assert src.max(initial=0) < n  # the mirror's n >= reach
        out[:, before] = x[:, src]
    elif edge == "external":
        h = halo.shape[-1] + g[before]
        vals = np.zeros((x.shape[0], len(h)))
        vals[:, h >= 0] = halo[:, h[h >= 0]]
        out[:, before] = vals
    return out


def walk_analysis(x, filters, levels, tile, edge="periodic", halo=None):
    """The analysis kernel replayed block by block; returns the J+1 planes."""
    lo, hi = _padded(filters[0]), _padded(filters[1])
    taps, lp = len(filters[0]), len(lo)
    b, n = x.shape
    span = mc.composite_halo_samples(taps, levels)
    outs = [np.full((b, n), np.nan) for _ in range(levels + 1)]
    for t0 in range(0, n, tile):
        n_out = min(tile, n - t0)
        width = n_out + span
        before = max(span - t0, 0)
        cur = _edge_window(x, t0 - span + np.arange(width), edge, halo)
        valid = 0
        for j in range(1, levels + 1):
            s = 1 << (j - 1)
            if edge == "mirror" and j > 1 and before:
                q = np.arange(max(before - (taps - 1) * s, 0), before)
                assert (2 * before - 1 - q).max() < width
                cur[:, q] = cur[:, 2 * before - 1 - q]
            first = valid + (taps - 1) * s
            nxt = np.full((b, width), np.nan)
            written = np.zeros(width, int)
            for c0 in range(first, width, max(s, THREADS) * R):
                for q0 in _thread_starts(c0, s):
                    lim = np.where(q0 < width, np.minimum(R, (width - q0 + s - 1) // s), 0)
                    q0, lim = q0[lim > 0], lim[lim > 0]
                    if not len(q0):
                        continue
                    guard = (lim < R) | (lp != taps)
                    m = np.arange(1 - lp, R)
                    idx = q0[:, None] + s * m[None]
                    load = ~guard[:, None] | ((m >= 1 - taps) & (m < lim[:, None]))
                    assert idx[load].min() >= valid and idx[load].max() < width
                    w = np.where(load, cur[:, np.clip(idx, 0, width - 1)], 0.0)
                    for r in range(R):
                        v = w[:, :, r - np.arange(lp) + lp - 1]  # w[r - t]
                        a, d = v @ lo, v @ hi
                        on = r < lim
                        q = q0[on] + r * s
                        nxt[:, q] = a[:, on]
                        written[q] += 1
                        o = q - span
                        keep = o >= 0
                        outs[j - 1][:, t0 + o[keep]] = d[:, on][:, keep]
            assert (written[first:] == 1).all() and not written[:first].any()
            cur, valid = nxt, first
        outs[levels][:, t0 : t0 + n_out] = cur[:, span : span + n_out]
    return outs


def _plane_window(plane, g, periodic, halo):
    """A plane extended past its end (g >= 0) by the synthesis edge rule."""
    n = plane.shape[-1]
    out = np.zeros((plane.shape[0], len(g)))
    inside = g < n
    out[:, inside] = plane[:, g[inside]]
    past = ~inside
    if periodic:
        out[:, past] = plane[:, g[past] % n]
    elif halo is not None:
        h = g[past] - n
        vals = np.zeros((plane.shape[0], len(h)))
        vals[:, h < halo.shape[-1]] = halo[:, h[h < halo.shape[-1]]]
        out[:, past] = vals
    return out


def walk_synthesis(planes, filters, levels, tile, periodic, halo=None):
    """The synthesis kernel replayed block by block; returns the signal."""
    lo, hi = _padded(filters[0]), _padded(filters[1])
    taps, lp = len(filters[0]), len(lo)
    b, n = planes[0].shape
    span = mc.composite_halo_samples(taps, levels)
    out = np.full((b, n), np.nan)
    for t0 in range(0, n, tile):
        n_out = min(tile, n - t0)
        valid_end = n_out + span

        def window(i, count):
            return _plane_window(planes[i], t0 + np.arange(count), periodic,
                                 None if halo is None else halo[i])

        cur = window(levels, valid_end)
        for j in range(levels, 0, -1):
            s = 1 << (j - 1)
            det = window(j - 1, valid_end)
            new_end = valid_end - (taps - 1) * s
            nxt = np.full((b, valid_end), np.nan)
            written = np.zeros(valid_end, int)
            for c0 in range(0, new_end, max(s, THREADS) * R):
                for q0 in _thread_starts(c0, s):
                    q0 = q0[q0 < new_end]
                    if not len(q0):
                        continue
                    lim = np.minimum(R, (new_end - q0 + s - 1) // s)
                    guard = (lim < R) | (lp != taps)
                    m = np.arange(R + lp - 1)
                    idx = q0[:, None] + s * m[None]
                    load = ~guard[:, None] | (m < (lim + taps - 1)[:, None])
                    assert idx[load].max() < valid_end
                    safe = np.clip(idx, 0, valid_end - 1)
                    wc = np.where(load, cur[:, safe], 0.0)
                    wd = np.where(load, det[:, safe], 0.0)
                    for r in range(R):
                        acc = wc[:, :, r : r + lp] @ lo + wd[:, :, r : r + lp] @ hi
                        on = r < lim
                        q = q0[on] + r * s
                        nxt[:, q] = acc[:, on]
                        written[q] += 1
            assert (written[:new_end] == 1).all() and not written[new_end:].any()
            cur, valid_end = nxt, new_end
        out[:, t0 : t0 + n_out] = cur[:, :n_out]
    return out


def _x(b, n, seed):
    return np.random.default_rng(seed).standard_normal((b, n))


#: (wavelet, levels, batch, n, edge): ragged last tiles and rows not a
#: multiple of 4 long (5001, 9003), a periodic row shorter than the span
#: (db4 J=6 at 300, sym8 J=4 at 150), J=9 (stride 256 = kThreads) and J=10
#: (stride 512: two passes), haar (L=2, padded to a step of 8), a long filter
#: (db36, 9 steps), and the mirror at its tiles (db36 J=8: 9088 < span)
ANALYSIS_CASES = [
    ("db4", 6, 2, 5001, "periodic"), ("db4", 6, 2, 5001, "zero"),
    ("db4", 6, 2, 300, "periodic"), ("sym8", 4, 2, 150, "periodic"),
    ("db4", 6, 2, 1100, "mirror"), ("sym8", 4, 1, 4103, "mirror"),
    ("haar", 10, 1, 3001, "periodic"), ("db4", 9, 1, 5003, "zero"),
    ("db4", 10, 1, 9003, "periodic"), ("haar", 5, 2, 301, "mirror"),
    ("db36", 8, 1, 20000, "mirror"), ("db36", 3, 1, 2500, "periodic"),
]


@pytest.mark.parametrize("name,levels,b,n,edge", ANALYSIS_CASES)
def test_analysis_kernel_walk_reproduces_the_cascade(name, levels, b, n, edge):
    fd, _ = _filters(name)
    tile = _tile(n, len(fd[0]), levels, mirror=edge == "mirror")
    x = _x(b, n, 5)
    got = walk_analysis(x, fd, levels, tile, edge)
    xt = torch.from_numpy(x)
    want = (ms._symmetric_cascade(xt, fd, levels) if edge == "mirror"
            else mc.analysis_plain(xt, levels, fd, edge == "periodic"))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=TOL)


#: (wavelet, levels, batch, n, halo): the external edge with halos shorter
#: than, equal to and longer than the span, and a row shorter than the span
EXTERNAL_CASES = [("db4", 6, 2, 5001, 100), ("db4", 6, 2, 300, 441),
                  ("sym8", 4, 1, 3000, 700), ("db4", 10, 1, 2050, 1000)]


@pytest.mark.parametrize("name,levels,b,n,h", EXTERNAL_CASES)
def test_analysis_kernel_walk_external_edge(name, levels, b, n, h):
    fd, _ = _filters(name)
    x, halo = _x(b, n, 6), _x(b, h, 7)
    got = walk_analysis(x, fd, levels, _tile(n, len(fd[0]), levels), "external", halo)
    want = mc.analysis_plain(torch.from_numpy(x), levels, fd, False,
                             halo=torch.from_numpy(halo))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=TOL)


#: (wavelet, levels, batch, n, periodic, right halo or None)
SYNTHESIS_CASES = [
    ("db4", 6, 2, 5001, True, None), ("db4", 6, 2, 5001, False, None),
    ("db4", 6, 2, 300, True, None), ("sym8", 4, 2, 150, True, None),
    ("haar", 10, 1, 3001, True, None), ("db4", 9, 1, 5003, False, None),
    ("db4", 10, 1, 9003, True, None), ("db36", 3, 1, 2500, True, None),
    ("db4", 6, 2, 5001, False, 100), ("db4", 6, 1, 300, False, 441),
    ("sym8", 4, 1, 3000, False, 700),
]


@pytest.mark.parametrize("name,levels,b,n,periodic,h", SYNTHESIS_CASES)
def test_synthesis_kernel_walk_reproduces_the_cascade(name, levels, b, n, periodic, h):
    _, fr = _filters(name)
    taps = len(fr[0])
    planes = [_x(b, n, 10 + i) for i in range(levels + 1)]
    halo = None if h is None else [_x(b, h, 30 + i) for i in range(levels + 1)]
    got = walk_synthesis(planes, fr, levels, _tile(n, taps, levels), periodic, halo)
    want = mc.synthesis_plain([torch.from_numpy(p) for p in planes], levels, fr, periodic,
                              None if halo is None else [torch.from_numpy(p) for p in halo])
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=TOL)


@pytest.mark.parametrize("tile", [128, 441, 1000, 2048, 4096])
def test_the_walks_hold_at_every_tile_a_launch_may_take(tile):
    """db4 J=6 on rows of 5001 at tiles the library may pick: halvings of
    the preferred tile, a tile of the span and one clamped to a short row;
    the analysis in the zero edge, the synthesis in the periodic one."""
    fd, fr = _filters("db4")
    x = _x(2, 5001, 8)
    got = walk_analysis(x, fd, 6, tile, "zero")
    want = mc.analysis_plain(torch.from_numpy(x), 6, fd, False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=TOL)
    planes = [w.numpy() for w in want]
    got = walk_synthesis(planes, fr, 6, tile, True)
    want = mc.synthesis_plain(list(want), 6, fr, True)
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=TOL)


@pytest.mark.parametrize("s", [1, 2, 4])
def test_staged_details_fill_each_warps_buffer_once(s):
    """At strides below 8 a warp's lanes write their 9 outputs each into
    its buffer at q0 - cw0 + r s: the 32 x 9 slots once each, and the
    buffer is read back as 9 rows of 32 consecutive outputs."""
    q0 = _thread_starts(0, s)[0]
    for warp in range(THREADS // 32):
        lanes = q0[32 * warp : 32 * (warp + 1)]
        slots = (lanes[:, None] - 32 * warp * R + s * np.arange(R)[None]).ravel()
        assert sorted(slots) == list(range(32 * R))
        # the lanes of one store land on 32 banks
        for r in range(R):
            assert len(set((lanes - 32 * warp * R + r * s) % 32)) == 32


@pytest.mark.parametrize("s", [1 << k for k in range(10)])
def test_every_stride_covers_each_chunk_once(s):
    """A chunk of max(s, kThreads) x 9 outputs: each once, over its passes."""
    starts = np.concatenate(_thread_starts(0, s))
    outs = (starts[:, None] + s * np.arange(R)[None]).ravel()
    assert sorted(outs) == list(range(max(s, THREADS) * R))


# --- the routers' gates ------------------------------------------------------------


def _old_analysis_bytes(taps, levels, tile):
    """The gates' rule since the kernels' first design: taps and two
    (analysis) or three (synthesis) rows of tile + span."""
    return 4 * (2 * taps + 2 * (tile + mc.composite_halo_samples(taps, levels)))


def _old_synthesis_bytes(taps, levels, tile):
    return 4 * (2 * taps + 3 * (tile + mc.composite_halo_samples(taps, levels)))


def _old_tile(bytes_fn, taps, levels, preferred=2048):
    tile = preferred
    while tile >= 128:
        if bytes_fn(taps, levels, tile) <= mc.SHARED_LIMIT:
            return tile
        tile //= 2
    return None


@pytest.mark.parametrize("levels", range(1, 11))
def test_the_gates_send_the_kernels_every_shape_they_sent_before(levels):
    """For every filter length 1-128 the analysis tile, the mirror's and the
    synthesis tile are the first design's rules halving from the preferred
    tile, so each exists where it did at 2048, and kernels_fit is the first
    design's pair rule at 2048: the analysis and the synthesis, without the
    denoise kernel's room (the denoise routes ask for theirs)."""
    for taps in range(1, 129):
        old_a = _old_tile(_old_analysis_bytes, taps, levels, mc.ANALYSIS_TILE)
        assert mc.analysis_tile(taps, levels) == old_a
        assert (old_a is None) == (_old_tile(_old_analysis_bytes, taps, levels) is None)
        reach = mc.mirror_reach(taps, levels)
        mirror = max(old_a or 0, reach)
        old_m = mirror if _old_analysis_bytes(taps, levels, mirror) <= mc.SHARED_LIMIT else None
        assert mc.analysis_tile(taps, levels, mirror=True) == old_m
        before = max(_old_tile(_old_analysis_bytes, taps, levels) or 0, reach)
        assert (old_m is None) == (_old_analysis_bytes(taps, levels, before) > mc.SHARED_LIMIT)
        old_s = _old_tile(_old_synthesis_bytes, taps, levels, mc.SYNTHESIS_TILE)
        assert mc._fitting_tile(lambda t: mc.synthesis_shared_bytes(taps, levels, t),
                                mc.SYNTHESIS_TILE) == old_s
        assert (old_s is None) == (_old_tile(_old_synthesis_bytes, taps, levels) is None)
        old_fit = max(_old_analysis_bytes(taps, levels, 2048),
                      _old_synthesis_bytes(taps, levels, 2048)) <= mc.SHARED_LIMIT
        assert mc.kernels_fit(taps, levels) == old_fit


@pytest.mark.parametrize("name,levels,fit,mirror_tile", [
    ("db4", 6, True, 4096), ("sym8", 4, True, 4096), ("db36", 8, False, 9088),
    ("haar", 10, True, 4096), ("db4", 10, True, 4096)])
def test_the_main_path_shapes_reach_the_kernels(name, levels, fit, mirror_tile):
    """db4 J=6 (config #2), sym8 J=4, db36 J=8 (mirror tile 9088 < span),
    haar and db4 at J=10 (db4's default depth at N >= 3585): the streaming
    tier's gate (the analysis tile) and the symmetric route's (the mirror
    tile and the synthesis) send them all; multilevel's and the tiled
    tier's (kernels_fit, the cascade pair at a tile of 2048) all but db36
    J=8, whose synthesis needs a smaller tile."""
    taps = vt.wavelet(name).filter_length
    assert mc.kernels_fit(taps, levels) == fit
    assert mc.analysis_tile(taps, levels) == mc.ANALYSIS_TILE
    assert mc.analysis_tile(taps, levels, mirror=True) == mirror_tile
    assert ms.analysis_fits(taps, levels)


@pytest.mark.parametrize("taps,levels,analysis,synthesis", [
    (8, 6, True, True), (16, 4, True, True), (72, 8, True, True), (56, 9, True, False),
    (40, 9, True, False), (76, 9, False, False), (76, 10, False, False)])
def test_routing_gates_on_both_sides(taps, levels, analysis, synthesis):
    """multilevel and the tiled tier read kernels_fit, streaming the
    analysis tile, the symmetric route both tiles: db36 J=8 (span 18105)
    fits both kernels, db28 J=9 (28105, at a tile of 512) and db20 J=9
    (19929) the analysis alone, db38 J=9 neither."""
    assert (mc.analysis_tile(taps, levels) is not None) == analysis
    assert (mc._fitting_tile(lambda t: mc.synthesis_shared_bytes(taps, levels, t),
                             mc.SYNTHESIS_TILE) is not None) == synthesis
    assert ms.analysis_fits(taps, levels) == (analysis and synthesis
                                              and mc.analysis_tile(taps, levels, True)
                                              is not None)
    if analysis and not synthesis:
        assert not mc.kernels_fit(taps, levels)
    if taps == 56:
        assert mc.analysis_tile(taps, levels) == 512


@pytest.mark.parametrize("name,levels,n,kernel", [
    ("db4", 10, 65536, True), ("sym8", 9, 65536, True), ("sym8", 10, 65536, True),
    ("db4", 10, 8192, True), ("db28", 9, 65536, False), ("db38", 9, 65536, False),
    ("db38", 10, 131072, False), ("db4", 10, 4095, False), ("db4", 6, 4095, False)])
def test_default_depth_gate_on_both_sides(monkeypatch, name, levels, n, kernel):
    """The 1-D MODWT routes ask for the cascade pair's room and no other
    kernel's, in both directions: db4 J=10 (the default depth at N >= 3585)
    and sym8 J=9 and J=10 reach the kernels, on a faked card; L=56 J=9 (the
    synthesis does not fit), L=76 J=9 and J=10 and any N < 4096 stay on the
    plain cascade.  The tiled tier's gate reads the same rule."""
    from types import SimpleNamespace

    from vectorwave_tpu_torch import parallel as tp
    from vectorwave_tpu_torch.kernels import modwt_fused
    from vectorwave_tpu_torch.parallel import tiled as tt
    from vectorwave_tpu_torch.transforms import multilevel as ml

    monkeypatch.setattr(modwt_fused, "kernel_available", lambda: True)
    w = vt.wavelet(name)
    card = SimpleNamespace(device=torch.device("cuda"), dtype=torch.float32, shape=(2, n))
    for synthesis in (False, True):
        for boundary in ("periodic", "zero"):
            assert ml._kernel_eligible(card, w, levels, boundary, synthesis) == kernel
    assert mc.kernels_fit(w.filter_length, levels) == (kernel or n < 4096)
    cards = tp.make_mesh({"signal": 4}, devices=[torch.device("cuda")] * 4)
    tiles = tt._tiles(cards, "signal", None, (2, 4 * n), -1)
    route = tt._resolve_tiled_backend("auto", "periodic", tiles, torch.float32,
                                      w.filter_length, levels)
    assert route == ("kernel" if mc.kernels_fit(w.filter_length, levels) else "torch")
    cpu = SimpleNamespace(device=torch.device("cpu"), dtype=torch.float32, shape=(2, n))
    assert not ml._kernel_eligible(cpu, w, levels, "periodic")


@pytest.mark.parametrize("name,levels,depth", [("db4", None, 9), ("sym8", None, 9),
                                               ("db4", 10, 10)])
def test_default_depth_call_takes_the_pair_route_on_the_cpu(name, levels, depth):
    """With no ``levels`` the depth is ``max_levels``, which stops at 9 (the
    reference's loop stops one short of its cap of 10): db4 and sym8 at
    8192 samples, and db4 J=10 asked for.  Forced onto the kernel tier (the
    pair's plain versions on a CPU tensor) each equals the plain cascade,
    and so does its inverse."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 8192)))
    got = vt.modwt_multilevel(x, name, levels=levels, backend="kernel")
    want = vt.modwt_multilevel(x, name, levels=levels, backend="torch")
    assert got.levels == want.levels == depth
    for g, r in zip((*got.details, got.approx), (*want.details, want.approx)):
        assert (g - r).abs().max().item() <= 1e-12
    y = vt.imodwt_multilevel(got, name, backend="kernel")
    assert (y - vt.imodwt_multilevel(want, name, backend="torch")).abs().max().item() <= 1e-12
    assert (y - x).abs().max().item() <= 1e-10


@pytest.mark.parametrize("name,levels,boundary,fused", [
    ("sym8", None, "periodic", False), ("sym8", None, "zero", False),
    ("db4", 10, "periodic", False), ("db4", 10, "zero", False),
    ("db4", 6, "periodic", True), ("db9", 8, "zero", True)])
def test_denoise_asks_for_its_own_room(monkeypatch, name, levels, boundary, fused):
    """The fused denoise route asks for the cascade pair's gate and the
    denoise kernel's own room (``denoise_tile``), the rule its wrapper
    raises by: sym8 at its default depth (J=9) and db4 J=10, where the
    denoise block fits no tile, take the 3-call path on the pair; db4 J=6
    and db9 J=8 (a tile of 512) the fused kernel.  Forced onto the kernel
    tier (the plain versions on a CPU tensor), each equals the plain
    route's denoise within 2e-5 (the same float32 arithmetic in another
    order)."""
    from vectorwave_tpu_torch import config
    from vectorwave_tpu_torch.denoise import denoiser
    from vectorwave_tpu_torch.kernels import modwt_fused

    taps = vt.wavelet(name).filter_length
    depth = levels or 9
    assert (mc.denoise_tile(taps, depth) is not None) == fused
    assert mc.kernels_fit(taps, depth)
    calls = {"denoise": 0, "analysis": 0, "synthesis": 0}

    def spy(key, fn):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(denoiser, "fused_denoise_multilevel",
                        spy("denoise", denoiser.fused_denoise_multilevel))
    monkeypatch.setattr(modwt_fused, "fused_analysis",
                        spy("analysis", modwt_fused.fused_analysis))
    monkeypatch.setattr(modwt_fused, "fused_synthesis",
                        spy("synthesis", modwt_fused.fused_synthesis))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 8192)).astype(np.float32))
    want = vt.denoise_multilevel(x, name, levels=levels, boundary=boundary)
    assert calls == {"denoise": 0, "analysis": 0, "synthesis": 0}
    monkeypatch.setattr(config, "_backend", "kernel")
    got = vt.denoise_multilevel(x, name, levels=levels, boundary=boundary)
    assert calls == ({"denoise": 1, "analysis": 0, "synthesis": 0} if fused
                     else {"denoise": 0, "analysis": 1, "synthesis": 1})
    assert got.shape == x.shape and got.dtype == torch.float32
    assert (got - want).abs().max().item() <= 2e-5
