"""Port parity: the 2-D MODWT family (transforms/twodim.py) and its kernel tier.

The same seeded numpy inputs go through vectorwave_tpu and
vectorwave_tpu_torch.  Tolerances:

* float64, port against the JAX package's jnp path: 1e-12 max abs (the same
  float64 arithmetic in another order, values of order 1); ``denoise2``,
  whose MAD sigma and threshold pass through a sort, 1e-10;
* float32, the port's kernel tier (its wrappers run their plain versions on
  the CPU) against the JAX Pallas kernels in interpret mode: 2e-5 per band,
  4e-5 for a deep case that crosses the TPU cascade tier, 3e-5 and 5e-5 for
  round trips (the bounds of ``tests/test_modwt2_pallas.py``: fp32 sums in
  another order over composite filters of up to hundreds of taps);
* the CUDA kernels' windows, walked in numpy in float64 against the plain
  versions: 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt
from vectorwave_tpu.kernels import modwt2_mxu as jk2
from vectorwave_tpu.kernels.modwt2_pallas import (
    imodwt2_multilevel_pallas,
    modwt2_multilevel_pallas,
)
from vectorwave_tpu.transforms import twodim as jtwo
from vectorwave_tpu.transforms.modwt import _resolve_discrete as jwavelet
from vectorwave_tpu_torch import convert
from vectorwave_tpu_torch.errors import InvalidArgumentError, InvalidSignalError
from vectorwave_tpu_torch.kernels import modwt2 as k2
from vectorwave_tpu_torch.kernels import modwt2_composite as c2
from vectorwave_tpu_torch.kernels.modwt_fused import _kernel_filters

torch.set_num_threads(1)

TOL = 1e-12
BOUNDARIES = ["periodic", "zero", "symmetric"]


def _image(h=64, w=96, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.sin(2 * np.pi * yy / 16) + np.cos(2 * np.pi * xx / 12)
    return img + 0.1 * rng.standard_normal((h, w))


def _randn(shape, seed=0, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _port_wavelet(name):
    if name.startswith("bior"):
        w = vw.wavelet(name)
        return convert.wavelet_from_arrays(name, w.dec_lo, w.dec_hi, w.rec_lo, w.rec_hi)
    return vt.wavelet(name)


def _close(got, want, tol=TOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, msg
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=msg)


def _close_result(got, want, tol=TOL):
    """Every band of two multi-level 2-D results, level by level."""
    assert len(got.details) == len(want.details)
    for j, (g3, w3) in enumerate(zip(got.details, want.details), start=1):
        for g, w, tag in zip(g3, w3, ("lh", "hl", "hh")):
            _close(g, w, tol, f"level {j} {tag}")
    _close(got.approx, want.approx, tol, "ll")


def _jnp(fn):
    vw.set_backend("jnp")
    try:
        return fn()
    finally:
        vw.set_backend("auto")


# --- the CUDA kernels' windows, walked in numpy ------------------------------------


def _edge_index(g, n, edge):
    if edge == "zero":
        return np.where((g >= 0) & (g < n), g, -1)
    p = 2 * n if edge == "symmetric" else n
    m = np.mod(g, p)
    return np.where(m < n, m, p - 1 - m)


def _gather(img, rows, cols):
    """img[rows][:, cols] with -1 reading 0 (the zero edge)."""
    h, w = img.shape
    out = img[np.clip(rows, 0, h - 1)][:, np.clip(cols, 0, w - 1)]
    return np.where((rows[:, None] >= 0) & (cols[None, :] >= 0), out, 0.0)


def _blocks(b, h, w, s, tile):
    """(image, residue, k0, c0) of every block, in the kernels' grid order."""
    th, tw = tile
    blocks, chunks, wtiles = k2.grid_blocks(b, h, w, s, tile)
    for bid in range(blocks):
        rest, wt = divmod(bid, wtiles)
        rest, chunk = divmod(rest, chunks)
        image, res = divmod(rest, s)
        yield image, res, chunk * th, wt * tw


def _store(outs, image, res, k0, c0, s, tile, vals):
    """Write the block's [.., th, tw] values where rows and columns are in
    range, as the kernels' stores do; count each pixel's writes."""
    th, tw = tile
    h, w = outs[0].shape[-2:]
    rows = res + s * (k0 + np.arange(th))
    cols = c0 + np.arange(tw)
    ok_r, ok_c = rows < h, cols < w
    for out, v in zip(outs, vals):
        out[image][np.ix_(rows[ok_r], cols[ok_c])] += v[np.ix_(ok_r, ok_c)]


def _walk_analysis(x, filters, s, edge, plan):
    """modwt2_analysis.cu's block loop for a plan: the window of th + L - 1
    rows of the residue class by tw + s (L - 1) columns; the W pass in
    strips of ``plan.block`` outputs of one column class, forward reads of
    the reversed taps, into the low and high row buffers; the H pass in
    items of 4 class rows (fewer at a ragged tile's end), forward reads down
    the buffers' columns; then the stores.  Every read must stay inside the
    window or a buffer, and every buffer slot is written once."""
    lo, hi = (np.asarray(f) for f in filters)
    taps = len(lo)
    g_lo, g_hi = lo[::-1], hi[::-1]
    b, h, w = x.shape
    th, tw = plan.tile
    rows_n, width = k2.analysis_window(taps, s, plan.tile)
    kw = plan.block
    assert tw % (8 * kw) == 0 and (kw == 1 or tw % (4 * s) == 0)
    sigma = np.arange(tw // kw)
    cols = sigma if kw == 1 else sigma % s + s * kw * (sigma // s)
    outs = [np.zeros_like(x) for _ in range(4)]  # ll, lh, hl, hh
    for image, res, k0, c0 in _blocks(b, h, w, s, plan.tile):
        gr = _edge_index(res + s * (k0 - (taps - 1) + np.arange(rows_n)), h, edge)
        gc = _edge_index(c0 - s * (taps - 1) + np.arange(width), w, edge)
        win = _gather(x[image], gr, gc)

        def line(e):
            idx = cols[None, :] + s * e
            assert idx.min() >= 0 and idx.max() < width
            return win[:, idx[0]]
        aw, dw = np.full((rows_n, tw), np.nan), np.full((rows_n, tw), np.nan)
        written = np.zeros((rows_n, tw), dtype=int)
        for j, (a, d) in enumerate(zip(_filter_line(line, kw, g_lo),
                                       _filter_line(line, kw, g_hi))):
            aw[:, cols + s * j], dw[:, cols + s * j] = a, d
            written[:, cols + s * j] += 1
        assert np.all(written == 1)
        bands = [np.zeros((th, tw)) for _ in range(4)]  # ll, lh, hl, hh
        for k in range(0, th, 4):
            for r0, kh in ((k, 4),) if k + 4 <= th else ((k + j, 1) for j in range(th - k)):
                for buf, (b_lo, b_hi) in ((aw, (0, 2)), (dw, (1, 3))):
                    def hline(e, r0=r0, buf=buf):
                        assert r0 + e < rows_n
                        return buf[r0 + e]
                    for g, band in ((g_lo, b_lo), (g_hi, b_hi)):
                        for j, v in enumerate(_filter_line(hline, kh, g)):
                            bands[band][r0 + j] = v
        _store(outs, image, res, k0, c0, s, plan.tile, bands)
    return outs


def _forward(f, sign, off, s):
    """An op's forward-read form, as the synthesis kernel builds it: taps in
    read order (reversed for sign -1) and the base offset."""
    f = np.asarray(f)
    return (f, off) if sign > 0 else (f[::-1], off - s * (len(f) - 1))


def _filter_line(line, k, g):
    """filter_line of modwt2_synthesis.cu: acc[j] += sum_l g[l] line(j + l),
    j < k, taps 4 at a time with the k + 3 samples of a step loaded and k - 1
    of them carried to the next, then the taps left over one at a time."""
    taps = len(g)
    full = taps & ~3
    acc = [0.0] * k
    b = {e: line(e) for e in range(k - 1)} if full else {}
    for l0 in range(0, full, 4):
        b.update({e: line(l0 + e) for e in range(k - 1, k + 3)})
        for u in range(4):
            for j in range(k):
                acc[j] = acc[j] + g[l0 + u] * b[j + u]
        b = {e: b[e + 4] for e in range(k - 1)}
    for tap in range(full, taps):
        for j in range(k):
            acc[j] = acc[j] + g[tap] * line(j + tap)
    return acc


def _walk_synthesis(planes, filters, s, ops, edge, plan):
    """modwt2_synthesis.cu's block loop for a plan: per H op, the windows of
    its two planes (th + L - 1 rows of the class it reads by the columns the
    W ops read), the W pass in strips of ``plan.block`` outputs of one column
    class into the row buffer (with one stage the first plane's sums stored
    and the second's added; with more, both summed before the store: the
    same sums in another rounding order); the H pass in items of 4 class
    rows (fewer at a ragged tile's end), summed over the two H ops; then the
    stores.  How many windows the block holds at once changes when copies
    run, not what is read.  Every read must stay inside its window or the
    buffer, and every buffer slot is written once a pass."""
    lo, hi = filters
    taps = len(lo)
    b, h, w = planes[0].shape
    th, tw = plan.tile
    rows_n, width, wlo = k2.synthesis_window(taps, s, ops, plan.tile)
    (g_lo, base_lo), (g_hi, base_hi) = (_forward(lo, *ops[:2], s), _forward(hi, *ops[2:], s))
    kw = plan.block
    assert tw % (8 * kw) == 0 and (kw == 1 or tw % (4 * s) == 0)
    sigma = np.arange(tw // kw)
    cols = sigma if kw == 1 else sigma % s + s * kw * (sigma // s)
    out = np.zeros_like(planes[0])
    for image, res, k0, c0 in _blocks(b, h, w, s, plan.tile):
        gc = _edge_index(c0 + wlo + np.arange(width), w, edge)
        oacc = np.zeros((th, tw))
        for hh_, (g_h, base_h) in enumerate(((g_lo, base_lo), (g_hi, base_hi))):
            gr = _edge_index(res + base_h + s * (k0 + np.arange(rows_n)), h, edge)
            rowbuf = np.full((rows_n, tw), np.nan)
            written = np.zeros((rows_n, tw), dtype=int)
            for ww, (g_w, base_w) in enumerate(((g_lo, base_lo), (g_hi, base_hi))):
                win = _gather(planes[2 * hh_ + ww][image], gr, gc)

                def line(e, win=win, off=base_w - wlo):
                    idx = cols[None, :] + off + s * e
                    assert idx.min() >= 0 and idx.max() < width
                    return win[:, idx[0]]
                acc = _filter_line(line, kw, g_w)
                for j in range(kw):
                    if ww == 0:
                        rowbuf[:, cols + s * j] = acc[j]
                        written[:, cols + s * j] += 1
                    else:
                        rowbuf[:, cols + s * j] = rowbuf[:, cols + s * j] + acc[j]
            assert np.all(written == 1)
            for k in range(0, th, 4):
                if k + 4 <= th:
                    def hline(e, k=k):
                        assert k + e < rows_n
                        return rowbuf[k + e]
                    for j, v in enumerate(_filter_line(hline, 4, g_h)):
                        oacc[k + j] += v
                else:
                    for j in range(th - k):
                        def hline1(e, r=k + j):
                            assert r + e < rows_n
                            return rowbuf[r + e]
                        oacc[k + j] += _filter_line(hline1, 1, g_h)[0]
        _store([out], image, res, k0, c0, s, plan.tile, (oacc,))
    return out


def _walk_plan(tile, s, stages):
    """A plan for a walk's tile: the kernels' W-pass block where the tile
    takes it, else one output a thread."""
    tw = tile[1]
    block = 4 if tw % (4 * s) == 0 and tw % 32 == 0 else 1
    return k2.LevelPlan(tile, stages, 0, 0, block)


WALK_CASES = [
    # (wavelet, level, edge, shape, tile): small tiles give many blocks and
    # ragged edges; (16, 128) is the kernels' first choice.
    ("db4", 1, "periodic", (2, 40, 56), (4, 8)),
    ("db4", 3, "periodic", (1, 40, 56), (2, 16)),
    ("db4", 2, "zero", (2, 37, 29), (4, 8)),
    ("db4", 3, "symmetric", (1, 45, 52), (4, 8)),
    ("sym8", 2, "symmetric", (1, 64, 48), (16, 128)),
    ("haar", 5, "periodic", (1, 24, 40), (4, 8)),  # spacing 16, span above H
    ("haar", 4, "symmetric", (1, 20, 18), (1, 32)),
]


@pytest.mark.parametrize("name,level,edge,shape,tile", WALK_CASES)
def test_kernel_windows_reproduce_the_plain_level(name, level, edge, shape, tile):
    """The CUDA kernels' index arithmetic (windows, polyphase rows, edge
    mapping, ragged stores), walked in numpy, equals the plain versions for
    every band and writes every pixel exactly once."""
    w = vt.wavelet(name)
    s = 1 << (level - 1)
    x = _randn(shape, seed=level)
    fa = _kernel_filters(w, synthesis=False)
    want = k2.analysis2_level_plain(torch.from_numpy(x), fa, s, edge)
    got = _walk_analysis(x, fa, s, edge, _walk_plan(tile, s, 1))
    for g, wt, tag in zip(got, want, ("ll", "lh", "hl", "hh")):
        _close(g, wt, msg=tag)
    count = _walk_analysis(np.ones_like(x), ((1.0,), (0.0,)), s, "periodic",
                           _walk_plan(tile, s, 1))[0]
    assert np.array_equal(count, np.ones_like(x))
    planes = [_randn(shape, seed=10 + i) for i in range(4)]
    fs = _kernel_filters(w, synthesis=True)
    ops = k2.synthesis_ops(w, level, edge)[level - 1]
    want = k2.synthesis2_level_plain(*(torch.from_numpy(p) for p in planes), fs, s, ops,
                                     edge)
    plan = _walk_plan(tile, s, 2)
    _close(_walk_synthesis(planes, fs, s, ops, edge, plan), want)
    ones = [np.ones_like(x)] + [np.zeros_like(x)] * 3
    count = _walk_synthesis(ones, ((1.0,), (0.0,)), s, k2.FORWARD_OPS, "periodic",
                            _walk_plan(tile, s, 2))
    assert np.array_equal(count, np.ones_like(x))


#: The synthesis planner's own tiles on images big enough for them, the
#: tile changing between levels (db4: (32, 128) at level 1, wider at level
#: 6), ragged W, a class row count that is not a multiple of 4, and
#: a one-output-a-thread W pass (haar level 9).
PLAN_WALKS = [
    ("db4", 1, "periodic", (1, 70, 300)),
    ("db4", 6, "periodic", (1, 300, 530)),
    ("db4", 6, "symmetric", (1, 290, 520)),
    ("sym8", 4, "zero", (1, 150, 301)),
    ("haar", 9, "periodic", (1, 520, 600)),
]


@pytest.mark.parametrize("name,level,edge,shape", PLAN_WALKS)
def test_synthesis_plans_walk_to_the_plain_level(name, level, edge, shape):
    w = vt.wavelet(name)
    s = 1 << (level - 1)
    fs = _kernel_filters(w, synthesis=True)
    ops = k2.synthesis_ops(w, level, edge)[level - 1]
    plan = k2.synthesis_plan(w.filter_length, s, ops)
    assert plan is not None and plan.stages == 2
    planes = [_randn(shape, seed=20 + i) for i in range(4)]
    want = k2.synthesis2_level_plain(*(torch.from_numpy(p) for p in planes), fs, s, ops,
                                     edge)
    _close(_walk_synthesis(planes, fs, s, ops, edge, plan), want)


def test_the_synthesis_tile_follows_the_level():
    """The planner takes tall tiles at shallow levels and wide ones at deep
    levels, where the W reach (L - 1) s would make (16, 128) read each plane
    almost 4 times, and keeps three blocks to an SM."""
    w = vt.wavelet("db4")
    tiles = [k2.synthesis_tile(8, 1 << (j - 1), k2.FORWARD_OPS) for j in range(1, 7)]
    assert tiles[0] == (32, 128) and tiles[5] == (8, 256)

    def reads(tile):
        rows, width, _ = k2.synthesis_window(8, 32, k2.FORWARD_OPS, tile)
        return rows * width / (tile[0] * tile[1])
    assert reads(tiles[5]) < reads((16, 128))
    for j, ops in enumerate(k2.synthesis_ops(w, 6, "periodic"), start=1):
        plan = k2.synthesis_plan(8, 1 << (j - 1), ops)
        assert k2.plan_shared_bytes(8, 1 << (j - 1), ops, plan) <= k2.THREE_BLOCKS_SHARED
        assert plan.block == 4 and plan.pitch % 32 == min(1 << (j - 1), 8)


@pytest.mark.parametrize("name,levels", [("db4", 6), ("sym8", 6), ("db20", 4), ("haar", 10)])
def test_the_main_widths_fit_shared_memory(name, levels):
    """db4 and sym8 to J=6, a long filter (db20 J=4) and haar J=10 get a
    tile at every level and in every edge mode; the first level's analysis
    a planned tile that leaves two blocks to an SM."""
    w = vt.wavelet(name)
    for edge in BOUNDARIES:
        for j, ops in enumerate(k2.synthesis_ops(w, levels, edge), start=1):
            s = 1 << (j - 1)
            a, syn = k2.analysis_plan(w.filter_length, s), k2.synthesis_plan(
                w.filter_length, s, ops)
            assert a is not None and syn is not None
            assert k2.analysis_shared_bytes(w.filter_length, s, a) <= k2.SHARED_LIMIT
            assert k2.plan_shared_bytes(w.filter_length, s, ops, syn) <= k2.SHARED_LIMIT
        first = k2.analysis_plan(w.filter_length, 1)
        assert first.tile in k2.PLAN_TILES
        assert k2.analysis_shared_bytes(w.filter_length, 1, first) <= k2.TWO_BLOCKS_SHARED


#: The synthesis gate before the two-stage kernel, as a table: the deepest
#: level whose one-plane block (2 L taps, one window, two W-pass sums of
#: rows x columns and the row and column tables) fit 232448 bytes at a tile
#: of TILES, in every edge mode.
OLD_DEEPEST_SYNTHESIS = {"db4": 10, "sym8": 8, "db20": 6, "haar": 10}


def _old_synthesis_tile(taps, s, ops):
    for tile in k2.TILES:
        rows, width, _ = k2.synthesis_window(taps, s, ops, tile)
        if 4 * (2 * taps + rows * width + 2 * rows * tile[1] + rows + width) <= 232448:
            return tile
    return None


@pytest.mark.parametrize("name", sorted(OLD_DEEPEST_SYNTHESIS))
def test_every_level_the_old_synthesis_served_is_served(name):
    w = vt.wavelet(name)
    for edge in BOUNDARIES:
        for j, ops in enumerate(k2.synthesis_ops(w, 10, edge), start=1):
            s = 1 << (j - 1)
            old = _old_synthesis_tile(w.filter_length, s, ops)
            assert (old is not None) == (j <= OLD_DEEPEST_SYNTHESIS[name])
            if old is not None:
                plan = k2.synthesis_plan(w.filter_length, s, ops)
                assert plan is not None
                assert k2.plan_shared_bytes(w.filter_length, s, ops, plan) <= k2.SHARED_LIMIT


@pytest.mark.parametrize("name,level,edge,shape", PLAN_WALKS)
def test_analysis_plans_walk_to_the_plain_level(name, level, edge, shape):
    """The analysis planner's tiles (as the synthesis's above): every band
    of the walked kernel equals the plain level."""
    w = vt.wavelet(name)
    s = 1 << (level - 1)
    fa = _kernel_filters(w, synthesis=False)
    plan = k2.analysis_plan(w.filter_length, s)
    assert plan is not None and plan.stages == 1
    x = _randn(shape, seed=30 + level)
    want = k2.analysis2_level_plain(torch.from_numpy(x), fa, s, edge)
    for g, wt, tag in zip(_walk_analysis(x, fa, s, edge, plan), want,
                          ("ll", "lh", "hl", "hh")):
        _close(g, wt, msg=tag)


def test_the_analysis_tile_follows_the_level():
    """The analysis planner takes the synthesis's rule with two blocks to an
    SM: tall tiles at shallow levels, wide ones at deep levels, where the
    first-fit (16, 128) would read the input 3.95 times at level 6."""
    tiles = [k2.analysis_tile(8, 1 << (j - 1)) for j in range(1, 7)]
    assert tiles[0] == (32, 128) and tiles[5] == (16, 256)

    def reads(tile):
        rows, width = k2.analysis_window(8, 32, tile)
        return rows * width / (tile[0] * tile[1])
    assert reads((16, 128)) == pytest.approx(3.953125)
    assert reads(tiles[5]) == pytest.approx(2.6953125)
    for j in range(1, 7):
        s = 1 << (j - 1)
        plan = k2.analysis_plan(8, s)
        assert k2.analysis_shared_bytes(8, s, plan) <= k2.TWO_BLOCKS_SHARED
        assert plan.block == 4 and plan.pitch % 32 == min(s, 8)


#: The analysis gate before the planned kernel, as a table: the deepest
#: level whose block (2 L taps, one window, two W-pass sums of rows x
#: columns and the row and column index tables) fit 232448 bytes at the
#: first fitting tile of TILES.
OLD_DEEPEST_ANALYSIS = {"db4": 10, "sym8": 8, "db20": 6, "db38": 4, "haar": 10}


def _old_analysis_tile(taps, s):
    for tile in k2.TILES:
        rows, width = k2.analysis_window(taps, s, tile)
        if 4 * (2 * taps + rows * width + 2 * rows * tile[1] + rows + width) <= 232448:
            return tile
    return None


@pytest.mark.parametrize("name", sorted(OLD_DEEPEST_ANALYSIS))
def test_every_level_the_old_analysis_served_is_served(name):
    """Every level the old gate served is served, and no other: the routing
    (kernel_refusal) accepts what it accepted."""
    taps = vt.wavelet(name).filter_length
    for j in range(1, 11):
        s = 1 << (j - 1)
        old = _old_analysis_tile(taps, s)
        assert (old is not None) == (j <= OLD_DEEPEST_ANALYSIS[name])
        plan = k2.analysis_plan(taps, s)
        assert (plan is not None) == (old is not None)
        if plan is not None:
            assert k2.analysis_shared_bytes(taps, s, plan) <= k2.SHARED_LIMIT


# --- parity with the Pallas kernels (interpret mode, float32) ----------------------


def _kernel_tier(x, name, levels, boundary):
    res = vt.modwt2_multilevel(torch.from_numpy(x), name, levels=levels,
                               boundary=boundary, backend="kernel")
    return res, vt.imodwt2_multilevel(res, name, boundary=boundary, backend="kernel")


@pytest.mark.parametrize("boundary", ["periodic", "zero"])
@pytest.mark.parametrize("name,levels", [("db4", 3), ("haar", 4), ("sym8", 2)])
def test_kernel_tier_matches_pallas_kernels(name, levels, boundary):
    x = _randn((2, 256, 256), dtype=np.float32)
    det, ll = modwt2_multilevel_pallas(jnp.asarray(x), jwavelet(name), levels, boundary,
                                       "float32", interpret=True)
    got, _ = _kernel_tier(x, name, levels, boundary)
    _close_result(got, vt.MultiLevelMODWT2Result(det, ll), tol=2e-5)


def test_kernel_tier_matches_pallas_cascade_tier_deep():
    """db4 J=5 at 512x512 crosses the TPU kernels' cascade tier
    (``_cascade_start``); the port runs every level as one stage."""
    x = _randn((1, 512, 512), seed=3, dtype=np.float32)
    det, ll = modwt2_multilevel_pallas(jnp.asarray(x), jwavelet("db4"), 5, "periodic",
                                       "float32", interpret=True)
    got, _ = _kernel_tier(x, "db4", 5, "periodic")
    _close_result(got, vt.MultiLevelMODWT2Result(det, ll), tol=4e-5)


@pytest.mark.parametrize("boundary", ["periodic", "zero"])
@pytest.mark.parametrize("levels,hw,tol", [(3, 256, 3e-5), (5, 512, 5e-5)])
def test_kernel_tier_round_trip_matches_pallas(levels, hw, tol, boundary):
    x = _randn((1, hw, hw), seed=4, dtype=np.float32)
    w = jwavelet("db4")
    det, ll = modwt2_multilevel_pallas(jnp.asarray(x), w, levels, boundary, "float32",
                                       interpret=True)
    want = imodwt2_multilevel_pallas(det, ll, w, boundary, "float32", interpret=True)
    res = convert.modwt2_result_from_arrays(det, ll, device="cpu")
    got = vt.imodwt2_multilevel(res, "db4", boundary=boundary, backend="kernel")
    _close(got, want, tol)
    if boundary == "periodic":
        _close(_kernel_tier(x, "db4", levels, boundary)[1], x, tol)


@pytest.mark.parametrize("name,levels", [("db4", 3), ("sym8", 2)])
def test_symmetric_kernel_tier_matches_jax_fast_paths(name, levels):
    """The symmetric edge mode against the JAX reflect-padded symmetric fast
    paths (Pallas, interpret mode) at 2e-5, and against the jnp cascade in
    float64 at 1e-12."""
    x = _randn((2, 256, 256), seed=5, dtype=np.float32)
    w = jwavelet(name)
    vw.set_backend("pallas")
    vw.set_fused_precision("float32")
    try:
        fast = jtwo._modwt2_symmetric_fast(jnp.asarray(x), w, levels)
        assert fast is not None
        fast_inv = jtwo._imodwt2_symmetric_fast(fast, w)
        assert fast_inv is not None
    finally:
        vw.set_backend("auto")
        vw.set_fused_precision("bf16_3x")
    got = vt.modwt2_multilevel(torch.from_numpy(x), name, levels=levels,
                               boundary="symmetric", backend="kernel")
    _close_result(got, fast, tol=2e-5)
    res = convert.modwt2_result_from_arrays(fast.details, fast.approx, device="cpu")
    _close(vt.imodwt2_multilevel(res, name, boundary="symmetric", backend="kernel"),
           fast_inv, 2e-5)
    x64 = x.astype(np.float64)[:1, :96, :80]
    want = _jnp(lambda: jtwo.modwt2_multilevel(jnp.asarray(x64), name, levels=levels,
                                               boundary="symmetric"))
    got = vt.modwt2_multilevel(torch.from_numpy(x64), name, levels=levels,
                               boundary="symmetric", backend="kernel")
    _close_result(got, want)
    _close(vt.imodwt2_multilevel(got, name, boundary="symmetric", backend="kernel"),
           _jnp(lambda: jtwo.imodwt2_multilevel(want, name, boundary="symmetric")))


# --- parity with the cascade in float64 ----------------------------------------------


@pytest.mark.parametrize("name,levels,shape,boundary", [
    *(("db4", 3, (3, 200, 328), b) for b in BOUNDARIES),  # H != W, not 128-multiples
    *(("sym8", 2, (2, 64, 96), b) for b in BOUNDARIES),
    *(("bior2.2", 2, (1, 48, 64), b) for b in BOUNDARIES),
    ("haar", 5, (24, 40), "periodic"),  # the level-5 span (16) wraps past H - 16
])
def test_public_pair_matches_jax_cascade(name, levels, shape, boundary):
    x = _randn(shape, seed=7)
    want = _jnp(lambda: vw.modwt2_multilevel(jnp.asarray(x), name, levels=levels,
                                             boundary=boundary))
    want_y = _jnp(lambda: vw.imodwt2_multilevel(want, name, boundary=boundary))
    w = _port_wavelet(name)
    for backend in ("torch", "kernel"):
        got = vt.modwt2_multilevel(torch.from_numpy(x), w, levels=levels,
                                   boundary=boundary, backend=backend)
        _close_result(got, want)
        _close(vt.imodwt2_multilevel(got, w, boundary=boundary, backend=backend), want_y)
    if boundary == "periodic":
        _close(want_y, x, 1e-10)


# --- the composite form ---------------------------------------------------------------


@pytest.mark.parametrize("boundary", ["periodic", "zero"])
@pytest.mark.parametrize("name,levels", [("db4", 3), ("sym8", 2), ("haar", 4)])
def test_composite_form_matches_jax_fast_path_and_the_cascade(name, levels, boundary):
    """modwt2_multilevel_composite against the JAX banded-matmul path at 2e-5
    in float32, and against the port's per-level cascade (the kernel tier's
    definition) at 1e-12 in float64, both directions."""
    x = _randn((2, 128, 256), seed=8, dtype=np.float32)
    w = vt.wavelet(name)
    det, ll = c2.modwt2_multilevel_composite(torch.from_numpy(x), w, levels, boundary)
    jdet, jll = jk2.modwt2_multilevel_fast(jnp.asarray(x), jwavelet(name), levels,
                                           boundary, "float32")
    _close_result(vt.MultiLevelMODWT2Result(det, ll), vt.MultiLevelMODWT2Result(jdet, jll),
                  tol=2e-5)
    _close(c2.imodwt2_multilevel_composite(det, ll, w, boundary),
           jk2.imodwt2_multilevel_fast(jdet, jll, jwavelet(name), boundary, "float32"),
           5e-5)
    x64 = torch.from_numpy(x.astype(np.float64)[:, :64, :80])
    det, ll = c2.modwt2_multilevel_composite(x64, w, levels, boundary)
    casc = vt.modwt2_multilevel(x64, w, levels=levels, boundary=boundary, backend="kernel")
    _close_result(vt.MultiLevelMODWT2Result(det, ll), casc)
    _close(c2.imodwt2_multilevel_composite(casc.details, casc.approx, w, boundary),
           vt.imodwt2_multilevel(casc, w, boundary=boundary, backend="kernel"))


def test_composite_planes_split_matches_jax():
    low, high = np.array([0.4, 0.6, -0.1]), np.array([0.2, -0.7, 0.3])
    for got, want in zip(c2.composite_planes_split(low, high, 3),
                         jk2.composite_planes_split(low, high, 3)):
        for g, wt in zip(got, want):
            np.testing.assert_array_equal(g, wt)
    with pytest.raises(InvalidArgumentError):
        c2.modwt2_multilevel_composite(torch.zeros(1, 16, 16), vt.wavelet("haar"), 1,
                                       "symmetric")


# --- mirrors of tests/test_twodim.py -------------------------------------------------


@pytest.mark.parametrize("boundary", ["periodic", "zero"])
def test_modwt2_roundtrip(boundary):
    x = _image()
    res = vt.modwt2(torch.from_numpy(x), "db4", boundary=boundary)
    want = jtwo.modwt2(jnp.asarray(x), "db4", boundary=boundary)
    for g, wt in zip(res, want):
        _close(g, wt)
    xr = vt.imodwt2(res, "db4", boundary=boundary)
    _close(xr, jtwo.imodwt2(want, "db4", boundary=boundary))
    err = (xr.numpy() - x)
    if boundary == "periodic":
        assert np.abs(err).max() < 1e-10
    else:
        assert np.abs(err[16:-16, 16:-16]).max() < 1e-9


def test_modwt2_symmetric_matches_1d_contract():
    x = _image()
    res = vt.modwt2(torch.from_numpy(x), "haar", boundary="symmetric")
    xr = vt.imodwt2(res, "haar", boundary="symmetric")
    _close(xr, jtwo.imodwt2(jtwo.modwt2(jnp.asarray(x), "haar", boundary="symmetric"),
                            "haar", boundary="symmetric"))
    interior = (xr.numpy() - x)[16:-16, 16:-16]
    assert np.sqrt(np.mean(interior**2)) / np.std(x[16:-16, 16:-16]) < 0.6


def test_modwt2_separability_oracle():
    x = torch.from_numpy(_image(32, 48))
    res = vt.modwt2(x, "haar")
    col = vt.modwt(x, "haar")
    row = vt.modwt(col.approx.transpose(-1, -2), "haar")
    _close(res.ll, row.approx.transpose(-1, -2).numpy())
    _close(res.hl, row.detail.transpose(-1, -2).numpy())
    _close(res.ll, jtwo.modwt2(jnp.asarray(x.numpy()), "haar").ll)


def test_modwt2_subband_orientation():
    """A horizontal edge excites hl (high along H), a vertical one lh, in the
    plain single level and in the kernel tier's first level alike."""
    img = np.zeros((64, 64))
    img[32:, :] = 1.0
    for img_, big, small in ((img, "hl", "lh"), (img.T.copy(), "lh", "hl")):
        res = vt.modwt2(torch.from_numpy(img_), "haar")
        assert float((getattr(res, big) ** 2).sum()) > 100 * max(
            float((getattr(res, small) ** 2).sum()), 1e-30)
        kern = vt.modwt2_multilevel(torch.from_numpy(img_), "haar", levels=1,
                                    backend="kernel")
        lh, hl, _ = kern.details[0]
        _close(lh, res.lh.numpy())
        _close(hl, res.hl.numpy())


def test_modwt2_energy_preserved_orthogonal():
    x = _image()
    res = vt.modwt2(torch.from_numpy(x), "db4")
    np.testing.assert_allclose(float(res.energy()), float((x**2).sum()), rtol=1e-10)
    _close(res.energy(), jtwo.modwt2(jnp.asarray(x), "db4").energy(), 1e-9)


def test_modwt2_multilevel_roundtrip_and_batch():
    x = np.stack([_image(seed=s) for s in range(3)])
    res = vt.modwt2_multilevel(torch.from_numpy(x), "sym4", levels=3)
    assert res.levels == 3 and res.details[0][0].shape == x.shape
    want = jtwo.modwt2_multilevel(jnp.asarray(x), "sym4", levels=3)
    _close_result(res, want)
    xr = vt.imodwt2_multilevel(res, "sym4")
    _close(xr, jtwo.imodwt2_multilevel(want, "sym4"))
    assert np.abs(xr.numpy() - x).max() < 1e-9
    _close(res.detail_energy(2), want.detail_energy(2), 1e-9)


@pytest.mark.parametrize("wavelet", ["haar", "db4", "bior2.2"])
def test_dwt2_roundtrip(wavelet):
    x = _image(64, 64)
    w = _port_wavelet(wavelet)
    res = vt.dwt2(torch.from_numpy(x), w)
    assert res.ll.shape == (32, 32)
    want = jtwo.dwt2(jnp.asarray(x), wavelet)
    for g, wt in zip(res, want):
        _close(g, wt)
    xr = vt.idwt2(res, w)
    _close(xr, jtwo.idwt2(want, wavelet))
    _close(xr, x, 1e-9)


def test_wavedec2_roundtrip():
    x = _image(64, 64)
    details, ll = vt.wavedec2(torch.from_numpy(x), "db2", levels=3)
    assert ll.shape == (8, 8) and len(details) == 3
    jdet, jll = jtwo.wavedec2(jnp.asarray(x), "db2", levels=3)
    _close_result(vt.MultiLevelMODWT2Result(tuple(details), ll),
                  vt.MultiLevelMODWT2Result(tuple(jdet), jll))
    xr = vt.waverec2(details, ll, "db2")
    _close(xr, jtwo.waverec2(jdet, jll, "db2"))
    _close(xr, x, 1e-9)


def test_denoise2_reduces_noise():
    rng = np.random.default_rng(3)
    clean = _image(64, 64) - 0.1 * rng.standard_normal((64, 64))
    noisy = clean + 0.5 * rng.standard_normal((64, 64))
    den = vt.denoise2(torch.from_numpy(noisy), "sym4", levels=3)
    _close(den, jtwo.denoise2(jnp.asarray(noisy), "sym4", levels=3), 1e-10)
    rmse_noisy = np.sqrt(np.mean((noisy - clean) ** 2))
    assert np.sqrt(np.mean((den.numpy() - clean) ** 2)) < 0.6 * rmse_noisy


def test_twodim_validation():
    with pytest.raises(InvalidSignalError):
        vt.modwt2(torch.zeros(16), "db4")
    with pytest.raises(InvalidArgumentError):
        vt.modwt2_multilevel(torch.zeros(8, 8), "db4", levels=0)
    with pytest.raises(InvalidArgumentError):
        vt.modwt2_multilevel(torch.zeros(8, 8), "db4", levels=2)  # filter too long
    with pytest.raises(InvalidArgumentError):
        vt.wavedec2(torch.zeros(12, 12), "haar", levels=3)


def test_denoise2_orientation_invariant():
    noisy = _image(64, 96) + 0.4 * np.random.default_rng(9).standard_normal((64, 96))
    a = vt.denoise2(torch.from_numpy(noisy), "sym4", levels=2)
    b = vt.denoise2(torch.from_numpy(noisy.T.copy()), "sym4", levels=2)
    _close(a, b.numpy().T, 1e-10)
    _close(a, jtwo.denoise2(jnp.asarray(noisy), "sym4", levels=2), 1e-10)


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("method,mode", [("universal", "soft"), ("sure", "hard")])
def test_denoise2_matches_jax_per_boundary(method, mode, boundary):
    noisy = np.stack([_image(48, 64, seed=s) for s in range(2)])
    noisy = noisy + 0.3 * np.random.default_rng(10).standard_normal(noisy.shape)
    got = vt.denoise2(torch.from_numpy(noisy), "db4", levels=2, method=method, mode=mode,
                      boundary=boundary)
    want = jtwo.denoise2(jnp.asarray(noisy), "db4", levels=2, method=method, mode=mode,
                         boundary=boundary)
    _close(got, want, 1e-10)


# --- mirrors of tests/test_modwt2_fast.py ---------------------------------------------


@pytest.mark.parametrize("h,wd,name,levels,boundary", [
    (256, 128, "db4", 3, "periodic"),
    (128, 256, "sym8", 2, "zero"),
    (128, 128, "haar", 4, "periodic"),
    (256, 256, "bior2.2", 2, "periodic"),
])
def test_fast2_matches_jnp(h, wd, name, levels, boundary):
    """The port's kernel tier and composite form against the JAX jnp cascade
    in float64 (1e-12), and its kernel tier against the JAX fast path in
    float32 (3e-6 per band, 5e-6 on the inverse, as the JAX test)."""
    x = _randn((2, h, wd))
    w = _port_wavelet(name)
    ref = _jnp(lambda: vw.modwt2_multilevel(jnp.asarray(x), name, levels=levels,
                                            boundary=boundary))
    ref_inv = _jnp(lambda: vw.imodwt2_multilevel(ref, name, boundary=boundary))
    got = vt.modwt2_multilevel(torch.from_numpy(x), w, levels=levels, boundary=boundary,
                               backend="kernel")
    _close_result(got, ref)
    _close(vt.imodwt2_multilevel(got, w, boundary=boundary, backend="kernel"), ref_inv)
    det, ll = c2.modwt2_multilevel_composite(torch.from_numpy(x), w, levels, boundary)
    _close_result(vt.MultiLevelMODWT2Result(det, ll), ref)
    x32 = x.astype(np.float32)
    jdet, jll = jk2.modwt2_multilevel_fast(jnp.asarray(x32), jwavelet(name), levels,
                                           boundary, "float32")
    got = vt.modwt2_multilevel(torch.from_numpy(x32), w, levels=levels, boundary=boundary,
                               backend="kernel")
    _close_result(got, vt.MultiLevelMODWT2Result(jdet, jll), tol=3e-6)
    if boundary == "periodic":
        _close(vt.imodwt2_multilevel(got, w, boundary=boundary, backend="kernel"), x32,
               5e-6)


def test_fast2_ineligible_shapes_fall_back():
    """On the CPU, ``auto`` takes the plain cascade for shapes the JAX fast
    path leaves to jnp (unaligned axes, symmetric edges); the results equal
    the JAX package's."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((100, 96))
    res = vt.modwt2_multilevel(torch.from_numpy(x), "db4", levels=2)
    _close(vt.imodwt2_multilevel(res, "db4"), x, 1e-10)
    x2 = rng.standard_normal((128, 128))
    res2 = vt.modwt2_multilevel(torch.from_numpy(x2), "db4", levels=2,
                                boundary="symmetric")
    ref = _jnp(lambda: vw.imodwt2_multilevel(
        vw.modwt2_multilevel(jnp.asarray(x2), "db4", levels=2, boundary="symmetric"),
        "db4", boundary="symmetric"))
    _close(vt.imodwt2_multilevel(res2, "db4", boundary="symmetric"), ref)


def test_fast2_energy_and_dtype_preserved():
    x = _randn((128, 128), seed=2, dtype=np.float32)
    for backend in ("torch", "kernel"):
        res = vt.modwt2_multilevel(torch.from_numpy(x), "haar", levels=3, backend=backend)
        assert res.approx.dtype == torch.float32
        assert np.isfinite(float(res.approx.var()))


# --- routing and the gate ------------------------------------------------------------


def test_gate_sides():
    """Both sides of each gate of modwt2_kernel_eligible's admission test."""
    w4, w38 = vt.wavelet("db4"), vt.wavelet("db38")
    x = torch.zeros(1, 256, 256)
    assert k2.kernel_refusal(x, w4, 4, "periodic") is None
    assert "float32" in k2.kernel_refusal(x.double(), w4, 4, "periodic")
    assert "float32" in k2.kernel_refusal(x.bfloat16(), w4, 4, "periodic")
    for b in ("zero", "symmetric", "sym", "per"):
        assert k2.kernel_refusal(x, w4, 4, b) is None
    assert "boundary" in k2.kernel_refusal(x, w4, 4, "antireflect")
    assert k2.kernel_refusal(torch.zeros(1, 22, 300), w4, 2, "periodic") is None
    assert "longer" in k2.kernel_refusal(torch.zeros(1, 21, 300), w4, 3, "periodic")
    assert "levels" in k2.kernel_refusal(x, w4, 11, "periodic")
    big = torch.empty(1, 1 << 14, 1 << 14, device="meta")
    assert k2.kernel_refusal(big, w38, 4, "periodic") is None
    assert "shared memory" in k2.kernel_refusal(big, w38, 5, "periodic")


def test_gate_needs_a_card_under_auto_and_follows_the_backend():
    x = torch.zeros(1, 256, 256)
    w = vt.wavelet("db4")
    assert not k2.modwt2_kernel_eligible(x, w, 2, "periodic")  # a CPU tensor
    vt.set_backend("kernel")
    try:
        assert k2.modwt2_kernel_eligible(x, w, 2, "periodic")
        assert not k2.modwt2_kernel_eligible(x.double(), w, 2, "periodic")
    finally:
        vt.set_backend("torch")
    try:
        assert not k2.modwt2_kernel_eligible(x, w, 2, "periodic")
    finally:
        vt.set_backend("auto")


def test_kernel_backend_on_cpu_runs_the_plain_versions(monkeypatch):
    """``backend='kernel'`` (and the global ``set_backend('pallas')``) on a
    CPU tensor goes through the level wrappers, which run their plain
    versions and count no launch; ``'torch'`` skips the wrappers."""
    from vectorwave_tpu_torch.kernels import modwt_composite as mc

    calls = {"analysis2_level": 0, "synthesis2_level": 0}
    for name in calls:
        orig = getattr(k2, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(k2, name, spy)
    x = torch.from_numpy(_randn((2, 40, 48), seed=11, dtype=np.float32))
    mc.reset_launches()
    res = vt.modwt2_multilevel(x, "db4", levels=2, backend="pallas")
    vt.imodwt2_multilevel(res, "db4", backend="kernel")
    assert calls == {"analysis2_level": 2, "synthesis2_level": 2}
    vt.set_backend("kernel")
    try:
        vt.denoise2(x, "db4", levels=2)
    finally:
        vt.set_backend("auto")
    assert calls == {"analysis2_level": 4, "synthesis2_level": 4}
    vt.modwt2_multilevel(x, "db4", levels=2, backend="torch")
    assert calls["analysis2_level"] == 4
    assert mc.LAUNCHES["modwt2_analysis"] == mc.LAUNCHES["modwt2_synthesis"] == 0
    with pytest.raises(Exception):
        vt.modwt2_multilevel(x, "db4", levels=2, backend="tpu")


def test_cpu_gradient_through_the_plain_path():
    """On the CPU the 2-D pair differentiates natively, on either backend."""
    x = torch.from_numpy(_randn((1, 32, 40), seed=12)).requires_grad_(True)
    for backend in ("torch", "kernel"):
        res = vt.modwt2_multilevel(x, "db4", levels=2, backend=backend)
        y = vt.imodwt2_multilevel(res, "db4", backend=backend)
        (g,) = torch.autograd.grad((y * y).sum(), x)
        _close(g, 2 * x.detach().numpy(), 1e-10)


def test_modwt2_result_from_arrays():
    x = _randn((2, 32, 48), seed=13)
    want = _jnp(lambda: vw.modwt2_multilevel(jnp.asarray(x), "db4", levels=2))
    res = convert.modwt2_result_from_arrays(want.details, want.approx, device="cpu")
    assert isinstance(res, vt.MultiLevelMODWT2Result) and res.approx.dtype == torch.float64
    _close(vt.imodwt2_multilevel(res, "db4"), x, 1e-10)
    with pytest.raises(InvalidArgumentError):
        convert.modwt2_result_from_arrays(((x[0], x[0]),), x[0], device="cpu")


def test_modwt2_result_from_arrays_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(InvalidArgumentError, match="no CUDA device"):
        convert.modwt2_result_from_arrays(((np.zeros((4, 4)),) * 3,), np.zeros((4, 4)))
