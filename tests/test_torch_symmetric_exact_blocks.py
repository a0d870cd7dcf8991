"""The symmetric synthesis and exact analysis CUDA kernels
(``csrc/modwt_symmetric_synthesis.cu`` forward, ``csrc/modwt_exact_analysis.cu``)
walked in numpy, block by block.

The kernels cannot run here, so their index arithmetic is replayed as it
stands in the sources.  The symmetric synthesis: each block's windows from
the plan (``symmetric_plan``, made for the launch tile, each shortened by
tile - n_out in a ragged last block), zero outside [0, n), where each window
lands in its shared row (the part inside the row on its source's place
modulo 16 bytes), each op turned into a forward run (a backward op reads
the reversed taps, zero-padded after the reversal, from (L-1) s samples
earlier), the runs of kSymBlock = 9 outputs a thread on each residue class
(``run_base``) with ``kGuard`` where a run reaches past the level's end or
reads padded taps, and the splice on the store.  The exact analysis: the
window [t0 - S, t0 + n_out) as a hi and a lo row with its edge rule before
0 (wrapped, zero or the left halo), converted once to doubles, the fp64
pair runs of
kExactAnalysisBlock = 5 outputs, the per-warp detail staging at strides
below 8, and the (hi, lo) split of every output.  The walks assert that no
load leaves the part of a window that is exact at that level, that every
output is written once, and that the result equals
:func:`modwt_composite.symmetric_synthesis_plain` and
:func:`modwt_composite.exact_analysis_plain` within 1e-12 (the same
arithmetic in another order).  The shapes reach each path: strides of 256
and 512 (passes), haar and long filters (padded taps), rows shorter than the
span, rows one sample longer than the two splices, ragged last tiles and
tiles from 64 to the row.
"""

import numpy as np
import pytest
import torch

import vectorwave_tpu_torch as vt
from vectorwave_tpu_torch.kernels import modwt_composite as mc
from vectorwave_tpu_torch.kernels import modwt_symmetric as ms
from vectorwave_tpu_torch.kernels.modwt_fused import _kernel_filters

from .test_torch_cascade_blocks import THREADS, _padded
from .test_torch_denoise_blocks import _starts, _synthesis_level

TOL = 1e-12
#: outputs a thread's run holds: the symmetric forward kernel's kSymBlock,
#: the exact analysis's kExactAnalysisBlock; details staged below stride 8
R_SYM = 9
R_EXACT = 5
STAGED_STRIDE = 8


def _row_floats(width):
    """window_row_floats: up to 3 floats before the window, rounded to 16 B."""
    return (width + 6) & ~3


def _zero_window(plane, g0, count):
    """copy_zero_window: the plane over [g0, g0 + count), zero outside [0, n)."""
    n = plane.shape[-1]
    g = g0 + np.arange(count)
    inside = (g >= 0) & (g < n)
    vals = np.zeros((plane.shape[0], count))
    vals[:, inside] = plane[:, g[inside]]
    return vals


def walk_symmetric(planes, head, tail, filters, ops, tile):
    """The forward symmetric kernel replayed block by block; returns x."""
    lo, hi = np.asarray(filters[0]), np.asarray(filters[1])
    taps = len(lo)
    rows = {(False, "lo"): _padded(lo), (True, "lo"): _padded(lo[::-1]),
            (False, "hi"): _padded(hi), (True, "hi"): _padded(hi[::-1])}
    levels = len(ops)
    b, n = planes[0].shape
    span = mc.composite_halo_samples(taps, levels)
    span_l, span_r = mc.symmetric_spans(taps, ops)
    plan, width = mc.symmetric_plan(taps, ops, tile, False)
    assert width == tile + span
    # a window lands up to 3 floats into its row, on its source's place
    # modulo 16 bytes
    room = _row_floats(width) - 3
    level = [plan[mc.PLAN_STRIDE * j: mc.PLAN_STRIDE * (j + 1)] for j in range(levels)]
    out = np.full((b, n), np.nan)
    for t0 in range(0, n, tile):
        n_out = min(tile, n - t0)
        cut = tile - n_out
        top = level[levels - 1]
        assert top[1] - cut <= room
        cur = _zero_window(planes[levels], t0 + top[0], top[1] - cut)
        det = _zero_window(planes[levels - 1], t0 + top[2], top[1] - cut)
        for j in range(levels, 0, -1):
            e, length, ed, b_a, st_a, b_d, st_d, _ = level[j - 1]
            s = 1 << (j - 1)
            assert abs(st_a) == abs(st_d) == s
            new_len = level[j - 2][1] - cut if j > 1 else n_out
            # a backward op: the reversed taps from (L-1) s samples earlier
            base_c = b_a + min(st_a, 0) * (taps - 1)
            base_d = b_d + min(st_d, 0) * (taps - 1)
            assert base_c >= 0 and base_d >= 0
            c, d = cur[:, base_c:], det[:, base_d:]
            valid_end = new_len + (taps - 1) * s
            assert valid_end == length - cut and e <= 0
            assert c.shape[-1] >= valid_end and d.shape[-1] >= valid_end
            nxt, end = _synthesis_level(c, d, valid_end, s, rows[st_a < 0, "lo"],
                                        rows[st_d < 0, "hi"], taps, R_SYM)
            assert end == new_len
            cur = nxt[:, :new_len]
            if j > 1:  # d_{j-1}, copied once the level is done
                det = _zero_window(planes[j - 2], t0 + level[j - 2][2],
                                   level[j - 2][1] - cut)
        out[:, t0: t0 + n_out] = cur[:, :n_out]
    out[:, :span_l] = head
    out[:, n - span_r:] = tail
    return out


#: (wavelet, levels, n, tile): ragged last tiles, odd rows, rows one sample
#: longer than the two splices (db4 J=6: 441), a row clamped as the tile,
#: haar at J = 10 (strides 256 and 512: passes), bior2.2 (6 taps, padded),
#: a long filter (db20), the launch tile at config #2's depth
SYMMETRIC_CASES = [
    ("haar", 4, 300, 128), ("db4", 3, 701, 256), ("sym8", 2, 900, 256),
    ("bior2.2", 3, 513, 128), ("db4", 6, 1500, 512), ("db4", 6, 442, 442),
    ("sym8", 4, 226, 226), ("db4", 6, 5001, 4096), ("haar", 10, 3001, 1024),
    ("db20", 3, 1203, 1024),
]


@pytest.mark.parametrize("name,levels,n,tile", SYMMETRIC_CASES)
def test_symmetric_forward_walk_reproduces_the_definition(name, levels, n, tile):
    w = vt.wavelet(name)
    filters, ops = _kernel_filters(w, synthesis=True), ms.symmetric_level_ops(w, levels)
    span_l, span_r = mc.symmetric_spans(w.filter_length, ops)
    rng = np.random.default_rng(50)
    planes = [rng.standard_normal((2, n)) for _ in range(levels + 1)]
    head, tail = rng.standard_normal((2, span_l)), rng.standard_normal((2, span_r))
    want = mc.symmetric_synthesis_plain([torch.from_numpy(p) for p in planes],
                                        torch.from_numpy(head), torch.from_numpy(tail),
                                        levels, filters, ops)
    got = walk_symmetric(planes, head, tail, filters, ops, tile)
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=TOL)


def test_every_symmetric_op_reads_from_its_windows_start():
    """The plan puts each window where its op's first read falls: a
    forward run's base is 0 for both ops of every level, so the block's
    rows hold no sample a level does not read."""
    for name, levels in (("db4", 6), ("sym8", 4), ("haar", 10), ("bior2.2", 5),
                         ("coif2", 3)):
        w = vt.wavelet(name)
        taps, ops = w.filter_length, ms.symmetric_level_ops(w, levels)
        plan, _ = mc.symmetric_plan(taps, ops, 1024, False)
        for j in range(levels):
            b_a, st_a, b_d, st_d = plan[mc.PLAN_STRIDE * j + 3: mc.PLAN_STRIDE * j + 7]
            assert b_a + min(st_a, 0) * (taps - 1) == 0
            assert b_d + min(st_d, 0) * (taps - 1) == 0


def _exact_window(x_hi, x_lo, g, periodic, halo):
    """The window's (hi, lo) rows at the samples g < n: the row; before 0
    wrapped, the halo (lo word 0) or zeros."""
    n = x_hi.shape[-1]
    vh = np.zeros((x_hi.shape[0], len(g)), np.float32)
    vl = np.zeros_like(vh)
    inside = g >= 0
    vh[:, inside] = x_hi[:, g[inside]]
    if x_lo is not None:
        vl[:, inside] = x_lo[:, g[inside]]
    before = ~inside
    if halo is not None:
        h = halo.shape[-1] + g
        take = before & (h >= 0)
        vh[:, take] = halo[:, h[take]]
    elif periodic:
        m = g[before] % n
        vh[:, before] = x_hi[:, m]
        if x_lo is not None:
            vl[:, before] = x_lo[:, m]
    return vh.astype(np.float64) + vl.astype(np.float64)


def _pair_level(cur, valid, width, s, lo, hi, taps, on_detail):
    """One analysis level of fp64 pair runs of R_EXACT outputs over window
    indices [valid + (L-1) s, width), with the details staged by warps at
    strides below 8; returns the next row and the level's first exact
    index."""
    lp = len(lo)
    start = valid + (taps - 1) * s
    nxt = np.full_like(cur, np.nan)
    written = np.zeros(width, int)
    group = max(s, THREADS)
    for c0 in range(start, width, group * R_EXACT):
        for q0 in _starts(c0, s, R_EXACT):
            lim = np.where(q0 < width, np.minimum(R_EXACT, (width - q0 + s - 1) // s), 0)
            guard = (lim < R_EXACT) | (lp != taps)
            m = np.arange(1 - lp, R_EXACT)
            idx = q0[:, None] + s * m[None]
            load = (lim > 0)[:, None] & (~guard[:, None]
                                         | ((m >= 1 - taps) & (m < lim[:, None])))
            if load.any():
                assert idx[load].min() >= valid and idx[load].max() < width
            w = np.where(load, cur[:, np.clip(idx, 0, width - 1)], 0.0)
            a = np.zeros((cur.shape[0], THREADS, R_EXACT))
            d = np.zeros_like(a)
            for r in range(R_EXACT):
                v = w[:, :, r - np.arange(lp) + lp - 1]  # w[r - t]
                a[:, :, r], d[:, :, r] = v @ lo, v @ hi
                on = r < lim
                q = q0[on] + r * s
                nxt[:, q] = a[:, on, r]
                written[q] += 1
            if s < STAGED_STRIDE:
                for warp in range(THREADS // 32):
                    lanes = slice(32 * warp, 32 * (warp + 1))
                    cw0 = c0 + 32 * warp * R_EXACT
                    staged = np.full((cur.shape[0], 32 * R_EXACT), np.nan)
                    slot = (q0[lanes][:, None] - cw0 + s * np.arange(R_EXACT)[None])
                    assert sorted(slot.ravel()) == list(range(32 * R_EXACT))
                    staged[:, slot.ravel()] = d[:, lanes].reshape(cur.shape[0], -1)
                    # the warp stores its 32 R outputs on consecutive addresses
                    i = np.arange(32 * R_EXACT)
                    q = cw0 + i
                    inside = q < width  # past the window: a run's unused sums
                    on_detail(q[inside], staged[:, inside])
            else:
                for r in range(R_EXACT):
                    on = r < lim
                    on_detail(q0[on] + r * s, d[:, on, r])
    assert (written[start:] == 1).all() and not written[:start].any()
    return nxt, start


def _split(v):
    """store_pair: hi the float32 round of v, lo that of the rest."""
    h = v.astype(np.float32)
    return h, (v - h.astype(np.float64)).astype(np.float32)


def walk_exact_analysis(x_hi, x_lo, fd, levels, first, tile, periodic, halo=None):
    """The exact analysis kernel replayed block by block; returns the
    levels + 1 (hi, lo) pairs."""
    lo, hi = _padded(fd[0]), _padded(fd[1])
    taps = len(fd[0])
    b, n = x_hi.shape
    span = mc.composite_halo_samples(taps, levels) << (first - 1)
    planes = [np.full((b, n), np.nan) for _ in range(levels + 1)]
    for t0 in range(0, n, tile):
        n_out = min(tile, n - t0)
        width = n_out + span
        assert width + 3 <= _row_floats(tile + span)  # each half of slot a
        cur = _exact_window(x_hi, x_lo, t0 - span + np.arange(width), periodic, halo)
        valid = 0
        for i in range(levels):
            stored = np.zeros(n_out, int)

            def on_detail(q, d, i=i, stored=stored):
                o = q - span
                keep = (o >= 0) & (o < n_out)
                planes[i][:, t0 + o[keep]] = d[:, keep]
                np.add.at(stored, o[keep], 1)

            cur, valid = _pair_level(cur, valid, width, 1 << (first - 1 + i), lo, hi, taps,
                                     on_detail)
            assert (stored == 1).all()
        planes[levels][:, t0: t0 + n_out] = cur[:, span: span + n_out]
    return [_split(p) for p in planes]


def _pair(shape, seed):
    v = np.random.default_rng(seed).standard_normal(shape)
    return _split(v)


#: (wavelet, levels, first level, batch, n, periodic, lo word, left halo or
#: None, tile): J = 1, 6, 10; later first levels (strides 8-32, and 256 and
#: 512: passes); haar, sym8 and db20; rows shorter than the span (wrapped
#: more than once); halos shorter than, equal to and longer than the span;
#: odd rows; ragged last tiles; tiles from 64 (the library's least) to 4096
EXACT_CASES = [
    ("db4", 6, 1, 2, 2500, True, False, None, 1024),
    ("db4", 6, 1, 2, 2501, False, True, None, 2048),
    ("db4", 6, 1, 1, 300, True, True, None, 300), ("db4", 6, 1, 1, 2500, False, False, 100, 2048),
    ("db4", 6, 1, 1, 1100, False, True, 441, 512), ("sym8", 4, 1, 1, 3000, False, False, 700, 4096),
    ("db4", 3, 4, 1, 2000, True, True, None, 512), ("db4", 2, 9, 1, 4100, True, True, None, 4096),
    ("haar", 10, 1, 1, 2100, True, False, None, 1024), ("db20", 3, 1, 1, 1500, False, False, None, 256),
    ("db4", 6, 1, 1, 9001, True, False, None, 4096), ("db4", 1, 10, 1, 800, False, True, None, 64),
]


@pytest.mark.parametrize("name,levels,first,b,n,periodic,with_lo,h,tile", EXACT_CASES)
def test_exact_analysis_walk_reproduces_the_plain_cascade(name, levels, first, b, n, periodic,
                                                          with_lo, h, tile):
    fd = _kernel_filters(vt.wavelet(name), synthesis=False)
    x_hi, x_lo = _pair((b, n), 60)
    x_lo = x_lo if with_lo else None
    halo = None if h is None else np.random.default_rng(61).standard_normal((b, h)).astype(
        np.float32)
    got = walk_exact_analysis(x_hi, x_lo, fd, levels, first, tile, periodic, halo)
    want = mc.exact_analysis_plain(torch.from_numpy(x_hi),
                                   None if x_lo is None else torch.from_numpy(x_lo), levels,
                                   fd, periodic, first,
                                   None if halo is None else torch.from_numpy(halo))
    for (gh, gl), (wh, wl) in zip(got, want):
        np.testing.assert_allclose(gh.astype(np.float64) + gl,
                                   wh.double().numpy() + wl.double().numpy(),
                                   rtol=0, atol=TOL)


@pytest.mark.parametrize("s", [1, 2, 4])
def test_exact_staging_fills_each_warps_buffer_once_on_distinct_bank_pairs(s):
    """Below stride 8 a warp's lanes write their 5 fp64 details each into
    its buffer at q0 - cw0 + r s: the 32 x 5 slots once each, and each half
    warp's eight-byte writes of one r on 16 distinct bank pairs."""
    q0 = _starts(0, s, R_EXACT)[0]
    for warp in range(THREADS // 32):
        lanes = q0[32 * warp: 32 * (warp + 1)]
        slots = (lanes[:, None] - 32 * warp * R_EXACT + s * np.arange(R_EXACT)[None]).ravel()
        assert sorted(slots) == list(range(32 * R_EXACT))
        for r in range(R_EXACT):
            for half in (lanes[:16], lanes[16:]):
                assert len(set((half - 32 * warp * R_EXACT + r * s) % 16)) == 16
