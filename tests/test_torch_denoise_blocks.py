"""The fused denoise and exact synthesis CUDA kernels (``csrc/modwt_denoise.cu``,
``csrc/modwt_exact_synthesis.cu``) walked in numpy, block by block.

The kernels cannot run here, so their index arithmetic is replayed as it
stands in the sources: every block's window and its edge rule (wrap, zero,
or the stream mode's halo), each level's chunks, passes and per-thread runs
(``run_base``, kRunBlock = 9 outputs in fp32, kExactBlock = 9 in fp64),
the samples a run loads (all of them, or with ``kGuard`` only those its
outputs need, the taps zero-padded to whole steps of 8), the denoise's
thresholded plane rows and their zero-tail rule, and the exact kernel's
three slots and its copy schedule.
The walk asserts that no load leaves the part of a window or a row that is
exact at that level, that every output is written once, and that the
result equals :func:`modwt_composite.denoise_plain` and
:func:`modwt_composite.exact_synthesis_plain` in float64 within 1e-12 (the
same arithmetic in another order).  The shapes reach each path: J = 1, 6, 9
and 10, haar and a long filter, rows shorter than the span, ragged last
tiles, stream halos shorter than the span, and tiles from 128 to the row
(the library clamps its preferred tile to the row and halves it until a
block fits, so a launch may take any of them).
"""

import numpy as np
import pytest
import torch

from chip_smoke import gap_thresholds
from vectorwave_tpu_torch.kernels import modwt_composite as mc

from .test_torch_cascade_blocks import THREADS, _filters, _padded

TOL = 1e-12
#: outputs a thread's run holds: the fp32 kernels' kRunBlock, the exact
#: synthesis's kExactBlock
R_F32 = 9
R_F64 = 9


def _starts(c0, s, block):
    """q0 of every thread, one array a pass, for the chunk at c0: run_base
    for s <= kThreads, else s / kThreads passes of consecutive residues."""
    tid = np.arange(THREADS)
    if s <= THREADS:
        shift = s.bit_length() - 1
        return [c0 + (tid & (s - 1)) + ((tid >> shift) << shift) * block]
    return [c0 + p + tid for p in range(0, s, THREADS)]


def _x_window(x, g, periodic, halo):
    """x at the samples g by the denoise's edge rule: wrapped; or zero
    outside [0, n), with the stream halo before 0."""
    n = x.shape[-1]
    if periodic:
        return x[:, g % n]
    out = np.zeros((x.shape[0], len(g)))
    inside = (g >= 0) & (g < n)
    out[:, inside] = x[:, g[inside]]
    if halo is not None:
        h = halo.shape[-1] + g
        take = (g < 0) & (h >= 0)
        out[:, take] = halo[:, h[take]]
    return out


def _shrink(d, t, mode):
    if mode == "soft":
        return d - np.minimum(np.maximum(d, -t), t)
    if mode == "hard":
        return np.where(np.abs(d) > t, d, 0.0)
    return d


def _analysis_level(cur, valid, width, s, lo, hi, taps, on_output):
    """One analysis level of fp32 runs over window indices [valid + (L-1)s,
    width); returns the next row and the level's first exact index."""
    lp = len(lo)
    first = valid + (taps - 1) * s
    nxt = np.full_like(cur, np.nan)
    written = np.zeros(width, int)
    for c0 in range(first, width, max(s, THREADS) * R_F32):
        for q0 in _starts(c0, s, R_F32):
            q0 = q0[q0 < width]
            if not len(q0):
                continue
            lim = np.minimum(R_F32, (width - q0 + s - 1) // s)
            guard = (lim < R_F32) | (lp != taps)
            m = np.arange(1 - lp, R_F32)
            idx = q0[:, None] + s * m[None]
            load = ~guard[:, None] | ((m >= 1 - taps) & (m < lim[:, None]))
            assert idx[load].min() >= valid and idx[load].max() < width
            w = np.where(load, cur[:, np.clip(idx, 0, width - 1)], 0.0)
            for r in range(R_F32):
                v = w[:, :, r - np.arange(lp) + lp - 1]  # w[r - t]
                on = r < lim
                q = q0[on] + r * s
                nxt[:, q] = (v @ lo)[:, on]
                written[q] += 1
                on_output(q, (v @ hi)[:, on])
    assert (written[first:] == 1).all() and not written[:first].any()
    return nxt, first


def _synthesis_level(c, det, valid_end, s, lo, hi, taps, block):
    """One synthesis level of forward runs into [0, valid_end - (L-1)s)."""
    lp = len(lo)
    new_end = valid_end - (taps - 1) * s
    out = np.full((c.shape[0], valid_end), np.nan)
    written = np.zeros(valid_end, int)
    for c0 in range(0, new_end, max(s, THREADS) * block):
        for q0 in _starts(c0, s, block):
            q0 = q0[q0 < new_end]
            if not len(q0):
                continue
            lim = np.minimum(block, (new_end - q0 + s - 1) // s)
            guard = (lim < block) | (lp != taps)
            m = np.arange(block + lp - 1)
            idx = q0[:, None] + s * m[None]
            load = ~guard[:, None] | (m < (lim + taps - 1)[:, None])
            assert idx[load].max() < valid_end
            assert c.shape[-1] >= valid_end and det.shape[-1] >= valid_end
            safe = np.clip(idx, 0, valid_end - 1)
            wc = np.where(load, c[:, safe], 0.0)
            wd = np.where(load, det[:, safe], 0.0)
            for r in range(block):
                acc = wc[:, :, r: r + lp] @ lo + wd[:, :, r: r + lp] @ hi
                on = r < lim
                q = q0[on] + r * s
                out[:, q] = acc[:, on]
                written[q] += 1
    assert (written[:new_end] == 1).all() and not written[new_end:].any()
    return out, new_end


def walk_denoise(x, th, fd, fr, levels, tile, periodic, mode, halo=None):
    """The denoise kernel replayed block by block; returns x_hat."""
    a_lo, a_hi = _padded(fd[0]), _padded(fd[1])
    r_lo, r_hi = _padded(fr[0]), _padded(fr[1])
    taps = len(fd[0])
    b, n = x.shape
    span = mc.composite_halo_samples(taps, levels)
    out = np.full((b, n), np.nan)
    for t0 in range(0, n, tile):
        n_out = min(tile, n - t0)
        width, pw = n_out + 2 * span, n_out + span
        keep = pw if periodic else min(pw, n - t0)
        cur = _x_window(x, t0 - span + np.arange(width), periodic, halo)
        planes = [np.full((b, n_out + mc.composite_halo_samples(taps, j)), np.nan)
                  for j in range(1, levels + 1)]
        stored = [np.zeros(p.shape[-1], int) for p in planes]
        valid = 0
        for j in range(1, levels + 1):
            plane_end = span + planes[j - 1].shape[-1]

            def store(q, d, j=j, plane_end=plane_end):
                st = (q >= span) & (q < plane_end)
                v = _shrink(d[:, st], th[:, j - 1: j], mode)
                v[:, q[st] >= span + keep] = 0.0  # the zero tail
                planes[j - 1][:, q[st] - span] = v
                stored[j - 1][q[st] - span] += 1

            cur, valid = _analysis_level(cur, valid, width, 1 << (j - 1), a_lo, a_hi,
                                         taps, store)
        assert all((k == 1).all() for k in stored)
        c = cur[:, span:].copy()
        c[:, keep:pw] = 0.0
        valid_end = pw
        for j in range(levels, 0, -1):
            assert planes[j - 1].shape[-1] == valid_end
            c, valid_end = _synthesis_level(c, planes[j - 1], valid_end, 1 << (j - 1),
                                            r_lo, r_hi, taps, R_F32)
        assert valid_end == n_out
        out[:, t0: t0 + n_out] = c[:, :n_out]
    return out


def _pair_window(hi, lo, g, periodic, halo):
    """A (hi, lo) plane at the samples g >= 0 as doubles, hi + lo: the row,
    then wrapped, the right halo pair, or zeros."""
    n = hi.shape[-1]
    vh = np.zeros((hi.shape[0], len(g)), np.float32)
    vl = np.zeros_like(vh)
    inside = g < n
    vh[:, inside], vl[:, inside] = hi[:, g[inside]], lo[:, g[inside]]
    past = ~inside
    if periodic:
        vh[:, past], vl[:, past] = hi[:, g[past] % n], lo[:, g[past] % n]
    elif halo is not None:
        k = g - n
        take = past & (k < halo[0].shape[-1])
        vh[:, take], vl[:, take] = halo[0][:, k[take]], halo[1][:, k[take]]
    return vh.astype(np.float64) + vl.astype(np.float64)


def walk_exact_synthesis(pairs, fr, levels, first, tile, periodic, halo=None):
    """The exact synthesis kernel replayed block by block, with its three
    slots: the approximation, the detail and the level's output, the next
    detail copied once the level is done.  Returns (hi, lo)."""
    lo, hi = _padded(fr[0]), _padded(fr[1])
    taps = len(fr[0])
    b, n = pairs[0][0].shape
    span = mc.composite_halo_samples(taps, levels) << (first - 1)
    out_hi, out_lo = np.full((b, n), np.nan, np.float32), np.full((b, n), np.nan, np.float32)
    for t0 in range(0, n, tile):
        n_out = min(tile, n - t0)
        slots = {}  # slot -> (what, values)
        in_flight = set()

        def copy(slot, i, count):
            g = t0 + np.arange(count)
            h = None if halo is None else halo[i]
            slots[slot] = (("pair", i), _pair_window(*pairs[i], g, periodic, h))
            in_flight.add(slot)

        c_slot, d_slot, o_slot = 0, 1, 2
        valid_end = n_out + span
        copy(c_slot, levels, valid_end)
        copy(d_slot, levels - 1, valid_end)
        for i in range(levels - 1, -1, -1):
            s = 1 << (first - 1 + i)
            new_end = valid_end - (taps - 1) * s
            in_flight.clear()  # cp.async.wait_all, then the barrier
            # the level reads the landed slots and writes the third
            assert o_slot not in (c_slot, d_slot) and c_slot != d_slot
            assert slots[d_slot][0] == ("pair", i)
            assert slots[c_slot][0] in (("pair", levels), ("double", i + 1))
            c = slots[c_slot][1]
            det = slots[d_slot][1]
            assert c.shape[-1] >= valid_end and det.shape[-1] >= valid_end
            res, _ = _synthesis_level(c, det, valid_end, s, lo, hi, taps, R_F64)
            slots[o_slot] = (("double", i), res)
            if i > 0:  # after the level's barrier: d_i is read
                copy(d_slot, i - 1, new_end)
            c_slot, o_slot = o_slot, c_slot
            valid_end = new_end
        assert not in_flight and valid_end == n_out
        v = slots[c_slot][1][:, :n_out]
        h32 = v.astype(np.float32)
        out_hi[:, t0: t0 + n_out] = h32
        out_lo[:, t0: t0 + n_out] = (v - h32.astype(np.float64)).astype(np.float32)
    return out_hi, out_lo


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


#: (wavelet, levels, batch, n, periodic, stream halo or None, tile): J = 1,
#: 6, 9, 10; haar and db20; rows shorter than the span (db4 J=6 at 300,
#: haar J=10 at 700); ragged last tiles; halos shorter and longer than the
#: span; tiles from 128 to the row
DENOISE_CASES = [
    ("db4", 6, 2, 2500, True, None, 1024), ("db4", 6, 2, 2500, False, None, 1024),
    ("db4", 6, 2, 300, True, None, 300), ("db4", 6, 1, 2500, False, 100, 1024),
    ("db4", 6, 1, 1100, False, 441, 512), ("db4", 1, 2, 1000, True, None, 128),
    ("haar", 10, 1, 700, True, None, 700), ("haar", 9, 1, 2100, False, 300, 1024),
    ("db20", 3, 1, 1500, True, None, 256), ("db4", 6, 1, 5000, True, None, 4096),
    ("db4", 6, 1, 5000, False, None, 2048), ("db4", 6, 1, 4500, False, 441, 2048),
]


@pytest.mark.parametrize("mode", ["none", "soft", "hard"])
@pytest.mark.parametrize("name,levels,b,n,periodic,h,tile", DENOISE_CASES)
def test_denoise_kernel_walk_reproduces_the_plain_denoise(name, levels, b, n, periodic,
                                                          h, tile, mode):
    fd, fr = _filters(name)
    x = _x((b, n), 40)
    halo = None if h is None else _x((b, h), 41)
    xt, ht = torch.from_numpy(x), None if halo is None else torch.from_numpy(halo)
    planes = (mc._analysis_cascade(xt, levels, fd, periodic) if ht is None
              else mc._external_cascade(xt, ht, levels, fd))
    th = gap_thresholds(planes, levels).double()
    got = walk_denoise(x, th.numpy(), fd, fr, levels, tile, periodic, mode, halo)
    want = mc.denoise_plain(xt, th, levels, fd, fr, periodic, mode, ht)
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=TOL)


#: (wavelet, levels, first level, batch, n, periodic, right halo or None,
#: tile): J = 1, 6, 9, 10; a later first level (a split plan's coarser
#: launch); haar, sym8 and db20; rows shorter than the span; right halos
#: shorter than the span; tiles from 128 to the row, 4096 (the launch tile
#: at config #2) with a ragged last tile
EXACT_CASES = [
    ("db4", 6, 1, 2, 2500, True, None, 2048), ("db4", 6, 1, 2, 2500, False, None, 1024),
    ("db4", 6, 1, 1, 2500, False, 100, 2048), ("db4", 6, 1, 2, 300, True, None, 300),
    ("db4", 2, 3, 1, 2000, False, None, 512), ("db4", 1, 1, 1, 700, True, None, 128),
    ("sym8", 9, 1, 1, 3000, True, None, 2048), ("haar", 10, 1, 1, 1500, True, None, 1500),
    ("sym8", 1, 10, 1, 1200, False, None, 1024), ("db4", 6, 1, 1, 9000, True, None, 4096),
    ("db4", 6, 1, 1, 5000, False, 441, 4096), ("haar", 10, 1, 1, 2100, False, 300, 1024),
    ("sym8", 4, 1, 2, 3000, False, 50, 256), ("db20", 3, 1, 1, 2500, True, None, 2048),
]


@pytest.mark.parametrize("name,levels,first,b,n,periodic,h,tile", EXACT_CASES)
def test_exact_synthesis_walk_reproduces_the_plain_inverse(name, levels, first, b, n,
                                                           periodic, h, tile):
    _, fr = _filters(name)
    rng = np.random.default_rng(44)
    pairs = []
    for _ in range(levels + 1):
        v = rng.standard_normal((b, n))
        hi = v.astype(np.float32)
        pairs.append((hi, (v - hi.astype(np.float64)).astype(np.float32)))
    halo = None
    if h is not None:
        halo = []
        for _ in range(levels + 1):
            v = rng.standard_normal((b, h))
            hi = v.astype(np.float32)
            halo.append((hi, (v - hi.astype(np.float64)).astype(np.float32)))
    got = walk_exact_synthesis(pairs, fr, levels, first, tile, periodic, halo)
    tp = [tuple(torch.from_numpy(t) for t in p) for p in pairs]
    th = None if halo is None else [tuple(torch.from_numpy(t) for t in p) for p in halo]
    want = mc.exact_synthesis_plain(tp, levels, fr, periodic, first, th)
    np.testing.assert_allclose(got[0].astype(np.float64) + got[1],
                               want[0].double().numpy() + want[1].double().numpy(),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("s", [1, 2, 4, 8, 16, 32])
def test_exact_runs_cover_each_chunk_once_on_distinct_bank_pairs(s):
    """kExactBlock = 9 outputs a thread: each output of a chunk once, and
    each half warp's eight-byte loads of one run sample on 16 distinct bank
    pairs."""
    starts = _starts(0, s, R_F64)[0]
    outs = (starts[:, None] + s * np.arange(R_F64)[None]).ravel()
    assert sorted(outs) == list(range(max(s, THREADS) * R_F64))
    for half in range(THREADS // 16):
        lanes = starts[16 * half: 16 * (half + 1)]
        assert len(set(lanes % 16)) == 16
