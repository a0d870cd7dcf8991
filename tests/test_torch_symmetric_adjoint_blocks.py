"""The symmetric synthesis's adjoint kernel (``csrc/modwt_symmetric_synthesis.cu``,
adjoint mode) walked in numpy, block by block and row by row.

The kernel cannot run here, so its index arithmetic is replayed as it stands
in the source: each block's window of the cotangent from the plan
(``symmetric_plan(..., adjoint=True)``, made for the launch tile, each
window shortened by tile - n_out in a ragged last block), read as zero
outside the interior [span_l, n - span_r), and where it lands in its shared
row (its part inside the interior on its source's place modulo 16 bytes in
float32, on a 4-byte pair in bfloat16); every op turned into a forward run
(a backward op reads the reversed taps, zero-padded after the reversal, from
(L-1) s samples earlier); the runs of kSymBlock = 9 outputs a thread on each
residue class (``run_base``, or passes of consecutive residues above stride
256) with ``kGuard`` where a run reaches past its positions or reads padded
taps; a level's two ops as one pair run over the union of their outputs
where that union is at most 5/8 of both ranges, with grad d_j staged by
warps below stride 8 where the buffers fit (else two runs, unstaged).  The walk asserts
that no load leaves the part of a row its level holds, that every output is
written once, and that the result equals
:func:`modwt_composite.symmetric_adjoint_plain` within 1e-12
(the same arithmetic in another order).
"""

import numpy as np
import pytest
import torch

import vectorwave_tpu_torch as vt
from vectorwave_tpu_torch.kernels import modwt_composite as mc
from vectorwave_tpu_torch.kernels import modwt_symmetric as ms
from vectorwave_tpu_torch.kernels.modwt_fused import _kernel_filters

from .test_torch_cascade_blocks import THREADS, _padded
from .test_torch_denoise_blocks import _starts
from .test_torch_symmetric_exact_blocks import _row_floats

TOL = 1e-12
#: the kernel's kSymBlock, kAdjointStagedStride, kAdjointExcess
R = 9
STAGED_STRIDE = 8
EXCESS = 3
STAGE_FLOATS = THREADS * R


def adjoint_bytes(taps, levels, tile, stage):
    """symmetric_adjoint_bytes: four padded tap rows, two rows of tile + S +
    kAdjointExcess and, with `stage`, the staging buffers."""
    span = mc.composite_halo_samples(taps, levels)
    return 4 * (4 * len(_padded(np.zeros(taps))) + 2 * _row_floats(tile + span + EXCESS)
                + (STAGE_FLOATS if stage else 0))


def adjoint_shared_bytes(taps, levels, tile):
    stage = adjoint_bytes(taps, levels, tile, True) <= mc.SHARED_LIMIT
    return adjoint_bytes(taps, levels, tile, stage)


def adjoint_tile(taps, levels, n, preferred=mc.SYMMETRIC_ADJOINT_LAUNCH_TILE):
    """symmetric_adjoint_tile: cascade_tile's halving from the preferred tile
    clamped to the row, then below 128 only where 128 does not fit."""
    fits = lambda t: adjoint_shared_bytes(taps, levels, t) <= mc.SHARED_LIMIT  # noqa: E731
    t = min(n, preferred)
    while t > 128 and not fits(t):
        t = max(t // 2, 128)
    if fits(t):
        return t
    u = min(n, 64)
    while u >= 1:
        if fits(u):
            return u
        u //= 2
    return 0


def _runs(row, start, end, base, p0, p1, s, tap_rows, taps):
    """The runs of one level over positions [p0, p1): for each pass, (c0, q0,
    lim, sums), sums[k][thread, r] the sum of tap_rows[k] . row[base + q0 +
    r s + s m], every load inside [start, end)."""
    lp = len(tap_rows[0])
    out = []
    for c0 in range(p0, p1, max(s, THREADS) * R):
        for q0 in _starts(c0, s, R):
            lim = np.where(q0 < p1, np.minimum(R, (p1 - q0 + s - 1) // s), 0)
            guard = (lim < R) | (lp != taps)
            m = np.arange(R + lp - 1)
            idx = base + q0[:, None] + s * m[None]
            load = (lim > 0)[:, None] & (~guard[:, None] | (m[None] < (lim + taps - 1)[:, None]))
            if load.any():
                assert idx[load].min() >= start and idx[load].max() < end
            w = np.where(load, row[np.clip(idx, 0, len(row) - 1)], 0.0)
            sums = [np.stack([w[:, r: r + lp] @ t for r in range(R)], axis=1)
                    for t in tap_rows]
            out.append((c0, q0, lim, sums))
    return out


def _store_details(passes, k, s, delta, n_out, staged, on_detail):
    """grad d_j of a level's passes (sums[k]) at q = p - delta in [0, n_out):
    from registers, or through each warp's staging buffer."""
    for c0, q0, lim, sums in passes:
        d = sums[k]
        if staged:
            for warp in range(THREADS // 32):
                lanes = slice(32 * warp, 32 * (warp + 1))
                cw0 = c0 + 32 * warp * R
                slot = (q0[lanes][:, None] - cw0 + s * np.arange(R)[None]).ravel()
                assert sorted(slot) == list(range(32 * R))
                buf = np.full(32 * R, np.nan)
                buf[slot] = d[lanes].ravel()
                # the warp stores its 32 R outputs on consecutive addresses
                q = cw0 + np.arange(32 * R) - delta
                keep = (q >= 0) & (q < n_out)
                on_detail(q[keep], buf[keep])
        else:
            for r in range(R):
                q = q0 + r * s - delta
                keep = (r < lim) & (q >= 0) & (q < n_out)
                on_detail(q[keep], d[keep, r])


def walk_adjoint(c, filters, ops, tile, span_l, span_r, bfloat16=False):
    """The adjoint kernel replayed block by block on each row; returns the
    J+1 planes and the number of levels run as one pair run."""
    lo, hi = np.asarray(filters[0]), np.asarray(filters[1])
    taps = len(lo)
    rows = {(False, "lo"): _padded(lo), (True, "lo"): _padded(lo[::-1]),
            (False, "hi"): _padded(hi), (True, "hi"): _padded(hi[::-1])}
    levels = len(ops)
    b, n = c.shape
    span = mc.composite_halo_samples(taps, levels)
    plan, width = mc.symmetric_plan(taps, ops, tile, True)
    assert width <= tile + span + EXCESS
    row_floats = _row_floats(tile + span + EXCESS)
    stage = adjoint_bytes(taps, levels, tile, True) <= mc.SHARED_LIMIT
    level = [plan[mc.PLAN_STRIDE * j: mc.PLAN_STRIDE * (j + 1)] for j in range(levels)]
    outs = [np.full((b, n), np.nan) for _ in range(levels + 1)]
    merged = 0
    for bi in range(b):
        for t0 in range(0, n, tile):
            n_out = min(tile, n - t0)
            cut = tile - n_out
            # v_0: copy_zero_window over [g0, g0 + count), zero outside the
            # interior, landing on its source's place modulo 16 bytes
            g0, count = t0 + level[0][0], level[0][1] - cut
            first, end = max(g0, span_l), min(g0 + count, n - span_r)
            inside = max(end - first, 0)
            before = first - g0 if inside else count
            place = 0 if bfloat16 else (bi * n + first) % 4
            off = (place - before) & 3 if inside else 0
            assert off + count <= row_floats
            cur = np.full(row_floats, np.nan)
            g = g0 + np.arange(count)
            keep = (g >= span_l) & (g < n - span_r)
            cur[off: off + count] = np.where(keep, c[bi, np.clip(g, 0, n - 1)], 0.0)
            valid = (off, off + count)
            for j in range(1, levels + 1):
                _, _, b_a, st_a, b_d, st_d, _, _ = level[j - 1]
                s = 1 << (j - 1)
                assert abs(st_a) == abs(st_d) == s
                v_len = level[j][1] - cut if j < levels else n_out
                base_a = valid[0] + b_a + min(st_a, 0) * (taps - 1)
                base_d = valid[0] + b_d + min(st_d, 0) * (taps - 1)
                delta = base_d - base_a
                staged = stage and s < STAGED_STRIDE
                nxt = np.full(row_floats, np.nan)
                v_written = np.zeros(row_floats, int)
                d_written = np.zeros(n_out, int)
                plane = outs[j - 1]

                def on_detail(q, v, plane=plane, d_written=d_written, t0=t0, bi=bi):
                    plane[bi, t0 + q] = v
                    np.add.at(d_written, q, 1)

                def on_v(passes, k):
                    for _, q0, lim, sums in passes:
                        for r in range(R):
                            p = q0 + r * s
                            keep = (r < lim) & (p >= 0) & (p < v_len)
                            nxt[p[keep]] = sums[k][keep, r]
                            np.add.at(v_written, p[keep], 1)

                lo_row, hi_row = rows[st_a < 0, "lo"], rows[st_d < 0, "hi"]
                p0, p1 = min(0, delta), max(v_len, delta + n_out)
                if 8 * (p1 - p0) <= 5 * (v_len + n_out):
                    merged += 1
                    passes = _runs(cur, *valid, base_a, p0, p1, s, (lo_row, hi_row), taps)
                    on_v(passes, 0)
                    _store_details(passes, 1, s, delta, n_out, staged, on_detail)
                else:
                    on_v(_runs(cur, *valid, base_a, 0, v_len, s, (lo_row,), taps), 0)
                    passes = _runs(cur, *valid, base_d, 0, n_out, s, (hi_row,), taps)
                    _store_details(passes, 0, s, 0, n_out, False, on_detail)
                assert (v_written[:v_len] == 1).all() and not v_written[v_len:].any()
                assert (d_written == 1).all()
                cur, valid = nxt, (0, v_len)
            outs[levels][bi, t0: t0 + n_out] = cur[:n_out]
    return outs, merged


def _case(name, levels, n, seed):
    w = vt.wavelet(name)
    filters, ops = _kernel_filters(w, synthesis=True), ms.symmetric_level_ops(w, levels)
    c = np.random.default_rng(seed).standard_normal((3, n))
    return w, filters, ops, c


#: (wavelet, levels, n, tile, interior): config #2's depth at the launch
#: tile and below it (a ragged last block, odd rows), rows one sample longer
#: than the two splices (db4 J=6: 441, sym8 J=4: 225), haar and J = 10
#: (strides 256 and 512: passes), filters with padded taps (db3, db10,
#: coif3), a long filter (db20), a row clamped as the tile, tiles from 64,
#: without and with the interior spans
ADJOINT_CASES = [
    ("db4", 6, 9001, 4096, True), ("db4", 6, 5001, 2048, False), ("db4", 6, 442, 442, True),
    ("sym8", 4, 226, 226, True), ("sym8", 4, 3001, 1024, True), ("haar", 4, 300, 128, True),
    ("haar", 10, 3001, 1024, True), ("db3", 5, 1001, 256, True), ("db10", 3, 1203, 512, True),
    ("coif3", 3, 901, 64, False), ("db20", 3, 1203, 1024, True), ("sym8", 8, 4100, 4096, True),
]


@pytest.mark.parametrize("name,levels,n,tile,interior", ADJOINT_CASES)
def test_adjoint_walk_reproduces_the_definition(name, levels, n, tile, interior):
    w, filters, ops, c = _case(name, levels, n, 70)
    span_l, span_r = mc.symmetric_spans(w.filter_length, ops) if interior else (0, 0)
    want = mc.symmetric_adjoint_plain(torch.from_numpy(c), levels, filters, ops, span_l, span_r)
    got, _ = walk_adjoint(c, filters, ops, tile, span_l, span_r)
    for g, wt in zip(got, want):
        np.testing.assert_allclose(g, wt.numpy(), rtol=0, atol=TOL)


@pytest.mark.parametrize("name,levels,n,tile,split", [
    ("db4", 6, 3072, 1024, False), ("sym8", 4, 3072, 1024, False),
    ("haar", 5, 3072, 1024, False), ("db4", 6, 2500, 256, True), ("sym8", 8, 4100, 4096, True),
    ("db4", 6, 2500, 1024, True), ("bior1.3", 3, 1025, 1024, True),
])
def test_pair_runs_where_the_union_is_short_in_bfloat16_rows(name, levels, n, tile, split):
    """As forward runs both ops of a level read one row a constant shift
    apart, whatever their directions: one pair run a level where their
    union is at most 5/8 of both ranges (every level of a whole block at
    config #2's depths); two runs where v_j's window is much longer than
    the block's outputs (db4 J=6 at a tile of 256, sym8 J=8's levels 1-6, a
    ragged last block of 452) or lies apart from them (bior1.3's one-sample
    last block); the bfloat16 window's place (a 4-byte pair) changes no
    read."""
    w, filters, ops, c = _case(name, levels, n, 71)
    span_l, span_r = mc.symmetric_spans(w.filter_length, ops)
    want = mc.symmetric_adjoint_plain(torch.from_numpy(c), levels, filters, ops, span_l, span_r)
    got, merged = walk_adjoint(c, filters, ops, tile, span_l, span_r, bfloat16=True)
    assert (merged < 3 * levels * -(-n // tile)) == split and merged > 0
    for g, wt in zip(got, want):
        np.testing.assert_allclose(g, wt.numpy(), rtol=0, atol=TOL)


def test_interior_spans_equal_the_masked_cotangent():
    """The plain version's spans are the old mask pass: the adjoint of the
    cotangent zeroed outside [span_l, n - span_r)."""
    w, filters, ops, c = _case("db4", 6, 1500, 72)
    span_l, span_r = mc.symmetric_spans(w.filter_length, ops)
    masked = c.copy()
    masked[:, :span_l] = 0.0
    masked[:, c.shape[-1] - span_r:] = 0.0
    got = mc.symmetric_adjoint_plain(torch.from_numpy(c), 6, filters, ops, span_l, span_r)
    want = mc.symmetric_adjoint_plain(torch.from_numpy(masked), 6, filters, ops)
    for g, wt in zip(got, want):
        assert torch.equal(g, wt)


def test_every_adjoint_window_fits_its_row():
    """Every registered wavelet's adjoint plan, at every depth: its widest
    window is v_0's and reaches at most kAdjointExcess past tile + S, and
    every shape the adjoint gate admits has a tile of at least 128 in the
    library's layout (the card's tests hold the library to it)."""
    served = 0
    for name in vt.available_wavelets():
        w = vt.wavelet(name)
        if not isinstance(w, vt.DiscreteWavelet) or w.filter_length > 128:
            continue
        taps = w.filter_length
        for levels in range(1, 11):
            ops = ms.symmetric_level_ops(w, levels)
            plan, width = mc.symmetric_plan(taps, ops, 1024, True)
            assert plan[1] == width
            assert width <= 1024 + mc.composite_halo_samples(taps, levels) + EXCESS
            if mc.symmetric_tile(taps, ops, True) is not None:
                assert adjoint_tile(taps, levels, 1 << 20) >= 128, (name, levels)
                served += 1
    assert served > 1000
    assert adjoint_tile(8, 6, 1000) == 1000
    assert adjoint_tile(8, 6, 65536) == mc.SYMMETRIC_ADJOINT_LAUNCH_TILE


@pytest.mark.parametrize("s", [1, 2, 4])
def test_adjoint_staging_fills_each_warps_buffer_once(s):
    """Below stride 8 each warp's 32 x 9 positions run on from its first:
    its lanes fill the buffer's slots once each, and each r's writes fall
    on 32 distinct banks."""
    q0 = _starts(0, s, R)[0]
    for warp in range(THREADS // 32):
        lanes = q0[32 * warp: 32 * (warp + 1)]
        slots = (lanes[:, None] - 32 * warp * R + s * np.arange(R)[None]).ravel()
        assert sorted(slots) == list(range(32 * R))
        for r in range(R):
            assert len(set((lanes - 32 * warp * R + r * s) % 32)) == 32
