"""Port parity: the general filter bank (``kernels/modwt_bank.py``).

The JAX counterpart is the ``planes_override`` mode of the composite pair
(``run_analysis_composite`` / ``run_synthesis_composite`` in
``vectorwave_tpu/kernels/modwt_mxu.py``), run here as the JAX package's own
tests run it on the CPU: ``precision='float32'`` in interpret mode.  On the
CPU the port's wrappers run their plain versions; the CUDA kernels cannot run
here, so their windows and register blocks are walked in numpy instead.

Tolerances: 2e-5 against the JAX kernels (float32, another summation order;
the JAX package's own bound in ``tests/test_bank_kernel.py``), 1e-12 against
a direct float64 convolution, 5e-6 of the largest entry for gradients.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorwave_tpu_torch as vt
from vectorwave_tpu.kernels.modwt_mxu import run_analysis_composite, run_synthesis_composite
from vectorwave_tpu.transforms import packets as jpackets
from vectorwave_tpu_torch.errors import InvalidArgumentError
from vectorwave_tpu_torch.kernels import modwt_bank as mb
from vectorwave_tpu_torch.kernels.modwt_composite import LAUNCHES, SHARED_LIMIT
from vectorwave_tpu_torch.transforms import packets as tpackets

torch.set_num_threads(1)

TOL_KERNEL, TOL_F64, TOL_GRAD = 2e-5, 1e-12, 5e-6
UNIT = ((1.0,), (1.0,))


def _random_dense(rng, lengths=(1, 37, 300)):
    """Random dense taps, scaled so that the outputs are of the order of x."""
    return tuple(tuple((rng.standard_normal(k) / math.sqrt(k)).tolist()) for k in lengths)


def _tree_dense(name="db4", depth=3, dec=True):
    return tpackets._tree_dense(vt.wavelet(name), depth, dec)


def _direct_analysis(x, dense, periodic):
    """out_p[t] = sum_tau f_p[tau] x[t - tau], index by index, in float64."""
    b, n = x.shape
    outs = []
    for f in dense:
        out = np.zeros((b, n))
        for tau, v in enumerate(f):
            if v == 0.0:
                continue
            idx = np.arange(n) - tau
            if periodic:
                out += v * x[:, idx % n]
            else:
                out += v * np.where(idx >= 0, x[:, np.maximum(idx, 0)], 0.0)
        outs.append(out)
    return outs


def _direct_synthesis(planes, dense, periodic):
    """out[t] = sum_p sum_tau f_p[tau] c_p[t + tau], in float64."""
    b, n = planes[0].shape
    out = np.zeros((b, n))
    for c, f in zip(planes, dense):
        for tau, v in enumerate(f):
            if v == 0.0:
                continue
            idx = np.arange(n) + tau
            if periodic:
                out += v * c[:, idx % n]
            else:
                out += v * np.where(idx < n, c[:, np.minimum(idx, n - 1)], 0.0)
    return out


CASES = [("random", (2, 2048)), ("random", (3, 1000)), ("tree", (2, 2048)),
         ("tree", (3, 1000))]


def _dense_for(kind, rng, dec=True):
    return _random_dense(rng) if kind == "random" else _tree_dense(dec=dec)


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "zero"])
@pytest.mark.parametrize("kind,shape", CASES)
def test_plain_versions_match_the_jax_bank_kernels(kind, shape, periodic):
    rng = np.random.default_rng(0)
    dense = _dense_for(kind, rng)
    x = rng.standard_normal(shape).astype(np.float32)
    want = run_analysis_composite(jnp.asarray(x), len(dense) - 1, UNIT, periodic, 65536,
                                  "float32", True, planes_override=dense)
    got = mb.bank_analysis(torch.from_numpy(x), dense, periodic)
    assert len(got) == len(dense)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == shape
        assert np.max(np.abs(g.numpy() - np.asarray(w))) <= TOL_KERNEL
    # the synthesis reads the leaves of a tree, or every plane of a random bank
    syn = _tree_dense(dec=False) if kind == "tree" else dense
    planes = [np.array(w) for w in want][-len(syn):]
    y_want = run_synthesis_composite(tuple(jnp.asarray(p) for p in planes), len(syn) - 1,
                                     UNIT, periodic, 65536, "float32", True,
                                     planes_override=syn)
    y_got = mb.bank_synthesis([torch.from_numpy(p) for p in planes], syn, periodic)
    assert np.max(np.abs(y_got.numpy() - np.asarray(y_want))) <= TOL_KERNEL


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "zero"])
@pytest.mark.parametrize("shape,lengths", [((2, 301), (1, 37, 300)), ((2, 150), (1, 37, 300)),
                                           ((3, 64), (5, 130)), ((1, 1), (1, 4))])
def test_plain_versions_match_a_direct_float64_convolution(shape, lengths, periodic):
    rng = np.random.default_rng(1)
    dense = _random_dense(rng, lengths)
    x = rng.standard_normal(shape)
    got = mb.bank_analysis_plain(torch.from_numpy(x), dense, periodic)
    for g, w in zip(got, _direct_analysis(x, dense, periodic)):
        assert g.dtype == torch.float64
        assert np.max(np.abs(g.numpy() - w)) <= TOL_F64
    planes = [rng.standard_normal(shape) for _ in dense]
    y = mb.bank_synthesis_plain([torch.from_numpy(p) for p in planes], dense, periodic)
    assert np.max(np.abs(y.numpy() - _direct_synthesis(planes, dense, periodic))) <= TOL_F64


def test_sparse_taps_skip_the_zeros_of_an_atrous_pair():
    w = vt.wavelet("sym8")
    dense = tpackets._pair_dense(w.dec_lo, w.dec_hi, 16)
    taps = mb.bank_taps(dense)
    assert taps.planes == 2 and taps.nonzeros == 32 and taps.span == 15 * 16
    assert taps.plane(0)[1][0] == 16 and len(dense[0]) == 15 * 16 + 1
    assert mb.bank_taps(dense) is taps  # one table per tap tuple
    # an all-zero plane keeps its place, with no taps
    hole = mb.bank_taps(((0.0, 0.0), (0.0, 2.0)))
    assert hole.starts == (0, 0, 1) and hole.spans == (0, 1)
    x = torch.arange(6.0).reshape(1, 6)
    zero, shifted = mb.bank_analysis(x, ((0.0, 0.0), (0.0, 2.0)), False)
    assert zero.abs().max() == 0 and shifted.tolist() == [[0.0, 0.0, 2.0, 4.0, 6.0, 8.0]]


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "zero"])
def test_analysis_and_synthesis_are_adjoints(periodic):
    rng = np.random.default_rng(2)
    dense = _random_dense(rng)
    x = torch.from_numpy(rng.standard_normal((2, 301)))
    ys = [torch.from_numpy(rng.standard_normal((2, 301))) for _ in dense]
    lhs = sum((a * y).sum() for a, y in zip(mb.bank_analysis(x, dense, periodic), ys))
    rhs = (x * mb.bank_synthesis(ys, dense, periodic)).sum()
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "zero"])
def test_autograd_matches_jax_grad_of_the_bank_cores(periodic):
    rng = np.random.default_rng(3)
    dense = _tree_dense("db4", 2)
    x = rng.standard_normal((2, 1024)).astype(np.float32)
    weights = [rng.standard_normal((2, 1024)).astype(np.float32) for _ in dense]

    def jax_loss(v):
        outs = jpackets._bank_ana_core(v, dense, periodic, "float32", True)
        return sum(jnp.sum(o * jnp.asarray(w)) for o, w in zip(outs, weights))

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = sum((o * torch.from_numpy(w)).sum()
               for o, w in zip(mb.bank_analysis(xt, dense, periodic), weights))
    (got,) = torch.autograd.grad(loss, xt)
    assert np.max(np.abs(got.numpy() - want)) <= TOL_GRAD * np.max(np.abs(want))

    def jax_syn_loss(planes):
        out = jpackets._bank_syn_core(planes, dense, periodic, "float32", True)
        return jnp.sum(out * jnp.asarray(weights[0]))

    planes = tuple(jnp.asarray(w) for w in weights)
    want_p = jax.grad(jax_syn_loss)(planes)
    pt = [torch.from_numpy(w).requires_grad_(True) for w in weights]
    out = mb.bank_synthesis(pt, dense, periodic)
    got_p = torch.autograd.grad((out * torch.from_numpy(weights[0])).sum(), pt)
    for g, w in zip(got_p, want_p):
        w = np.asarray(w)
        assert np.max(np.abs(g.numpy() - w)) <= TOL_GRAD * np.max(np.abs(w))


def test_bfloat16_computes_in_float32_and_rounds_once():
    rng = np.random.default_rng(4)
    dense = _random_dense(rng, (1, 37))
    x = torch.from_numpy(rng.standard_normal((2, 500)).astype(np.float32)).bfloat16()
    got = mb.bank_analysis(x, dense, True)
    want = mb.bank_analysis_plain(x.float(), dense, True)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, w.bfloat16())


def test_cpu_tensors_never_launch_and_wrong_plane_counts_raise():
    before = dict(LAUNCHES)
    dense = ((1.0, 0.5), (0.25,))
    x = torch.ones(1, 8)
    planes = mb.bank_analysis(x, dense, True)
    mb.bank_synthesis(planes, dense, True)
    assert dict(LAUNCHES) == before
    with pytest.raises(InvalidArgumentError, match="expected 2 planes"):
        mb.bank_synthesis(planes[:1], dense, True)
    with pytest.raises(InvalidArgumentError):
        mb.bank_taps(())
    with pytest.raises(InvalidArgumentError):
        mb.bank_taps(((1.0,), ()))


def test_the_cards_gates_on_both_sides():
    """What one launch serves: at most MAX_PLANES planes, and a window of
    TILE + span floats within shared memory; the synthesis holds two
    windows up to the widest span where both fit, one beyond."""
    edge = SHARED_LIMIT // 4 - mb.TILE  # widest span served
    assert mb.analysis_shared_bytes(edge) == SHARED_LIMIT
    assert mb.analysis_shared_bytes(edge + 1) > SHARED_LIMIT
    assert mb.synthesis_shared_bytes(edge, 1) == SHARED_LIMIT
    assert mb.synthesis_shared_bytes(edge + 1, 1) > SHARED_LIMIT
    assert mb.synthesis_stages(0) == 2 and mb.synthesis_stages(edge) == 1
    assert mb.synthesis_stages(TWO_BUFFERS) == 2 and mb.synthesis_stages(TWO_BUFFERS + 1) == 1
    assert mb.synthesis_shared_bytes(TWO_BUFFERS, 2) <= SHARED_LIMIT
    assert mb.synthesis_shared_bytes(TWO_BUFFERS + 1, 2) > SHARED_LIMIT
    assert mb.bank_fits(_tree_dense("sym8", 5))  # 62 planes, span 465
    assert mb.synthesis_stages(465) == 2
    assert not mb.bank_fits(tuple((1.0,) for _ in range(mb.MAX_PLANES + 1)))
    assert mb.bank_fits(tuple((1.0,) for _ in range(mb.MAX_PLANES)))
    assert not mb.bank_fits(((0.0,) * (edge + 1) + (1.0,),))
    assert mb.bank_fits(((0.0,) * edge + (1.0,),))
    # off the CPU (a meta tensor stands for a CUDA one) the wrapper refuses
    # what the kernel cannot take, and never reaches the plain version
    meta = torch.zeros(2, 64, device="meta")
    with pytest.raises(InvalidArgumentError):
        mb.bank_analysis(meta, ((1.0,),), True)
    with pytest.raises(InvalidArgumentError):
        mb.bank_synthesis((meta,), ((1.0,),), True)
    with pytest.raises(InvalidArgumentError, match="at most 64 planes"):
        mb._launch_plan(mb.bank_taps(tuple((1.0,) for _ in range(65))))
    with pytest.raises(InvalidArgumentError, match="shared memory"):
        mb._launch_plan(mb.bank_taps(((0.0,) * (edge + 1) + (1.0,),)))
    # plane groups: one where the (signal, tile) blocks give every SM eight
    assert mb.plane_groups(4096, 30, 132) == 1
    assert mb.plane_groups(8, 30, 132) == 30 and mb.plane_groups(100, 30, 132) == 11


# --- a numpy walk of the CUDA kernels' plan ------------------------------------------

#: The widest span at which two synthesis windows fit shared memory:
#: 2 * 4 * (TILE + span) <= 232448.
TWO_BUFFERS = 232448 // 8 - 2304


def _window(row, g0, count, n, periodic):
    """Samples g0 .. g0 + count of the extended row, as ``bank_load`` of
    modwt_bank_common.cuh reads them: the row inside [0, n), outside it
    zero or the wrap modulo n."""
    g = g0 + np.arange(count)
    inside = (g >= 0) & (g < n)
    if periodic:
        return row[g % n]
    return np.where(inside, row[np.clip(g, 0, n - 1)], 0.0)


def _walk_analysis(x, taps, periodic, groups):
    """modwt_bank_analysis_kernel block by block, its 256 threads as numpy
    rows: a window of n_out + span samples per (signal, tile) (the rest
    NaN), the planes cut into the plane groups, and each thread's RUN_BLOCK
    outputs of one residue class stepping through its plane's runs RUN_CHUNK
    taps at a time, the samples carried from one step to the next as the
    kernel carries them in registers, then the taps left over one at a time.
    Every read must stay inside the window; returns the planes and how often
    each output was written."""
    runs = mb.bank_runs(taps)
    bounds = mb.group_bounds(runs, groups)
    assert bounds[0] == 0 and bounds[-1] == taps.planes and len(bounds) - 1 <= groups
    assert all(a < b for a, b in zip(bounds, bounds[1:]))
    vals = np.asarray(runs.values)
    b, n = x.shape
    span, tile, block, step = taps.span, mb.TILE, mb.RUN_BLOCK, mb.RUN_CHUNK
    outs = [np.full((b, n), np.nan) for _ in range(taps.planes)]
    writes = np.zeros((taps.planes, b, n), dtype=int)
    tid, r = np.arange(mb.THREADS), np.arange(block)
    for row in range(b):
        for t0 in range(0, n, tile):
            n_out = min(tile, n - t0)
            win = np.full(tile + span, np.nan)
            win[:n_out + span] = _window(x[row], t0 - span, n_out + span, n, periodic)
            for p in range(taps.planes):
                shift = runs.shifts[p]
                d = 1 << shift
                base = (tid & (d - 1)) + ((tid >> shift) << shift) * block
                live = base < n_out
                acc = np.zeros((mb.THREADS, block))
                for first, count, start in runs.plane(p):
                    assert start % 4 == 0 and count >= 1
                    src = (base + span - first)[live]

                    def sample(m, src=src, d=d):
                        idx = src[:, None] + np.asarray(m)[None, :] * d
                        assert idx.min() >= 0 and idx.max() < tile + span
                        return win[idx]

                    i0, got = 0, np.zeros((len(src), block))
                    if count >= step:
                        old = sample(np.arange(1, step + 1))
                        while i0 + step <= count:
                            fresh = sample(-(i0 + step - 1) + np.arange(step))
                            both = np.concatenate([fresh, old], axis=1)
                            for t in range(step):
                                got += vals[start + i0 + t] * both[:, r - t + step - 1]
                            old, i0 = fresh, i0 + step
                    for i in range(i0, count):
                        got += vals[start + i] * sample(r - i)
                    acc[live] += got
                o = base[:, None] + r[None, :] * d
                keep = (o < n_out) & live[:, None]
                outs[p][row, t0 + o[keep]] = acc[keep]
                writes[p, row, t0 + o[keep]] += 1
    return outs, writes


def _walk_synthesis(planes, taps, periodic, stages):
    """modwt_bank_synthesis_kernel block by block, its 256 threads as numpy
    rows: every plane's runs on the least stride of the bank, so a thread
    owns the same RUN_BLOCK outputs of one residue class in every plane and
    sums the planes in order into them.  Plane p's window of n_out +
    spans[p] samples goes into buffer p mod ``stages``, poisoned (NaN) when
    its copy is issued: with two buffers plane p + 1's copy is issued before
    plane p's runs, which must then read their own buffer only.  Each thread
    steps through the runs RUN_CHUNK taps at a time with the samples carried
    from one step to the next (forward reads: output r reads w[r + i] for
    tap i), then the taps left over one at a time; the threads whose
    outputs all lie past n_out skip the runs.  Every read must stay inside
    its buffer; returns the signal and how often each output was written."""
    runs = mb.bank_runs(taps, one_stride=True)
    assert len(set(runs.shifts)) == 1 and runs.spans == taps.spans
    vals = np.asarray(runs.values)
    b, n = planes[0].shape
    tile, block, step = mb.TILE, mb.RUN_BLOCK, mb.RUN_CHUNK
    buffer = -(-(tile + taps.span) // 4) * 4
    assert mb.synthesis_shared_bytes(taps.span, stages) == 4 * stages * buffer
    shift = runs.shifts[0]
    d = 1 << shift
    tid, r = np.arange(mb.THREADS), np.arange(block)
    base = (tid & (d - 1)) + ((tid >> shift) << shift) * block
    out = np.full((b, n), np.nan)
    writes = np.zeros((b, n), dtype=int)
    for row in range(b):
        for t0 in range(0, n, tile):
            n_out = min(tile, n - t0)
            live = base < n_out
            bufs = np.zeros((stages, buffer))

            def copy(p, row=row, t0=t0, n_out=n_out, bufs=bufs):
                count = n_out + runs.spans[p]
                bufs[p % stages] = np.nan
                bufs[p % stages, :count] = _window(planes[p][row], t0, count, n, periodic)

            acc = np.zeros((int(live.sum()), block))
            copy(0)
            for p in range(taps.planes):
                if stages == 2 and p + 1 < taps.planes:
                    copy(p + 1)
                win = bufs[p % stages]
                for first, count, start in runs.plane(p):
                    assert start % 4 == 0 and count >= 1
                    src = (base + first)[live]

                    def sample(m, src=src, win=win):
                        idx = src[:, None] + np.asarray(m)[None, :] * d
                        assert idx.min() >= 0 and idx.max() < buffer
                        return win[idx]

                    i0 = 0
                    if count >= step:
                        old = sample(np.arange(step))
                        while i0 + step <= count:
                            fresh = sample(i0 + step + np.arange(step))
                            both = np.concatenate([old, fresh], axis=1)
                            for t in range(step):
                                acc += vals[start + i0 + t] * both[:, r + t]
                            old, i0 = fresh, i0 + step
                    for i in range(i0, count):
                        acc += vals[start + i] * sample(r + i)
                if stages == 1 and p + 1 < taps.planes:
                    copy(p + 1)
            o = base[live][:, None] + r[None, :] * d
            keep = o < n_out
            out[row, t0 + o[keep]] = acc[keep]
            writes[row, t0 + o[keep]] += 1
    return out, writes


WALKS = [
    # (shape, tap lengths, a tree's depth or a pair's spacing, analysis plane
    #  groups, synthesis window buffers)
    ((2, 301), (1, 37, 300), 1, 2),             # odd N, one ragged tile
    ((2, 150), (1, 37, 300), 3, 1),             # span >= N: the wrap goes round twice
    ((1, 700), (1, 37, 300), 2, 1),             # 2 groups; one buffer
    ((1, 1024), 3, 4, 2),                       # a db4 depth-3 tree, 14 planes in 4 groups
    ((2, 2 * mb.TILE + 5), ("pair", 16), 1, 2),  # stride 16, 3 tiles
    ((1, 3000), ("pair", 512), 2, 1),           # stride 256 with zero taps; span >= N
    ((1, 2000), "gaps", 2, 2),                  # runs bridged and cut at their gaps
]


def _walk_dense(rng, spec):
    if isinstance(spec, int):
        return _tree_dense("db4", spec)
    if spec == "gaps":
        # stride 4; gaps of 2 steps (bridged) and 9 steps (a new run); a
        # plane of 13 taps at stride 1 leaves 5 taps over after one step
        # (and puts the synthesis's runs of both planes on stride 1)
        f = np.zeros(4 * 40 + 1)
        f[[0, 4, 8, 16, 20, 56, 60, 64, 68, 72, 76, 80, 84, 88, 160]] = rng.standard_normal(15)
        return (tuple(f.tolist()), tuple(rng.standard_normal(13).tolist()))
    if isinstance(spec, tuple) and spec[0] == "pair":
        w = vt.wavelet("sym8")
        return tpackets._pair_dense(w.dec_lo / math.sqrt(2.0), w.dec_hi / math.sqrt(2.0),
                                    spec[1])
    return _random_dense(rng, spec)


def _check_walks(x, planes, dense, periodic, groups, stages):
    taps = mb.bank_taps(dense)
    # the values the kernels see are the float64 taps rounded once to fp32
    rounded = tuple(tuple(float(np.float32(v)) for v in f) for f in dense)
    got, writes = _walk_analysis(x, taps, periodic, groups)
    assert np.all(writes == 1)
    for g, w in zip(got, _direct_analysis(x, rounded, periodic)):
        assert np.max(np.abs(g - w)) <= TOL_F64
    y, writes = _walk_synthesis(planes, taps, periodic, stages)
    assert np.all(writes == 1)
    assert np.max(np.abs(y - _direct_synthesis(planes, rounded, periodic))) <= TOL_F64


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "zero"])
@pytest.mark.parametrize("shape,spec,groups,stages", WALKS)
def test_numpy_walk_of_the_kernels_windows_and_tap_staging(shape, spec, groups, stages,
                                                           periodic):
    rng = np.random.default_rng(5)
    dense = _walk_dense(rng, spec)
    x = rng.standard_normal(shape)
    planes = [rng.standard_normal(shape) for _ in dense]
    _check_walks(x, planes, dense, periodic, groups, stages)


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "zero"])
@pytest.mark.parametrize("span", [TWO_BUFFERS, TWO_BUFFERS + 1])
def test_numpy_walk_at_the_two_buffer_limit(span, periodic):
    """A bank at the widest span that takes two synthesis buffers, and one
    past it, which takes one: the host's choice of buffers, walked on a
    short signal that the span wraps round many times."""
    rng = np.random.default_rng(6)
    far = np.zeros(span + 1)
    far[[0, 3, span]] = rng.standard_normal(3)
    dense = (tuple(far.tolist()), tuple(rng.standard_normal(13).tolist()))
    taps = mb.bank_taps(dense)
    stages = mb.synthesis_stages(taps.span)
    assert stages == (2 if span == TWO_BUFFERS else 1)
    assert mb.synthesis_shared_bytes(taps.span, stages) <= SHARED_LIMIT
    x = rng.standard_normal((2, 300))
    planes = [rng.standard_normal((2, 300)) for _ in dense]
    _check_walks(x, planes, dense, periodic, 1, stages)


def test_bank_runs_of_the_routes_banks():
    """A packet tree and the dual tree are one stride-1 run a plane, an à
    trous pair one run at its spacing (at most THREADS: wider spacings
    bridge their gaps with zero taps), and the plane groups balance the
    taps."""
    w = vt.wavelet("sym8")
    tree = mb.bank_runs(mb.bank_taps(tpackets._tree_dense(w, 4, True)))
    assert tree.shifts == (0,) * 30 and len(tree.runs) == 3 * 30
    assert [c for _, c, _ in tree.plane(29)] == [226]
    for spacing, shift, count in ((8, 3, 16), (256, 8, 16), (1024, 8, 61)):
        pair = mb.bank_runs(mb.bank_taps(tpackets._pair_dense(w.dec_lo, w.dec_hi, spacing)))
        assert pair.shifts == (shift, shift) and pair.plane(1) == [(0, count, pair.runs[5])]
    bounds = mb.group_bounds(tree, 3)
    assert bounds == (0, 16, 23, 30)
    loads = [sum(tree.costs[a:b]) for a, b in zip(bounds, bounds[1:])]
    assert max(loads) - min(loads) <= max(tree.costs)
    assert mb.group_bounds(tree, 1) == (0, 30)
    # more groups than planes: the cheap planes still share groups
    many = mb.group_bounds(tree, 64)
    assert many[-1] == 30 and 16 < len(many) - 1 < 30


#: What the kernels served before the register-blocked analysis kernel:
#: at most 64 planes, and a span up to the widest whose window of
#: 256 + span floats fit beside one 1024-tap chunk of (offset, value) pairs,
#: (232448 - 8 * 1024) // 4 - 256 = 55808.
OLD_WIDEST_SPAN = 55808
#: The synthesis kernel's own gate before its register-blocked design,
#: ``bank_tile(span) is not None``: a tile of 2048 outputs halved to no less
#: than 256 until 4 (tile + span) + 8 * 1024 bytes fit 232448.
OLD_SYNTHESIS_WIDEST_SPAN = (232448 - 8 * 1024) // 4 - 256


@pytest.mark.parametrize("planes", [1, 30, 62, 64])
def test_every_bank_the_old_plan_served_is_served(planes):
    assert OLD_SYNTHESIS_WIDEST_SPAN == OLD_WIDEST_SPAN
    for span in (0, 1, 15, 225, 465, 4096, 18105, TWO_BUFFERS, TWO_BUFFERS + 1,
                 OLD_SYNTHESIS_WIDEST_SPAN):
        dense = tuple((0.0,) * span + (1.0,) for _ in range(planes))
        assert mb.bank_fits(dense), span
        mb._launch_plan(mb.bank_taps(dense))
        assert mb.analysis_shared_bytes(span) <= SHARED_LIMIT
        assert mb.synthesis_shared_bytes(span, mb.synthesis_stages(span)) <= SHARED_LIMIT
