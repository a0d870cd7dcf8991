"""Port parity: the general filter bank (``kernels/modwt_bank.py``).

The JAX counterpart is the ``planes_override`` mode of the composite pair
(``run_analysis_composite`` / ``run_synthesis_composite`` in
``vectorwave_tpu/kernels/modwt_mxu.py``), run here as the JAX package's own
tests run it on the CPU: ``precision='float32'`` in interpret mode.  On the
CPU the port's wrappers run their plain versions; the CUDA kernels cannot run
here, so their window and tap-staging plan is walked in numpy instead.

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
    tile + span floats beside one chunk of taps within shared memory."""
    assert mb.bank_tile(0) == mb.THREADS * mb.PER_THREAD
    edge = (SHARED_LIMIT - 8 * mb.TAP_CHUNK) // 4 - mb.THREADS  # widest span served
    assert mb.bank_tile(edge) == mb.THREADS and mb.bank_tile(edge + 1) is None
    assert mb.bank_shared_bytes(edge, mb.THREADS) <= SHARED_LIMIT
    assert mb.bank_fits(_tree_dense("sym8", 5))  # 62 planes, span 465
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
    # plane groups: one where the (signal, tile) blocks fill the card
    assert mb.plane_groups(4096, 30, 132) == 1
    assert mb.plane_groups(8, 30, 132) == 30 and mb.plane_groups(100, 30, 132) == 3


# --- a numpy walk of the CUDA kernels' plan ------------------------------------------


def _bank_load(row, g, n, periodic):
    """``bank_load`` of modwt_bank_common.cuh: the row inside [0, n), outside
    it zero or the wrap modulo n."""
    if 0 <= g < n:
        return row[g]
    return row[g % n] if periodic else 0.0


def _walk_analysis(x, taps, periodic, tile, groups, chunk):
    """modwt_bank_analysis_kernel block by block: one window of tile + span
    samples per (signal, tile), planes split over ``groups`` grid rows, taps
    staged ``chunk`` at a time as (span - offset, value).  Every window slot
    that is not loaded holds NaN, and every read must stay inside the window."""
    b, n = x.shape
    span = taps.span
    outs = [np.full((b, n), np.nan) for _ in range(taps.planes)]
    per_block = -(-taps.planes // groups)
    for row in range(b):
        for t0 in range(0, n, tile):
            n_out = min(tile, n - t0)
            win = np.array([_bank_load(x[row], t0 - span + q, n, periodic)
                            for q in range(tile + span)])
            for group in range(-(-taps.planes // per_block)):
                for p in range(group * per_block, min(taps.planes, (group + 1) * per_block)):
                    acc = np.zeros(tile)
                    for k0 in range(taps.starts[p], taps.starts[p + 1], chunk):
                        count = min(chunk, taps.starts[p + 1] - k0)
                        s_off = [span - taps.offsets[k0 + i] for i in range(count)]
                        s_val = [np.float32(taps.values[k0 + i]) for i in range(count)]
                        for off, v in zip(s_off, s_val):
                            assert 0 <= off and off + tile <= tile + span
                            acc += float(v) * win[off:off + tile]
                    outs[p][row, t0:t0 + n_out] = acc[:n_out]
    return outs


def _walk_synthesis(planes, taps, periodic, tile, chunk):
    """modwt_bank_synthesis_kernel block by block: one accumulator tile; each
    plane in turn loads tile + spans[p] samples into the one window (the rest
    of it poisoned here) and stages its taps ``chunk`` at a time."""
    b, n = planes[0].shape
    out = np.full((b, n), np.nan)
    for row in range(b):
        for t0 in range(0, n, tile):
            n_out = min(tile, n - t0)
            acc = np.zeros(tile)
            for p in range(taps.planes):
                win = np.full(tile + taps.span, np.nan)
                width = tile + taps.spans[p]
                win[:width] = [_bank_load(planes[p][row], t0 + q, n, periodic)
                               for q in range(width)]
                for k0 in range(taps.starts[p], taps.starts[p + 1], chunk):
                    count = min(chunk, taps.starts[p + 1] - k0)
                    for i in range(count):
                        off = taps.offsets[k0 + i]
                        acc += float(np.float32(taps.values[k0 + i])) * win[off:off + tile]
            out[row, t0:t0 + n_out] = acc[:n_out]
    return out


WALKS = [
    # (shape, tap lengths or a tree's depth, tile, plane groups, chunk)
    ((2, 301), (1, 37, 300), 256, 1, 1024),   # odd N, a last tile of 45 outputs
    ((2, 150), (1, 37, 300), 256, 3, 1024),   # span >= N: the wrap goes round twice
    ((1, 700), (1, 37, 300), 256, 2, 64),     # taps staged in five chunks; 2 groups of 2, 1
    ((1, 1024), 3, 512, 4, 16),               # a db4 depth-3 tree, 14 planes in 4 groups
]


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "zero"])
@pytest.mark.parametrize("shape,spec,tile,groups,chunk", WALKS)
def test_numpy_walk_of_the_kernels_windows_and_tap_staging(shape, spec, tile, groups, chunk,
                                                           periodic):
    rng = np.random.default_rng(5)
    dense = _tree_dense("db4", spec) if isinstance(spec, int) else _random_dense(rng, spec)
    taps = mb.bank_taps(dense)
    assert tile % mb.THREADS == 0 and tile <= mb.bank_tile(taps.span)
    # the values the kernels see are the float64 taps rounded once to fp32
    rounded = tuple(tuple(float(np.float32(v)) for v in f) for f in dense)
    x = rng.standard_normal(shape)
    got = _walk_analysis(x, taps, periodic, tile, groups, chunk)
    for g, w in zip(got, _direct_analysis(x, rounded, periodic)):
        assert np.max(np.abs(g - w)) <= TOL_F64
    planes = [rng.standard_normal(shape) for _ in dense]
    y = _walk_synthesis(planes, taps, periodic, tile, chunk)
    assert np.max(np.abs(y - _direct_synthesis(planes, rounded, periodic))) <= TOL_F64
