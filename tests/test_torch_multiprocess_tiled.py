"""The signal axis across ranks: every facade of the parallel tier on a mesh
that spans the ranks of a ``torch.distributed`` world, on real processes.

Each rank (Gloo, a ``file://`` store under the test's temporary directory,
a 40 s collective timeout, a 60 s join) imports ``torch`` and the port
only, builds its meshes with ``make_mesh`` / ``make_multihost_mesh``, cuts
its block of each seeded global input with ``local_index`` and runs the
facades on it; every ``torch.distributed`` function is wrapped with a
counter, and ``batch_isend_irecv`` also sums the bytes it sends.  Three
worlds, each spawned once:

* ``2x4``: 2 ranks x 4 virtual CPU shards, ``{"signal": 8}``;
* ``4x1``: 4 ranks x 1, ``{"signal": 4}``;
* ``2x2``: 4 ranks as ``{"data": 2, "signal": 2}``, the batch and the
  signal both across ranks (the facades with a batch axis split it over
  ``data``; the others run on a ``{"signal": 4}`` mesh of the same world).

The test process holds each rank's block, in float64, to the JAX package's
untiled ``backend="jnp"`` transform of the global input at the one-process
tests' bounds (``tests/test_parallel.py:161-186``: planes 1e-12, inverse
1e-11; the exact tier: hi + lo of its planes and inverse 1e-11 against the
float64 oracle, the periodic round trip's RMSE 1e-10 against x; 2-D
1e-12; the tiled CWT 1e-12 of the largest coefficient,
``tests/test_torch_cwt_tiled.py:33``), and to the port's
one-process facade on a mesh of the same shape within 1e-13.  It counts the
exchanges: the periodic cascade analysis is one ``batch_isend_irecv`` that
sends ``rows x (L0-1)(2^J-1) x 8`` bytes, and a layout with no exchange
(the multihost facades, ``cwt_tiled_2d`` over a multihost mesh, the batch
facades) makes no ``torch.distributed`` call.

Run as a script, this file is the worker:
``python tests/test_torch_multiprocess_tiled.py WORLD RANK STORE OUT_DIR``.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
WAVELET, LEVELS, WIDE, N, ROWS, SEED = "db4", 4, 8, 1024, 3, 29
BOUNDARIES = ("periodic", "zero", "symmetric")
#: the tiled pair's cases: (boundary, levels); db4 J=8 on 8 shards of 1024
#: takes a periodic halo hop by hop past N (span 1785) and the symmetric
#: levels whose halo outgrows a shard gather the axis
CASES = tuple((b, LEVELS) for b in BOUNDARIES) + (("periodic", WIDE), ("symmetric", WIDE))
#: the exact tier's cases: (boundary, levels); db4 J=8 wraps the periodic
#: span (1785) past N, the gather path
EXACT_CASES = (("periodic", LEVELS), ("zero", LEVELS), ("periodic", WIDE))
#: the 2-D cases: J=2 (a slab of 21 rows over shards of 8-32 rows) in every
#: boundary, and J=4 periodic, whose span (105) wraps past H: the gather path
IMG = (2, 64, 64)
IMG_CASES = tuple((b, 2) for b in BOUNDARIES) + (("periodic", 4),)
SCALES = tuple(np.geomspace(2.0, 16.0, 8).tolist())
BATCH, BATCH_LEVELS = (8, 256), 3
TOL_PLANES, TOL_INVERSE, TOL_ORACLE, TOL_RMSE = 1e-12, 1e-11, 1e-11, 1e-10
TOL_CWT, TOL_ONE_PROCESS = 1e-12, 1e-13
COLLECTIVE_TIMEOUT, JOIN_TIMEOUT = 40, 60
#: every function of torch.distributed that talks to another rank
COLLECTIVES = (
    "all_gather", "all_gather_into_tensor", "all_gather_object", "all_reduce", "all_to_all",
    "all_to_all_single", "barrier", "batch_isend_irecv", "broadcast", "broadcast_object_list",
    "gather", "gather_object", "irecv", "isend", "monitored_barrier", "recv",
    "recv_object_list", "reduce", "reduce_scatter", "reduce_scatter_tensor", "scatter",
    "scatter_object_list", "send", "send_object_list",
)
#: name -> (ranks, CPU shards a rank, the main mesh)
WORLDS = {"2x4": (2, 4, {"signal": 8}), "4x1": (4, 1, {"signal": 4}),
          "2x2": (4, 1, {"data": 2, "signal": 2})}


def signals(groups: int) -> np.ndarray:
    """``ROWS`` rows a batch group; the first rows are equal for every count."""
    return np.random.default_rng(SEED).standard_normal((ROWS * groups, N))


def images() -> np.ndarray:
    return np.random.default_rng(SEED + 1).standard_normal(IMG)


def batch() -> np.ndarray:
    return np.random.default_rng(SEED + 2).standard_normal(BATCH)


def _bounds(index, shape) -> list:
    """A ``local_index`` tuple as ``[start, stop]`` a dimension of the
    global ``shape``."""
    return [list(s.indices(n)[:2]) for s, n in zip(index, shape)]


def _cut(bounds) -> tuple:
    return tuple(slice(a, b) for a, b in bounds)


# --- the worker ---------------------------------------------------------------------------


def count_calls(dist) -> dict:
    """Wrap every function of ``COLLECTIVES`` with a counter; returns the live
    ``{name: calls}``, with the bytes that ``batch_isend_irecv`` sends under
    ``"sent_bytes"``."""
    from torch.distributed import distributed_c10d as c10d

    calls: dict = {}

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            if name == "batch_isend_irecv":
                calls["sent_bytes"] = calls.get("sent_bytes", 0) + sum(
                    op.tensor.numel() * op.tensor.element_size() for op in args[0]
                    if op.op is c10d.isend)
            return fn(*args, **kwargs)
        return call

    for name in COLLECTIVES:
        if hasattr(dist, name):
            setattr(dist, name, counted(name, getattr(dist, name)))
    return calls


def worker(name: str, rank: int, store: str, out_dir: str) -> None:
    import datetime

    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    from vectorwave_tpu_torch import parallel as tp
    from vectorwave_tpu_torch.errors import InvalidArgumentError
    from vectorwave_tpu_torch.parallel import exchange

    torch.set_num_threads(1)
    ranks, chips, shape = WORLDS[name]
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=ranks,
                            rank=rank, timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
    arrays: dict = {}
    meta: dict = {"rank": rank, "index": {}, "traffic": {}, "refused": {}}
    try:
        calls = count_calls(dist)
        cpu = [torch.device("cpu")] * chips

        def record(label, fn):
            before = dict(calls)
            exchange.reset_traffic()
            out = fn()
            meta["traffic"][label] = {
                "calls": {k: v - before.get(k, 0) for k, v in calls.items()
                          if v != before.get(k, 0)},
                "module": dict(exchange.TRAFFIC)}
            return out

        def place(grid, shape, **how):
            return tp.local_index(grid, shape, **how), shape

        def keep(label, where, tensors):
            meta["index"][label] = _bounds(*where)
            arrays[label] = torch.stack([t.detach() for t in tensors]).numpy()

        mesh = tp.make_mesh(shape, devices=cpu)
        meta["built"] = dict(calls)
        batch_axis = "data" if "data" in shape else None
        groups = shape.get("data", 1)
        big = signals(groups)
        where = place(mesh, big.shape, axis="signal", batch_axis=batch_axis)
        x = torch.from_numpy(big[where[0]])
        for b, levels in CASES:
            tag = f"j{levels}_{b}"
            res = record(f"{tag}_fwd", lambda b=b, levels=levels: tp.modwt_multilevel_tiled(
                x, WAVELET, levels=levels, mesh=mesh, boundary=b, batch_axis=batch_axis))
            inv = record(f"{tag}_inv", lambda b=b, res=res: tp.imodwt_multilevel_tiled(
                res, WAVELET, mesh=mesh, boundary=b, batch_axis=batch_axis))
            keep(f"{tag}_planes", where, (*res.details, res.approx))
            keep(f"{tag}_inverse", where, (inv,))
        for b, levels in EXACT_CASES:
            tag = f"exact_j{levels}_{b}"
            d, a = record(f"{tag}_fwd", lambda b=b, levels=levels:
                          tp.modwt_multilevel_tiled_exact(x.float(), WAVELET, levels=levels,
                                                          mesh=mesh, boundary=b,
                                                          batch_axis=batch_axis))
            hi, lo = record(f"{tag}_inv", lambda b=b, d=d, a=a: tp.imodwt_multilevel_tiled_exact(
                d, a, WAVELET, mesh=mesh, boundary=b, batch_axis=batch_axis))
            keep(f"{tag}_planes", where, [h.double() + lo_.double() for h, lo_ in (*d, a)])
            keep(f"{tag}_inverse", where, (hi.double() + lo.double(),))
        img_at = place(mesh, IMG, axis="signal", batch_axis=batch_axis, dim=-2)
        img = torch.from_numpy(images()[img_at[0]])
        for b, levels in IMG_CASES:
            tag = f"img_j{levels}_{b}"
            r2 = record(f"{tag}_fwd", lambda b=b, levels=levels: tp.modwt2_multilevel_tiled(
                img, WAVELET, levels=levels, mesh=mesh, axis="signal", boundary=b,
                batch_axis=batch_axis))
            inv = record(f"{tag}_inv", lambda b=b, r2=r2: tp.imodwt2_multilevel_tiled(
                r2, WAVELET, mesh=mesh, axis="signal", boundary=b, batch_axis=batch_axis))
            keep(f"{tag}_planes", img_at, [p for trip in r2.details for p in trip] + [r2.approx])
            keep(f"{tag}_inverse", img_at, (inv,))
        # the facades that split one axis: a {"signal": ranks * chips} mesh
        line = mesh if batch_axis is None else tp.make_mesh({"signal": ranks * chips},
                                                            devices=cpu)
        pair = signals(1)[:2]
        cwt_in = tp.local_index(line, pair.shape, axis="signal")
        for b in ("zero", "periodic"):
            c = record(f"cwt_{b}", lambda b=b: tp.cwt_tiled(
                torch.from_numpy(pair[cwt_in]), SCALES, "morl", mesh=line, boundary=b))
            keep(f"cwt_{b}", place(line, (2, len(SCALES), N), axis="signal"), (c.coeffs,))
        hosts = tp.make_multihost_mesh(devices=cpu)
        grids = [("multihost", hosts, "chip", "host")]
        if batch_axis is not None:
            grids.append(("grid", mesh, "signal", "data"))
        for label, grid, signal_axis, scale_axis in grids:
            sig_in = tp.local_index(grid, (N,), axis=signal_axis)
            c = record(f"cwt2d_{label}", lambda grid=grid, sa=signal_axis, ca=scale_axis,
                       sig_in=sig_in: tp.cwt_tiled_2d(
                torch.from_numpy(pair[0][sig_in]), SCALES, "morl", mesh=grid,
                signal_axis=sa, scale_axis=ca))
            keep(f"cwt2d_{label}", place(grid, (len(SCALES), N), axis=signal_axis,
                                         batch_axis=scale_axis), (c.coeffs,))
        rows = batch()
        mh_at = place(hosts, rows.shape, axis="chip", batch_axis="host")
        res = record("multihost_fwd", lambda: tp.modwt_multilevel_multihost(
            torch.from_numpy(rows[mh_at[0]]), WAVELET, levels=BATCH_LEVELS, mesh=hosts))
        inv = record("multihost_inv", lambda: tp.imodwt_multilevel_multihost(
            res, WAVELET, mesh=hosts))
        keep("multihost_planes", mh_at, (*res.details, res.approx))
        keep("multihost_inverse", mh_at, (inv,))
        b_at = place(line, rows.shape, axis="signal", dim=0)
        chunks = record("shard_batch", lambda: tp.shard_batch(
            torch.from_numpy(rows[b_at[0]]), line, axis="signal"))
        keep("shard_batch", b_at, (torch.cat(chunks),))
        res = record("sharded_batch", lambda: tp.modwt_multilevel_sharded_batch(
            torch.from_numpy(rows[b_at[0]]), WAVELET, levels=BATCH_LEVELS, mesh=line,
            axis="signal"))
        keep("sharded_batch", b_at, (*res.details, res.approx))
        one_at = place(line, (N,), axis="signal")
        res = record("sharded_batch_1d", lambda: tp.modwt_multilevel_sharded_batch(
            torch.from_numpy(pair[0][one_at[0]]), WAVELET, levels=BATCH_LEVELS, mesh=line,
            axis="signal"))
        keep("sharded_batch_1d", one_at, (*res.details, res.approx))
        meta["roundtrip"] = record("roundtrip", lambda: tp.tiled_roundtrip_check(
            line, axis="signal"))
        # a mesh whose rank cells form no box: 3 cells a rank on a data x signal grid
        before = dict(calls)
        askew = tp.make_mesh({"data": 3, "signal": ranks}, devices=[torch.device("cpu")] * 3)
        at_refusal = dict(calls)
        for label, call in (
            ("tiled", lambda: tp.modwt_multilevel_tiled(torch.zeros(3, 64), WAVELET, levels=1,
                                                        mesh=askew, batch_axis="data")),
            ("tiled2d", lambda: tp.modwt2_multilevel_tiled(torch.zeros(3, 8, 8), WAVELET,
                                                           levels=1, mesh=askew, axis="signal",
                                                           batch_axis="data")),
            ("cwt_tiled_2d", lambda: tp.cwt_tiled_2d(torch.zeros(64), (2.0, 4.0, 8.0),
                                                     mesh=askew, signal_axis="signal",
                                                     scale_axis="data")),
            ("local_index", lambda: tp.local_index(askew, (3, 64), axis="signal",
                                                   batch_axis="data")),
        ):
            try:
                call()
                meta["refused"][label] = None
            except InvalidArgumentError as exc:
                meta["refused"][label] = exc.code.value
        meta["askew_build"] = {k: v - before.get(k, 0) for k, v in at_refusal.items()
                               if v != before.get(k, 0)}
        meta["after_refusal"] = {k: v - at_refusal.get(k, 0) for k, v in calls.items()
                                 if v != at_refusal.get(k, 0)}
        meta["jax_loaded"] = any(m == "jax" or m.startswith(("jax.", "vectorwave_tpu."))
                                 for m in sys.modules)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
        print("RESULT " + json.dumps(meta), flush=True)
    finally:
        dist.destroy_process_group()


# --- the test process ---------------------------------------------------------------------


def run_world(out_dir: pathlib.Path, name: str) -> list[dict]:
    """Start the world's ranks on one store, wait at most ``JOIN_TIMEOUT`` s
    for all of them (killing every one past it) and return their results in
    rank order; a rank that fails, hangs or prints no result fails the test
    with every rank's stderr."""
    ranks = WORLDS[name][0]
    procs, logs = [], []
    for rank in range(ranks):
        out, err = out_dir / f"rank{rank}.out", out_dir / f"rank{rank}.err"
        logs.append((out, err))
        with open(out, "w") as fo, open(err, "w") as fe:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, name, str(rank), str(out_dir / "store"),
                 str(out_dir)], stdout=fo, stderr=fe, cwd=REPO))
    deadline = time.monotonic() + JOIN_TIMEOUT
    hung = []
    for rank, proc in enumerate(procs):
        try:
            proc.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            hung.append(rank)
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    results, faults = [], []
    for rank, (proc, (out, err)) in enumerate(zip(procs, logs)):
        lines = [ln for ln in out.read_text().splitlines() if ln.startswith("RESULT ")]
        if rank in hung or proc.returncode != 0 or len(lines) != 1:
            hang = f"hung past {JOIN_TIMEOUT} s, killed; " if rank in hung else ""
            faults.append(f"rank {rank}: {hang}exit code {proc.returncode}\n"
                          f"{err.read_text()[-3000:]}")
            continue
        results.append(json.loads(lines[0][len("RESULT "):]))
    if faults:
        pytest.fail("multi-process workers failed:\n" + "\n".join(faults))
    return results


@pytest.fixture(scope="module", params=list(WORLDS))
def run(request, tmp_path_factory):
    """One run of a world: ``(name, results, {rank: arrays})``."""
    out_dir = tmp_path_factory.mktemp(f"tiled{request.param}")
    results = run_world(out_dir, request.param)
    arrays = {r: dict(np.load(out_dir / f"rank{r}.npz")) for r in range(len(results))}
    return request.param, results, arrays


def _jax_planes(res) -> np.ndarray:
    return np.stack([np.asarray(p) for p in (*res.details, res.approx)])


@pytest.fixture(scope="module")
def reference():
    """The JAX package's untiled ``backend="jnp"`` transforms of every global
    input, float64: ``{label: [arrays]}`` under the workers' labels."""
    import jax.numpy as jnp

    import vectorwave_tpu as vw

    big = jnp.asarray(signals(2))
    out = {}
    for b, levels in CASES:
        res = vw.modwt_multilevel(big, WAVELET, levels=levels, boundary=b, backend="jnp")
        out[f"j{levels}_{b}_planes"] = _jax_planes(res)
        out[f"j{levels}_{b}_inverse"] = np.asarray(
            vw.imodwt_multilevel(res, WAVELET, boundary=b, backend="jnp"))[None]
    x32 = jnp.asarray(signals(2).astype(np.float32).astype(np.float64))
    for b, levels in EXACT_CASES:
        res = vw.modwt_multilevel(x32, WAVELET, levels=levels, boundary=b, backend="jnp")
        out[f"exact_j{levels}_{b}_planes"] = _jax_planes(res)
        out[f"exact_j{levels}_{b}_inverse"] = np.asarray(
            vw.imodwt_multilevel(res, WAVELET, boundary=b, backend="jnp"))[None]
    out["x32"] = np.asarray(x32)[None]
    img = jnp.asarray(images())
    for b, levels in IMG_CASES:
        r2 = vw.modwt2_multilevel(img, WAVELET, levels=levels, boundary=b)
        out[f"img_j{levels}_{b}_planes"] = np.stack(
            [np.asarray(p) for trip in r2.details for p in trip] + [np.asarray(r2.approx)])
        out[f"img_j{levels}_{b}_inverse"] = np.asarray(
            vw.imodwt2_multilevel(r2, WAVELET, boundary=b))[None]
    pair = jnp.asarray(signals(1)[:2])
    for b in ("zero", "periodic"):
        out[f"cwt_{b}"] = np.asarray(vw.cwt(pair, SCALES, "morl", boundary=b).coeffs)[None]
    out["cwt2d"] = np.asarray(vw.cwt(pair[0], SCALES, "morl").coeffs)[None]
    rows = jnp.asarray(batch())
    res = vw.modwt_multilevel(rows, WAVELET, levels=BATCH_LEVELS, backend="jnp")
    out["multihost_planes"] = out["sharded_batch"] = _jax_planes(res)
    out["multihost_inverse"] = np.asarray(vw.imodwt_multilevel(res, WAVELET, backend="jnp"))[None]
    out["shard_batch"] = batch()[None]
    out["sharded_batch_1d"] = _jax_planes(vw.modwt_multilevel(
        pair[0], WAVELET, levels=BATCH_LEVELS, backend="jnp"))
    return out


def _bound(label: str):
    """(the bound against JAX, whether relative to the largest value)."""
    if label.startswith("exact_"):
        return TOL_ORACLE, False
    if label.startswith("cwt"):
        return TOL_CWT, True
    if label == "shard_batch":
        return 0.0, False
    return (TOL_INVERSE if label.endswith("_inverse") else TOL_PLANES), False


def _want(reference, label: str, rank_meta: dict) -> np.ndarray:
    key = "cwt2d" if label.startswith("cwt2d") else label
    full = reference[key]
    index = _cut(rank_meta["index"][label])
    return full[(slice(None),) + index]


def test_every_rank_block_matches_jax(run, reference):
    """Each rank's block of every facade's output against the JAX jnp
    transform of the global input; the exact tier's round trip by the RMSE
    of hi + lo against x."""
    name, results, arrays = run
    for meta in results:
        got_all = arrays[meta["rank"]]
        for label in meta["index"]:
            got = got_all[label]
            want = _want(reference, label, meta)
            assert got.shape == want.shape, (name, label)
            tol, relative = _bound(label)
            if label.startswith("exact_") and label.endswith("periodic_inverse"):
                x = reference["x32"][(slice(None),) + _cut(meta["index"][label])]
                rmse = float(np.sqrt(np.mean((got - x) ** 2)))
                assert rmse <= TOL_RMSE, (name, meta["rank"], label, rmse)
            scale = float(np.max(np.abs(want))) if relative else 1.0
            err = float(np.max(np.abs(got - want)))
            assert err <= tol * scale, (name, meta["rank"], label, err)


def _one_process(name: str) -> dict:
    """The port's one-process facades on meshes of the same shapes, on the
    global inputs: ``{label: array}``."""
    from vectorwave_tpu_torch import parallel as tp

    ranks, chips, shape = WORLDS[name]
    cpu = [torch.device("cpu")] * (ranks * chips)
    mesh = tp.make_mesh(shape, devices=cpu)
    line = tp.make_mesh({"signal": ranks * chips}, devices=cpu)
    hosts = tp.make_multihost_mesh(ranks, chips, devices=cpu)
    batch_axis = "data" if "data" in shape else None
    x = torch.from_numpy(signals(shape.get("data", 1)))
    out = {}
    for b, levels in CASES:
        res = tp.modwt_multilevel_tiled(x, WAVELET, levels=levels, mesh=mesh, boundary=b,
                                        batch_axis=batch_axis)
        out[f"j{levels}_{b}_planes"] = torch.stack([*res.details, res.approx]).numpy()
        out[f"j{levels}_{b}_inverse"] = tp.imodwt_multilevel_tiled(
            res, WAVELET, mesh=mesh, boundary=b, batch_axis=batch_axis)[None].numpy()
    for b, levels in EXACT_CASES:
        d, a = tp.modwt_multilevel_tiled_exact(x.float(), WAVELET, levels=levels, mesh=mesh,
                                               boundary=b, batch_axis=batch_axis)
        hi, lo = tp.imodwt_multilevel_tiled_exact(d, a, WAVELET, mesh=mesh, boundary=b,
                                                  batch_axis=batch_axis)
        out[f"exact_j{levels}_{b}_planes"] = torch.stack(
            [h.double() + lo_.double() for h, lo_ in (*d, a)]).numpy()
        out[f"exact_j{levels}_{b}_inverse"] = (hi.double() + lo.double())[None].numpy()
    img = torch.from_numpy(images())
    for b, levels in IMG_CASES:
        r2 = tp.modwt2_multilevel_tiled(img, WAVELET, levels=levels, mesh=mesh,
                                        axis="signal", boundary=b, batch_axis=batch_axis)
        out[f"img_j{levels}_{b}_planes"] = torch.stack(
            [p for trip in r2.details for p in trip] + [r2.approx]).numpy()
        out[f"img_j{levels}_{b}_inverse"] = tp.imodwt2_multilevel_tiled(
            r2, WAVELET, mesh=mesh, axis="signal", boundary=b,
            batch_axis=batch_axis)[None].numpy()
    pair = torch.from_numpy(signals(1)[:2])
    for b in ("zero", "periodic"):
        out[f"cwt_{b}"] = tp.cwt_tiled(pair, SCALES, "morl", mesh=line, boundary=b).coeffs[
            None].numpy()
    out["cwt2d_multihost"] = tp.cwt_tiled_2d(pair[0], SCALES, "morl", mesh=hosts).coeffs[
        None].numpy()
    if batch_axis is not None:
        out["cwt2d_grid"] = tp.cwt_tiled_2d(pair[0], SCALES, "morl", mesh=mesh,
                                            signal_axis="signal", scale_axis="data").coeffs[
            None].numpy()
    rows = torch.from_numpy(batch())
    res = tp.modwt_multilevel_multihost(rows, WAVELET, levels=BATCH_LEVELS, mesh=hosts)
    out["multihost_planes"] = torch.stack([*res.details, res.approx]).numpy()
    out["multihost_inverse"] = tp.imodwt_multilevel_multihost(res, WAVELET, mesh=hosts)[
        None].numpy()
    out["shard_batch"] = torch.cat(tp.shard_batch(rows, line, axis="signal"))[None].numpy()
    res = tp.modwt_multilevel_sharded_batch(rows, WAVELET, levels=BATCH_LEVELS, mesh=line,
                                            axis="signal")
    out["sharded_batch"] = torch.stack([*res.details, res.approx]).numpy()
    res = tp.modwt_multilevel_sharded_batch(pair[0], WAVELET, levels=BATCH_LEVELS, mesh=line,
                                            axis="signal")
    out["sharded_batch_1d"] = torch.stack([*res.details, res.approx]).numpy()
    out["roundtrip"] = tp.tiled_roundtrip_check(line, axis="signal")
    return out


def test_every_rank_block_matches_the_one_process_facade(run):
    name, results, arrays = run
    one = _one_process(name)
    for meta in results:
        for label in meta["index"]:
            got = arrays[meta["rank"]][label]
            want = one[label][(slice(None),) + _cut(meta["index"][label])]
            scale = max(1.0, float(np.max(np.abs(want))))
            assert float(np.max(np.abs(got - want))) <= TOL_ONE_PROCESS * scale, (
                name, meta["rank"], label)
        # the round trip check's error is the largest over all ranks
        assert meta["roundtrip"] == results[0]["roundtrip"]
        assert abs(meta["roundtrip"] - one["roundtrip"]) <= TOL_ONE_PROCESS
        assert 0 < meta["roundtrip"] < 1e-5


def test_the_halos_cross_ranks_in_one_call_an_exchange(run):
    """The periodic cascade analysis is one ``batch_isend_irecv`` a rank that
    sends rows x (L0-1)(2^J-1) x 8 bytes (no all-gather); the zero boundary's
    last rank sends nothing.  The module's own count equals the wrapper's."""
    name, results, _ = run
    signal = WORLDS[name][2]["signal"]
    span = 7 * ((1 << LEVELS) - 1)
    for meta in results:
        cols = _cut(meta["index"]["j4_periodic_planes"])[-1]
        rows = ROWS  # a rank's rows: one batch group
        periodic = meta["traffic"]["j4_periodic_fwd"]
        assert periodic["calls"] == {"batch_isend_irecv": 1, "sent_bytes": rows * span * 8}
        zero = meta["traffic"]["j4_zero_fwd"]
        holds_last = cols.stop == N
        if holds_last:
            assert zero["calls"] == {"batch_isend_irecv": 1}  # receives only
        else:
            assert zero["calls"] == {"batch_isend_irecv": 1, "sent_bytes": rows * span * 8}
        # the plain inverse exchanges both planes of each level in one call
        inverse = meta["traffic"]["j4_periodic_inv"]
        assert inverse["calls"] == {"batch_isend_irecv": LEVELS,
                                    "sent_bytes": 2 * rows * span * 8}
        # a wide halo goes hop by hop: one call a hop, whole shards on the wire
        n_loc = N // signal
        hops = -(-7 * ((1 << WIDE) - 1) // n_loc)
        wide = meta["traffic"]["j8_periodic_fwd"]["calls"]
        assert wide["batch_isend_irecv"] == hops, (name, wide)
        for label, traffic in meta["traffic"].items():
            calls = traffic["calls"]
            assert traffic["module"]["calls"] == calls.get("batch_isend_irecv", 0), label
            assert traffic["module"]["bytes"] == calls.get("sent_bytes", 0), label


def test_a_layout_with_no_exchange_makes_no_call(run):
    """The multihost facades, ``cwt_tiled_2d`` over a multihost mesh (its
    scales across ranks, its signal within each) and the batch facades send
    nothing; the mesh is built with one ``all_gather_object``."""
    name, results, _ = run
    for meta in results:
        assert meta["built"] == {"all_gather_object": 1}
        for label in ("multihost_fwd", "multihost_inv", "cwt2d_multihost", "shard_batch",
                      "sharded_batch"):
            assert meta["traffic"][label]["calls"] == {}, (name, label)
        assert meta["traffic"]["roundtrip"]["calls"]["all_reduce"] == 1
        assert not meta["jax_loaded"]


def test_a_mesh_whose_rank_cells_form_no_box_raises_on_every_rank(run):
    _, results, _ = run
    for meta in results:
        assert meta["refused"] == {k: "DIST_001" for k in (
            "tiled", "tiled2d", "cwt_tiled_2d", "local_index")}
        assert meta["askew_build"] == {"all_gather_object": 1}
        assert meta["after_refusal"] == {}


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4])
