"""The multi-process run of the host x chip layout, on real processes.

Counterpart of ``tests/test_multiprocess_dcn.py`` (``tools/dcn_worker.py``)
for the port: each rank of a ``torch.distributed`` world (Gloo, a
``file://`` store under ``tmp_path``) is one process that imports ``torch``
and the port only, builds ``make_multihost_mesh`` (one row a rank), passes
its own batch rows to ``modwt_multilevel_multihost`` and
``imodwt_multilevel_multihost`` and saves what it gets back.  The test
process holds every rank's rows against the JAX package's ``backend="jnp"``
transform of the same seeded global batch in float64.  Two worlds: 2 ranks
of 4 virtual CPU shards (the DCN worker's layout) and 4 ranks of 1 shard
(``torchrun``'s one device a rank).

Run as a script, this file is the worker:
``python tests/test_torch_multiprocess.py RANK WORLD STORE CHIPS OUT_DIR``.
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
WAVELET, LEVELS, N, LOCAL, SEED = "db4", 4, 1024, 3, 19
BOUNDARIES = ("periodic", "zero", "symmetric")
#: the float64 parity bounds of tests/test_parallel.py:161-186
TOL_PLANES, TOL_INVERSE = 1e-12, 1e-11
#: seconds a rank may wait in a collective, and the whole world may run
COLLECTIVE_TIMEOUT, JOIN_TIMEOUT = 40, 60
#: every function of torch.distributed that talks to another rank
COLLECTIVES = (
    "all_gather", "all_gather_into_tensor", "all_gather_object", "all_reduce", "all_to_all",
    "all_to_all_single", "barrier", "batch_isend_irecv", "broadcast", "broadcast_object_list",
    "gather", "gather_object", "irecv", "isend", "monitored_barrier", "recv",
    "recv_object_list", "reduce", "reduce_scatter", "reduce_scatter_tensor", "scatter",
    "scatter_object_list", "send", "send_object_list",
)
WORLDS = {"2x4": (2, 4), "4x1": (4, 1)}


def global_rows() -> np.ndarray:
    """The seeded rows of the largest world; in every world rank r holds rows
    ``LOCAL*r .. LOCAL*r + LOCAL-1`` (a world's global batch is its first
    ``LOCAL*world`` rows)."""
    ranks = max(world for world, _ in WORLDS.values())
    return np.random.default_rng(SEED).standard_normal((LOCAL * ranks, N))


# --- the worker ---------------------------------------------------------------------------


def count_collectives(dist) -> dict:
    """Wrap every function of ``COLLECTIVES`` with a counter; returns the
    live ``{name: calls}``."""
    calls: dict = {}

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return call

    for name in COLLECTIVES:
        if hasattr(dist, name):
            setattr(dist, name, counted(name, getattr(dist, name)))
    return calls


def worker(rank: int, world: int, store: str, chips: int, out_dir: str) -> None:
    import datetime

    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    from vectorwave_tpu_torch import parallel as tp
    from vectorwave_tpu_torch.errors import InvalidArgumentError

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
    try:
        calls = count_collectives(dist)
        cpu = [torch.device("cpu")] * chips
        mesh = tp.make_multihost_mesh(devices=cpu)
        at_build = dict(calls)
        x = torch.from_numpy(global_rows()[LOCAL * rank:LOCAL * (rank + 1)])
        arrays = {}
        for boundary in BOUNDARIES:
            res = tp.modwt_multilevel_multihost(x, WAVELET, levels=LEVELS, mesh=mesh,
                                                boundary=boundary)
            xr = tp.imodwt_multilevel_multihost(res, WAVELET, mesh=mesh, boundary=boundary)
            arrays[f"{boundary}_planes"] = torch.stack([*res.details, res.approx]).numpy()
            arrays[f"{boundary}_inverse"] = xr.numpy()
        during = {k: v - at_build.get(k, 0) for k, v in calls.items() if v != at_build.get(k, 0)}
        report = tp.communication_report(mesh, WAVELET, levels=LEVELS, n=N,
                                         batch=LOCAL * world)
        refused = {}
        for label, call in (
            ("n_hosts", lambda: tp.make_multihost_mesh(n_hosts=world + 1, devices=cpu)),
            ("uneven", lambda: tp.make_multihost_mesh(devices=cpu * (2 if rank == 0 else 1))),
            ("chips_per_host", lambda: tp.make_multihost_mesh(chips + 1, devices=cpu)),
            ("tiled", lambda: tp.modwt_multilevel_tiled(x, WAVELET, levels=LEVELS, mesh=mesh,
                                                        axis="chip")),
            ("tiled2d", lambda: tp.modwt2_multilevel_tiled(x[None], WAVELET, levels=1,
                                                           mesh=mesh, axis="chip")),
            ("batch", lambda: tp.modwt_multilevel_sharded_batch(x, WAVELET, levels=LEVELS,
                                                                mesh=mesh, axis="host")),
            ("cwt_tiled", lambda: tp.cwt_tiled(x[0], (2.0, 4.0), mesh=mesh, axis="chip")),
        ):
            try:
                call()
                refused[label] = None
            except InvalidArgumentError as exc:
                refused[label] = exc.code.value
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
        print("RESULT " + json.dumps({
            "rank": rank,
            "shape": mesh.shape,
            "process_index": mesh.process_index.tolist(),
            "local_devices": [str(d) for d in mesh.local_devices],
            "at_build": at_build,
            "during": during,
            "report": list(report),
            "refused": refused,
            "jax_loaded": any(m == "jax" or m.startswith(("jax.", "vectorwave_tpu."))
                              for m in sys.modules),
        }), flush=True)
    finally:
        dist.destroy_process_group()


# --- the test process ---------------------------------------------------------------------


def run_world(out_dir: pathlib.Path, world: int, chips: int) -> list[dict]:
    """Start ``world`` workers on one store, wait at most ``JOIN_TIMEOUT`` s
    for all of them (killing every one past it) and return their results in
    rank order; a worker that fails, hangs or prints no result fails the
    test with every worker's stderr."""
    procs, logs = [], []
    for rank in range(world):
        out, err = out_dir / f"rank{rank}.out", out_dir / f"rank{rank}.err"
        logs.append((out, err))
        with open(out, "w") as fo, open(err, "w") as fe:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, str(rank), str(world), str(out_dir / "store"),
                 str(chips), str(out_dir)], stdout=fo, stderr=fe, cwd=REPO))
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
    """One run of a world: ``(name, world, chips, results, {rank: arrays})``."""
    world, chips = WORLDS[request.param]
    out_dir = tmp_path_factory.mktemp(f"world{request.param}")
    results = run_world(out_dir, world, chips)
    arrays = {r: dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world)}
    return request.param, world, chips, results, arrays


@pytest.fixture(scope="module")
def jax_reference():
    """``{boundary: (planes [J+1, B, N], inverse [B, N])}`` of the JAX
    package's jnp route on :func:`global_rows`, float64, each boundary's pair
    under one ``jax.jit``."""
    import jax
    import jax.numpy as jnp

    import vectorwave_tpu as vw

    def pair(x, boundary):
        res = vw.modwt_multilevel(x, WAVELET, levels=LEVELS, boundary=boundary, backend="jnp")
        inv = vw.imodwt_multilevel(res, WAVELET, boundary=boundary, backend="jnp")
        return jnp.stack([*res.details, res.approx]), inv

    x = jnp.asarray(global_rows())
    return {b: tuple(map(np.asarray, jax.jit(pair, static_argnums=1)(x, b)))
            for b in BOUNDARIES}


def test_mesh_has_one_row_a_rank(run):
    name, world, chips, results, _ = run
    for res in results:
        assert res["shape"] == {"host": world, "chip": chips}
        assert res["process_index"] == [[r] * chips for r in range(world)]
        assert res["local_devices"] == ["cpu"] * chips
        # the rows are exchanged once, at build time
        assert res["at_build"] == {"all_gather_object": 1}
        assert not res["jax_loaded"]


@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_each_rank_matches_jax(run, jax_reference, boundary, direction):
    """3 local rows a rank (the global batch is 3 x world): each rank's rows
    of the planes and of the inverse against the JAX jnp transform of the
    global batch."""
    name, world, chips, results, arrays = run
    planes, inverse = jax_reference[boundary]
    for rank in range(world):
        rows = slice(LOCAL * rank, LOCAL * (rank + 1))
        if direction == "forward":
            got, want, tol = arrays[rank][f"{boundary}_planes"], planes[:, rows], TOL_PLANES
        else:
            got, want, tol = arrays[rank][f"{boundary}_inverse"], inverse[rows], TOL_INVERSE
        assert got.shape == want.shape and got.dtype == np.float64
        assert np.max(np.abs(got - want)) <= tol, (name, rank)


def test_no_collective_during_the_transforms(run):
    """The counterpart of test_multihost_collectives_stay_on_ici: the batch
    crosses ranks, and nothing else does."""
    _, _, _, results, _ = run
    assert all(res["during"] == {} for res in results)


def test_communication_report_equals_jax(run):
    import vectorwave_tpu.parallel as jp

    _, world, chips, results, _ = run
    jmesh = jp.make_multihost_mesh(n_hosts=world, chips_per_host=chips)
    want = jp.communication_report(jmesh, WAVELET, levels=LEVELS, n=N, batch=LOCAL * world)
    for res in results:
        assert tuple(res["report"][:2]) == tuple(want[:2])
        assert tuple(res["report"][2]) == tuple(want.per_level_halo_samples)
        assert res["report"][3] == want.ici_fraction_of_compute_bytes
        assert res["report"][1] == 0  # dcn_bytes_per_host


def test_bad_meshes_raise_on_every_rank(run):
    """Uneven rows, an n_hosts other than the world size and a chips_per_host
    other than the row raise on every rank, after the one exchange (no rank
    is left waiting), as do the facades that compute every cell in one
    process."""
    _, _, _, results, _ = run
    for res in results:
        assert res["refused"] == {k: "DIST_001" for k in (
            "n_hosts", "uneven", "chips_per_host", "tiled", "tiled2d", "batch", "cwt_tiled")}


# --- in one process: a mesh that names another rank's cells --------------------------------


def test_remote_cells_are_never_computed_here():
    """A hand-built mesh of two ranks seen from rank 0: rank 1's cells are
    RemoteDevice entries; the multihost facades run this rank's row alone,
    with no process group; the other facades refuse the mesh."""
    from vectorwave_tpu_torch import parallel as tp
    from vectorwave_tpu_torch.errors import InvalidArgumentError
    from vectorwave_tpu_torch.parallel.mesh import Mesh, RemoteDevice

    import vectorwave_tpu_torch as vt

    cpu = torch.device("cpu")
    mesh = Mesh([[cpu] * 4, [RemoteDevice(1, cpu)] * 4], ("host", "chip"))
    assert mesh.rank == 0 and mesh.process_count == 2
    assert mesh.process_index.tolist() == [[0] * 4, [1] * 4]
    assert mesh.local_devices == [cpu] * 4
    one = tp.make_multihost_mesh(2, 4, devices=[cpu] * 8)
    assert one.process_count == 1 and one.process_index.tolist() == [[0] * 4] * 2
    x = torch.from_numpy(global_rows()[:LOCAL])
    res = tp.modwt_multilevel_multihost(x.numpy(), WAVELET, levels=LEVELS, mesh=mesh)
    want = vt.modwt_multilevel(x, WAVELET, levels=LEVELS, backend="torch")
    assert all(torch.allclose(g, w, atol=TOL_PLANES, rtol=0)
               for g, w in zip((*res.details, res.approx), (*want.details, want.approx)))
    xr = tp.imodwt_multilevel_multihost(res, WAVELET, mesh=mesh)
    assert torch.allclose(xr, x, atol=1e-10, rtol=0)
    for call in (lambda: tp.modwt_multilevel_tiled(x, WAVELET, levels=2, mesh=mesh, axis="chip"),
                 lambda: tp.tiled_roundtrip_check(mesh, axis="chip"),
                 lambda: tp.shard_batch(x, mesh, axis="host"),
                 lambda: tp.cwt_tiled_2d(x[0], (2.0, 4.0), mesh=mesh)):
        with pytest.raises(InvalidArgumentError) as got:
            call()
        assert got.value.code.value == "DIST_001"
        assert "local_devices" in str(got.value.suggestions)
    with pytest.raises(InvalidArgumentError):  # the 2-D shape check stays
        tp.modwt_multilevel_multihost(x[0], WAVELET, levels=2, mesh=mesh)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4]), sys.argv[5])
