"""Multi-host layouts on the PyTorch port: splits over a ("host", "chip") mesh.

Counterpart of ``examples/multihost_demo.py``.  The batch goes over hosts,
so the link between hosts carries nothing during the transform, and each
signal tiles over the chips of its host, whose per-level halos stay inside
the host.  Three ways to run it:

    python examples/torch/multihost_demo.py          # one card: 2 hosts x 4 virtual shards
    python examples/torch/multihost_demo.py --cpu    # the same on the CPU
    torchrun --nproc_per_node 2 examples/torch/multihost_demo.py --cpu

Under ``torchrun`` every process is one host: ``make_multihost_mesh`` gives
each rank one row of the mesh (here 4 shards of its own device; by default
its current card), each rank passes its own batch rows and gets its own rows
back, and no ``torch.distributed`` call runs during the transform.  Without
``--cpu`` each rank takes the card ``LOCAL_RANK`` and NCCL, one card a rank.
"""

import argparse
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np
import torch

import vectorwave_tpu_torch as vt
from vectorwave_tpu_torch.parallel import (
    communication_report,
    cwt_tiled,
    cwt_tiled_2d,
    imodwt_multilevel_multihost,
    make_mesh,
    make_multihost_mesh,
    modwt_multilevel_multihost,
)

ROWS, N, LEVELS, CHIPS = 2, 4096, 4, 4


def one_process(dev: torch.device) -> None:
    mesh = make_multihost_mesh(n_hosts=2, chips_per_host=CHIPS, devices=[dev] * (2 * CHIPS))
    print(f"mesh: {mesh.shape} over {mesh.size} shards of {dev}")

    # MODWT: batch over "host", each signal tiled over "chip".
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((2 * ROWS, N)), dtype=torch.float32, device=dev)
    res = modwt_multilevel_multihost(x, "db4", levels=LEVELS, mesh=mesh)
    xr = imodwt_multilevel_multihost(res, "db4", mesh=mesh)
    single = vt.modwt_multilevel(x, "db4", levels=LEVELS)
    print(f"MODWT parity vs single-device: {(res.approx - single.approx).abs().max():.2e}; "
          f"round trip: {(xr - x).abs().max():.2e}")
    print(f"output: ordinary tensors on {res.approx.device}")

    # The analytic communication model: exact bytes per chip per transform.
    rep = communication_report(mesh, "db4", levels=LEVELS, n=N, batch=2 * ROWS)
    print(f"ICI halo bytes/chip: {rep.ici_bytes_per_chip}  "
          f"DCN bytes/host: {rep.dcn_bytes_per_host}  "
          f"comm/compute: {rep.ici_fraction_of_compute_bytes:.4f}")

    # CWT: scales over "host", the signal tiled over "chip".
    sig = torch.as_tensor(rng.standard_normal(N), dtype=torch.float32, device=dev)
    scales = vt.scales_log(2.0, 32.0, 16)
    spec = cwt_tiled_2d(sig, scales, "morl", mesh=mesh)
    ref = vt.cwt(sig, scales, "morl", boundary="zero")
    print(f"CWT 2-axis parity vs single-device: {(spec.coeffs - ref.coeffs).abs().max():.2e}")


def one_rank(dev: torch.device, cpu: bool) -> None:
    import torch.distributed as dist

    if not cpu:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo" if cpu else "nccl")
    try:
        rank, world = dist.get_rank(), dist.get_world_size()
        mesh = make_multihost_mesh(devices=[dev] * CHIPS)  # this rank's row
        if rank == 0:
            print(f"mesh: {mesh.shape}, one row a rank, {CHIPS} shards of each rank's device")

        # every rank draws the same global batch and passes its own rows
        rng = np.random.default_rng(0)
        rows = rng.standard_normal((world * ROWS, N))[rank * ROWS:(rank + 1) * ROWS]
        x = torch.as_tensor(rows, dtype=torch.float32, device=dev)
        res = modwt_multilevel_multihost(x, "db4", levels=LEVELS, mesh=mesh)
        xr = imodwt_multilevel_multihost(res, "db4", mesh=mesh)
        single = vt.modwt_multilevel(x, "db4", levels=LEVELS)
        print(f"rank {rank}: rows {rank * ROWS}-{(rank + 1) * ROWS - 1}, MODWT parity vs "
              f"single-device {(res.approx - single.approx).abs().max():.2e}; round trip "
              f"{(xr - x).abs().max():.2e}", flush=True)

        rep = communication_report(mesh, "db4", levels=LEVELS, n=N, batch=world * ROWS)
        if rank == 0:
            print(f"ICI halo bytes/chip: {rep.ici_bytes_per_chip}  "
                  f"DCN bytes/host: {rep.dcn_bytes_per_host}")

        # the other facades run inside one process: give them this rank's row
        row = make_mesh({"chip": len(mesh.local_devices)}, devices=mesh.local_devices)
        scales = vt.scales_log(2.0, 32.0, 16)
        spec = cwt_tiled(x[0], scales, "morl", mesh=row, axis="chip")
        ref = vt.cwt(x[0], scales, "morl", boundary="zero")
        print(f"rank {rank}: tiled CWT over its row vs single-device: "
              f"{(spec.coeffs - ref.coeffs).abs().max():.2e}", flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = parser.parse_args(argv)
    dev = torch.device("cpu" if args.cpu else "cuda")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        one_rank(dev, args.cpu)
    else:
        one_process(dev)


if __name__ == "__main__":
    main()
