"""Distributed transforms over a device mesh on the PyTorch port.

Counterpart of ``examples/distributed_demo.py``: batch sharding (data
parallel), long-signal tiling with halo exchange (sequence parallel) and a
tiled CWT, each against its single-device transform.  A mesh is a grid of
torch devices in one process, and a device may repeat: on one card the
eight shards are virtual (``[torch.device("cuda")] * 8``); with several
cards pass their devices.

    python examples/torch/distributed_demo.py          # on the card
    python examples/torch/distributed_demo.py --cpu    # 8 shards on the CPU
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np
import torch

import vectorwave_tpu_torch as vt
from vectorwave_tpu_torch.parallel import (
    cwt_tiled,
    imodwt_multilevel_tiled,
    make_mesh,
    modwt_multilevel_sharded_batch,
    modwt_multilevel_tiled,
)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    dev = torch.device("cpu" if parser.parse_args(argv).cpu else "cuda")
    rng = np.random.default_rng(0)

    def signal(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)

    # --- long-signal tiling: one signal across 8 shards --------------------
    mesh = make_mesh({"signal": 8}, devices=[dev] * 8)
    x = signal(16384)
    res = modwt_multilevel_tiled(x, "db4", levels=4, mesh=mesh, boundary="symmetric")
    single = vt.modwt_multilevel(x, "db4", levels=4, boundary="symmetric")
    print(f"tiled symmetric analysis vs single-device: "
          f"{(res.approx - single.approx).abs().max():.2e}")
    xr = imodwt_multilevel_tiled(res, "db4", mesh=mesh, boundary="symmetric")
    xr_single = vt.imodwt_multilevel(single, "db4", boundary="symmetric")
    print(f"tiled symmetric inverse vs single-device: {(xr - xr_single).abs().max():.2e}")

    # --- batch sharding: 16 signals over a data axis -----------------------
    mesh2 = make_mesh({"data": 8}, devices=[dev] * 8)
    res_b = modwt_multilevel_sharded_batch(signal(16, 4096), "db4", levels=4, mesh=mesh2,
                                           axis="data")
    energies = res_b.relative_energy_distribution()
    print(f"sharded batch energies shape: {tuple(energies.shape)}")

    # --- distributed CWT: signal tiled, scales batched ---------------------
    y = signal(8192)
    scales = vt.scales_log(2, 64, 16)
    spec = cwt_tiled(y, scales, "morl", mesh=mesh, boundary="zero")
    ref = vt.cwt(y, scales, "morl", boundary="zero")
    print(f"tiled CWT vs single-device: {(spec.coeffs - ref.coeffs).abs().max():.2e}")


if __name__ == "__main__":
    main()
