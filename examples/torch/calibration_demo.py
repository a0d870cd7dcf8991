"""Runtime performance learning on the PyTorch port: prediction,
calibration, backend routing.

Counterpart of ``examples/calibration_demo.py`` (the reference's
RuntimeLearningDemo, PerformanceCalibrationDemo and AdaptiveThresholdTuner
examples): predict a transform's cost with a confidence interval, tighten
the interval by measuring the device, and inspect how the router picks
the FFT or the rolled form for the plain periodic MODWT.  The JAX
example's ``jax.devices()`` becomes the card (or the CPU with
``--cpu``), which the cost model is calibrated on.

    python examples/torch/calibration_demo.py          # on the card
    python examples/torch/calibration_demo.py --cpu    # on the CPU
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np
import torch

from vectorwave_tpu_torch import cost_model
from vectorwave_tpu_torch.ops.facade import get_performance_info, should_use_fft
from vectorwave_tpu_torch.wavelets.registry import wavelet


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    dev = torch.device("cpu" if parser.parse_args(argv).cpu else "cuda")
    torch.empty(0, device=dev)  # without a card and without --cpu this raises

    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev.type} ({kind})")
    info = get_performance_info(device=dev)
    print(f"  {info.description}")
    print(f"  devices: {info.device_count}, CUDA kernels: {info.cuda_kernels}")

    # --- prediction BEFORE calibration: wide platform-default interval ---
    pred = cost_model.estimate_processing_time(65536, levels=6, batch=8, device=dev)
    print(f"\npredicted 8x64K 6-level round-trip: "
          f"{pred.estimated_seconds * 1e3:.2f} ms "
          f"[{pred.lower_seconds * 1e3:.2f}, {pred.upper_seconds * 1e3:.2f}] "
          f"(calibrated={pred.calibrated})")

    # --- calibrate: measure this device, persist the sustained rate ------
    rate = cost_model.calibrate(sizes=(16384,), batch=4, persist=True, device=dev)
    print(f"calibrated sustained rate: {rate / 1e6:.1f} Msamples/s")

    pred2 = cost_model.estimate_processing_time(65536, levels=6, batch=8, device=dev)
    print(f"after calibration: {pred2.estimated_seconds * 1e3:.2f} ms "
          f"[{pred2.lower_seconds * 1e3:.2f}, {pred2.upper_seconds * 1e3:.2f}] "
          f"(calibrated={pred2.calibrated})")

    # --- FFT-vs-rolled routing of the plain periodic MODWT ----------------
    # CPU tensors keep the JAX package's thresholds (the FFT for >= 64-tap
    # filters); CUDA tensors take the crossover measured on the card.
    print("\nFFT routing decisions (filter taps -> use FFT?):")
    for name in ("db4", "sym8", "dmey"):
        taps = len(wavelet(name).dec_lo)
        print(f"  {name:<5} ({taps:>2} taps, N=65536): "
              f"{should_use_fft(65536, taps, dev)}")
    print(f"  custom 96-tap filter, N=65536: {should_use_fft(65536, 96, dev)}")


if __name__ == "__main__":
    main()
