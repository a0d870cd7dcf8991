"""CWT workflow on the PyTorch port: scale selection, time-frequency
analysis, reconstruction.

Counterpart of ``examples/cwt_analysis_demo.py`` (the reference's CWTDemo,
ScaleSelectionDemo and InverseCWTDemo).

    python examples/torch/cwt_analysis_demo.py          # on the card
    python examples/torch/cwt_analysis_demo.py --cpu    # on the CPU
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np
import torch

import vectorwave_tpu_torch as vw


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    dev = torch.device("cpu" if parser.parse_args(argv).cpu else "cuda")
    torch.empty(0, device=dev)  # without a card and without --cpu this raises

    fs = 1000.0
    t = np.arange(4096) / fs
    # chirp + a burst: classic time-frequency test signal
    x_np = np.sin(2 * np.pi * (20 + 30 * t) * t)
    x_np[2000:2200] += 0.8 * np.sin(2 * np.pi * 180 * t[2000:2200])
    x = torch.as_tensor(x_np, dtype=torch.float32, device=dev)

    # --- adaptive scale selection (the 4th selector) -----------------------
    cfg = vw.ScaleSelectionConfig(sampling_rate=fs, scales_per_octave=8)
    scales = vw.select_scales_adaptive(x_np, "morl", cfg)
    lo, hi = vw.frequency_range_of_scales(scales, "morl", fs)
    print(f"adaptive selection: {len(scales)} scales covering "
          f"{lo:.1f}-{hi:.1f} Hz")

    # --- transform + ridge extraction --------------------------------------
    res = vw.cwt(x, scales, "morl", config=vw.CWTConfig(boundary="zero"))
    # small on-device reductions before pulling anything to the host
    power_cols = res.power()[:, 960:1040].mean(dim=-1).cpu().numpy()
    freqs = np.asarray(vw.scale_to_frequency(np.asarray(scales), "morl")) * fs
    in_band = (freqs > 10) & (freqs < 400)  # ignore drift-scale leakage
    ridge = float(freqs[in_band][power_cols[in_band].argmax()])
    print(f"chirp ridge frequency at t=1s: {ridge:.0f} Hz "
          f"(instantaneous f = 20 + 60t -> ~80)")
    burst_band = res.power()[:, 2050:2150].mean(dim=-1).cpu().numpy()
    f_burst = float(freqs[in_band][burst_band[in_band].argmax()])
    print(f"burst detected near {f_burst:.0f} Hz (expect ~180)")

    # --- analytic (Hilbert) coefficients for phase -------------------------
    res_c = vw.cwt(x, (8.0,), "morl", analytic=True)
    cvals = res_c.coeffs[0, 500:1500].cpu().numpy()
    inst_phase = np.unwrap(np.angle(cvals))
    print(f"analytic path: phase advances monotonically: "
          f"{bool(np.median(np.diff(inst_phase)) > 0)}")

    # --- reconstruction (periodic mode round-trips exactly when the scale
    # grid covers DC..Nyquist; burst edges are broadband, so go to ~1.2) ----
    sc = vw.scales_log(1.2, 1024, 128)
    res_p = vw.cwt(x, sc, "morl", boundary="periodic")
    xr = vw.icwt(res_p, "morl")
    err = float((xr - x).abs().max())
    print(f"equalized icwt round-trip error: {err:.2e}")

    # band-limited reconstruction isolates the burst
    band = vw.reconstruct_frequency_band(res_p, "morl", 150 / fs, 220 / fs)
    ratio = float(band[2050:2150].abs().mean() / (band[:1000].abs().mean() + 1e-12))
    print(f"150-220 Hz band energy concentrates at the burst: {ratio:.0f}x")


if __name__ == "__main__":
    main()
