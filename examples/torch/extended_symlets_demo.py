"""Extended Symlets on the PyTorch port: sym2-sym20, near-linear phase, and
when to pick them.

Counterpart of ``examples/extended_symlets_demo.py`` (the reference's
ExtendedSymletDemo.java): every symlet is generated by least-asymmetric
spectral root selection, so the demo verifies the defining properties
instead of printing stored tables.

    python examples/torch/extended_symlets_demo.py          # on the card
    python examples/torch/extended_symlets_demo.py --cpu    # on the CPU
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np
import torch

import vectorwave_tpu_torch as vw


def group_delay_spread(h: np.ndarray) -> float:
    """Spread of the filter's group delay over the passband: the asymmetry
    measure symlets minimize (0 = exactly linear phase)."""
    n = 4096
    H = np.fft.rfft(h, n)
    phase = np.unwrap(np.angle(H))
    omega = np.linspace(0, np.pi, len(phase))
    gd = -np.gradient(phase, omega)
    band = np.abs(H) > 0.1 * np.abs(H).max()
    return float(np.std(gd[band]))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    dev = torch.device("cpu" if parser.parse_args(argv).cpu else "cuda")
    torch.empty(0, device=dev)  # without a card and without --cpu this raises

    syms = sorted(
        (n for n in vw.available_wavelets() if n.startswith("sym")),
        key=lambda s: int(s[3:]),
    )
    print(f"Symlets available: {len(syms)} ({syms[0]}..{syms[-1]})\n")

    print(f"{'wavelet':>8} {'taps':>5} {'phase spread':>13} {'db spread':>10}")
    for order in (4, 8, 12, 16, 20):
        sym = vw.wavelet(f"sym{order}")
        db = vw.wavelet(f"db{order}")
        s_spread = group_delay_spread(np.asarray(sym.dec_lo))
        d_spread = group_delay_spread(np.asarray(db.dec_lo))
        print(
            f"{'sym' + str(order):>8} {sym.filter_length:>5} "
            f"{s_spread:>13.3f} {d_spread:>10.3f}"
        )
    print("\nSame vanishing moments as dbN, far flatter group delay: features")
    print("in the reconstruction stay where they were in the signal.")

    # perfect reconstruction at every order, straight from the generator
    assert all(vw.wavelet(n).validate_perfect_reconstruction() for n in syms)
    wave = torch.sin(torch.arange(256.0, device=dev))
    worst = max(
        float(
            (vw.imodwt_multilevel(vw.modwt_multilevel(wave, n, levels=3), n) - wave)
            .abs().max()
        )
        for n in ("sym2", "sym10", "sym20")
    )
    print(f"\nPR holds for all {len(syms)} symlets; "
          f"worst 3-level round-trip error {worst:.2e}")

    # alignment in practice: denoise a spike train and measure feature drift
    rng = np.random.default_rng(0)
    x = np.zeros(1024, np.float64)
    x[256] = x[600] = 1.0
    noisy = torch.as_tensor(x + 0.05 * rng.standard_normal(1024),
                            dtype=torch.float32, device=dev)
    for name in ("db8", "sym8"):
        den = vw.denoise_multilevel(noisy, name, levels=4).cpu().numpy()
        drift = abs(int(np.argmax(den)) - 256)
        print(f"{name}: spike recovered at drift {drift} samples, "
              f"peak {den.max():.3f}")


if __name__ == "__main__":
    main()
