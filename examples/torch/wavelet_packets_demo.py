"""Wavelet packets on the PyTorch port: full-tree analysis, best basis,
packet-domain denoising.

Counterpart of ``examples/wavelet_packets_demo.py``: the binary filter-bank
tree refines the high-frequency side too, so narrowband structure that the
MODWT lumps into one detail level gets its own node.  On the card the
undecimated tree runs the hand-written filter-bank kernels.

    python examples/torch/wavelet_packets_demo.py          # on the card
    python examples/torch/wavelet_packets_demo.py --cpu    # on the CPU
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

    rng = np.random.default_rng(4)
    n = 1024
    t = np.arange(n)
    # two narrowband tones, one in a HIGH band where plain MODWT cannot separate
    sig = np.sin(2 * np.pi * 0.071 * t) + 0.8 * np.sin(2 * np.pi * 0.41 * t)
    x = torch.as_tensor(sig + 0.25 * rng.standard_normal(n), dtype=torch.float32,
                        device=dev)

    # --- full undecimated tree, frequency-ordered energy map ---------------
    depth = 4
    tree = vw.modwpt(x, "sym8", depth)
    energies = tree.energy_map().cpu().numpy()[vw.frequency_order(depth)]
    bands = vw.packet_frequency_bands(depth)[vw.frequency_order(depth)]
    print(f"depth-{depth} MODWPT, {len(energies)} leaves (frequency order):")
    top = np.argsort(energies)[::-1][:3]
    for i in sorted(top):
        print(f"  band [{bands[i][0]:.3f}, {bands[i][1]:.3f}) cycles/sample: "
              f"energy {energies[i]:.1f}")
    # energy is preserved at every depth (tight frame)
    print(f"energy check: leaves {float(energies.sum()):.3f} "
          f"vs signal {float((x ** 2).sum()):.3f}")

    # --- best basis adapts the tiling to the signal ------------------------
    basis = vw.best_basis(tree, cost="shannon")
    print(f"\nbest basis: {len(basis)} nodes "
          f"(vs {1 << depth} leaves / 1 root): {list(basis)[:6]} ...")
    xr = vw.reconstruct_basis(tree, basis, "sym8")
    print(f"best-basis reconstruction max err: "
          f"{float((xr - x).abs().max()):.2e}")

    # --- packet-domain denoising via the node-editing hook -----------------
    sigma = 0.25
    thr = sigma * float(np.sqrt(2 * np.log(n)))

    def soft(level, idx, c):
        return torch.sign(c) * torch.clamp(c.abs() - thr * 2.0 ** (-level / 2), min=0.0)

    den = vw.reconstruct_basis(tree, [(depth, i) for i in range(1 << depth)],
                               "sym8", transform_nodes=soft)
    clean = torch.as_tensor(sig, dtype=torch.float32, device=dev)
    mse_in = float(((x - clean) ** 2).mean())
    mse_out = float(((den - clean) ** 2).mean())
    print(f"\npacket-domain soft threshold: noise MSE {mse_in:.4f} -> {mse_out:.4f}")

    # the packaged best-basis denoiser does this in one call (and estimates
    # sigma from the noise floor across deepest-level nodes)
    auto = vw.denoise_packet(x, "sym8", depth)
    modwt_mse = float(((vw.denoise_multilevel(x, "sym8", levels=depth) - clean) ** 2).mean())
    print(f"denoise_packet: MSE {float(((auto - clean) ** 2).mean()):.4f} "
          f"(MODWT denoiser on the same signal: {modwt_mse:.4f})")

    # --- decimated WPT round trip ------------------------------------------
    dt = vw.wpt(x, "db4", 3)
    print(f"\ndecimated WPT leaf block: {tuple(dt.leaves.shape)} "
          f"(8 bands x {n // 8} coeffs), round-trip err "
          f"{float((vw.iwpt(dt, 'db4') - x).abs().max()):.2e}")


if __name__ == "__main__":
    main()
