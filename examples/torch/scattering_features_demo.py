"""Scattering features on the PyTorch port: separating signal classes a
spectrogram confuses.

Counterpart of ``examples/scattering_features_demo.py``: three classes
with the same power spectrum band but different temporal structure (a
steady tone, an amplitude-modulated tone, and tone bursts) are nearly
indistinguishable by first-order (spectral) energies but separate cleanly
in the second-order scattering coefficients.

    python examples/torch/scattering_features_demo.py          # on the card
    python examples/torch/scattering_features_demo.py --cpu    # on the CPU
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np
import torch

import vectorwave_tpu_torch as vw


def make_class(kind, seed, n=4096, f0=0.1):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    phase = rng.uniform(0, 2 * np.pi)
    carrier = np.cos(2 * np.pi * f0 * t + phase)
    if kind == "steady":
        x = carrier
    elif kind == "am":
        x = carrier * (1 + 0.8 * np.cos(2 * np.pi * 0.004 * t + phase))
    else:  # bursts
        envelope = (np.sin(2 * np.pi * 0.002 * t + phase) > 0).astype(float)
        x = carrier * envelope * 1.8
    x = x + 0.05 * rng.standard_normal(n)
    return (x / x.std()).astype(np.float32)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    dev = torch.device("cpu" if parser.parse_args(argv).cpu else "cuda")
    torch.empty(0, device=dev)  # without a card and without --cpu this raises

    classes = ("steady", "am", "bursts")
    per_class = 8
    signals = np.stack(
        [make_class(c, 100 * i + j) for i, c in enumerate(classes)
         for j in range(per_class)]
    )
    res = vw.scattering1d(torch.as_tensor(signals, device=dev), J=8, Q=8)
    feats = res.feature_vector().cpu().numpy()
    n1 = len(res.xi1)
    s1_feats = feats[:, 1 : 1 + n1]
    s2_feats = feats[:, 1 + n1 :]

    def class_separation(f):
        """Fisher-style: between-class distance / within-class spread."""
        groups = f.reshape(len(classes), per_class, -1)
        centroids = groups.mean(axis=1)
        within = np.mean([np.linalg.norm(g - c, axis=1).mean()
                          for g, c in zip(groups, centroids)])
        between = np.mean([np.linalg.norm(centroids[i] - centroids[j])
                           for i in range(3) for j in range(i + 1, 3)])
        return between / within

    print("class separation (between/within centroid distance):")
    print(f"  order-1 (spectral) features : {class_separation(s1_feats):5.1f}")
    print(f"  order-2 (modulation) features: {class_separation(s2_feats):5.1f}")

    # nearest-centroid accuracy, leave-one-out on order-2 features
    groups = s2_feats.reshape(3, per_class, -1)
    correct = 0
    for ci in range(3):
        for j in range(per_class):
            cents = [
                np.delete(groups[k], j, axis=0).mean(axis=0) if k == ci
                else groups[k].mean(axis=0)
                for k in range(3)
            ]
            pred = int(np.argmin([np.linalg.norm(groups[ci, j] - c)
                                  for c in cents]))
            correct += pred == ci
    print(f"nearest-centroid accuracy on order-2 features: "
          f"{correct}/{3 * per_class}")


if __name__ == "__main__":
    main()
