"""Checkpoint / resume on the PyTorch port: persist streaming state with
torch.save and continue exactly.

Counterpart of ``examples/checkpoint_resume_demo.py``.  Every stateful
carry of the port (block streaming, sliding windows, per-tick financial
analysis) is a NamedTuple of tensors and Python counters, so it saves with
``torch.save`` and loads with ``torch.load(weights_only=True)`` as
nested dicts; no bespoke serialization layer.  The JAX example does the
same with orbax and ``jax.tree``.

This demo interrupts a block stream mid-signal, saves the carry, restores
it into a freshly made state, and verifies the resumed run is
bit-identical to an uninterrupted one.

    python examples/torch/checkpoint_resume_demo.py          # on the card
    python examples/torch/checkpoint_resume_demo.py --cpu    # on the CPU
"""

import tempfile

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np
import torch

import vectorwave_tpu_torch as vw
from vectorwave_tpu_torch.finance import incremental_wavelet_init, incremental_wavelet_update
from vectorwave_tpu_torch.streaming import modwt_stream_block, streaming_init


def as_tree(state):
    """A carry as nested dicts and lists of tensors and numbers."""
    if hasattr(state, "_asdict"):
        return {k: as_tree(v) for k, v in state._asdict().items()}
    if isinstance(state, (tuple, list)):
        return [as_tree(v) for v in state]
    return state


def from_tree(template, tree):
    """Rebuild a carry shaped like ``template`` from :func:`as_tree`'s form."""
    if hasattr(template, "_asdict"):
        return type(template)(**{k: from_tree(v, tree[k])
                                 for k, v in template._asdict().items()})
    if isinstance(template, (tuple, list)):
        return type(template)(from_tree(t, v) for t, v in zip(template, tree))
    return tree


def leaves(tree):
    """Every tensor of a carry, in order."""
    if hasattr(tree, "_asdict"):
        tree = tuple(tree)
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in leaves(v)]
    return [tree]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    dev = torch.device("cpu" if parser.parse_args(argv).cpu else "cuda")
    torch.empty(0, device=dev)  # without a card and without --cpu this raises
    with tempfile.TemporaryDirectory(prefix="vw_ckpt_") as tmp:
        checkpoint_and_resume(dev, pathlib.Path(tmp))


def checkpoint_and_resume(dev, tmp: pathlib.Path) -> None:
    rng = np.random.default_rng(7)
    signal = rng.standard_normal(4096).astype(np.float32)
    blocks = [torch.as_tensor(signal[i : i + 512], device=dev) for i in range(0, 4096, 512)]

    # --- run the first half of a block stream ------------------------------
    state = streaming_init("db4", levels=3, device=dev)
    first_half = []
    for block in blocks[:4]:
        state, res = modwt_stream_block(state, block, "db4", boundary="zero")
        first_half.append(res)

    # --- checkpoint the carry (a NamedTuple of tensors and counters) -------
    ckpt_dir = tmp / "stream_state"
    ckpt_dir.mkdir()
    torch.save(as_tree(state), ckpt_dir / "state.pt")
    n_files = sum(1 for _ in ckpt_dir.rglob("*") if _.is_file())
    print(f"saved StreamingState -> {ckpt_dir} ({n_files} files)")

    # --- restore into a freshly made template and resume -------------------
    template = streaming_init("db4", levels=3, device=dev)  # structure only
    restored = from_tree(template, torch.load(ckpt_dir / "state.pt", weights_only=True,
                                              map_location=dev))

    second_half = []
    for block in blocks[4:]:
        restored, res = modwt_stream_block(restored, block, "db4", boundary="zero")
        second_half.append(res)

    resumed_d1 = torch.cat([r.details[0] for r in first_half + second_half], dim=-1)

    # --- ground truth 1: an uninterrupted stream (bit-exact contract) ------
    ref_state = streaming_init("db4", levels=3, device=dev)
    ref_parts = []
    for block in blocks:
        ref_state, res = modwt_stream_block(ref_state, block, "db4", boundary="zero")
        ref_parts.append(res)
    ref_d1 = torch.cat([r.details[0] for r in ref_parts], dim=-1)
    deviation = float((resumed_d1 - ref_d1).abs().max())
    print(f"resumed-after-checkpoint vs uninterrupted stream (level-1 detail): "
          f"{deviation:.2e}")
    assert deviation == 0.0, "checkpoint/resume must be bit-exact"

    # --- ground truth 2: the whole-signal transform (left-history contract;
    # the tolerance covers the kernel tier's float32 summation order) -------
    whole = vw.modwt_multilevel(torch.as_tensor(signal, device=dev), "db4", levels=3,
                                boundary="zero")
    wdev = float((resumed_d1 - whole.details[0]).abs().max())
    print(f"resumed stream vs whole-signal transform: {wdev:.2e}")
    assert wdev < 1e-4

    # --- the same recipe works for the per-tick finance carry --------------
    fstate = incremental_wavelet_init(device=dev)
    prices = 100.0 * np.exp(np.cumsum(rng.normal(0, 1e-3, 256))).astype(np.float32)
    for p in prices[:128]:
        fstate, _ = incremental_wavelet_update(fstate, p)
    fin_dir = tmp / "finance_state"
    fin_dir.mkdir()
    torch.save(as_tree(fstate), fin_dir / "state.pt")
    frestored = from_tree(incremental_wavelet_init(device=dev),
                          torch.load(fin_dir / "state.pt", weights_only=True,
                                     map_location=dev))
    for p in prices[128:]:
        fstate, ref_m = incremental_wavelet_update(fstate, p)
        frestored, got_m = incremental_wavelet_update(frestored, p)
    fdev = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(leaves(ref_m), leaves(got_m)))
    print(f"finance per-tick metrics after resume, max deviation: {fdev:.2e}")
    assert fdev == 0.0

    print("checkpoint/resume round trips are bit-exact")


if __name__ == "__main__":
    main()
