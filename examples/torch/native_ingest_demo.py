"""Real-time ingest on the PyTorch port: a producer thread feeds the native
ring buffer while the consumer drains batched sliding-window transforms.

Counterpart of ``examples/native_ingest_demo.py``: the host-side half of
the reference's streaming pipeline (MODWTStreamingTransformImpl.java's
circular buffer and JVM feed thread) as the C++ SPSC ring buffer in
``vectorwave_tpu_torch.native``, with window assembly and one batched
transform a drain whatever the backlog.

    python examples/torch/native_ingest_demo.py          # on the card
    python examples/torch/native_ingest_demo.py --cpu    # on the CPU
"""

import threading
import time

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np
import torch

import vectorwave_tpu_torch as vw
from vectorwave_tpu_torch.native import RingBuffer, native_available
from vectorwave_tpu_torch.streaming import StreamIngest


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    dev = torch.device("cpu" if parser.parse_args(argv).cpu else "cuda")
    torch.empty(0, device=dev)  # without a card and without --cpu this raises

    vw.enable_compilation_cache()  # the first run builds the ring; later runs load it
    print(f"native C++ backend available: {native_available()}")

    # --- raw ring buffer: overlap-retaining frame assembly ------------------
    rb = RingBuffer(capacity=4096)
    rb.push(np.arange(100.0))
    frames = rb.pop_frames(frame_len=16, hop=10)
    print(f"frames from 100 ticks (len 16, hop 10): {frames.shape}; "
          f"frame[1] starts at {frames[1, 0]:.0f}, overlap kept = 6 ticks")

    # --- live pipeline: producer thread -> batched window transforms --------
    rng = np.random.default_rng(0)
    n_total = 50_000
    t = np.arange(n_total)
    feed = (np.sin(2 * np.pi * t / 500.0)
            + 0.3 * rng.standard_normal(n_total)).astype(np.float32)

    ingest = StreamIngest("db4", buffer_size=512, levels=4, capacity=16384, device=dev)
    print(f"window={ingest.buffer_size} overlap={ingest.overlap} "
          f"step={ingest.step} backend={ingest.ring.backend}")

    def producer():
        i = 0
        while i < n_total:
            n = min(int(rng.integers(100, 2000)), n_total - i)
            accepted = ingest.push(feed[i : i + n])
            i += accepted  # bounded buffer: retry the rejected tail
            time.sleep(0.0005)

    worker = threading.Thread(target=producer)
    worker.start()
    drains = 0
    energies = []

    def consume(out):
        nonlocal drains
        drains += 1
        # per-window detail-energy profile at the finest level
        energies.append(out.details[0].square().mean(dim=-1).cpu().numpy())

    # Drain in fixed batches of 8 while the feed is live, then flush the
    # tail.
    while worker.is_alive() or ingest.ready >= 8:
        if ingest.ready >= 8:
            consume(ingest.drain(max_frames=8))
        else:
            time.sleep(0.002)
    worker.join()
    while ingest.ready:
        consume(ingest.drain(max_frames=min(8, ingest.ready)))
    energy = np.concatenate(energies)
    stats = ingest.statistics
    print(f"drains={drains}, windows={stats['windows_emitted']} "
          f"(avg {stats['windows_emitted'] / max(drains, 1):.1f} windows/dispatch)")
    print(f"finest-detail energy: mean={energy.mean():.4f} "
          f"min={energy.min():.4f} max={energy.max():.4f}")
    assert stats["windows_emitted"] == 1 + (n_total - 512) // ingest.step


if __name__ == "__main__":
    main()
