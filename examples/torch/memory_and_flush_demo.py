"""Streaming memory behaviour on the PyTorch port: bounded state, flush
semantics, large signals.

Counterpart of ``examples/memory_and_flush_demo.py`` (the reference's
MemoryEfficiencyMODWTDemo and BatchStreamingFlushExample): process an
arbitrarily long signal in fixed-size blocks with O(levels * filter)
carried state, and drain the tail correctly with flush().  On the card
block streaming keeps the working set in device memory bounded whatever
the signal's length.

    python examples/torch/memory_and_flush_demo.py          # on the card
    python examples/torch/memory_and_flush_demo.py --cpu    # on the CPU
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np
import torch

import vectorwave_tpu_torch as vw
from vectorwave_tpu_torch.streaming.stream import (
    StreamingTransform,
    history_length,
    suggest_flush_tail_length,
)

WAVELET, LEVELS = "db4", 4
BLOCK, N_BLOCKS = 1024, 64  # 65536 samples total, never held at once


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    dev = torch.device("cpu" if parser.parse_args(argv).cpu else "cuda")
    torch.empty(0, device=dev)  # without a card and without --cpu this raises

    rng = np.random.default_rng(9)
    full = rng.standard_normal(BLOCK * N_BLOCKS)

    # Carried state is tiny and CONSTANT in signal length:
    l0 = len(vw.wavelet(WAVELET).dec_lo)
    hist = sum(history_length(l0, j) for j in range(1, LEVELS + 1))
    state_bytes = hist * 8
    signal_bytes = full.nbytes
    print(f"signal {signal_bytes/1e6:.1f} MB; carried history {hist} samples "
          f"({state_bytes/1e3:.1f} kB) — {signal_bytes/state_bytes:.0f}x smaller")

    stream = StreamingTransform(WAVELET, levels=LEVELS, device=dev)
    outputs = [stream.process(full[i * BLOCK:(i + 1) * BLOCK])
               for i in range(N_BLOCKS)]

    # flush() drains the history tail so nothing is lost at end-of-stream.
    tail = suggest_flush_tail_length(WAVELET, LEVELS)
    flushed = stream.flush(tail)
    print(f"flush tail: {tail} samples, flushed block shape "
          f"{tuple(flushed.approx.shape)}")

    # Streamed output matches the whole-signal transform (streaming is
    # causal, so parity is defined against the zero-extension boundary).
    whole = vw.modwt_multilevel(
        torch.as_tensor(full, dtype=torch.float32, device=dev), WAVELET, levels=LEVELS,
        boundary="zero",
    )
    streamed_a = torch.cat([o.approx for o in outputs])
    err = float((streamed_a - whole.approx).abs().max())
    print(f"streamed vs whole-signal approx, max error: {err:.2e}")

    stats = stream.statistics
    print(f"processed: {stats['samples_processed']} samples in "
          f"{stats['blocks_processed']} blocks")


if __name__ == "__main__":
    main()
