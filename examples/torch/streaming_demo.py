"""Streaming transforms on the PyTorch port: block, sliding-window and
denoiser streams.

Counterpart of ``examples/streaming_demo.py`` (the reference's
StreamingDenoiserDemo and MODWTStreamingDemo).  On the card a block of the
block stream is one launch of the cascade analysis kernel with the carried
history as its external edge, and the kernel-tier streaming denoiser one
launch of the fused denoise kernel in stream mode.

    python examples/torch/streaming_demo.py          # on the card
    python examples/torch/streaming_demo.py --cpu    # on the CPU
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np
import torch

import vectorwave_tpu_torch as vw
from vectorwave_tpu_torch.streaming import (
    SlidingStreamingTransform,
    StreamingDenoiser,
    StreamingTransform,
    kernel_streaming_denoiser_init,
    streaming_denoise_block_kernel,
)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    dev = torch.device("cpu" if parser.parse_args(argv).cpu else "cuda")
    torch.empty(0, device=dev)  # without a card and without --cpu this raises

    rng = np.random.default_rng(0)
    t = np.arange(4096)
    stream = (np.sin(2 * np.pi * t / 128) + 0.4 * rng.standard_normal(len(t))).astype(
        np.float32)

    # --- block streaming: equal to the whole-signal transform --------------
    xform = StreamingTransform("db4", levels=3, boundary="zero", device=dev)
    block_results = [xform.process(stream[i : i + 512]) for i in range(0, 4096, 512)]
    streamed_d1 = torch.cat([r.details[0] for r in block_results], dim=-1)
    whole = vw.modwt_multilevel(
        torch.as_tensor(stream, device=dev), "db4", levels=3, boundary="zero"
    )
    deviation = float((streamed_d1 - whole.details[0]).abs().max())
    print(f"block streaming vs whole-signal (level-1 detail): {deviation:.2e}")
    print(f"  statistics: {xform.statistics}")

    # --- sliding window with per-sample feeding ----------------------------
    sliding = SlidingStreamingTransform("db4", buffer_size=256, device=dev)
    emitted = 0
    for sample in stream[:1500]:
        if sliding.process_sample(float(sample)) is not None:
            emitted += 1
    print(
        f"sliding window: {emitted} windows over 1500 samples "
        f"(overlap {sliding.overlap}, step {sliding.step})"
    )

    # --- streaming denoiser (MAD noise tracking, ring window) --------------
    den = StreamingDenoiser("sym8", implementation="quality", levels=4, device=dev)
    cleaned = torch.cat(
        [den.denoise(stream[i : i + 512]) for i in range(0, 4096, 512)], dim=-1
    )
    clean_ref = np.sin(2 * np.pi * t / 128)
    before = float(np.sqrt(np.mean((stream - clean_ref) ** 2)))
    after = float(np.sqrt(np.mean((cleaned.cpu().numpy() - clean_ref) ** 2)))
    print(f"streaming denoise RMSE: {before:.3f} -> {after:.3f}")

    # --- kernel-tier streaming denoiser (the fused denoise kernel in stream
    # mode, one launch a block; routes automatically on a float32 CUDA
    # stream; forced here) -----------------------------------------------
    st = kernel_streaming_denoiser_init("sym8", levels=4, device=dev)
    outs = []
    for i in range(0, 4096, 512):
        st, blk = streaming_denoise_block_kernel(
            st, stream[i : i + 512], "sym8", levels=4
        )
        outs.append(blk.cpu().numpy())
    fused = np.concatenate(outs, axis=-1)
    after_k = float(np.sqrt(np.mean((fused - clean_ref) ** 2)))
    print(f"kernel-tier streaming denoise RMSE: {before:.3f} -> {after_k:.3f}")


if __name__ == "__main__":
    main()
