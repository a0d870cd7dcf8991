"""Run one cell of the benchmark of vectorwave_tpu_torch on one CUDA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints earlier lines prefixed ``#``, then
one JSON object as the last line of standard output, and the compared
numbers beside their limits as the last lines of standard error.  Exits
non-zero, printing no result, without a CUDA card, and where anything of
JAX is loaded (``guard.FORBIDDEN``).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
#: Caches of the program and of the libraries it may use, at fixed paths in
#: the checkout so that only a checkout's first run builds.  The kernel
#: library itself builds into vectorwave_tpu_torch/kernels/_build/.
CACHE = HERE / ".cache"
for var, sub in (("VECTORWAVE_TPU_TORCH_CACHE", "vectorwave_tpu_torch"),
                 ("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
sys.path.insert(0, str(HERE.parent))

from portbench import guard  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    found = guard.forbidden_modules()
    if found:
        print(f"portbench: JAX modules loaded at start: {found}", file=sys.stderr)
        return 4
    import torch

    from portbench import core

    cell = core.load_cell(args.workload)
    chips = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = core.run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)
    found = guard.forbidden_modules()
    if found:
        print(f"portbench: JAX modules loaded after the window: {found}", file=sys.stderr)
        return 4
    sys.stdout.flush()
    for line in core.check_lines(result["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
