#!/usr/bin/env python3
"""Record what the JAX examples print, as the figures the port's examples
are held to.

Runs each ``examples/<name>.py`` that has a counterpart under
``examples/torch/`` on the CPU (``JAX_PLATFORMS=cpu``), each in its own
process and unchanged, and writes its standard output to
``tests/torch_examples_expected/<name>.txt``.  The machine with the card has
no JAX, so the port's tests and ``chip_smoke.py`` read these files.

    python3 tools/record_jax_examples.py              # every example
    python3 tools/record_jax_examples.py swt_demo     # only those named
    python3 tools/record_jax_examples.py --jobs 4     # several at once
"""

import argparse
import concurrent.futures
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
EXPECTED = ROOT / "tests" / "torch_examples_expected"

#: the parallel tier's examples, held by ``tests/test_torch_examples.py``
#: to their own parity figures instead of a recording
UNRECORDED = ("multihost_demo", "distributed_demo", "parallel_denoising")


def recorded_names() -> list[str]:
    """The JAX examples that are recorded: every ``examples/*.py`` but the
    parallel tier's three."""
    return sorted(p.stem for p in EXAMPLES.glob("*.py") if p.stem not in UNRECORDED)


def record(name: str, timeout: float = 600.0) -> tuple[str, float]:
    """Run one JAX example on the CPU and write its standard output."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONHASHSEED="0")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(EXAMPLES / f"{name}.py")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{name} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    EXPECTED.mkdir(parents=True, exist_ok=True)
    (EXPECTED / f"{name}.txt").write_text(proc.stdout)
    return name, seconds


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("names", nargs="*", help="examples to record (default: all)")
    parser.add_argument("--jobs", type=int, default=1, help="examples run at once")
    args = parser.parse_args(argv)
    names = args.names or recorded_names()
    with concurrent.futures.ThreadPoolExecutor(max_workers=args.jobs) as pool:
        for name, seconds in pool.map(record, names):
            print(f"{name}: {seconds:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
