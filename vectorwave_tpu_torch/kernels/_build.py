"""Build and load the port's CUDA kernels.

The sources in ``csrc/`` have a plain C interface.  At first use they are
compiled by ``nvcc`` into one shared library for Hopper (``sm_90a``), keyed
by a hash of the sources and flags, under ``kernels/_build/`` inside the
package, and loaded with ``ctypes``.  A build takes seconds; nothing here
includes PyTorch's headers.

There is no fallback: a missing toolkit or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

CSRC = pathlib.Path(__file__).with_name("csrc")
BUILD_DIR = pathlib.Path(__file__).with_name("_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def sources() -> list[pathlib.Path]:
    """Every file the library is built from: the .cu units and their headers."""
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    """Path of ``nvcc`` in the CUDA toolkit PyTorch finds (``CUDA_HOME``,
    ``CUDA_PATH``, ``nvcc`` on ``PATH`` or the default install)."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "No CUDA toolkit found to build the vectorwave_tpu_torch kernels; "
            "set CUDA_HOME to a toolkit that has nvcc"
        )
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def compile_command(output: str | os.PathLike) -> list[str]:
    """The nvcc command that builds the library into ``output``."""
    units = [str(p) for p in sources() if p.suffix == ".cu"]
    return [nvcc(), *NVCC_FLAGS, "-o", str(output), *units]


def build() -> pathlib.Path:
    """Compile the library unless a build of the same sources exists."""
    target = BUILD_DIR / f"libvw_modwt_{_digest()}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    proc = subprocess.run(compile_command(tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, target)
    return target


def _declare(lib: ctypes.CDLL) -> None:
    ptr, ptrs = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
    i64, i32 = ctypes.c_longlong, ctypes.c_int
    # (x, outs, taps, batch, n, levels, taps_len, tile, periodic, dtype, stream)
    lib.vw_modwt_analysis.argtypes = [ptr, ptrs, ptr, i64, i64, i32, i32, i32, i32,
                                      i32, ptr]
    # (ins, out, taps, batch, n, levels, taps_len, tile, periodic, dtype, stream)
    lib.vw_modwt_synthesis.argtypes = [ptrs, ptr, ptr, i64, i64, i32, i32, i32,
                                       i32, i32, ptr]
    # (x, out, thresholds, taps, batch, n, levels, taps_len, tile, periodic,
    #  mode, dtype, stream)
    lib.vw_modwt_denoise.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i32, i32, i32,
                                     i32, i32, i32, ptr]
    for fn in (lib.vw_modwt_analysis, lib.vw_modwt_synthesis, lib.vw_modwt_denoise):
        fn.restype = i32


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
    return _lib
