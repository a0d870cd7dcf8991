"""Build and load the port's CUDA kernels.

The sources in ``csrc/`` have a plain C interface.  At first use each
``.cu`` unit is compiled by its own ``nvcc`` for Hopper (``sm_90a``), all at
once, and the objects are linked into one shared library, keyed by a hash
of the sources and flags, under ``kernels/_build/`` inside the package, and
loaded with ``ctypes``.  A build takes seconds; nothing here includes
PyTorch's headers.

There is no fallback: a missing toolkit or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).with_name("csrc")
BUILD_DIR = pathlib.Path(__file__).with_name("_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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


def compile_commands(out_dir: str | os.PathLike) -> list[tuple[pathlib.Path, list[str]]]:
    """One nvcc command per ``.cu`` unit, each compiling it to an object in
    ``out_dir``: ``[(object path, command), ...]``."""
    out_dir = pathlib.Path(out_dir)
    return [
        (out_dir / f"{unit.stem}.o",
         [nvcc(), *NVCC_FLAGS, "-c", "-o", str(out_dir / f"{unit.stem}.o"), str(unit)])
        for unit in sources() if unit.suffix == ".cu"
    ]


def link_command(objects, output: str | os.PathLike) -> list[str]:
    """The nvcc command that links the objects into the shared library."""
    return [nvcc(), *NVCC_FLAGS, "-shared", "-o", str(output), *map(str, objects)]


def _run_all(commands: list[list[str]]) -> None:
    """Start every command at once and wait for all; raise on any failure."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd in commands]
    failures = []
    for cmd, proc in zip(commands, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{' '.join(cmd)}\nexit code {proc.returncode}:\n{out}")
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))


def build() -> pathlib.Path:
    """Compile the library unless a build of the same sources exists: every
    unit by its own nvcc, all started together, then one link."""
    target = BUILD_DIR / f"libvw_modwt_{_digest()}.so"
    if target.exists():
        return target
    work = BUILD_DIR / f"{target.stem}.{os.getpid()}.tmp"
    work.mkdir(parents=True, exist_ok=True)
    units = compile_commands(work)
    _run_all([cmd for _, cmd in units])
    tmp = work / target.name
    _run_all([link_command([obj for obj, _ in units], tmp)])
    os.replace(tmp, target)
    shutil.rmtree(work, ignore_errors=True)
    return target


def _declare(lib: ctypes.CDLL) -> None:
    ptr, ptrs = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
    i64, i32 = ctypes.c_longlong, ctypes.c_int
    # (x, outs, taps, head, head_samples, halo, halo_len, batch, n, levels,
    #  taps_len, tile, edge, dtype, stream)
    lib.vw_modwt_analysis.argtypes = [ptr, ptrs, ptr, ptr, i32, ptr, i32, i64, i64, i32,
                                      i32, i32, i32, i32, ptr]
    # (ins, halos, halo_len, out, taps, batch, n, levels, taps_len, tile,
    #  periodic, dtype, stream)
    lib.vw_modwt_synthesis.argtypes = [ptrs, ptrs, i32, ptr, ptr, i64, i64, i32, i32,
                                       i32, i32, i32, ptr]
    # (x, out, thresholds, taps, halo, halo_len, batch, n, levels, taps_len,
    #  tile, periodic, mode, dtype, stream)
    lib.vw_modwt_denoise.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i64, i64, i32, i32,
                                     i32, i32, i32, i32, ptr]
    # (x_hi, x_lo, halo, halo_len, outs, taps, batch, n, first, levels,
    #  taps_len, tile, periodic, direct, stream)
    lib.vw_modwt_exact_analysis.argtypes = [ptr, ptr, ptr, i32, ptrs, ptr, i64, i64,
                                            i32, i32, i32, i32, i32, i32, ptr]
    # (ins, halos, halo_len, out_hi, out_lo, taps, batch, n, first, levels,
    #  taps_len, tile, periodic, direct, stream)
    lib.vw_modwt_exact_synthesis.argtypes = [ptrs, ptrs, i32, ptr, ptr, ptr, i64, i64,
                                             i32, i32, i32, i32, i32, i32, ptr]
    # (planes, signal, head, tail, taps, plan, batch, n, levels, taps_len, tile,
    #  width, span_l, span_r, adjoint, dtype, stream)
    lib.vw_modwt_symmetric_synthesis.argtypes = [ptrs, ptr, ptr, ptr, ptr, ptr, i64,
                                                 i64, i32, i32, i32, i32, i32, i32,
                                                 i32, i32, ptr]
    # (x, ll, lh, hl, hh, taps, batch, h, w, taps_len, spacing, edge, th, tw,
    #  pitch, row_pitch, block, stream)
    lib.vw_modwt2_analysis_level.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i64, i64,
                                             i64, i32, i32, i32, i32, i32, i32, i32,
                                             i32, ptr]
    # (ll, lh, hl, hh, out, taps, batch, h, w, taps_len, spacing, lo_sign, lo_off,
    #  hi_sign, hi_off, edge, th, tw, stages, pitch, row_pitch, block, stream)
    lib.vw_modwt2_synthesis_level.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i64, i64,
                                              i64, i32, i32, i32, i32, i32, i32, i32,
                                              i32, i32, i32, i32, i32, i32, ptr]
    # (x, outs, plane_runs, shifts, runs, values, group_bounds, groups, batch, n,
    #  planes, span, edge, dtype, stream)
    lib.vw_modwt_bank_analysis.argtypes = [ptr, ptrs, ptr, ptr, ptr, ptr,
                                           ctypes.POINTER(i32), i32, i64, i64, i32, i32,
                                           i32, i32, ptr]
    # (ins, out, plane_runs, spans, runs, values, batch, n, planes, span, shift,
    #  stages, edge, dtype, stream)
    lib.vw_modwt_bank_synthesis.argtypes = [ptrs, ptr, ptr, ptr, ptr, ptr, i64, i64, i32,
                                            i32, i32, i32, i32, i32, ptr]
    # a launch's tile for a preferred one: the cascade pair's, the denoise's
    # and the symmetric pair's, (taps_len, levels, n, tile[, edge]), the
    # exact pair's, (taps_len, first, levels, n, tile); and a block's shared
    # bytes, (taps_len, [first,] levels, tile)
    lib.vw_modwt_analysis_tile.argtypes = [i32, i32, i64, i32, i32]
    for fn in (lib.vw_modwt_synthesis_tile, lib.vw_modwt_denoise_tile,
               lib.vw_modwt_symmetric_synthesis_tile, lib.vw_modwt_symmetric_adjoint_tile):
        fn.argtypes = [i32, i32, i64, i32]
    for fn in (lib.vw_modwt_exact_analysis_tile, lib.vw_modwt_exact_synthesis_tile):
        fn.argtypes = [i32, i32, i32, i64, i32]
    for fn in (lib.vw_modwt_analysis_tile, lib.vw_modwt_synthesis_tile,
               lib.vw_modwt_denoise_tile, lib.vw_modwt_symmetric_synthesis_tile,
               lib.vw_modwt_symmetric_adjoint_tile, lib.vw_modwt_exact_analysis_tile,
               lib.vw_modwt_exact_synthesis_tile):
        fn.restype = i32
    for fn in (lib.vw_modwt_analysis_shared_bytes, lib.vw_modwt_synthesis_shared_bytes,
               lib.vw_modwt_denoise_shared_bytes,
               lib.vw_modwt_symmetric_synthesis_shared_bytes,
               lib.vw_modwt_symmetric_adjoint_shared_bytes):
        fn.argtypes, fn.restype = [i32, i32, i32], i64
    for fn in (lib.vw_modwt_exact_analysis_shared_bytes,
               lib.vw_modwt_exact_synthesis_shared_bytes):
        fn.argtypes, fn.restype = [i32, i32, i32, i32], i64
    for fn in (lib.vw_modwt_analysis, lib.vw_modwt_synthesis, lib.vw_modwt_denoise,
               lib.vw_modwt_exact_analysis, lib.vw_modwt_exact_synthesis,
               lib.vw_modwt_symmetric_synthesis, lib.vw_modwt2_analysis_level,
               lib.vw_modwt2_synthesis_level, lib.vw_modwt_bank_analysis,
               lib.vw_modwt_bank_synthesis):
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
