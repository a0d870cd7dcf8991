"""Long-signal CWT tiled across a mesh with two-sided support halos.

Counterpart of ``vectorwave_tpu/parallel/cwt_tiled.py``, the distributed
CWT of BASELINE config #5 ("CWT Morlet 64-scale on a 1M-sample signal,
tiles + halo").  The signal shards along time over a mesh axis; every shard
gathers the largest wavelet half-support as a halo from BOTH ring
neighbours (the CWT's kernel is two-sided, unlike the causal MODWT) and
runs the FFT path on its extended tile at the tile's own FFT size,
``nextpow2(n_loc + 4 halo)``, with the bank spectrum the single-device path
caches (``transforms.cwt._bank_spectrum``).  Edge shards see zeros beyond
the signal, which IS the zero boundary's linear convolution; ``periodic``
keeps the ring's wrap link.  So the result equals the single-device
``cwt(..., boundary=...)`` to float precision, except with
``analytic=True`` on a real wavelet, whose Hilbert transform is taken per
extended tile and is approximate near tile edges (about 1e-4; use a
complex wavelet, such as ``cmor``, for exact tiled analytic coefficients).

In one process the shards are the ``[B, T, n_loc]`` view of the signal and
the exchange is :func:`.tiled._gather_halo`, hop by hop where the halo
outgrows a shard.  The shards of one device are computed together, one
FFT product for all of them; their ``[R, S, fft_size]`` tiles land in the
``[..., S, N]`` result in one copy that cuts the halos and puts time back
in order.
"""

from __future__ import annotations

import torch

from ..errors import ErrorCode, InvalidArgumentError
from ..transforms.cwt import (
    CWTResult,
    _bank_spectrum,
    _half_support,
    _is_complex,
    _next_pow2,
    _resolve_continuous,
    validate_scales,
)
from .mesh import Mesh, _check_one_process
from .tiled import _gather_halo, _ring_perms


def _check_tiling(n: int, size: int, halo: int) -> None:
    """The JAX package's two refusals: an uneven split, and a halo that
    reaches past every other shard."""
    if n % size != 0:
        raise InvalidArgumentError(
            ErrorCode.DIST_TILE_TOO_SMALL,
            f"Signal length {n} must divide evenly across {size} shards",
            suggestions=("Pad the signal to a multiple of the mesh axis size",),
        )
    if halo > (n // size) * (size - 1) and size > 1:
        raise InvalidArgumentError(
            ErrorCode.DIST_TILE_TOO_SMALL,
            f"Wavelet support halo ({halo}) exceeds the reachable neighbor span",
            suggestions=("Use fewer shards or smaller maximum scale",),
        )


def _extended_tiles(x2: torch.Tensor, size: int, halo: int, axis: str, mesh: Mesh,
                    wrap: bool) -> torch.Tensor:
    """``[B, N]`` -> ``[B, T, halo + n_loc + halo]``: each shard between the
    halos its ring neighbours send (zeros past the ends without ``wrap``)."""
    shards = x2.reshape(x2.shape[0], size, -1)
    from_left, from_right = _ring_perms(axis, mesh, wrap)
    left = _gather_halo(shards, halo, from_left, "left")
    right = _gather_halo(shards, halo, from_right, "right")
    return torch.cat([left, shards, right], dim=2)


def _tile_cwt(ext: torch.Tensor, bank: torch.Tensor, fft_size: int, halo: int, n_loc: int,
              complex_out: bool, analytic: bool) -> torch.Tensor:
    """The FFT path on ``[R, E]`` extended tiles against ``[S, F]`` bank
    rows: ``[R, S, n_loc]``, a view of the tiles without their halos."""
    if complex_out:
        spec = torch.fft.fft(ext, n=fft_size, dim=-1)
        if analytic:
            freq = torch.fft.fftfreq(fft_size, dtype=ext.dtype, device=ext.device)
            spec = spec * torch.where(freq > 0, 2.0, torch.where(freq == 0, 1.0, 0.0))
        out = torch.fft.ifft(spec[:, None, :] * bank, dim=-1)
    else:
        spec = torch.fft.rfft(ext, n=fft_size, dim=-1)
        out = torch.fft.irfft(spec[:, None, :] * bank, n=fft_size, dim=-1)
    return out[..., halo:halo + n_loc]


def _runs(devices: list) -> list[tuple[int, int]]:
    """``(first, end)`` shard ranges of consecutive shards on one device."""
    runs, start = [], 0
    for q in range(1, len(devices) + 1):
        if q == len(devices) or devices[q] != devices[start]:
            runs.append((start, q))
            start = q
    return runs


def _tiled(x2: torch.Tensor, w, scales: tuple, groups: list, chips: list, axis: str,
           mesh: Mesh, boundary: str, analytic: bool) -> torch.Tensor:
    """The tiled CWT of ``[B, N]`` rows: ``groups`` are ``(first, end)``
    scale ranges, ``chips[g]`` the devices of group g's T shards.  Returns
    ``[B, S, N]`` on the device of ``x2``."""
    n, size = x2.shape[-1], len(chips[0])
    halo = max(_half_support(s, w.bandwidth) for s in scales)
    _check_tiling(n, size, halo)
    n_loc = n // size
    fft_size = _next_pow2(n_loc + 4 * halo)
    real_dtype = torch.float64 if x2.dtype == torch.float64 else torch.float32
    complex_dtype = torch.complex128 if real_dtype == torch.float64 else torch.complex64
    is_complex = _is_complex(w)
    complex_out = is_complex or analytic
    ext = _extended_tiles(x2.to(real_dtype), size, halo, axis, mesh,
                          boundary.lower().startswith("per"))
    b = x2.shape[0]
    out = torch.empty((b, len(scales), n), device=x2.device,
                      dtype=complex_dtype if complex_out else real_dtype)
    out4 = out.view(b, len(scales), size, n_loc)
    for (s0, s1), devices in zip(groups, chips):
        for q0, q1 in _runs(devices):
            dev = devices[q0]
            bank = _bank_spectrum(w, scales, fft_size, not complex_out, complex_dtype, dev)
            rows = ext[:, q0:q1].to(dev).reshape(b * (q1 - q0), -1)
            tile = _tile_cwt(rows, bank[s0:s1], fft_size, halo, n_loc, complex_out,
                             analytic and not is_complex)
            out4[:, s0:s1, q0:q1].copy_(
                tile.view(b, q1 - q0, s1 - s0, n_loc).transpose(1, 2))
    return out


def _axis_devices(mesh: Mesh, fixed: dict) -> list:
    """The devices along the one axis not in ``fixed`` (``{axis: index}``
    for every other axis)."""
    _check_one_process(mesh)
    names = mesh.axis_names
    free = [a for a in names if a not in fixed]
    (axis,) = free
    devices = []
    for i in range(mesh.axis_size(axis)):
        idx = tuple(i if a == axis else fixed[a] for a in names)
        devices.append(mesh.devices[idx])
    return devices


def cwt_tiled(
    x: torch.Tensor,
    scales,
    wavelet="morl",
    *,
    mesh: Mesh,
    axis: str = "signal",
    boundary: str = "zero",
    analytic: bool = False,
) -> CWTResult:
    """CWT of ``[..., N]`` signals sharded along their LAST axis over
    ``mesh[axis]``; ``[..., S, N]`` coefficients on the device of the
    mesh's first shard.

    Equals the single-device ``cwt(..., boundary=...)`` (float precision for
    real and complex wavelets); with ``analytic=True`` on a REAL wavelet the
    Hilbert transform is computed per extended tile and is approximate near
    tile boundaries (~1e-4 relative; use a complex wavelet, e.g. ``cmor``,
    for exact distributed analytic coefficients).  Mesh axes other than
    ``axis`` hold replicas; the first computes.
    """
    w = _resolve_continuous(wavelet)
    scales = validate_scales(scales)
    mesh.axis_size(axis)  # an axis the mesh lacks raises
    devices = _axis_devices(mesh, {a: 0 for a in mesh.axis_names if a != axis})
    n = x.shape[-1]
    x2 = x.reshape(-1, n).to(devices[0])
    out = _tiled(x2, w, scales, [(0, len(scales))], [devices], axis, mesh, boundary, analytic)
    return CWTResult(out.reshape(x.shape[:-1] + (len(scales), n)), scales, boundary)


def cwt_tiled_2d(
    x: torch.Tensor,
    scales,
    wavelet="morl",
    *,
    mesh: Mesh,
    signal_axis: str = "chip",
    scale_axis: str = "host",
    boundary: str = "zero",
) -> CWTResult:
    """CWT of a 1-D signal over a two-axis mesh: scales shard over
    ``scale_axis``, the signal tiles over ``signal_axis`` with two-sided
    support halos (BASELINE config #5's multi-host layout: the axis that
    crosses hosts carries the scale split, which needs no exchange during
    the transform; the halos stay on ``signal_axis``).

    Each scale group convolves the extended tiles of its row of the mesh
    against its own rows of the one cached bank spectrum.  Returns ``[S,
    N]`` on the device of the mesh's first shard; equals the single-device
    ``cwt(x, scales, w, boundary=...)`` to float precision.
    """
    w = _resolve_continuous(wavelet)
    scales = validate_scales(scales)
    if x.ndim != 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"cwt_tiled_2d expects a 1-D signal, got shape {tuple(x.shape)}",
            suggestions=("vmap over leading axes for batches",),
        )
    n = x.shape[-1]
    chips = mesh.axis_size(signal_axis)
    hosts = mesh.axis_size(scale_axis)
    if n % chips != 0:
        raise InvalidArgumentError(
            ErrorCode.DIST_TILE_TOO_SMALL,
            f"Signal length {n} must divide evenly across {chips} shards",
            suggestions=("Pad the signal to a multiple of the mesh axis size",),
        )
    if len(scales) % hosts != 0:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"{len(scales)} scales must divide evenly across {hosts} "
            f"'{scale_axis}' shards",
            suggestions=("Pad the scale list to a multiple of the host count",),
        )
    others = {a: 0 for a in mesh.axis_names if a not in (signal_axis, scale_axis)}
    per = len(scales) // hosts
    groups = [(h * per, (h + 1) * per) for h in range(hosts)]
    chip_devices = [_axis_devices(mesh, {**others, scale_axis: h}) for h in range(hosts)]
    x2 = x.reshape(1, n).to(chip_devices[0][0])
    out = _tiled(x2, w, scales, groups, chip_devices, signal_axis, mesh, boundary, False)
    return CWTResult(out[0], scales, boundary)
