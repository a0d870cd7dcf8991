"""Carry parameters across from the JAX package.

The two packages share no code, so these helpers take plain numpy arrays:
a filter bank exported from a ``vectorwave_tpu`` wavelet, a threshold
array, the planes of an exact-tier result or of a multi-level MODWT result,
the bands of a 2-D MODWT result, the levels of a packet tree or quadtree,
the coefficients of a DTCWT (1-D or 2-D), a CWT or a synchrosqueezed result, one of the four streaming states, the wavelet
variance stream's state or one of the two incremental tick states becomes
the port's object (a stream or a tick
stream checkpointed in JAX resumes in the port).
The parity tests use them so that both packages filter with identical taps
and each package's inverse can read the other's planes.
"""

from __future__ import annotations

import numpy as np
import torch

from .errors import ErrorCode, InvalidArgumentError
from .wavelets.base import DiscreteWavelet, WaveletType


def wavelet_from_arrays(
    name: str,
    dec_lo,
    dec_hi,
    rec_lo,
    rec_hi,
    *,
    family: str = "",
    vanishing_moments: int = 0,
) -> DiscreteWavelet:
    """A :class:`DiscreteWavelet` from four filter arrays (for example the
    ``dec_lo``/``dec_hi``/``rec_lo``/``rec_hi`` of a ``vectorwave_tpu``
    wavelet).  It is orthogonal when the reconstruction filters equal the
    decomposition filters, biorthogonal otherwise."""
    filters = [np.array(f, dtype=np.float64).reshape(-1) for f in
               (dec_lo, dec_hi, rec_lo, rec_hi)]
    if len({f.shape for f in filters}) != 1 or filters[0].size == 0:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            "the four filters must be non-empty and of equal length",
            context={"lengths": [f.size for f in filters]},
        )
    orthogonal = np.array_equal(filters[0], filters[2]) and np.array_equal(
        filters[1], filters[3]
    )
    return DiscreteWavelet(
        name=name,
        family=family,
        dec_lo=filters[0],
        dec_hi=filters[1],
        rec_lo=filters[2],
        rec_hi=filters[3],
        vanishing_moments=vanishing_moments,
        wavelet_type=WaveletType.ORTHOGONAL if orthogonal else WaveletType.BIORTHOGONAL,
    )


def _device(device) -> torch.device:
    """``device`` as a torch device; a CUDA device without a card raises
    rather than falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"device {device!r} was asked for, but there is no CUDA device",
            suggestions=("Pass device='cpu' to build the tensors on the CPU",),
        )
    return dev


def thresholds_from_numpy(thresholds, device="cuda") -> torch.Tensor:
    """A ``[..., J]`` threshold array as the float32 tensor the fused denoise
    takes, on ``device`` (default: the card; pass ``device="cpu"`` for the
    CPU).  Without a card the default raises."""
    arr = np.asarray(thresholds, dtype=np.float32)
    if arr.ndim < 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            "thresholds need a trailing level axis",
            context={"shape": arr.shape},
        )
    return torch.from_numpy(np.ascontiguousarray(arr)).to(_device(device))


def exact_result_from_arrays(details_hi, approx_hi, details_lo, approx_lo,
                             device="cuda"):
    """An :class:`~vectorwave_tpu_torch.ExactMODWTResult` from the float32
    (hi, lo) planes of an exact-tier result (for example the fields of a
    ``vectorwave_tpu`` ``ExactMODWTResult``), on ``device`` (default: the
    card; pass ``device="cpu"`` for the CPU).  Without a card the default
    raises."""
    from .transforms.multilevel import ExactMODWTResult

    dev = _device(device)

    def tensor(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    details_hi, details_lo = tuple(details_hi), tuple(details_lo)
    shapes = {np.shape(a) for a in (*details_hi, *details_lo, approx_hi, approx_lo)}
    if len(details_hi) != len(details_lo) or len(shapes) != 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            "every hi and lo plane must have the same shape, one lo per hi",
            context={"details_hi": len(details_hi), "details_lo": len(details_lo),
                     "shapes": sorted(shapes)},
        )
    return ExactMODWTResult(
        tuple(tensor(a) for a in details_hi), tensor(approx_hi),
        tuple(tensor(a) for a in details_lo), tensor(approx_lo),
    )


def modwt2_result_from_arrays(details, approx, device="cuda"):
    """A :class:`~vectorwave_tpu_torch.MultiLevelMODWT2Result` from the bands
    of a 2-D MODWT result as arrays (for example the fields of a
    ``vectorwave_tpu`` ``MultiLevelMODWT2Result``): ``details`` is one
    ``(lh, hl, hh)`` triple per level, ``approx`` the final ``ll``.  The
    dtype is kept; the tensors go to ``device`` (default: the card; pass
    ``device="cpu"`` for the CPU).  Without a card the default raises."""
    from .transforms.twodim import MultiLevelMODWT2Result

    dev = _device(device)

    def tensor(a):
        return torch.from_numpy(np.array(a)).to(dev)

    details = tuple(tuple(trip) for trip in details)
    shapes = {np.shape(a) for a in (approx, *(p for trip in details for p in trip))}
    if any(len(trip) != 3 for trip in details) or len(shapes) != 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            "every level needs an (lh, hl, hh) triple, all bands of one shape",
            context={"triples": [len(trip) for trip in details],
                     "shapes": sorted(shapes)},
        )
    return MultiLevelMODWT2Result(
        tuple(tuple(tensor(p) for p in trip) for trip in details), tensor(approx)
    )


def multilevel_result_from_arrays(details, approx, device="cuda"):
    """A :class:`~vectorwave_tpu_torch.MultiLevelMODWTResult` from the planes
    of a 1-D multi-level MODWT result as arrays (for example the fields of a
    ``vectorwave_tpu`` ``MultiLevelMODWTResult``, or a ``SparseRecovery``'s
    ``coeffs``): ``details`` finest first, ``approx`` the final
    approximation, all of one shape.  The dtype is kept; the tensors go to
    ``device`` (default: the card; pass ``device="cpu"`` for the CPU).
    Without a card the default raises."""
    from .transforms.multilevel import MultiLevelMODWTResult

    dev = _device(device)
    planes = [np.array(a) for a in (*details, approx)]
    if len(planes) < 2 or len({p.shape for p in planes}) != 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            "a multi-level result needs at least one detail plane, all planes of one shape",
            context={"shapes": [p.shape for p in planes]},
        )
    tensors = [torch.from_numpy(p).to(dev) for p in planes]
    return MultiLevelMODWTResult(tuple(tensors[:-1]), tensors[-1])


def packet2_tree_from_arrays(levels, device="cuda"):
    """A :class:`~vectorwave_tpu_torch.WaveletPacket2DTree` from the
    per-depth node arrays of a 2-D packet quadtree (for example the
    ``levels`` of a ``vectorwave_tpu`` ``WaveletPacket2DTree``):
    ``levels[j]`` is ``[..., 4^j, H_j, W_j]``.  The dtype is kept; the
    tensors go to ``device`` (default: the card; pass ``device="cpu"`` for
    the CPU).  Without a card the default raises."""
    from .transforms.packets2d import WaveletPacket2DTree

    dev = _device(device)
    arrays = [np.array(a) for a in levels]
    if not arrays or any(a.ndim < 3 or a.shape[-3] != (1 << (2 * j))
                         or a.shape[:-3] != arrays[0].shape[:-3]
                         for j, a in enumerate(arrays)):
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            "levels[j] must be [..., 4^j, H_j, W_j] with the same leading axes",
            context={"shapes": [a.shape for a in arrays]},
        )
    return WaveletPacket2DTree(tuple(torch.from_numpy(a).to(dev) for a in arrays))


def dtcwt2_result_from_arrays(highpasses, lowpasses, device="cuda"):
    """A :class:`~vectorwave_tpu_torch.DTCWT2Result` from the complex
    ``[..., 6, H_j, W_j]`` highpasses (finest first) and the real
    ``[..., 4, h, w]`` lowpasses of a 2-D DTCWT result as arrays (for
    example the fields of a ``vectorwave_tpu`` ``DTCWT2Result``).  The dtypes
    are kept; the tensors go to ``device`` (default: the card; pass
    ``device="cpu"`` for the CPU).  Without a card the default raises."""
    from .transforms.dtcwt2 import DTCWT2Result

    dev = _device(device)
    highs = [np.array(z) for z in highpasses]
    lows = np.array(lowpasses)
    halving = all(a.shape[-2:] == (2 * b.shape[-2], 2 * b.shape[-1])
                  for a, b in zip(highs, highs[1:]))
    if (not highs or not all(np.iscomplexobj(z) and z.ndim >= 3 and z.shape[-3] == 6
                             for z in highs)
            or not halving or lows.ndim < 3 or lows.shape[-3] != 4
            or lows.shape[-2:] != highs[-1].shape[-2:]):
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            "highpasses must be complex [..., 6, H_j, W_j], halving level by level, and "
            "the lowpasses [..., 4, h, w] of the coarsest highpass's size",
            context={"highpasses": [z.shape for z in highs], "lowpasses": lows.shape},
        )
    return DTCWT2Result(tuple(torch.from_numpy(z).to(dev) for z in highs),
                        torch.from_numpy(lows).to(dev))


def packet_tree_from_arrays(levels, device="cuda"):
    """A :class:`~vectorwave_tpu_torch.WaveletPacketTree` from the per-depth
    node arrays of a packet tree (for example the ``levels`` of a
    ``vectorwave_tpu`` ``WaveletPacketTree``): ``levels[j]`` is
    ``[..., 2^j, N_j]``.  The dtype is kept; the tensors go to ``device``
    (default: the card; pass ``device="cpu"`` for the CPU).  Without a card
    the default raises."""
    from .transforms.packets import WaveletPacketTree

    dev = _device(device)
    arrays = [np.array(a) for a in levels]
    if not arrays or any(a.ndim < 2 or a.shape[-2] != (1 << j)
                         or a.shape[:-2] != arrays[0].shape[:-2]
                         for j, a in enumerate(arrays)):
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            "levels[j] must be [..., 2^j, N_j] with the same leading axes",
            context={"shapes": [a.shape for a in arrays]},
        )
    return WaveletPacketTree(tuple(torch.from_numpy(a).to(dev) for a in arrays))


def dtcwt_result_from_arrays(highpasses, lowpass_a, lowpass_b, device="cuda"):
    """A :class:`~vectorwave_tpu_torch.DTCWTResult` from the complex
    highpasses (finest first) and the two real lowpasses of a DTCWT result as
    arrays (for example the fields of a ``vectorwave_tpu`` ``DTCWTResult``).
    The dtypes are kept; the tensors go to ``device`` (default: the card;
    pass ``device="cpu"`` for the CPU).  Without a card the default raises."""
    from .transforms.dtcwt import DTCWTResult

    dev = _device(device)
    highs = [np.array(z) for z in highpasses]
    low_a, low_b = np.array(lowpass_a), np.array(lowpass_b)
    halving = all(2 * b.shape[-1] == a.shape[-1] for a, b in zip(highs, highs[1:]))
    if (not highs or not all(np.iscomplexobj(z) for z in highs) or not halving
            or low_a.shape != low_b.shape or low_a.shape != highs[-1].shape):
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            "highpasses must be complex, halving in length level by level, and "
            "both lowpasses of the coarsest highpass's shape",
            context={"highpasses": [z.shape for z in highs],
                     "lowpasses": [low_a.shape, low_b.shape]},
        )
    return DTCWTResult(
        tuple(torch.from_numpy(z).to(dev) for z in highs),
        torch.from_numpy(low_a).to(dev), torch.from_numpy(low_b).to(dev),
    )


def cwt_result_from_arrays(coeffs, scales, boundary="zero", device="cuda"):
    """A :class:`~vectorwave_tpu_torch.CWTResult` from the ``[..., S, N]``
    coefficients of a CWT result as an array (real or complex, for example
    the fields of a ``vectorwave_tpu`` ``CWTResult``), its scales and its
    boundary.  The dtype is kept; the tensor goes to ``device`` (default:
    the card; pass ``device="cpu"`` for the CPU).  Without a card the default
    raises."""
    from .transforms.cwt import CWTResult, validate_scales

    dev = _device(device)
    arr = np.array(coeffs)
    scales = validate_scales(scales)
    if arr.ndim < 2 or arr.shape[-2] != len(scales):
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            "coefficients must be [..., S, N] with one row per scale",
            context={"shape": arr.shape, "scales": len(scales)},
        )
    if boundary not in ("zero", "periodic"):
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"Unknown CWT boundary {boundary!r}",
            suggestions=("Use 'zero' or 'periodic'",),
        )
    return CWTResult(torch.from_numpy(arr).to(dev), scales, boundary)


def sst_result_from_arrays(coeffs, freqs, scales, boundary="zero", device="cuda"):
    """A :class:`~vectorwave_tpu_torch.SSTResult` from the ``[..., B, N]``
    complex coefficients of a synchrosqueezed result as an array, its bin
    frequencies, the scales and boundary of its CWT (for example the fields
    of a ``vectorwave_tpu`` ``SSTResult``), on ``device`` (default: the
    card; pass ``device="cpu"`` for the CPU).  Without a card the default
    raises."""
    from .transforms.cwt import validate_scales
    from .transforms.sst import SSTResult

    dev = _device(device)
    arr = np.array(coeffs)
    freqs = np.array(freqs, dtype=np.float64).reshape(-1)
    if arr.ndim < 2 or arr.shape[-2] != freqs.size:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            "coefficients must be [..., B, N] with one row per frequency bin",
            context={"shape": arr.shape, "bins": freqs.size},
        )
    if boundary not in ("zero", "periodic"):
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"Unknown CWT boundary {boundary!r}",
            suggestions=("Use 'zero' or 'periodic'",),
        )
    return SSTResult(torch.from_numpy(arr).to(dev), freqs, validate_scales(scales), boundary)


# --- streaming states -----------------------------------------------------------


def _state_tensor(a, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(dev)


def _count(a) -> int:
    """A JAX state's device scalar (a counter) as the port's Python int."""
    arr = np.asarray(a)
    if arr.shape != ():
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE, "a state counter must be a scalar",
            context={"shape": arr.shape},
        )
    return int(arr)


def streaming_state_from_arrays(histories, blocks_processed, device="cuda"):
    """A :class:`~vectorwave_tpu_torch.streaming.StreamingState` from the
    fields of a ``vectorwave_tpu`` ``StreamingState`` as arrays: the
    per-level histories and the block counter, on ``device`` (default: the
    card; pass ``device="cpu"`` for the CPU).  Without a card the default
    raises."""
    from .streaming.stream import StreamingState

    dev = _device(device)
    return StreamingState(tuple(_state_tensor(h, dev) for h in histories),
                          _count(blocks_processed))


def kernel_streaming_state_from_arrays(history, blocks_processed, device="cuda"):
    """A :class:`~vectorwave_tpu_torch.streaming.KernelStreamingState` from
    the fields of a ``vectorwave_tpu`` ``KernelStreamingState`` as arrays
    (the raw-input tail and the block counter), on ``device``."""
    from .streaming.stream import KernelStreamingState

    dev = _device(device)
    return KernelStreamingState(_state_tensor(history, dev), _count(blocks_processed))


def streaming_denoiser_state_from_arrays(histories, blocks_processed, noise_window,
                                         window_pos, window_fill, device="cuda"):
    """A :class:`~vectorwave_tpu_torch.streaming.StreamingDenoiserState` from
    the fields of a ``vectorwave_tpu`` ``StreamingDenoiserState`` as arrays:
    its transform's histories and block counter, the noise window and the
    window's cursor and fill, on ``device``."""
    from .streaming.denoiser_stream import StreamingDenoiserState

    dev = _device(device)
    return StreamingDenoiserState(
        streaming_state_from_arrays(histories, blocks_processed, dev),
        _state_tensor(noise_window, dev), _count(window_pos), _count(window_fill),
    )


def kernel_streaming_denoiser_state_from_arrays(history, noise_window, window_pos,
                                                window_fill, device="cuda"):
    """A :class:`~vectorwave_tpu_torch.streaming.KernelStreamingDenoiserState`
    from the fields of a ``vectorwave_tpu`` ``KernelStreamingDenoiserState``
    as arrays, on ``device``."""
    from .streaming.denoiser_stream import KernelStreamingDenoiserState

    dev = _device(device)
    return KernelStreamingDenoiserState(
        _state_tensor(history, dev), _state_tensor(noise_window, dev),
        _count(window_pos), _count(window_fill),
    )


def variance_stream_state_from_arrays(sumsq, counts, position, device="cuda"):
    """A :class:`~vectorwave_tpu_torch.VarianceStreamState` from the fields
    of a ``vectorwave_tpu`` ``VarianceStreamState`` as arrays: the
    ``[..., J]`` sums of squares (dtype kept), the ``[J]`` per-level counts
    and the position, on ``device`` (default: the card; pass
    ``device="cpu"`` for the CPU).  The counters become host numbers."""
    from .transforms.variance import VarianceStreamState

    dev = _device(device)
    sums = np.array(sumsq)
    per_level = np.array(counts, dtype=np.int64)
    if per_level.ndim != 1 or sums.ndim < 1 or sums.shape[-1] != per_level.shape[0]:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            "sumsq needs a trailing level axis as long as counts",
            context={"sumsq": sums.shape, "counts": per_level.shape},
        )
    return VarianceStreamState(_state_tensor(sums, dev), per_level, _count(position))


# --- incremental tick states -------------------------------------------------------


def incremental_state_from_arrays(count, last_price, mean_return, var_return, ewma_vol_fast,
                                  ewma_vol_slow, peak_price, max_drawdown, device="cuda"):
    """A :class:`~vectorwave_tpu_torch.finance.IncrementalState` from the
    scalar fields of a ``vectorwave_tpu`` ``IncrementalState`` as arrays, in
    field order, on ``device`` (default: the card; pass ``device="cpu"`` for
    the CPU).  The dtype is kept."""
    from .finance.incremental import IncrementalState

    dev = _device(device)
    fields = (count, last_price, mean_return, var_return, ewma_vol_fast, ewma_vol_slow,
              peak_price, max_drawdown)
    if any(np.shape(a) != () for a in fields):
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE, "every incremental state field is a scalar",
            context={"shapes": [np.shape(a) for a in fields]},
        )
    return IncrementalState(*(_state_tensor(a, dev) for a in fields))


def incremental_wavelet_state_from_arrays(base, ret_window, ema12, ema26, ema50, wavelet_vol,
                                          max_crash_score, device="cuda"):
    """A :class:`~vectorwave_tpu_torch.finance.IncrementalWaveletState` from
    the fields of a ``vectorwave_tpu`` ``IncrementalWaveletState``: ``base``
    the eight fields of its ``IncrementalState`` in order, the ``[K]``
    return window and the scalars, on ``device`` (default: the card)."""
    from .finance.incremental import IncrementalWaveletState

    dev = _device(device)
    window = np.array(ret_window)
    if window.ndim != 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE, "the return window is one [K] vector",
            context={"shape": window.shape},
        )
    return IncrementalWaveletState(
        incremental_state_from_arrays(*base, device=dev), _state_tensor(window, dev),
        *(_state_tensor(a, dev) for a in (ema12, ema26, ema50, wavelet_vol, max_crash_score)),
    )
