"""The general multi-output filter bank: wrappers, plain versions, gradients.

Counterpart of the ``planes_override`` mode of the JAX package's composite
pair (``run_analysis_composite(..., planes_override=)`` and
``run_synthesis_composite(..., planes_override=)`` in
``vectorwave_tpu/kernels/modwt_mxu.py``) and of ``_bank_ana_core`` /
``_bank_syn_core`` in ``vectorwave_tpu/transforms/packets.py``:

* :func:`bank_analysis`: plane p is x filtered with backward reads by its
  own dense tap vector, ``out_p[t] = sum_tau f_p[tau] x[t - tau]``, with a
  periodic or zero left edge; :func:`bank_analysis_stacked` returns the
  planes as the one ``[P, B, N]`` tensor the launch writes;
* :func:`bank_synthesis`: the adjoint, with forward reads,
  ``out[t] = sum_p sum_tau f_p[tau] c_p[t + tau]``, periodic or zero right
  edge.

===========================  ==============================  ==========================================
wrapper                      CUDA source                     TPU kernel mode it replaces
===========================  ==============================  ==========================================
:func:`bank_analysis`        ``modwt_bank_analysis.cu``      ``_composite_analysis_call``, planes_override
:func:`bank_synthesis`       ``modwt_bank_synthesis.cu``     ``_composite_synthesis_call``, planes_override
===========================  ==============================  ==========================================

``dense`` is a tuple of tuples of Python floats, one dense tap vector per
plane, composed in float64 on the host; the kernels take the non-zero taps
rounded once to fp32, so an à trous filter costs its L non-zeros and not
its (L-1)s+1 dense taps, as runs of taps on one stride (:class:`BankRuns`,
cut from the per-plane (offset, value) lists of :class:`BankTaps`), which
their register-blocked threads step through: the analysis a stride per
plane, the synthesis one stride for all planes, since its threads sum the
planes into the same outputs.
Both compute in fp32 and store in the input type (float32 or bfloat16), any
N >= 1, up to :data:`MAX_PLANES` planes; periodic wrap is taken modulo N, so
a filter longer than the signal is served.  The plain versions
(``bank_*_plain``) are sums of shifted slices over the non-zero taps, in
float64 for float64 input and in float32 otherwise.  A wrapper given a CPU
tensor runs its plain version; given a CUDA tensor it launches its kernel
or raises.  Launches count under ``modwt_bank_analysis`` and
``modwt_bank_synthesis`` in :data:`.modwt_composite.LAUNCHES`.

With the same taps each direction is the other's transpose, edges included,
so each is a ``torch.autograd.Function`` whose backward is one launch of
the other.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..errors import ErrorCode, InvalidArgumentError
from ..ops.constants import kept
from ._build import library
from .modwt_composite import (
    LAUNCHES,
    SHARED_LIMIT,
    _check_dtype,
    _check_operand,
    _check_planes,
    _compute_dtype,
    _raise_on_error,
    _stream,
)

#: Edges of the bank kernels (``BankEdge`` in the CUDA sources): zero or
#: periodic.  An external halo slab would be a third value.
EDGES = {"zero": 0, "periodic": 1}
#: Planes one launch serves (``kMaxBankPlanes``: the plane pointers travel in
#: the kernel's parameter block); a depth-5 packet tree has 62.
MAX_PLANES = 64
#: Both kernels (``kThreads``, ``kRunBlock``, ``kRunChunk``, ``kBankTile``):
#: a thread of the THREADS of a block owns RUN_BLOCK outputs of one residue
#: class mod its runs' tap stride and steps through a run of taps RUN_CHUNK
#: at a time with the window samples in registers; a block's tile is
#: THREADS * RUN_BLOCK outputs.
THREADS = 256
RUN_BLOCK = 9
RUN_CHUNK = 8
TILE = THREADS * RUN_BLOCK
#: Zero taps a run takes in to bridge a gap in its stride rather than end
#: (a new run costs RUN_CHUNK window loads; a zero tap RUN_BLOCK FMAs).
RUN_FILL = 3


@dataclasses.dataclass(frozen=True, eq=False)
class BankTaps:
    """The non-zero taps of a bank: plane p owns ``offsets[starts[p]:
    starts[p+1]]`` and the ``values`` beside them; ``spans[p]`` is its
    greatest offset and ``span`` the greatest of all."""

    starts: tuple[int, ...]
    spans: tuple[int, ...]
    offsets: tuple[int, ...]
    values: tuple[float, ...]

    @property
    def planes(self) -> int:
        return len(self.spans)

    @property
    def span(self) -> int:
        return max(self.spans)

    @property
    def nonzeros(self) -> int:
        return len(self.offsets)

    def plane(self, p: int) -> list[tuple[int, float]]:
        lo, hi = self.starts[p], self.starts[p + 1]
        return list(zip(self.offsets[lo:hi], self.values[lo:hi]))


#: bank_taps by the identity of its argument: a whole tree is thousands of
#: floats, too many to hash on every call; the entry keeps the tuple alive,
#: so its id is not reused while it stands.
_TAPS_BY_ID: dict[int, tuple] = {}


def bank_taps(dense: tuple) -> BankTaps:
    """The sparse form of a tuple of dense tap vectors (the routes pass the
    same tuple on every call, which is then found by its identity)."""
    hit = _TAPS_BY_ID.get(id(dense))
    if hit is not None and hit[0] is dense:
        return hit[1]
    taps = _bank_taps(dense)
    if len(_TAPS_BY_ID) >= 64:
        _TAPS_BY_ID.clear()
    _TAPS_BY_ID[id(dense)] = (dense, taps)
    return taps


@functools.lru_cache(maxsize=64)
def _bank_taps(dense: tuple) -> BankTaps:
    if not dense or any(len(f) == 0 for f in dense):
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            "a bank needs at least one plane, each with at least one tap",
        )
    starts, spans, offsets, values = [0], [], [], []
    for f in dense:
        nz = [(tau, float(v)) for tau, v in enumerate(f) if v != 0.0]
        offsets += [tau for tau, _ in nz]
        values += [v for _, v in nz]
        starts.append(len(offsets))
        spans.append(nz[-1][0] if nz else 0)
    return BankTaps(tuple(starts), tuple(spans), tuple(offsets), tuple(values))


@dataclasses.dataclass(frozen=True, eq=False)
class BankRuns:
    """The kernels' tap runs: plane p has stride ``2^shifts[p]``, its
    greatest offset ``spans[p]``, and owns the runs ``plane_runs[p] ..
    plane_runs[p+1]``; run k is ``runs[3k: 3k+3] = (first offset, count,
    start in values)``, its taps at offsets ``first + i * stride`` with the
    values ``values[start + i]`` (fp32, zero where a run bridges a gap),
    every start a multiple of 4."""

    plane_runs: tuple[int, ...]
    shifts: tuple[int, ...]
    spans: tuple[int, ...]
    runs: tuple[int, ...]
    values: tuple[float, ...]

    def plane(self, p: int) -> list[tuple[int, int, int]]:
        return [tuple(self.runs[3 * k: 3 * k + 3])
                for k in range(self.plane_runs[p], self.plane_runs[p + 1])]

    @property
    def costs(self) -> tuple[int, ...]:
        """Per plane, the taps its runs step through plus one output block:
        what the plane groups are balanced on."""
        return tuple(RUN_BLOCK + sum(c for _, c, _ in self.plane(p))
                     for p in range(len(self.shifts)))


def _stride(offsets: list[int]) -> int:
    """The largest power of two, at most THREADS, that divides every gap
    between a plane's offsets (1 for a single tap)."""
    g = 0
    for o in offsets[1:]:
        g = math.gcd(g, o - offsets[0])
    return min(g & -g, THREADS) if g else 1


@functools.lru_cache(maxsize=128)
def bank_runs(taps: BankTaps, one_stride: bool = False) -> BankRuns:
    """Cut each plane's non-zero taps into runs on one stride per plane (or,
    ``one_stride``, on the least of them for every plane: the synthesis's
    threads own the same outputs in every plane); a gap of at most
    :data:`RUN_FILL` stride steps is bridged with zero taps."""
    strides = [_stride([o for o, _ in taps.plane(p)]) for p in range(taps.planes)]
    if one_stride:
        strides = [min(strides)] * taps.planes
    plane_runs, shifts, runs, values = [0], [], [], []
    for p in range(taps.planes):
        nz = taps.plane(p)
        d = strides[p]
        shifts.append(d.bit_length() - 1)
        run: list[float] = []
        first = prev = None
        for o, v in nz + [(None, 0.0)]:
            if o is not None and prev is not None and (o - prev) // d - 1 <= RUN_FILL:
                run += [0.0] * ((o - prev) // d - 1) + [float(np.float32(v))]
            else:
                if run:
                    values += [0.0] * (-len(values) % 4)
                    runs += [first, len(run), len(values)]
                    values += run
                first, run = o, [float(np.float32(v))]
            prev = o
        plane_runs.append(len(runs) // 3)
    return BankRuns(tuple(plane_runs), tuple(shifts), taps.spans, tuple(runs),
                    tuple(values))


def _extend(t: torch.Tensor, span: int, periodic: bool, left: bool) -> torch.Tensor:
    """``t`` extended by ``span`` samples on one side: zeros, or the signal
    wrapped as often as the span needs (span >= N included)."""
    if span == 0:
        return t
    if not periodic:
        return F.pad(t, (span, 0) if left else (0, span))
    n = t.shape[-1]
    reps = -(-span // n) + 1
    tiled = torch.cat([t] * reps, dim=-1)
    return tiled[..., tiled.shape[-1] - (n + span):] if left else tiled[..., : n + span]


def bank_analysis_plain(x: torch.Tensor, dense, periodic: bool) -> tuple[torch.Tensor, ...]:
    """Plain version of :func:`bank_analysis`: per plane, the sum over its
    non-zero taps of shifted slices of the left-extended signal."""
    taps = bank_taps(dense)
    n, span = x.shape[-1], taps.span
    ext = _extend(x.to(_compute_dtype(x)), span, periodic, left=True)
    outs = []
    for p in range(taps.planes):
        acc = torch.zeros_like(ext[..., :n])
        for tau, v in taps.plane(p):
            acc = acc + ext[..., span - tau : span - tau + n] * v
        outs.append(acc.to(x.dtype))
    return tuple(outs)


def bank_synthesis_plain(planes, dense, periodic: bool) -> torch.Tensor:
    """Plain version of :func:`bank_synthesis`: the sum over planes and
    non-zero taps of shifted slices of the right-extended planes."""
    taps = bank_taps(dense)
    _check_plane_count(planes, taps)
    n = planes[0].shape[-1]
    acc = torch.zeros_like(planes[0], dtype=_compute_dtype(planes[0]))
    for p, plane in enumerate(planes):
        ext = _extend(plane.to(acc.dtype), taps.spans[p], periodic, left=False)
        for tau, v in taps.plane(p):
            acc = acc + ext[..., tau : tau + n] * v
    return acc.to(planes[0].dtype)


# --- launch plan -------------------------------------------------------------------


def analysis_shared_bytes(span: int) -> int:
    """Shared memory of one analysis block: a window of :data:`TILE` + span
    floats (the taps are read from device memory as broadcasts)."""
    return 4 * (TILE + span)


def synthesis_shared_bytes(span: int, stages: int) -> int:
    """Shared memory of one synthesis block: ``stages`` window buffers of
    :data:`TILE` + span floats, each rounded up to 16 bytes."""
    return 4 * stages * (-(-(TILE + span) // 4) * 4)


def synthesis_stages(span: int) -> int:
    """Window buffers of a synthesis block: two (the next plane's copies in
    flight while a plane's runs execute) where they fit shared memory, else
    one (copy, then compute)."""
    return 2 if synthesis_shared_bytes(span, 2) <= SHARED_LIMIT else 1


def span_fits(span: int) -> bool:
    """Whether both kernels' windows of :data:`TILE` + ``span`` samples fit
    one block's shared memory (the synthesis with one buffer)."""
    return (analysis_shared_bytes(span) <= SHARED_LIMIT
            and synthesis_shared_bytes(span, 1) <= SHARED_LIMIT)


def bank_fits(dense) -> bool:
    """Whether the kernels serve this bank: at most :data:`MAX_PLANES`
    planes and windows that fit one block's shared memory."""
    taps = bank_taps(dense)
    return taps.planes <= MAX_PLANES and span_fits(taps.span)


def plane_groups(blocks: int, planes: int, sms: int) -> int:
    """How many groups the analysis kernel splits its planes into (over
    ``blockIdx.y``): one where the (signal, tile) blocks alone give every
    SM eight blocks (two rounds of the four that fit an SM), else as many
    as bring the grid there."""
    return max(1, min(planes, -(-8 * sms // blocks)))


@functools.lru_cache(maxsize=256)
def group_bounds(runs: BankRuns, groups: int) -> tuple[int, ...]:
    """First plane of each of at most ``groups`` groups of consecutive
    planes, and the plane count: plane p joins the group its cost's
    midpoint falls in, so the groups hold about equal costs."""
    costs = runs.costs
    total, acc, bounds, current = sum(costs), 0, [0], 0
    for p, c in enumerate(costs):
        g = min(groups - 1, int((2 * acc + c) * groups // (2 * total)))
        if p > 0 and g > current:
            bounds.append(p)
            current = g
        acc += c
    return tuple(bounds) + (len(costs),)


def _check_plane_count(planes, taps: BankTaps) -> None:
    if len(planes) != taps.planes:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"expected {taps.planes} planes, one per tap vector, got {len(planes)}",
        )


def _launch_plan(taps: BankTaps) -> None:
    """Raises for a bank either kernel refuses."""
    if taps.planes > MAX_PLANES:
        raise InvalidArgumentError(
            ErrorCode.VAL_TOO_LARGE,
            f"one bank launch serves at most {MAX_PLANES} planes, got {taps.planes}",
        )
    if not span_fits(taps.span):
        raise InvalidArgumentError(
            ErrorCode.VAL_TOO_LARGE,
            "The bank's window does not fit the kernel's shared memory",
            context={"span": taps.span},
            suggestions=("Use shorter filters or backend='torch'",),
        )


@functools.lru_cache(maxsize=128)
@kept
def _device_runs(runs: BankRuns, device_index: int):
    """(int32 [plane_runs | shifts | spans | runs], float32 values) on the card."""
    dev = f"cuda:{device_index}"
    ints = torch.tensor(runs.plane_runs + runs.shifts + runs.spans + runs.runs,
                        dtype=torch.int32, device=dev)
    vals = torch.tensor(runs.values or (0.0,), dtype=torch.float32, device=dev)
    return ints, vals


def runs_pointers(runs: BankRuns, device: torch.device) -> tuple[int, ...]:
    """Device addresses of the run table's parts: (plane_runs, shifts,
    spans, runs, values)."""
    ints, vals = _device_runs(runs, device.index)
    base, p = ints.data_ptr(), len(runs.shifts)
    return (base, base + 4 * (p + 1), base + 4 * (2 * p + 1), base + 4 * (3 * p + 1),
            vals.data_ptr())


def _launch_analysis(x: torch.Tensor, taps: BankTaps, periodic: bool):
    _check_operand(x, "x")
    code = _check_dtype(x, "x")
    _launch_plan(taps)
    runs = bank_runs(taps)
    b, n = x.shape
    lib = library()
    # one allocation for all planes (a launch of a tree makes 30 or 62)
    stacked = torch.empty((taps.planes, b, n), dtype=x.dtype, device=x.device)
    out_ptrs = (ctypes.c_void_p * taps.planes)(*[o.data_ptr() for o in stacked.unbind(0)])
    plane_runs, shifts, _, run_table, values = runs_pointers(runs, x.device)
    p = taps.planes
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    bounds = group_bounds(runs, plane_groups(b * -(-n // TILE), p, sms))
    c_bounds = (ctypes.c_int * len(bounds))(*bounds)
    with torch.cuda.device(x.device):
        err = lib.vw_modwt_bank_analysis(
            x.data_ptr(), out_ptrs, plane_runs, shifts, run_table, values, c_bounds,
            len(bounds) - 1, b, n, p, taps.span, EDGES["periodic" if periodic else "zero"],
            code, _stream(x.device),
        )
    _raise_on_error(err, "modwt_bank_analysis")
    LAUNCHES["modwt_bank_analysis"] += 1
    return stacked


def _launch_synthesis(planes, taps: BankTaps, periodic: bool) -> torch.Tensor:
    _check_plane_count(planes, taps)
    code = _check_planes(planes)
    _launch_plan(taps)
    runs = bank_runs(taps, one_stride=True)
    first = planes[0]
    b, n = first.shape
    lib = library()
    out = torch.empty_like(first)
    in_ptrs = (ctypes.c_void_p * taps.planes)(*[p.data_ptr() for p in planes])
    plane_runs, _, spans, run_table, values = runs_pointers(runs, first.device)
    with torch.cuda.device(first.device):
        err = lib.vw_modwt_bank_synthesis(
            in_ptrs, out.data_ptr(), plane_runs, spans, run_table, values, b, n,
            taps.planes, taps.span, runs.shifts[0], synthesis_stages(taps.span),
            EDGES["periodic" if periodic else "zero"], code, _stream(first.device),
        )
    _raise_on_error(err, "modwt_bank_synthesis")
    LAUNCHES["modwt_bank_synthesis"] += 1
    return out


def _analysis(x, dense, periodic):
    if x.device.type == "cpu":
        return bank_analysis_plain(x, dense, periodic)
    return _launch_analysis(x, bank_taps(dense), periodic).unbind(0)


def _analysis_stacked(x, dense, periodic):
    if x.device.type == "cpu":
        return torch.stack(bank_analysis_plain(x, dense, periodic))
    return _launch_analysis(x, bank_taps(dense), periodic)


def _synthesis(planes, dense, periodic):
    if planes[0].device.type == "cpu":
        return bank_synthesis_plain(planes, dense, periodic)
    return _launch_synthesis(planes, bank_taps(dense), periodic)


class _BankAnalysis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dense, periodic):
        ctx.dense, ctx.periodic = dense, periodic
        return _analysis(x, dense, periodic)

    @staticmethod
    def backward(ctx, *cots):
        planes = tuple(c.contiguous() for c in cots)
        return _synthesis(planes, ctx.dense, ctx.periodic), None, None


class _BankAnalysisStacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dense, periodic):
        ctx.dense, ctx.periodic = dense, periodic
        return _analysis_stacked(x, dense, periodic)

    @staticmethod
    def backward(ctx, cot):
        return _synthesis(cot.contiguous().unbind(0), ctx.dense, ctx.periodic), None, None


class _BankSynthesis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dense, periodic, *planes):
        ctx.dense, ctx.periodic = dense, periodic
        return _synthesis(planes, dense, periodic)

    @staticmethod
    def backward(ctx, cot):
        return (None, None, *_analysis(cot.contiguous(), ctx.dense, ctx.periodic))


def bank_analysis(x: torch.Tensor, dense, periodic: bool) -> tuple[torch.Tensor, ...]:
    """``[B, N]`` -> ``len(dense)`` planes of ``[B, N]``: plane p is
    ``sum_tau dense[p][tau] x[t - tau]`` with a periodic or zero left edge.
    Differentiable: the backward is one :func:`bank_synthesis` pass with the
    same taps."""
    return _BankAnalysis.apply(x, dense, bool(periodic))


def bank_analysis_stacked(x: torch.Tensor, dense, periodic: bool) -> torch.Tensor:
    """:func:`bank_analysis` as one ``[P, B, N]`` tensor: on the card the
    launch's own allocation of every plane, handed back without a copy.
    Differentiable the same way."""
    return _BankAnalysisStacked.apply(x, dense, bool(periodic))


def bank_synthesis(planes, dense, periodic: bool) -> torch.Tensor:
    """``len(dense)`` planes of ``[B, N]`` -> ``[B, N]``:
    ``sum_p sum_tau dense[p][tau] planes[p][t + tau]`` with a periodic or
    zero right edge, the transpose of :func:`bank_analysis`.  Differentiable:
    the backward is one :func:`bank_analysis` pass with the same taps."""
    return _BankSynthesis.apply(dense, bool(periodic), *planes)
