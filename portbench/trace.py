"""Reduction of a profiler trace to the per-layer readings.

The arithmetic of ``tools/profile_port.py`` (device time and launches from
the device-side events), extended to the timeline: the union of the device
intervals gives the busy time, its complement inside the traced window the
idle gaps, and each gap is charged to the innermost host operation open at
its middle.  Times are in the profiler's microseconds on the way in and in
seconds on the way out.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

#: Name of the span the harness records around each traced call.
CALL_SPAN = "portbench.call"
#: Name charged with an idle gap while no host operation is open (the
#: Python between the program's operations).
HOST_PYTHON = "host python"
TOP = 10
NAME_CHARS = 120


@dataclass(frozen=True)
class Event:
    device: bool
    name: str
    start: float
    end: float


@dataclass
class TraceSummary:
    calls: int
    launches: int
    device_s: float
    busy_s: float
    window_s: float
    device_ops: list
    idle_gaps: list


def events_of(prof) -> list[Event]:
    """The events of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        r = e.time_range
        out.append(Event(e.device_type == DeviceType.CUDA, e.name, float(r.start),
                         float(r.end)))
    return out


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _top(totals: dict) -> list:
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name[:NAME_CHARS], seconds] for name, seconds in ranked]


def _charge_gaps(gaps, host) -> dict:
    """Seconds of idle device time by the innermost host event open at each
    gap's middle.  ``host`` holds nested intervals (one thread's operations),
    so a stack swept in time order finds it."""
    totals: dict = defaultdict(float)
    host = sorted(host, key=lambda e: (e.start, -e.end))
    stack, i = [], 0
    for lo, hi in sorted(gaps):
        mid = (lo + hi) / 2
        while i < len(host) and host[i].start <= mid:
            while stack and stack[-1].end <= host[i].start:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1].end < mid:
            stack.pop()
        name = stack[-1].name if stack and stack[-1].name != CALL_SPAN else HOST_PYTHON
        totals[name] += (hi - lo) * 1e-6
    return totals


def reduce(events: list[Event], calls: int) -> TraceSummary | None:
    """The readings of a traced window of ``calls`` calls, each inside a
    :data:`CALL_SPAN` span; None where the trace holds no such span."""
    spans = [e for e in events if not e.device and e.name == CALL_SPAN]
    if not spans or calls < 1:
        return None
    w0, w1 = min(e.start for e in spans), max(e.end for e in spans)
    # the span is mirrored on the device timeline too: not an operation
    device = [e for e in events
              if e.device and e.name != CALL_SPAN and e.end > w0 and e.start < w1]
    busy = _merge((max(e.start, w0), min(e.end, w1)) for e in device)
    gaps, edge = [], w0
    for s, e in busy:
        if s > edge:
            gaps.append((edge, s))
        edge = e
    if w1 > edge:
        gaps.append((edge, w1))
    by_name: dict = defaultdict(float)
    for e in device:
        by_name[e.name] += (e.end - e.start) * 1e-6
    host = [e for e in events if not e.device and e.end > w0 and e.start < w1]
    return TraceSummary(
        calls=calls,
        launches=len(device),
        device_s=sum(by_name.values()),
        busy_s=sum(e - s for s, e in busy) * 1e-6,
        window_s=(w1 - w0) * 1e-6,
        device_ops=_top(by_name),
        idle_gaps=_top(_charge_gaps(gaps, host)),
    )
