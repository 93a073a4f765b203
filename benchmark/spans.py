"""Readings inside the port's own spans of a traced window.

The port names parts of its work with host ranges on the profiler's clock
(``rec.train.step``, ``rec.rank.topk``, ...), which the traced window keeps
among its host records (``Trace.host``).  These helpers attribute the
window's other records to them by time alone, not by thread: the autograd
engine launches a backward's kernels from its own thread, inside the main
thread's span.

* :func:`intervals`: the spans of one name, as ``(start_us, end_us)``;
* :func:`idle_us`: the part of the spans' union with no device record
  running;
* :func:`calls_in`: host records of some names (launch calls, syncs) that
  start inside the spans;
* :func:`device_us_launched_in`: the device time of the kernels launched
  inside the spans.  Launch calls and kernel records are both sorted by
  start and paired in order (one stream runs its kernels in launch order);
  where their counts differ nothing is read.

A reader of a window that holds none of the spans (a program without them)
reads nothing; nothing here raises on it."""

from __future__ import annotations

import bisect
from typing import Iterable, List, Optional, Sequence, Tuple

from .tracing import LAUNCH_CALLS, Trace

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")

Interval = Tuple[float, float]


def intervals(trace: Trace, name: str) -> List[Interval]:
    """The host records named ``name``, by start."""
    return sorted((s, e) for n, s, e in trace.host if n == name)


def _union(iv: Iterable[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _inside(t: float, merged: List[Interval]) -> bool:
    """Whether ``t`` lies in one of the sorted, disjoint ``merged``."""
    i = bisect.bisect_right(merged, (t, float("inf"))) - 1
    return i >= 0 and merged[i][0] <= t <= merged[i][1]


def idle_us(trace: Trace, spans: Sequence[Interval]) -> float:
    """Microseconds of the spans' union in which no device record runs."""
    busy = _union((s, e) for _, s, e in trace.device)
    idle = 0.0
    for s, e in _union(spans):
        covered = 0.0
        i = max(bisect.bisect_right(busy, (s, float("inf"))) - 1, 0)
        while i < len(busy) and busy[i][0] < e:
            covered += max(0.0, min(e, busy[i][1]) - max(s, busy[i][0]))
            i += 1
        idle += (e - s) - covered
    return idle


def calls_in(trace: Trace, spans: Sequence[Interval],
             names: Sequence[str]) -> int:
    """Host records named in ``names`` that start inside the spans."""
    merged = _union(spans)
    return sum(n in names and _inside(s, merged) for n, s, _ in trace.host)


def device_us_launched_in(trace: Trace, spans: Sequence[Interval]
                          ) -> Optional[float]:
    """Device microseconds of the kernels whose launch call starts inside
    the spans; None where the window's launch calls and kernel records
    differ in number."""
    launches = sorted(s for n, s, _ in trace.host if n in LAUNCH_CALLS)
    kernels = sorted((s, e) for _, s, e in trace.kernels())
    if len(launches) != len(kernels):
        return None
    merged = _union(spans)
    return sum(e - s for t, (s, e) in zip(launches, kernels)
               if _inside(t, merged))


def per_span(total: Optional[float], spans: Sequence[Interval],
             scale: float = 1.0) -> Optional[float]:
    """``total`` times ``scale`` over the number of spans; None without
    spans or a total."""
    if total is None or not spans:
        return None
    return scale * total / len(spans)
