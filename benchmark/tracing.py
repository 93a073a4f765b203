"""The benchmark's spans and its reading of the profiler's trace.

Spans are the benchmark's own, on the host clock, around its calls into the
port; under the profiler each is also a ``record_function`` range, so an
idle gap of the card can be named by what the host was doing.  A trace is
used only when it is complete: its kernel records match the port's launch
counters and the runtime's launch calls (the profiler has dropped records
of short windows at 10M)."""

from __future__ import annotations

import contextlib
import re
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
PREFIX = "bench."             # the benchmark's own ranges in a trace
WINDOW = PREFIX + "window"
RUN_EPOCH = PREFIX + "run_epoch"   # a traced epoch's steps, after its draws


class Spans:
    """Seconds by span name, each span fenced on the card when asked."""

    def __init__(self):
        self.seconds: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str, device: Optional[torch.device] = None):
        fence = device is not None and device.type == "cuda"
        with torch.profiler.record_function(PREFIX + name):
            if fence:
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if fence:
                    torch.cuda.synchronize(device)
                self.seconds[name].append(time.perf_counter() - t0)


def kernel_name(record: str) -> str:
    """``void ns::name<T>(args)`` -> ``name``; a mangled record
    ``_Z<len><name>...`` or ``_ZN...<len><name>...`` -> ``name``."""
    m = re.match(r"_ZN?(?:\d+\w*?)*?(\d+)", record)
    if m:
        n = int(m.group(1))
        return record[m.end():m.end() + n]
    head = record.replace("(anonymous namespace)::", "")
    head = head.split("(", 1)[0].split("<", 1)[0].strip()
    return head.rsplit(" ", 1)[-1].rsplit("::", 1)[-1]


@dataclass
class Trace:
    """What one traced window held: device records ``(name, start_us,
    end_us)``, host records likewise, the window's ``(start_us, end_us)``
    and the runtime's kernel launch calls."""
    device: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    window: Tuple[float, float]
    launches: int
    counters: Dict[str, int] = field(default_factory=dict)

    def kernels(self) -> List[Tuple[str, float, float]]:
        return [d for d in self.device
                if not d[0].startswith(("Memcpy", "Memset"))]

    def device_s(self, fragments: Sequence[str] = ()) -> float:
        """Device seconds of the records whose name holds any of
        ``fragments`` (all records without)."""
        return sum(e - s for n, s, e in self.device
                   if not fragments or any(f in n for f in fragments)) / 1e6

    def kernel_s(self, kernels: Sequence[str]) -> float:
        """Device seconds of the kernels named in ``kernels``."""
        return sum(e - s for n, s, e in self.device
                   if kernel_name(n) in kernels) / 1e6

    def device_s_since(self, host_range: str,
                       excluding: Sequence[str] = ()) -> float:
        """Device seconds of the records that start at or after the start
        of the first host range named ``host_range``, but for the kernels
        named in ``excluding``."""
        t0 = min(s for n, s, _ in self.host if n == host_range)
        return sum(e - s for n, s, e in self.device
                   if s >= t0 and kernel_name(n) not in excluding) / 1e6

    def idle_pct(self) -> float:
        """The window's share with nothing running on the card, in %."""
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def kernel_counts(self, top: int) -> List[Tuple[str, int]]:
        by = defaultdict(int)
        for n, _, _ in self.kernels():
            by[kernel_name(n)] += 1
        return sorted(by.items(), key=lambda kv: -kv[1])[:top]

    def count(self, kernel: str) -> int:
        """Records of the kernel named ``kernel`` (its name without
        template arguments and parameters)."""
        return sum(kernel_name(n) == kernel for n, _, _ in self.device)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self) -> float:
        """Seconds of the window in which any device record ran."""
        w0, w1 = self.window
        iv = sorted((max(s, w0), min(e, w1)) for _, s, e in self.device
                    if e > w0 and s < w1)
        busy, end = 0.0, -np.inf
        for s, e in iv:
            if s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy / 1e6

    def idle_gaps(self, top: int = 10, most: int = 4000
                  ) -> List[Tuple[str, float]]:
        """The device's idle seconds in the window by the innermost host
        record that spans each gap's middle, the ``top`` largest."""
        w0, w1 = self.window
        iv = sorted((s, e) for _, s, e in self.device if e > w0 and s < w1)
        gaps, end = [], w0
        for s, e in iv:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if w1 > end:
            gaps.append((end, w1))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:most]
        if not gaps or not self.host:
            return []
        hs = np.array([h[1] for h in self.host])
        he = np.array([h[2] for h in self.host])
        dur = he - hs
        by = defaultdict(float)
        for s, e in gaps:
            mid = 0.5 * (s + e)
            inside = np.nonzero((hs <= mid) & (he >= mid))[0]
            name = (self.host[inside[np.argmin(dur[inside])]][0]
                    if inside.size else "no host record")
            by[name] += (e - s) / 1e6
        return sorted(by.items(), key=lambda kv: -kv[1])[:top]

    def device_ops(self, top: int = 10) -> List[Tuple[str, float]]:
        by = defaultdict(float)
        for n, s, e in self.device:
            by[n[:200]] += (e - s) / 1e6
        return sorted(by.items(), key=lambda kv: -kv[1])[:top]

    def complete(self, expected: Dict[str, int]) -> bool:
        """Every launch call has its kernel record, and each named kernel's
        records number what the port's counters say."""
        if self.launches and len(self.kernels()) < self.launches:
            return False
        return all(self.count(k) == n for k, n in expected.items())


def trace_window(fn: Callable[[], None], device: torch.device,
                 counters: Callable[[], Dict[str, int]]) -> Trace:
    """Profile ``fn()`` (host and card) inside a ``bench.window`` range and
    return its records, with the change of ``counters()`` across it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    on_card = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if on_card else [])
    c0 = counters()
    if on_card:
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        with torch.profiler.record_function(WINDOW):
            fn()
            if on_card:
                torch.cuda.synchronize(device)
    c1 = counters()
    dev, host, window, launches = [], [], None, 0
    for e in prof.events():
        rec = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            # a range's annotation on the card's timeline is no work
            if not e.name.startswith(PREFIX):
                dev.append(rec)
        elif e.name == WINDOW:
            window = rec[1:]
        else:
            host.append(rec)
            launches += e.name in LAUNCH_CALLS
    if window is None:
        raise RuntimeError("the profiler kept no window range")
    return Trace(device=dev, host=host, window=window, launches=launches,
                 counters={k: c1[k] - c0[k] for k in c1})
