"""The measured window: all the work over all the time, and tails over all
requests."""

from __future__ import annotations

import contextlib
import time
from typing import Callable, List

import numpy as np


class Window:
    """Runs ``unit()`` back to back from the first call until the first
    unit that ends ``seconds`` or more after the window opened; ``unit``
    returns the work it did and has finished it (its results are on the
    host) when it returns.  ``latencies`` holds each unit's seconds."""

    def __init__(self, seconds: float):
        self.seconds = float(seconds)
        self.work = 0.0
        self.units = 0
        self.elapsed = 0.0
        self.latencies: List[float] = []

    def run(self, unit: Callable[[], float]) -> "Window":
        t0 = time.perf_counter()
        while True:
            u0 = time.perf_counter()
            self.work += unit()
            t1 = time.perf_counter()
            self.latencies.append(t1 - u0)
            self.units += 1
            if t1 - t0 >= self.seconds:
                break
        self.elapsed = t1 - t0
        return self

    @property
    def rate(self) -> float:
        return rate(self.work, self.elapsed)


class OpenWindow(Window):
    """Issues unit ``j`` when it falls due, ``offsets[j]`` seconds after the
    window opened, whether or not the units before it have finished: one
    server takes them in order, so a late unit waits.  A unit's latency runs
    from when it was due until it ends; the window closes when the last
    unit due ends."""

    def __init__(self, offsets, waiting=contextlib.nullcontext):
        offsets = np.asarray(offsets, np.float64)
        super().__init__(float(offsets[-1]) if offsets.size else 0.0)
        self.offsets = offsets
        self.waiting = waiting

    def run(self, unit: Callable[[], float]) -> "OpenWindow":
        """``waiting()`` is entered while no unit is due."""
        t0 = time.perf_counter()
        for due in t0 + self.offsets:
            with self.waiting():
                now = time.perf_counter()
                if due - now > 2e-3:
                    time.sleep(due - now - 1e-3)
                while time.perf_counter() < due:
                    pass
            self.work += unit()
            t1 = time.perf_counter()
            self.latencies.append(t1 - due)
            self.units += 1
        self.elapsed = time.perf_counter() - t0
        return self


def arrivals(rate_per_s: float, seconds: float) -> np.ndarray:
    """Due offsets of ``rate_per_s`` arrivals over ``seconds``, evenly
    spaced."""
    n = max(int(round(rate_per_s * seconds)), 1)
    return np.arange(n) / rate_per_s


def rate(work: float, seconds: float) -> float:
    """Work a second over the whole window."""
    if seconds <= 0:
        raise ValueError("an empty window")
    return work / seconds


def p95_ms(latencies_s) -> float:
    """The 95th percentile of every latency, in ms (linear interpolation
    between the two nearest ranks)."""
    lat = np.asarray(latencies_s, np.float64)
    if lat.size == 0:
        raise ValueError("no requests")
    return float(np.percentile(lat, 95.0) * 1e3)


def readings(win: Window) -> dict:
    """What a window gives a cell's end-to-end metrics, by the names a
    traffic file's ``end_to_end`` maps them from: ``rate``, the work a
    second over the whole window, and ``p95_ms``, the tail of every
    unit's latency."""
    return {"rate": win.rate, "p95_ms": p95_ms(win.latencies)}
