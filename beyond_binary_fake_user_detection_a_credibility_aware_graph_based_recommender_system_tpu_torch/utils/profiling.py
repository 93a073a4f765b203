"""Tracing and timing utilities (``JAX: utils/profiling.py``).

  * ``trace(log_dir)``: a context manager around ``torch.profiler.profile``
    that writes a Chrome trace of the host and, on a card, of the device's
    kernels into ``log_dir``;
  * ``Throughput``: rolling edges/sec and steps/sec counters (propagation
    edges/sec is the north-star metric);
  * ``time_fn``: warmed-up wall-clock seconds a call, fenced with
    ``torch.cuda.synchronize`` when the call's output lies on a card.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str, host_profiling: bool = False):
    """Profile the enclosed block and write its Chrome trace into
    ``log_dir`` (``trace_<pid>_<ns>.json``).  The card's kernels are traced
    when one is present; ``host_profiling`` adds the host operators' shapes
    and call stacks."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities, record_shapes=host_profiling,
                   with_stack=host_profiling)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _fence(out) -> None:
    """Wait for the card when ``out`` (a tensor, or a tuple / list / dict
    of them) lies on one."""
    leaves = (out.values() if isinstance(out, dict)
              else out if isinstance(out, (tuple, list)) else (out,))
    devices = {t.device for t in leaves
               if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 3) -> float:
    """Mean seconds per call, post-warmup, device-fenced."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _fence(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _fence(out)
    return (time.perf_counter() - t0) / iters


@dataclass
class Throughput:
    """Rolling throughput counters.

    ``edges_per_step`` should count propagation edge traversals
    (E * layers * directions * fwd/bwd) so the reported number is the
    roofline-comparable edges/sec/chip.
    """

    edges_per_step: int
    steps: int = 0
    seconds: float = 0.0
    _t0: Optional[float] = field(default=None, repr=False)

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, steps: int = 1):
        assert self._t0 is not None, "call start() first"
        self.seconds += time.perf_counter() - self._t0
        self.steps += steps
        self._t0 = None

    @property
    def steps_per_sec(self) -> float:
        return self.steps / self.seconds if self.seconds else 0.0

    @property
    def edges_per_sec(self) -> float:
        return self.steps_per_sec * self.edges_per_step

    def summary(self) -> str:
        return (f"{self.steps} steps in {self.seconds:.2f}s | "
                f"{self.steps_per_sec:.2f} steps/s | "
                f"{self.edges_per_sec:,.0f} edges/s")
