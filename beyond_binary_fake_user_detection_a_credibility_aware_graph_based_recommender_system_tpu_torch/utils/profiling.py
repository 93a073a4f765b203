"""Tracing and timing utilities (``JAX: utils/profiling.py``).

  * ``span(name)``: a named host range inside the port, recorded only while
    a ``torch.profiler`` profile runs, on the profiler's own clock, so a
    gap on the card's timeline can be put down to the part of the program
    the host was in (:data:`SPANS` lists them);
  * ``trace(log_dir)``: a context manager around ``torch.profiler.profile``
    that writes a Chrome trace of the host (the spans included) and, on a
    card, of the device's kernels into ``log_dir``;
  * ``Throughput``: rolling edges/sec and steps/sec counters;
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
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

SPAN_PREFIX = "rec."
# every span of the port, by layer; a name holds no ids, so the spans of
# one step, batch or request are told apart by their enclosing span
SPANS = (
    # trainer and samplers (train/trainer.py)
    "rec.train.draw",               # draw_epoch: the permutation, the samples
    "rec.train.sample_positives",   # inside rec.train.draw
    "rec.train.sample_negatives",   # inside rec.train.draw
    "rec.train.plans",              # run_epoch's gather plans of every step
    "rec.train.epoch_cache",        # per_epoch: the epoch's propagation
    # one train step on one device (train_step)
    "rec.train.step",
    "rec.train.forward",            # the loss
    "rec.train.backward",           # torch.autograd.grad
    "rec.train.adam",               # the fused Adam update
    # ranking (eval/retrieval.py, eval/ranking.py)
    "rec.rank.exclusions",          # a batch's train-item rows, numpy
    "rec.rank.topk_for_users",      # a request on one device
    "rec.rank.score",               # the score product
    "rec.rank.mask",                # the train items set to a floor
    "rec.rank.topk",                # ops/topk_select
    # a full evaluation (RecTrainer.evaluate, eval/ranking.evaluate_full)
    "rec.eval.propagate",
    "rec.eval.batch",               # one batch, ids to accumulation
    "rec.eval.metrics",             # the batch's metrics from its top-k
    "rec.eval.finalize",            # the one copy to the host and the sums
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records the enclosed block as the host range
    ``name`` (one of :data:`SPANS`) while a ``torch.profiler`` profile runs.

    With no profile running it returns one shared no-op object after a
    single flag read, so a span costs ~0.5 us on the hot path.  Under a
    profile the range is an operator record on the host only: unlike
    ``torch.profiler.record_function``, whose user annotations the profiler
    mirrors onto the card's timeline, it adds no record to the device's.
    A span never synchronises, allocates or changes a result."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _RecordFunctionFast(name)


@contextlib.contextmanager
def trace(log_dir: str, host_profiling: bool = False):
    """Profile the enclosed block and write its Chrome trace into
    ``log_dir`` (``trace_<pid>_<ns>.json``).  The card's kernels are traced
    when one is present; ``host_profiling`` adds the host operators' shapes
    and call stacks.  The host rows hold the port's spans (:data:`SPANS`)
    around what the block runs: ``fit``'s draws, plans, epoch cache and
    steps (forward, backward, Adam), ``evaluate``'s propagation, batches
    (exclusions, score, mask, top-k, metrics) and final sums, and
    ``topk_for_users``'s score, mask and top-k; a gap in the card's row
    lies under the span the host was in."""
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
    """Rolling throughput counters: steps/sec, and ``edges_per_step`` times
    it.

    ``edges_per_step`` is whatever count the caller gives a step (the
    port's ``bench.py`` passes E * layers * directions * fwd/bwd, as JAX's
    does).  That rate is not the north-star metric and measures no cost
    the port pays: a per_epoch step propagates nothing (the epoch's
    propagation is cached), so it is no roofline share either.  The
    benchmark's ``train_samples_per_s`` and ``train_step_mfu`` are what a
    step is judged by.
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
