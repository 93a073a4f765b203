"""Timing and bounds for the probes (``device_loop_time`` of the JAX probes).

On a CUDA device a time is taken with CUDA events around ``iters`` calls
after ``warmup`` calls, best of ``reps``; on the CPU with the host clock.
:func:`clock_name` says which, so a CPU time is never printed as a device
time.  :func:`queued_device_ms` is the device time alone, with the calls
queued ahead of the card (on the card only).  The bounds are the least time
an H100 SXM could take for the same work: the compulsory bytes at its
published memory rate, or the fp32 operations at its rate outside the
tensor cores, whichever is larger.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, published
FP32_FLOPS = 67e12            # H100 SXM fp32 outside the tensor cores


def clock_name(device: torch.device) -> str:
    return "cuda events" if device.type == "cuda" else "host clock, cpu"


def device_loop_time(fn: Callable[[], object], device: torch.device,
                     iters: int = 20, warmup: int = 3, reps: int = 3) -> float:
    """Milliseconds per call of ``fn`` on ``device`` (best of ``reps``)."""
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            stop.record()
            torch.cuda.synchronize(device)
            ms = start.elapsed_time(stop)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            ms = 1e3 * (time.perf_counter() - t0)
        best = min(best, ms / iters)
    return best


SPIN_CYCLES = 20_000_000      # ~10 ms of the card: the host's head start


def queued_device_ms(fn: Callable[[], object], device: torch.device,
                     iters: int = 20):
    """Device milliseconds per call of ``fn`` when the card never waits for
    the host: a spin kernel (``torch.cuda._sleep``) holds the stream while
    the host queues ``iters`` calls, and CUDA events time them back to
    back.  A loop of CUDA events alone (:func:`device_loop_time`) also sees
    the host's issue time when a call's kernels are shorter than it.
    ``None`` (not measured) off the card."""
    if device.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop) / iters


def bound_ms(nbytes: float, flops: float) -> float:
    """The larger of the byte time and the fp32 operation time, in ms."""
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)


def csr_bound_ms(d, D: int, itemsize: int = 4) -> float:
    """One CSR application (``ops/spmm.CsrDirection``): the referenced
    source rows, ``src`` and ``w``, ``indptr`` and one write of y, with
    table and output elements of ``itemsize`` bytes."""
    rows = int(torch.unique(d.src).numel()) if d.src.numel() else 0
    E = d.src.numel()
    nbytes = (rows * D * itemsize + E * 8 + d.indptr.numel() * 8
              + d.num_dst * D * itemsize)
    return bound_ms(nbytes, 2.0 * E * D)


def plan_bound_ms(plan, D: int, lid_bytes: int = 4,
                  x_bytes: int = 4) -> float:
    """One chunked application: the referenced source rows (of ``x_bytes``
    a value: 2 for a bf16 table), the plan's arrays (source id and weight
    per real edge, local id per padded edge: a pad edge is known by its
    local id and skipped; block id, first flag and window start per chunk)
    and one write of the fp32 block space."""
    R, W = plan.block_rows, plan.window
    real = plan.local_ids < (W or R)
    src = plan.src_padded[real]
    rows = int(torch.unique(src).numel()) if src.numel() else 0
    G = plan.num_chunks
    E = int(real.sum())
    nbytes = (rows * D * x_bytes + E * 8 + plan.padded_edges * lid_bytes
              + G * 4 * (3 if W else 2) + plan.num_blocks * R * D * 4)
    return bound_ms(nbytes, 2.0 * E * D)
