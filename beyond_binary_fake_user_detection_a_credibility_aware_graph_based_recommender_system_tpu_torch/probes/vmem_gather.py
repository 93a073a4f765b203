"""Probe: row-gather throughput from a small slab (P4).

Port of ``scripts/probe_vmem_gather.py``.  For each slab of S rows (D=64
fp32) it gathers ``G * S`` rows (G=64 steps of S random rows each, as the
JAX probe's grid does) with ``ops/row_gather.row_gather``, and prints the
time per call (CUDA events around a loop of calls: the host's issue
included), the device time per call with the calls queued ahead of the
card (``_timing.queued_device_ms``), the time per row, the route and
``torch.index_select``'s times, then checks the result against numpy bit
for bit.  Every S goes through the L2 route (the wrapper's); a
slab that fits shared memory (up to 192 KiB: S <= 768) also goes through the
shared-memory route in clusters of 1, 2, 4 and 8 CTAs.

    python -m <package>.probes.vmem_gather [--device cuda|cpu]
        [--sizes 512,2048,8192,16384 --steps 64 --dim 64 --iters 20]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.row_gather import row_gather
from ..ops.row_gather_cuda import CLUSTERS, smem_fits
from ..utils.device import resolve_device
from ._timing import (bound_ms, clock_name, device_loop_time,
                      queued_device_ms)

SIZES = (512, 2048, 8192, 16384)


def variants(device: torch.device, S: int, dim: int) -> list:
    """``(route, cluster)`` of every kernel variant the probe runs at S
    (``("plain", 0)`` off the card)."""
    if device.type != "cuda":
        return [("plain", 0)]
    return [("l2", 0)] + ([("smem", c) for c in CLUSTERS]
                          if smem_fits(S, dim) else [])


def _ms(value) -> str:
    return "not measured" if value is None else f"{value:.4f}"


def run(device, sizes, steps, dim, iters) -> dict:
    device = resolve_device(device)
    print(f"vmem_gather probe on {device} (times: {clock_name(device)}; "
          f"device: queued calls), D={dim}, {steps} steps of S rows per call")
    rows = []
    for S in sizes:
        rng = np.random.default_rng(0)
        x_np = rng.standard_normal((S, dim)).astype(np.float32)
        idx_np = rng.integers(0, S, steps * S).astype(np.int32)
        x = torch.as_tensor(x_np, device=device)
        idx = torch.as_tensor(idx_np, device=device)
        n = idx_np.size
        lib = device_loop_time(lambda: x.index_select(0, idx), device, iters)
        lib_dev = queued_device_ms(lambda: x.index_select(0, idx), device,
                                   iters)
        plain = device_loop_time(lambda: row_gather(x, idx, backend="torch"),
                                 device, iters)
        bound = bound_ms(S * dim * 4 + n * 4 + n * dim * 4, 0)
        for route, cluster in variants(device, S, dim):
            kw = {} if route == "plain" else {"route": route}
            if cluster:
                kw["cluster"] = cluster
            out = row_gather(x, idx, **kw)
            exact = bool(np.array_equal(out.cpu().numpy(), x_np[idx_np]))
            ms = device_loop_time(lambda: row_gather(x, idx, **kw), device,
                                  iters)
            dev_ms = queued_device_ms(lambda: row_gather(x, idx, **kw),
                                      device, iters)
            rows.append(dict(
                S=S, rows=n, route=route, cluster=cluster, ms=ms,
                device_ms=dev_ms, ns_per_row=1e6 * ms / n, exact=exact,
                plain_ms=plain, library_ms=lib, library_device_ms=lib_dev,
                bound_ms=bound))
            name = route + (f"/c{cluster}" if cluster else "")
            print(f"S={S:6d} route={name:<8}: {ms:8.4f} ms/call (device "
                  f"{_ms(dev_ms)})  {1e6 * ms / n:7.4f} ns/row ({n} rows "
                  f"incl. out write)  index_select {lib:8.4f} ms (device "
                  f"{_ms(lib_dev)})  bound {bound:.4f} ms  "
                  f"{'correct' if exact else 'WRONG'}")
    return {"device": str(device), "clock": clock_name(device), "rows": rows}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)))
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--iters", type=int, default=20)
    a = ap.parse_args(argv)
    return run(a.device, [int(s) for s in a.sizes.split(",")], a.steps,
               a.dim, a.iters)


if __name__ == "__main__":
    main()
