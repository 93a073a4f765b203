"""Probe: the staged chunk kernel under lagging warps, on the card.

A CTA of ``chunk_staged_kernel`` (``csrc/chunk_spmm.cu``) reuses its shared
memory from chunk to chunk: two buffers of staged rows and two plan stages,
one of which thread 0 refills by bulk copies.  A missing barrier there shows
only when a warp runs far behind another at the wrong point, which a normal
launch does rarely.  This probe builds copies of the source into
``build/chunk_race/`` in which some warps sleep (``__nanosleep``) at the
points where a CTA's warps part ways (the start of a chunk, the next
item's copies, the row sums, the span sums), and holds each copy bit for
bit to the plain version's sequential CPU sum.
With its barriers right, a lagging warp only slows the kernel down.

Variants: ``rest`` (every warp but the first lags) and ``first`` (only the
first warp, which issues the bulk copies and counts the spans).  The cases
are graphs whose rows run across chunks (a hub row over hundreds of chunks,
a Zipf-skewed one) at D 63 and 256, where more than one warp sums a span,
fp32 and bf16 tables, in bulk-loaded and thread-loaded plan layouts.

    python -m <package>.probes.chunk_race [--source csrc/chunk_spmm.cu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..ops.chunk_spmm import chunk_spmm_reference
from ..ops.chunk_spmm_cuda import SOURCE, ChunkSpmmKernel
from ..ops.cuda_build import BUILD_DIR
from ..ops.segment_plan import build_segment_plan
from ..utils.device import resolve_device

OUT_DIR = BUILD_DIR.parent / "chunk_race"
LAG_NS = 20_000
# (text of csrc/chunk_spmm.cu, put the lag "before" or "after" it)
LAG_POINTS = [
    ("    const int nwords = (T + 31) / 32;\n", "before"),
    ("      XT* nbuf = s_buf + (size_t)((item + 1) & 1) * T * CW;\n", "after"),
    ("      const XT* s_x = s_buf + (size_t)(item & 1) * T * CW;\n", "before"),
    ("      const int done = s_done;\n", "after"),
]
VARIANTS = {"rest": "warp != 0", "first": "warp == 0"}
# (R, T, W, local-id dtype): T 36 and 32 load the plan by bulk copies (int16
# ids at T 32 too), T 30 and int16 ids at T 36 by the threads
LAYOUTS = {"block_t36": (64, 36, 0, torch.int32),
           "block_t32": (64, 32, 0, torch.int32),
           "block_t30": (64, 30, 0, torch.int32),
           "win_t32": (64, 32, 16, torch.int32),
           "i16_t32": (64, 32, 0, torch.int16),
           "i16_t36": (64, 36, 0, torch.int16),
           "block": (512, 256, 0, torch.int32)}
WIDTHS = (63, 256)


def lagged_source(variant: str, source: Path = SOURCE) -> Path:
    """``source`` with the warps of ``variant`` sleeping at every lag point."""
    text = source.read_text()
    lag = f"      if ({VARIANTS[variant]}) __nanosleep({LAG_NS});\n"
    for anchor, where in LAG_POINTS:
        if text.count(anchor) != 1:
            raise RuntimeError(f"lag point not found once in {source.name}: "
                               f"{anchor!r}")
        text = text.replace(anchor, lag + anchor if where == "before"
                            else anchor + lag)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    path = OUT_DIR / f"{source.stem}_{variant}.cu"
    path.write_text(text)
    return path


def graphs() -> dict:
    """Dst-sorted (src, dst, w, num_src, num_dst) whose rows span chunks."""
    rng = np.random.default_rng(0)
    E = 40_000
    hub = (rng.integers(0, 5_000, E),
           np.where(rng.random(E) < 0.75, 700, rng.integers(0, 2_000, E)),
           rng.normal(size=E), 5_000, 2_000)
    nd, E = 20_000, 200_000
    p = 1.0 / np.arange(1, nd + 1)
    zipf = (rng.integers(0, 60_000, E), rng.choice(nd, size=E, p=p / p.sum()),
            rng.uniform(0.0, 0.01, E), 60_000, nd)
    out = {}
    for name, (src, dst, w, ns, nd) in (("hub", hub), ("zipf", zipf)):
        o = np.argsort(dst, kind="stable")
        out[name] = (np.asarray(src, np.int32)[o], np.asarray(dst, np.int64)[o],
                     np.asarray(w, np.float32)[o], ns, nd)
    return out


def lagged_kernel(variant: str, source: Path = SOURCE, W: int = 0,
                  lid: torch.dtype = torch.int32) -> ChunkSpmmKernel:
    """The entry for a plan of window ``W`` and ``lid`` ids in the lagged
    copy (built at its first call, or by ``build()``)."""
    symbol = ("chunk_spmm_window" if W else
              "chunk_spmm_i16" if lid == torch.int16 else "chunk_spmm_block")
    k = ChunkSpmmKernel(symbol, bool(W), lid)
    k.source = lagged_source(variant, Path(source))
    return k


def run(device="cuda", source: Path = SOURCE) -> dict:
    """Each lagged copy of ``source`` on every graph, layout, width and table
    type; a case differs when its launch is not bit-equal to the CPU sum."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("chunk_race runs the CUDA kernel: it needs the card")
    gen = torch.Generator().manual_seed(0)
    kernels = {}
    rows = {v: {"cases": 0, "differs": [], "max_abs_err": 0.0} for v in VARIANTS}
    for gname, (src, dst, w, ns, nd) in graphs().items():
        for lname, (R, T, W, lid) in LAYOUTS.items():
            cpu, plan = (build_segment_plan(src, dst, w, nd, block_rows=R,
                                            chunk_edges=T, num_src=ns,
                                            window=W, device=d)
                         for d in ("cpu", device))
            dtypes = (torch.float32,) if lid == torch.int16 else (
                torch.float32, torch.bfloat16)
            for D in WIDTHS:
                for dt in dtypes:
                    x = torch.randn(ns, D, generator=gen).to(dt)
                    want = chunk_spmm_reference(cpu, x)
                    xd = x.to(device)
                    for v, row in rows.items():
                        if (v, W, lid) not in kernels:
                            kernels[v, W, lid] = lagged_kernel(v, source, W, lid)
                        got = kernels[v, W, lid](plan, xd).cpu()
                        row["cases"] += 1
                        row["max_abs_err"] = max(row["max_abs_err"],
                                                 float((got - want).abs().max()))
                        if not torch.equal(got, want):
                            row["differs"].append(f"{gname} {lname} D={D} {dt}")
    return {"device": torch.cuda.get_device_name(device), "source": str(source),
            "lag_ns": LAG_NS, "variants": rows}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--source", default=str(SOURCE))
    a = ap.parse_args(argv)
    res = run(a.device, Path(a.source))
    for v, r in res["variants"].items():
        print(f"chunk_race {v}: {r['cases']} cases, {len(r['differs'])} differ "
              f"(max abs err {r['max_abs_err']:.3g})"
              + (f": {', '.join(r['differs'])}" if r["differs"] else ""))
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
