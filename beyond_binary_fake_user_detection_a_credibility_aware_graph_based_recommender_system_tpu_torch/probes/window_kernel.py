"""Probe: the chunked SpMM layouts against the CSR kernel, both directions.

Port of ``scripts/probe_window_kernel.py`` ``main()``.  On the reference
graph (``synthetic_bipartite_graph(58_867, 261_728, 7.9, seed=0,
power=1.0)``, random weights, D=64) it prints one line per variant and
direction:

* ``csr``: the main path's kernel, ``ops/spmm_cuda.segment_spmm`` (long
  rows cut into pieces of ``LONG_ROW_EDGES`` edges);
* ``base``: full-block chunks, R=512 T=256 (the P3 body, ``chunk_spmm_block``);
* ``i16``: the same plan reading int16 local ids (P2, ``chunk_spmm_i16``);
* ``win W``: window chunks, W in {64, 128, 256} (P1, ``chunk_spmm_window``).

Each line has the time per application (a loop of CUDA events, and on the
card the device time of calls queued ahead of it), the plan's padding, the
largest difference from the CSR kernel and whether every row lies within the fp32
summation bound (1e-6 + 1e-5 * sum_e |w_e * x_src(e)|), the bound, the
plain version's time and ``torch.sparse.mm``'s on the same operator.

    python -m <package>.probes.window_kernel [--device cuda|cpu]
        [--users N --items N --edges-per-user F --dim D --iters N]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..graph.build import synthetic_bipartite_graph
from ..ops.chunk_spmm import apply_chunked, chunk_spmm_blocks, chunk_spmm_reference
from ..ops.segment_plan import build_segment_plan
from ..ops.spmm import CsrDirection
from ..ops.spmm_cuda import segment_spmm, segment_spmm_reference
from ..utils.device import resolve_device
from ._timing import (clock_name, csr_bound_ms, device_loop_time, plan_bound_ms,
                      queued_device_ms)

RTOL, ATOL = 1e-5, 1e-6
WINDOWS = (64, 128, 256)


def add_size_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--users", type=int, default=58_867)
    ap.add_argument("--items", type=int, default=261_728)
    ap.add_argument("--edges-per-user", type=float, default=7.9)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--iters", type=int, default=20)


def directions(users: int, items: int, edges_per_user: float, dim: int,
               device: torch.device, seed: int = 0) -> dict:
    """Both operator directions of the probe graph: dst-sorted edges, random
    weights, a random source table and the CSR form, as the JAX probe
    builds them."""
    graph = synthetic_bipartite_graph(users, items, edges_per_user,
                                      seed=seed, power=1.0)
    src_u = np.asarray(graph.train_edges[0])
    dst_i = np.asarray(graph.train_edges[1])
    rng = np.random.default_rng(seed)
    w = rng.random(len(src_u)).astype(np.float32)
    out = {}
    for name, (src, dst, ns, nd) in {
            "items<-users": (src_u, dst_i, graph.num_users, graph.num_items),
            "users<-items": (dst_i, src_u, graph.num_items, graph.num_users),
    }.items():
        order = np.argsort(dst, kind="stable")
        x = rng.standard_normal((ns, dim)).astype(np.float32)
        out[name] = dict(
            src=src[order].astype(np.int32), dst=dst[order].astype(np.int64),
            w=w[order], num_src=ns, num_dst=nd,
            x=torch.as_tensor(x, device=device),
            csr=CsrDirection.from_edges(src, dst, w, ns, nd, device))
    return out


def plan_for(d: dict, device, chunk_edges: int = 256, window: int = 0):
    return build_segment_plan(d["src"], d["dst"], d["w"], d["num_dst"],
                              chunk_edges=chunk_edges, num_src=d["num_src"],
                              window=window, device=device)


class Reference:
    """The CSR kernel's result on one direction and its error bound."""

    def __init__(self, d: dict):
        c, x = d["csr"], d["x"]
        self.y = segment_spmm(c.indptr, c.src, c.w, x, pieces=c.pieces)
        self.mag = segment_spmm(c.indptr, c.src, c.w.abs(), x.abs(),
                                pieces=c.pieces)

    def check(self, y: torch.Tensor):
        diff = (y - self.y).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        ok = bool((diff <= ATOL + RTOL * self.mag).all()
                  and torch.isfinite(y).all())
        return err, ok


def library_ms(d: dict, device, iters: int) -> float:
    c = d["csr"]
    a = torch.sparse_csr_tensor(c.indptr, c.src.long(), c.w,
                                size=(c.num_dst, c.num_src))
    return device_loop_time(lambda: torch.sparse.mm(a, d["x"]), device, iters)


def run(device, users, items, edges_per_user, dim, iters,
        dirs=None) -> dict:
    """Every variant on ``device``; ``dirs`` (from :func:`directions`)
    skips building the graph again."""
    device = resolve_device(device)
    if dirs is None:
        dirs = directions(users, items, edges_per_user, dim, device)
    rows = []
    print(f"window_kernel probe on {device} (times: {clock_name(device)}), "
          f"D={dim}")
    for name, d in dirs.items():
        c, x = d["csr"], d["x"]
        ref = Reference(d)
        E = c.src.numel()
        lib = library_ms(d, device, iters)
        def csr():
            return segment_spmm(c.indptr, c.src, c.w, x, pieces=c.pieces)
        rows.append(dict(
            direction=name, variant="csr", kernel="segment_spmm",
            ms=device_loop_time(csr, device, iters),
            device_ms=queued_device_ms(csr, device, iters),
            pad_pct=0.0, max_err=0.0, ok=True, bound_ms=csr_bound_ms(c, dim),
            plain_ms=device_loop_time(lambda: segment_spmm_reference(
                c.indptr, c.src, c.w, x), device, 3, reps=1),
            library_ms=lib, edges=E, max_dst_degree=int(
                (c.indptr[1:] - c.indptr[:-1]).max()) if c.num_dst else 0))
        base = plan_for(d, device)
        variants = [("base R=512 T=256", "chunk_spmm_block", base,
                     torch.int32),
                    ("i16 R=512 T=256", "chunk_spmm_i16", base, torch.int16)]
        variants += [(f"win W={W}", "chunk_spmm_window",
                      plan_for(d, device, window=W), torch.int32)
                     for W in WINDOWS]
        for variant, kernel, plan, lid in variants:
            err, ok = ref.check(apply_chunked(plan, x, lid))

            def apply():
                return chunk_spmm_blocks(plan, x, lid)
            rows.append(dict(
                direction=name, variant=variant, kernel=kernel,
                ms=device_loop_time(apply, device, iters),
                device_ms=queued_device_ms(apply, device, iters),
                pad_pct=100.0 * (plan.padded_edges / max(E, 1) - 1),
                max_err=err, ok=ok,
                bound_ms=plan_bound_ms(plan, dim,
                                       2 if lid == torch.int16 else 4),
                plain_ms=device_loop_time(lambda: chunk_spmm_reference(
                    plan, x), device, 3, reps=1),
                library_ms=lib, edges=E, chunks=plan.num_chunks,
                padded_edges=plan.padded_edges))
        for r in rows[-len(variants) - 1:]:
            dev_ms = ("" if r["device_ms"] is None
                      else f" (device {r['device_ms']:.4f})")
            print(f"{name} {r['variant']:<17}: {r['ms']:8.4f} ms{dev_ms}  "
                  f"pad=+{r['pad_pct']:.0f}%  maxerr={r['max_err']:.2e} "
                  f"{'ok' if r['ok'] else 'FAIL'}  bound {r['bound_ms']:.4f}"
                  f"  plain {r['plain_ms']:.4f}  sparse.mm "
                  f"{r['library_ms']:.4f}")
    return {"device": str(device), "clock": clock_name(device), "rows": rows}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_size_args(ap)
    a = ap.parse_args(argv)
    return run(a.device, a.users, a.items, a.edges_per_user, a.dim, a.iters)


if __name__ == "__main__":
    main()
