"""Probe: the (T, W) grid per direction, and the padded K=3 chain.

Port of ``scripts/probe_kernel_grid.py``.  On the probe graph of
``probes/window_kernel.py`` it times, per direction, full-block chunks
(``chunk_spmm_block``) and window chunks (``chunk_spmm_window``) for T in
{128, 256, 512} and W in {64, 128, 256}, and names the fastest.  Then it
runs a K=3 Gauss-Seidel chain (``i = A_iu u; u = A_ui i``, layer means)
three ways and prints each chain's sum and time:

* ``current``: the main path's CSR kernel (``segment_spmm``), whose output
  has exactly ``num_dst`` rows;
* ``truncated``: full-block chunks, truncated to ``num_dst`` after every
  apply (the JAX probe's "current");
* ``padded``: full-block chunks on tables padded to the block grid
  (``PadLayout``), staying in the block space and truncating once (P3).

    python -m <package>.probes.kernel_grid [--device cuda|cpu]
        [--users N --items N --edges-per-user F --dim D --iters N]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.chunk_spmm import apply_chunked, apply_chunked_padded, chunk_spmm_blocks
from ..ops.segment_plan import PadLayout
from ..ops.spmm_cuda import segment_spmm
from ..utils.device import resolve_device
from ._timing import clock_name, device_loop_time, plan_bound_ms
from .window_kernel import WINDOWS, Reference, add_size_args, directions, plan_for

CHUNKS = (128, 256, 512)
LAYERS = 3
CHAIN_RTOL = 1e-4     # chain sums: fp32 sums of ~1e6 terms in other orders


def _chain(apply_iu, apply_ui, u, i):
    acc_u, acc_i = u, i
    for _ in range(LAYERS):
        i = apply_iu(u)
        u = apply_ui(i)
        acc_u = acc_u + u
        acc_i = acc_i + i
    return (acc_u / (LAYERS + 1)).sum() + (acc_i / (LAYERS + 1)).sum()


def run(device, users, items, edges_per_user, dim, iters,
        dirs=None) -> dict:
    """Every variant on ``device``; ``dirs`` (from ``directions``)
    skips building the graph again."""
    device = resolve_device(device)
    if dirs is None:
        dirs = directions(users, items, edges_per_user, dim, device)
    print(f"kernel_grid probe on {device} (times: {clock_name(device)}), "
          f"D={dim}")
    grid, best = [], {}
    for name, d in dirs.items():
        x = d["x"]
        ref = Reference(d)
        E = d["src"].size
        results = []
        for T in CHUNKS:
            for W in (0,) + WINDOWS:
                plan = plan_for(d, device, chunk_edges=T, window=W)
                err, ok = ref.check(apply_chunked(plan, x))
                r = dict(direction=name, T=T, W=W,
                         kernel="chunk_spmm_window" if W else
                         "chunk_spmm_block",
                         ms=device_loop_time(
                             lambda: chunk_spmm_blocks(plan, x), device,
                             iters),
                         pad_pct=100.0 * (plan.padded_edges / max(E, 1) - 1),
                         max_err=err, ok=ok, chunks=plan.num_chunks,
                         bound_ms=plan_bound_ms(plan, dim))
                label = (f"win  T={T:3d} W={W:3d}" if W else
                         f"base T={T:3d} W={plan.block_rows}")
                print(f"{name} {label}: {r['ms']:8.4f} ms  "
                      f"pad=+{r['pad_pct']:.0f}%  chunks={plan.num_chunks}  "
                      f"maxerr={err:.1e} {'ok' if ok else 'FAIL'}")
                results.append((r["ms"], label))
                grid.append(r)
        results.sort()
        best[name] = {"variant": results[0][1], "ms": results[0][0]}
        print(f"{name} BEST: {results[0][1]} {results[0][0]:.4f} ms")

    # ---- the K=3 chain: current, truncated, padded -------------------------
    iu, ui = dirs["items<-users"], dirs["users<-items"]
    c_iu, c_ui = iu["csr"], ui["csr"]
    p_iu, p_ui = plan_for(iu, device), plan_for(ui, device)
    U, I = ui["num_dst"], iu["num_dst"]
    lay_u = PadLayout(U, p_ui.num_blocks * p_ui.block_rows)
    lay_i = PadLayout(I, p_iu.num_blocks * p_iu.block_rows)
    rng = np.random.default_rng(1)
    u0 = torch.as_tensor(rng.standard_normal((U, dim)).astype(np.float32),
                         device=device)
    i0 = torch.as_tensor(rng.standard_normal((I, dim)).astype(np.float32),
                         device=device)

    def current():
        return _chain(lambda u: segment_spmm(c_iu.indptr, c_iu.src, c_iu.w, u,
                                             pieces=c_iu.pieces),
                      lambda i: segment_spmm(c_ui.indptr, c_ui.src, c_ui.w, i,
                                             pieces=c_ui.pieces),
                      u0, i0)

    def truncated():
        return _chain(lambda u: apply_chunked(p_iu, u),
                      lambda i: apply_chunked(p_ui, i), u0, i0)

    def padded():
        return _chain(lambda u: apply_chunked_padded(p_iu, u),
                      lambda i: apply_chunked_padded(p_ui, i),
                      lay_u.to_padded(u0), lay_i.to_padded(i0))

    chain = {}
    for label, fn in (("current", current), ("truncated", truncated),
                      ("padded", padded)):
        chain[label] = {"sum": float(fn()),
                        "ms": device_loop_time(fn, device, max(iters // 2, 1))}
    want = chain["current"]["sum"]
    chain_ok = all(abs(v["sum"] - want) <= CHAIN_RTOL * max(abs(want), 1.0)
                   for v in chain.values())
    print("chain sums: " + " ".join(f"{k}={v['sum']:.4f}"
                                    for k, v in chain.items())
          + f" ({'ok' if chain_ok else 'FAIL'}, rtol {CHAIN_RTOL:g})")
    for k, v in chain.items():
        print(f"propagate {k:<9} (K={LAYERS}): {v['ms']:8.4f} ms")
    return {"device": str(device), "clock": clock_name(device), "grid": grid,
            "best": best, "chain": chain, "chain_ok": chain_ok}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_size_args(ap)
    a = ap.parse_args(argv)
    return run(a.device, a.users, a.items, a.edges_per_user, a.dim, a.iters)


if __name__ == "__main__":
    main()
