"""Probe: where the full-catalogue evaluation's time goes, per user batch.

Answers the JAX package's ``scripts/probe_eval_breakdown.py`` and
``scripts/probe_topk.py`` on the card.  For each batch of ``--batch`` val
users over the whole catalogue (``bench.build_graph("large")``: 1,000,000
items) at D=128 (random tables, seed 0) it times, in the order the
evaluation runs them:

  host_exclusion   the batch's train-item rows on the host
                   (``eval/retrieval.exclusion_rows_for_users``; host clock)
  h2d              their copy to the card with the user ids
  scores           the (B, D) @ (D, I) product (``torch.matmul``, fp32)
  exclusion        the scatter of -1e9 into the excluded slots
  topk_full        full-width ``torch.topk`` (the library's ranking; the
                   shipped one, ``ops/topk_select``, runs in full_batch)
  topk_chunked     a top-k in each of ``--chunks`` column chunks, then the
                   merge of their C*K candidates
  scores_bf16      the product on bf16 tables with fp32 sums, as the bf16
                   evaluation scores them (``eval/retrieval.score_product``),
                   and its exclusion
  topk_bf16        full-width top-k of those fp32 scores, and
  topk_bf16_chunked  their chunked top-k
  full_batch       the evaluation's own ``eval/ranking._full_batch`` (scores,
                   exclusion, top-k, metrics), fp32 and bf16

each with CUDA events around it (the host clock on the CPU), the first
batch a warm-up.  Every variant's top-K sets are checked against the
full-width top-K of the same scores (ties aside: a differing item must tie
the K-th score); the bf16 sets' Jaccard against fp32's is reported.  It
writes ``--out`` (default ``runs/torch_h100/eval_breakdown.json``) and
changes nothing on the main path.

    python -m <package>.probes.eval_breakdown [--batches 6] [--batch 512]
        [--chunks 32] [--scale large] [--device cuda|cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..utils.device import card_name, resolve_device
from ._timing import clock_name

PARTS = ("host_exclusion", "h2d", "scores", "exclusion", "topk_full",
         "topk_chunked", "scores_bf16", "topk_bf16", "topk_bf16_chunked",
         "full_batch", "full_batch_bf16")


def chunked_topk(scores: torch.Tensor, k: int, chunks: int):
    """Top-``k`` of each row through ``chunks`` column chunks: each chunk's
    top-k, then the top-k of the ``chunks * k`` candidates.  Columns past
    the last full chunk are padded with -inf.  Returns (values, ids)."""
    B, n = scores.shape
    w = -(-n // chunks)
    if w * chunks != n:
        pad = scores.new_full((B, w * chunks - n), float("-inf"))
        scores = torch.cat([scores, pad], dim=1)
    kc = min(k, w)
    v, i = torch.topk(scores.view(B, chunks, w), kc, dim=2)
    base = (torch.arange(chunks, device=scores.device) * w)[None, :, None]
    ids = (i + base).reshape(B, chunks * kc)
    v2, j = torch.topk(v.reshape(B, chunks * kc), k, dim=1)
    return v2, torch.gather(ids, 1, j)


def sets_agree(scores: torch.Tensor, ref: torch.Tensor,
               got: torch.Tensor) -> float:
    """Share of rows whose top-K set ``got`` equals ``ref``'s, ties aside:
    an item in one set and not the other must score what the K-th of
    ``ref`` scores."""
    ref, got = ref.cpu().numpy(), got.cpu().numpy()
    s = scores.float().cpu().numpy()
    ok = 0
    for r in range(ref.shape[0]):
        diff = np.setxor1d(ref[r], got[r])
        kth = s[r, ref[r]].min()
        ok += bool(np.all(s[r, diff] == kth))
    return ok / max(ref.shape[0], 1)


def jaccard(a: torch.Tensor, b: torch.Tensor) -> float:
    """Mean per-row Jaccard of two (B, K) top-K id lists."""
    from ..scripts.eval_equiv_r4 import jaccard_stats
    return jaccard_stats(a.cpu().numpy(), b.cpu().numpy())["mean"]


class _Clock:
    """Marks between the parts of one batch: CUDA events on the card (read
    after the batch's synchronize), the host clock on the CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.marks = []

    def mark(self, name=None):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append((name, e))
        else:
            self.marks.append((name, time.perf_counter()))

    def ms(self) -> dict:
        if self.cuda:
            torch.cuda.synchronize()
        out = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            out[name] = a.elapsed_time(b) if self.cuda else 1e3 * (b - a)
        return out


def run(graph, dev, batches: int = 6, batch: int = 512, dim: int = 128,
        K: int = 20, chunks: int = 32) -> dict:
    """The probe on ``graph``'s val users; returns the record."""
    from ..eval.ranking import _full_batch
    from ..eval.retrieval import (exact_fp32_matmul, exclusion_rows_for_users,
                                  mask_excluded, score_product)
    from ..ops.sampling import DeviceCSR
    exact_fp32_matmul()
    I = graph.num_items
    users_all = np.nonzero(graph.user_csr("val").degrees() > 0)[0]
    n_eval_batches = -(-users_all.size // batch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    user_emb = 0.1 * torch.randn(graph.num_users, dim, generator=gen,
                                 device=dev)
    item_emb = 0.1 * torch.randn(I, dim, generator=gen, device=dev)
    val_csr = DeviceCSR.from_host(graph.user_csr("val"), I, dev)
    print(f"[evalbd] eval users={users_all.size:,} -> {n_eval_batches:,} "
          f"batches of {batch}; I={I:,} D={dim} K={K} chunks={chunks}; "
          f"{clock_name(dev)}", flush=True)
    per_batch, checks = [], []
    for bi in range(batches):
        bu_host = users_all[bi * batch:(bi + 1) * batch]
        if bu_host.size < batch:
            bu_host = np.concatenate([bu_host, np.zeros(batch - bu_host.size,
                                                        np.int64)])
        clock = _Clock(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        excl_np = exclusion_rows_for_users(graph, bu_host)
        t_host = 1e3 * (time.perf_counter() - t0)
        clock.mark()
        excl = torch.as_tensor(excl_np).to(dev)
        bu = torch.as_tensor(bu_host, dtype=torch.int64).to(dev)
        clock.mark("h2d")
        scores = user_emb[bu] @ item_emb.T
        clock.mark("scores")
        mask_excluded(scores, excl, -1e9)
        clock.mark("exclusion")
        _, top_full = torch.topk(scores, K, dim=1)
        clock.mark("topk_full")
        _, top_chunk = chunked_topk(scores, K, chunks)
        clock.mark("topk_chunked")
        s16 = mask_excluded(score_product(user_emb[bu], item_emb, "bf16"),
                            excl, -1e9)
        clock.mark("scores_bf16")
        _, top16 = torch.topk(s16, K, dim=1)
        clock.mark("topk_bf16")
        _, top16_chunk = chunked_topk(s16, K, chunks)
        clock.mark("topk_bf16_chunked")
        _full_batch(user_emb, item_emb, bu, excl, val_csr, None, (10, K),
                    False, 1, I)
        clock.mark("full_batch")
        _full_batch(user_emb, item_emb, bu, excl, val_csr, None, (10, K),
                    False, 1, I, score_dtype="bf16")
        clock.mark("full_batch_bf16")
        ms = {"host_exclusion": t_host, **clock.ms()}
        per_batch.append(ms)
        checks.append({
            "topk_chunked_vs_full": sets_agree(scores, top_full, top_chunk),
            "topk_bf16_chunked_vs_bf16_full": sets_agree(s16, top16,
                                                         top16_chunk),
            "bf16_full_jaccard_vs_fp32": jaccard(top_full, top16)})
    timed = per_batch[1:] or per_batch
    mean = {p: float(np.mean([m[p] for m in timed])) for p in PARTS}
    shipped = ("host_exclusion", "h2d", "full_batch")
    per_eval = {"fp32": sum(mean[p] for p in shipped) * n_eval_batches / 1e3,
                "bf16": (mean["host_exclusion"] + mean["h2d"]
                         + mean["full_batch_bf16"]) * n_eval_batches / 1e3}
    agree = {k: min(c[k] for c in checks) for k in checks[0]
             if not k.endswith("jaccard_vs_fp32")}
    jac = {k: float(np.mean([c[k] for c in checks])) for k in checks[0]
           if k.endswith("jaccard_vs_fp32")}
    rec = {"graph": graph.summary(), "batch": batch, "dim": dim, "K": K,
           "chunks": chunks, "batches": batches, "eval_users": int(
               users_all.size), "eval_batches": n_eval_batches,
           "clock": clock_name(dev), "ms_per_batch": mean,
           "per_batch": per_batch, "checks": checks,
           "sets_agree_min": agree,
           "bf16_jaccard_vs_fp32_mean": jac["bf16_full_jaccard_vs_fp32"],
           "jaccard_vs_fp32_mean": jac,
           "full_eval_projection_s": per_eval, "card": card_name(dev)}
    print("[evalbd] per batch (ms): " + " | ".join(
        f"{p} {mean[p]:.3f}" for p in PARTS), flush=True)
    print(f"[evalbd] full-eval projection: fp32 {per_eval['fp32']:.2f} s, "
          f"bf16 {per_eval['bf16']:.2f} s over {n_eval_batches} batches; "
          f"sets agree (min share of rows) {agree}", flush=True)
    return rec


def main(argv=None, graph=None) -> dict:
    """``graph``: the graph to rank over when the caller has built it
    (default ``bench.build_graph(--scale)``)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--scale", default="large")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--K", type=int, default=20)
    ap.add_argument("--chunks", type=int, default=32)
    ap.add_argument("--out", default="runs/torch_h100/eval_breakdown.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if graph is None:
        from ..bench import build_graph
        graph = build_graph(args.scale)
    rec = run(graph, dev, args.batches, args.batch, args.dim, args.K,
              args.chunks)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rec, indent=2))
    return rec


if __name__ == "__main__":
    main()
