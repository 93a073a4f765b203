"""Evaluation-equivalence check on the planted 10M graph, the port's side:
the counterpart of the JAX package's ``scripts/eval_equiv_r4.py``.

Three arms of ``scaled_10m`` (12 epochs, seed 0) on the planted-structure
graph (500,000 users, 1,000,000 items, 20 a user, 16 x 16 clusters):

  exact   eval_topk=exact  eval_score_dtype=fp32
  approx  eval_topk=approx eval_score_dtype=fp32
  bf16    eval_topk=approx eval_score_dtype=bf16   (scaled_10m's default)

and, on the exact arm's best parameters, each arm's per-user top-20 SET
overlap (mean Jaccard@20) against the exact ranking, and that of bf16
tables scored in fp32 (the bf16 mode without rounding each score to bf16).
The port ranks "approx" with the exact ``torch.topk`` (the TPU's
approx_max_k has no counterpart here), so the approx arm equals the exact
arm by construction; the bf16 arm is the one that tests something.

    python -m <package>.scripts.eval_equiv_r4 train --mode exact|approx|bf16
    python -m <package>.scripts.eval_equiv_r4 overlap [--max-users N]
    python -m <package>.scripts.eval_equiv_r4 report

Records (``--dir``, default ``runs/torch_h100/eval_equiv_r4``):
``train_<mode>.json`` (the JAX keys plus ``card``), ``params_<mode>.npz``
(the best parameters, ``train/checkpoint.save_params_npz``; 768 MB at full
size, not a record), ``overlap.json`` and ``report.md``, which shows the
JAX package's ``runs/eval_equiv_r4/`` beside the port's.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

DIR = "runs/torch_h100/eval_equiv_r4"
EPOCHS = 12
MODES = {
    "exact": dict(eval_topk="exact", eval_score_dtype="fp32"),
    "approx": dict(eval_topk="approx", eval_score_dtype="fp32"),
    "bf16": dict(eval_topk="approx", eval_score_dtype="bf16"),
}
# the planted graph of the JAX script (graph/build.py's generator)
GRAPH = dict(num_users=500_000, num_items=1_000_000, edges_per_user=20.0)
K = 20
R20_TOL = 0.002        # an arm's TEST R@20 against the JAX record's
JACCARD_MIN = 0.99     # the bf16 arm's mean Jaccard@20 against exact
# overlap's extra list: bf16 tables with fp32 scores (no rounding of the
# score to bf16), beside the three modes
BF16_FP32_SCORES = "bf16_tables_fp32_scores"


def build_graph():
    from ..graph.build import synthetic_bipartite_graph_planted
    return synthetic_bipartite_graph_planted(
        GRAPH["num_users"], GRAPH["num_items"], GRAPH["edges_per_user"],
        seed=0, power=1.0, coarse_clusters=16, fine_per_coarse=16,
        mix=(0.55, 0.25, 0.20))


def make_cfg(mode: str, epochs: int = EPOCHS):
    from ..configs.presets import get_preset
    return get_preset("scaled_10m", epochs=epochs, seed=0, **MODES[mode])


def _metrics(block) -> dict:
    return {str(k): {m: float(v) for m, v in r.items()
                     if isinstance(v, (int, float))}
            for k, r in (block or {}).items()}


def cmd_train(args, graph=None) -> dict:
    from ..train.checkpoint import save_params_npz
    from ..train.trainer import RecTrainer
    from ..utils.device import card_name, resolve_device
    dev = resolve_device(args.device)
    d = Path(args.dir)
    d.mkdir(parents=True, exist_ok=True)
    graph = graph if graph is not None else build_graph()
    print(f"graph: {graph.summary()}", flush=True)
    cfg = make_cfg(args.mode, args.epochs)
    t0 = time.time()
    tr = RecTrainer(cfg, graph, device=dev, verbose=True)
    fit = tr.fit()
    wall = time.time() - t0
    rec = {
        "mode": args.mode, "epochs": args.epochs, "wall_seconds": wall,
        "history": [{"epoch": h.epoch, "loss": h.loss, "val": _metrics(h.val)}
                    for h in fit.history],
        "best_val_recall": float(fit.best_val_recall),
        "test": _metrics(fit.test_metrics),
        "card": card_name(dev),
    }
    (d / f"train_{args.mode}.json").write_text(json.dumps(rec, indent=2))
    save_params_npz(d / f"params_{args.mode}.npz", fit.best_params)
    print(f"[{args.mode}] wall={wall:.1f}s "
          f"testR@20={rec['test']['20']['recall']:.4f}", flush=True)
    return rec


def _topk_lists(user_emb, item_emb, graph, val_csr, users, mode, K=K,
                batch=512):
    """(n_users, K) top-K item lists under one mode's ranking path: the
    ``_full_batch`` that ``evaluate_full`` runs, on the batch's train
    exclusion rows."""
    from ..eval.ranking import _batched, _full_batch
    from ..eval.retrieval import exclusion_rows_for_users
    kw = MODES[mode]
    out = []
    for bu, bu_host, n_valid in _batched(users, batch, user_emb.device):
        excl = torch.as_tensor(exclusion_rows_for_users(graph, bu_host),
                               device=user_emb.device)
        _, topk_items, _, _ = _full_batch(
            user_emb, item_emb, bu, excl, val_csr, None, (K,), False, 1,
            graph.num_items, score_dtype=kw["eval_score_dtype"])
        out.append(topk_items[:n_valid, :K].cpu().numpy())
    return np.concatenate(out, axis=0)


def jaccard_stats(a: np.ndarray, b: np.ndarray) -> dict:
    """Per-row top-K set overlap of two (n, K) id lists: the JAX record's
    statistics (|A| = |B| = K, so |union| = 2K - |intersection|)."""
    Kc = a.shape[1]
    inter = np.array([np.intersect1d(x, y).size for x, y in zip(a, b)])
    jac = inter / (2 * Kc - inter)
    return {"mean": float(jac.mean()), "p05": float(np.percentile(jac, 5)),
            "min": float(jac.min()),
            "frac_identical": float((inter == Kc).mean())}


def overlap_lists(graph, params, users, device, batch=512) -> dict:
    """Each mode's top-K lists for ``users`` on one set of parameters."""
    from ..eval.retrieval import exact_fp32_matmul
    from ..models.lightgcn import LightGCN
    from ..ops.sampling import DeviceCSR
    cfg = make_cfg("exact")
    exact_fp32_matmul()
    model = LightGCN(cfg, graph, None, device=device)
    val_csr = DeviceCSR.from_host(graph.user_csr("val"), graph.num_items,
                                  device, cfg.membership)
    with torch.no_grad():
        user_emb, item_emb = model.propagate(params)
        lists = {m: _topk_lists(user_emb, item_emb, graph, val_csr, users, m,
                                batch=batch) for m in MODES}
        # bf16 tables, scores summed and kept in fp32: the bf16 mode without
        # its scores' rounding to bf16
        lists[BF16_FP32_SCORES] = _topk_lists(
            user_emb.bfloat16().float(), item_emb.bfloat16().float(), graph,
            val_csr, users, "exact", batch=batch)
        return lists


def cmd_overlap(args, graph=None) -> dict:
    """Mean Jaccard@20 of each fast mode against exact, SAME params."""
    from ..train.checkpoint import load_params_npz
    from ..utils.device import card_name, resolve_device
    dev = resolve_device(args.device)
    d = Path(args.dir)
    graph = graph if graph is not None else build_graph()
    params = load_params_npz(d / "params_exact.npz", dev)
    users = np.nonzero(graph.user_csr("val").degrees() > 0)[0].astype(
        np.int64)
    if args.max_users and users.size > args.max_users:
        users = users[np.linspace(0, users.size - 1, args.max_users,
                                  dtype=np.int64)]
    print(f"overlap over {users.size:,} val users", flush=True)
    t0 = time.perf_counter()
    lists = overlap_lists(graph, params, users, dev)
    res = {"n_users": int(users.size), "K": K}
    for m in ("approx", "bf16", BF16_FP32_SCORES):
        res[f"jaccard_{m}_vs_exact"] = jaccard_stats(lists["exact"],
                                                     lists[m])
        print(m, res[f"jaccard_{m}_vs_exact"], flush=True)
    res["seconds"] = time.perf_counter() - t0
    res["card"] = card_name(dev)
    (d / "overlap.json").write_text(json.dumps(res, indent=2))
    return res


def report_lines(d: Path, jax_dir: Path) -> list:
    recs = {m: json.loads((d / f"train_{m}.json").read_text())
            for m in MODES if (d / f"train_{m}.json").exists()}
    jrecs = {m: json.loads((jax_dir / f"train_{m}.json").read_text())
             for m in MODES if (jax_dir / f"train_{m}.json").exists()}
    ov = (json.loads((d / "overlap.json").read_text())
          if (d / "overlap.json").exists() else None)
    jov = (json.loads((jax_dir / "overlap.json").read_text())
           if (jax_dir / "overlap.json").exists() else None)
    cards = sorted({r["card"] for r in recs.values() if r.get("card")})
    lines = ["## Eval fast-path equivalence on the planted-structure 10M "
             "graph: the port", "",
             f"Port records `{d}/` ({', '.join(cards) or 'no card recorded'});"
             f" JAX records `{jax_dir}/` (TPU; walls are context, no "
             "target).  The port's approx ranks exactly (`torch.topk`), so "
             "its approx arm equals its exact arm by construction; bf16 "
             f"scores are the arm under test.  Tolerance: TEST R@20 within "
             f"{R20_TOL} of JAX's; bf16 mean Jaccard@20 >= {JACCARD_MIN}.", ""]
    if "exact" in recs:
        rs = [h["val"]["20"]["recall"] for h in recs["exact"]["history"]
              if h["val"]]
        improving = int((np.diff(rs) > 0).sum())
        lines += [f"Planted graph (port, exact arm): VAL R@20 "
                  f"{improving}/{len(rs) - 1} strict improvements over "
                  f"{len(rs)} epochs: " + " ".join(f"{r:.4f}" for r in rs),
                  ""]
    lines += ["| arm | wall (port / JAX) | best val R@20 | TEST R@20 | TEST "
              "NDCG@20 | JAX TEST R@20 | diff | tol | verdict |",
              "|---|---|---|---|---|---|---|---|---|"]
    for m, r in recs.items():
        t = r["test"]["20"]["recall"]
        j = jrecs.get(m)
        jt = None if j is None else j["test"]["20"]["recall"]
        jw = "missing" if j is None else f"{j['wall_seconds']:.1f}s"
        tail = "missing | | | PENDING |" if jt is None else (
            f"{jt:.4f} | {t - jt:+.4f} | {R20_TOL} | "
            f"{'PASS' if abs(t - jt) <= R20_TOL else 'FAIL'} |")
        lines.append(f"| {m} | {r['wall_seconds']:.1f}s / {jw} | "
                     f"{r['best_val_recall']:.4f} | {t:.4f} | "
                     f"{r['test']['20']['ndcg']:.4f} | " + tail)
    if "exact" in recs and "approx" in recs:
        ex, ap = recs["exact"], recs["approx"]
        same = ex["test"] == ap["test"] and \
            ex["best_val_recall"] == ap["best_val_recall"]
        lines += ["", "approx arm equal to the exact arm (TEST block and best "
                  f"val): {'yes' if same else 'NO'}"]
    if ov:
        lines += ["", f"Per-user top-20 SET overlap vs exact (same params, "
                  f"{ov['n_users']:,} val users; JAX's in brackets):", ""]
        for m in ("approx", "bf16", BF16_FP32_SCORES):
            if f"jaccard_{m}_vs_exact" not in ov:
                continue
            o = ov[f"jaccard_{m}_vs_exact"]
            jo = (jov or {}).get(f"jaccard_{m}_vs_exact")
            verdict = "" if m != "bf16" else (
                f" — {'PASS' if o['mean'] >= JACCARD_MIN else 'FAIL'} "
                f"(>= {JACCARD_MIN})")
            jtxt = "" if jo is None else (
                f" [JAX: mean {jo['mean']:.4f}, p05 {jo['p05']:.4f}, min "
                f"{jo['min']:.4f}; {jo['frac_identical']:.1%} identical]")
            lines.append(f"* {m}: mean Jaccard@20 = {o['mean']:.4f} (p05 "
                         f"{o['p05']:.4f}, min {o['min']:.4f}; "
                         f"{o['frac_identical']:.1%} of users have identical "
                         f"top-20 sets){verdict}{jtxt}")
    return lines


def cmd_report(args) -> str:
    d = Path(args.dir)
    text = "\n".join(report_lines(d, Path(args.jax_dir))) + "\n"
    (d / "report.md").write_text(text)
    print(text, end="")
    return text


def main(argv=None, graph=None):
    """``graph``: the planted graph when the caller has built it already."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("train")
    t.add_argument("--mode", required=True, choices=list(MODES))
    t.add_argument("--epochs", type=int, default=EPOCHS)
    t.set_defaults(fn=cmd_train)
    o = sub.add_parser("overlap")
    o.add_argument("--max-users", type=int, default=100_000)
    o.set_defaults(fn=cmd_overlap)
    r = sub.add_parser("report")
    r.add_argument("--jax-dir", default="runs/eval_equiv_r4",
                   help="the JAX package's committed records")
    r.set_defaults(fn=cmd_report)
    for p in (t, o, r):
        p.add_argument("--dir", default=DIR)
    for p in (t, o):
        p.add_argument("--device", default="cuda",
                       help="torch device (default cuda; cpu runs on the "
                            "CPU)")
    args = ap.parse_args(argv)
    if args.cmd == "report":
        return args.fn(args)
    return args.fn(args, graph)


if __name__ == "__main__":
    main()
