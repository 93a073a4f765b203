"""Quality-parity harness, the port's side: the counterpart of the JAX
package's ``scripts/parity_run.py``.

    python -m <package>.scripts.parity_run build --out runs/torch_h100/parity/graph.npz
    python -m <package>.scripts.parity_run framework --graph ... --config vanilla --seed 0 [--fast]
    python -m <package>.scripts.parity_run report --dir runs/torch_h100/parity

``build`` writes the shared synthetic graph with md5 splits and the shared
real-like credibility vector, array-equal to the JAX script's at the same
arguments.  ``framework`` trains one configuration of ``CONFIG_MAP`` with
one seed through the port's ``RecTrainer`` under the reference protocol
(epochs, evaluation cadence, sampled 1+99 evaluation, best-on-val
Recall@20) and appends one JSON line with the JAX script's keys and the
card.  ``report`` holds the port's records against the reference oracle's
(``scripts/parity_oracle.py``, torch on the CPU; its committed records are
read, not re-run) with the JAX report's tables and tolerance rule, shows
the JAX framework's mean beside the port's, and ends, as the JAX report
does, with the Stage-A parity report (``cred_parity_run report``'s
``stage_a.md`` in ``cred_parity_run.DIR``) when there is one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

import numpy as np

from .cred_parity_run import DIR as STAGE_A_DIR

CONFIG_MAP = {
    # parity preset fields for the framework side (all reference-protocol)
    "vanilla": dict(propagation="symmetric", weight_mode="symmetric",
                    table_layout="joint", negative_sampler="uniform"),
    "cu_message": dict(propagation="gauss_seidel", weight_mode="cu_message",
                       table_layout="split", negative_sampler="uniform"),
    "pop_neg": dict(propagation="gauss_seidel", weight_mode="cu_message",
                    table_layout="split", negative_sampler="popmix"),
    "cred_eq322": dict(propagation="bipartite_sync",
                       weight_mode="cred_eq322", table_layout="split",
                       negative_sampler="uniform", lambda_fair=0.0),
    "cred_eq322_fair": dict(propagation="bipartite_sync",
                            weight_mode="cred_eq322", table_layout="split",
                            negative_sampler="uniform", lambda_fair=1e-2),
    "degree_aware": dict(propagation="gauss_seidel",
                         weight_mode="degree_aware", table_layout="split",
                         negative_sampler="uniform"),
    "pop_extended": dict(propagation="gauss_seidel",
                         weight_mode="cu_message", table_layout="split",
                         negative_sampler="popmix", extended_metrics=True,
                         cred_group_pct=0.20),
}
# configs that consume the shared real-like cred vector (vs all-ones)
REAL_CRED = {"cred_eq322", "cred_eq322_fair"}
EXT_METRICS = ("item_coverage", "avg_log_popularity",
               "avg_self_information", "cred_utility",
               "high_cred_recall", "low_cred_recall")
REPORT_CONFIGS = ("vanilla", "cu_message", "pop_neg", "cred_eq322",
                  "cred_eq322_fair", "degree_aware", "pop_extended")
FAST_CONFIGS = ("vanilla", "cu_message", "pop_neg")
# the throughput-flag stack of ``framework --fast``
FAST_FLAGS = dict(spmm_precision="bf16", propagation_schedule="per_epoch",
                  eval_mode="full", eval_topk="approx",
                  eval_score_dtype="bf16")


def cmd_build(args):
    from ..graph.build import synthetic_bipartite_graph
    g = synthetic_bipartite_graph(num_users=args.users, num_items=args.items,
                                  edges_per_user=args.edges_per_user,
                                  seed=args.seed, power=1.0,
                                  hash_split="md5")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, train_edges=g.train_edges,
                        val_edges=g.val_edges, test_edges=g.test_edges,
                        num_users=g.num_users, num_items=g.num_items)
    print(f"graph: {g.summary()} -> {out}")
    # the shared real-like low-variance cred vector of the cred_eq322 runs:
    # lognormal matched to the reference's real scores (p50=0.065,
    # p90=0.128), clipped to [0, 1]; oracle and framework load this file
    rng = np.random.default_rng(args.seed + 101)
    sigma = float(np.log(0.128 / 0.065) / 1.2816)  # p90/p50 ratio
    cred = np.clip(rng.lognormal(np.log(0.065), sigma, g.num_users), 0.0, 1.0)
    cred_path = out.parent / "cred.npy"
    np.save(cred_path, cred.astype(np.float32))
    q = np.percentile(cred, [50, 90])
    print(f"cred: p50={q[0]:.4f} p90={q[1]:.4f} -> {cred_path}")


def cmd_framework(args) -> dict:
    from ..graph.build import BipartiteGraph
    from ..train.trainer import RecTrainer
    from ..utils.config import RecConfig
    from ..utils.device import card_name, resolve_device

    dev = resolve_device(args.device)
    z = np.load(args.graph)
    graph = BipartiteGraph(num_users=int(z["num_users"]),
                           num_items=int(z["num_items"]),
                           train_edges=z["train_edges"],
                           val_edges=z["val_edges"],
                           test_edges=z["test_edges"])
    # --fast: the most aggressive throughput stack (bf16 messages, the
    # cached per-epoch propagation, full-catalogue evaluation with bf16
    # scores), against the oracle's full-catalogue protocol; "approx" ranks
    # exactly in the port
    fast_kw = dict(FAST_FLAGS) if args.fast else {}
    if args.eval_mode:
        fast_kw["eval_mode"] = args.eval_mode
    cfg = RecConfig(name=f"parity_{args.config}",
                    epochs=args.epochs, eval_every=args.eval_every,
                    seed=args.seed, **CONFIG_MAP[args.config], **fast_kw)
    cred = None
    if args.config in REAL_CRED:
        cred_path = args.cred or str(Path(args.graph).parent / "cred.npy")
        cred = np.load(cred_path).astype(np.float32)
    t0 = time.perf_counter()
    trainer = RecTrainer(cfg, graph, cred=cred, device=dev,
                         verbose=args.verbose)
    fit = trainer.fit(epochs=args.epochs, seed=args.seed)
    test = {K: {k: float(v[k]) for k in v
                if isinstance(v[k], (int, float))}
            for K, v in fit.test_metrics.items()}
    res = {"config": args.config, "seed": args.seed,
           "best_val": float(fit.best_val_recall), "test": test,
           "fast": bool(args.fast), "eval_mode": cfg.eval_mode,
           "seconds": time.perf_counter() - t0, "card": card_name(dev)}
    line = json.dumps(res)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return res


def _load_jsonl(path):
    rows = []
    if Path(path).exists():
        for ln in Path(path).read_text().splitlines():
            if ln.strip():
                rows.append(json.loads(ln))
    return rows


def _agg(rows, config, key_k="20", metric="recall"):
    vals = [r["test"][key_k][metric] if key_k in r["test"]
            else r["test"][int(key_k)][metric]
            for r in rows if r["config"] == config]
    if not vals:
        return None
    mean = statistics.fmean(vals)
    std = statistics.stdev(vals) if len(vals) > 1 else 0.0
    return mean, std, len(vals)


def _cell(a) -> str:
    return "missing" if a is None else \
        f"{a[0]:.4f} +/- {a[1]:.4f} (n={a[2]})"


def judged(diff: float, tol: float, digits: int = 4) -> str:
    """A row's last cells: the difference, the tolerance and the verdict,
    PASS when |diff| <= tol."""
    return (f"{diff:+.{digits}f} | {tol:.{digits}f} | "
            f"{'PASS' if abs(diff) <= tol else 'FAIL'} |")


def _row(config, metric, o, f, j, full: bool) -> str:
    """One table row (PENDING while a side is missing).  Sampled rows:
    tol = max(2x pooled std, 0.01, 1% of the oracle mean); full-catalogue
    rows drop the 0.01 floor."""
    head = (f"| {config} | {metric}@20 | {_cell(o)} | {_cell(f)} | "
            f"{_cell(j)} | ")
    if o is None or f is None:
        return head + "| | PENDING |"
    pooled = (o[1] ** 2 + f[1] ** 2) ** 0.5
    tol = (max(2 * pooled, 0.01 * abs(o[0])) if full
           else max(2 * pooled, 0.01, 0.01 * abs(o[0])))
    return head + judged(f[0] - o[0], tol)


def report_lines(frame_dir, jax_dir) -> list:
    """The report's markdown lines: the port's records in ``frame_dir``
    against the oracle's in ``jax_dir``, the JAX framework's records there
    beside them; then, as the JAX report ends, the Stage-A parity report
    (``cred_parity_run report``) in STAGE_A_DIR when one is there."""
    fd, jd = Path(frame_dir), Path(jax_dir)
    oracle = _load_jsonl(jd / "oracle.jsonl")
    frame = _load_jsonl(fd / "framework.jsonl")
    jax_frame = _load_jsonl(jd / "framework.jsonl")
    lines = [
        "# Quality parity: the port against the reference oracle",
        "",
        "Shared synthetic graph + md5 splits (`parity_run build` at its "
        "defaults: 8,000 users, 24,000 items, 8.0 edges a user, seed 7); "
        "identical protocol on both sides (sampled 1+99 eval, "
        "best-on-val-Recall@20 selection, reference hyperparameters).  "
        f"Oracle = `scripts/parity_oracle.py` (records `{jd}/`), a torch-CPU "
        "implementation of the reference training-loop semantics.  Port = "
        f"`python -m <port>.scripts.parity_run framework` (records "
        f"`{fd}/`); JAX = the JAX package's framework records (`{jd}/`), "
        "shown beside it.  PASS = |port mean - oracle mean| <= tol, "
        "tol = max(2x pooled cross-seed std, 0.01 absolute, 1% of the "
        "oracle mean): the JAX report's rule, unchanged.  The full-catalog "
        "table below drops the 0.01 floor.",
        "",
        "| Config | Metric | Oracle (mean +/- std, n) | Port (mean +/- std, "
        "n) | JAX framework (mean +/- std, n) | diff | tol | verdict |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for config in REPORT_CONFIGS:
        metrics = ["recall", "ndcg"]
        if config == "pop_extended":
            metrics += list(EXT_METRICS)
        for metric in metrics:
            lines.append(_row(config, metric,
                              _agg(oracle, config, metric=metric),
                              _agg(frame, config, metric=metric),
                              _agg(jax_frame, config, metric=metric),
                              full=False))
    # the reference's own finding: real low-variance cred underperforms
    # all-ones; both sides should reproduce that ordering
    for side, rows in (("oracle", oracle), ("port", frame)):
        van = _agg(rows, "vanilla")
        eq = _agg(rows, "cred_eq322")
        if van and eq:
            ok = eq[0] < van[0]
            lines += ["", f"Real-cred ordering ({side}): cred_eq322 "
                      f"R@20={eq[0]:.4f} vs vanilla {van[0]:.4f} -> "
                      f"{'REPRODUCED (real cred underperforms)' if ok else 'NOT reproduced'}"]

    oracle_full = _load_jsonl(jd / "oracle_full.jsonl")
    frame_fast = _load_jsonl(fd / "framework_fast.jsonl")
    jax_fast = _load_jsonl(jd / "framework_fast.jsonl")
    if oracle_full and frame_fast:
        lines += [
            "", "## Fast-mode parity (bf16 + per_epoch + approx/bf16 "
            "full eval vs exact-fp32 oracle)", "",
            "Same shared graph; protocol = full-catalogue masked ranking on "
            "both sides (`parity_oracle.py --eval-mode full` / `parity_run "
            "framework --fast`): `spmm_precision=bf16 "
            "propagation_schedule=per_epoch eval_topk=approx "
            "eval_score_dtype=bf16`; the port ranks \"approx\" exactly.  "
            "tol = max(2x pooled cross-seed std, 1% of the oracle mean).",
            "",
            "| Config | Metric | Oracle full/exact (mean +/- std, n) | "
            "Port fast (mean +/- std, n) | JAX framework fast (mean +/- "
            "std, n) | diff | tol(max(2x pooled std, 1% rel)) | verdict |",
            "|---|---|---|---|---|---|---|---|",
        ]
        for config in FAST_CONFIGS:
            for metric in ("recall", "ndcg"):
                lines.append(_row(config, metric,
                                  _agg(oracle_full, config, metric=metric),
                                  _agg(frame_fast, config, metric=metric),
                                  _agg(jax_fast, config, metric=metric),
                                  full=True))
    stage_a = Path(STAGE_A_DIR) / "stage_a.md"
    if stage_a.exists():
        lines += ["", stage_a.read_text().rstrip(),
                  "", f"Raw Stage-A artifacts: `{STAGE_A_DIR}/` "
                  "(`python -m <port>.scripts.cred_parity_run`)."]
    return lines


def cmd_report(args) -> str:
    text = "\n".join(report_lines(args.dir, args.jax_dir)) + "\n"
    out = Path(args.report_out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    print(text, end="")
    return text


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build")
    b.add_argument("--out", default="runs/torch_h100/parity/graph.npz")
    b.add_argument("--users", type=int, default=8000)
    b.add_argument("--items", type=int, default=24000)
    b.add_argument("--edges-per-user", type=float, default=8.0)
    b.add_argument("--seed", type=int, default=7)
    b.set_defaults(fn=cmd_build)

    f = sub.add_parser("framework")
    f.add_argument("--graph", required=True)
    f.add_argument("--config", required=True, choices=list(CONFIG_MAP))
    f.add_argument("--cred", default=None)
    f.add_argument("--seed", type=int, required=True)
    f.add_argument("--epochs", type=int, default=200)
    f.add_argument("--eval-every", type=int, default=2)
    f.add_argument("--out", default=None)
    f.add_argument("--verbose", action="store_true")
    f.add_argument("--fast", action="store_true",
                   help="throughput flags: bf16 messages + per_epoch "
                        "propagation + approx/bf16 full eval")
    f.add_argument("--eval-mode", default=None,
                   choices=[None, "sampled", "full"])
    f.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs on the CPU)")
    f.set_defaults(fn=cmd_framework)

    r = sub.add_parser("report")
    r.add_argument("--dir", default="runs/torch_h100/parity",
                   help="the port's framework*.jsonl")
    r.add_argument("--jax-dir", default="runs/parity",
                   help="the JAX harness's committed records: the oracle's "
                        "oracle*.jsonl and the JAX framework's "
                        "framework*.jsonl")
    r.add_argument("--report-out", default="runs/torch_h100/QUALITY_PARITY.md")
    r.set_defaults(fn=cmd_report)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
