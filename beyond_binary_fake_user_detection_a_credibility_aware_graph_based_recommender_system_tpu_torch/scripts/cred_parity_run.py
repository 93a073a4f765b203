"""Stage-A quality-parity harness, the port's side: the counterpart of the
JAX package's ``scripts/cred_parity_run.py``.

Three Stage-A trainers on one planted-signal heterograph:

  oracle      ``scripts/cred_oracle.py`` (the reference's semantics: Python
              SLAS 2-hop subgraphs, torch on the CPU).  It is the measuring
              stick, not the system under test: its committed score vector
              (``runs/torch_h100/cred_parity/cred_oracle.npy``) is read, not
              re-run;
  full_graph  the port's ``CredTrainer`` with ``trainer_mode="full_graph"``
              (the full-graph temporal views through the SpMM kernel);
  slas        the port's ``CredTrainer`` with ``trainer_mode="slas"`` (the
              fixed-shape Gumbel-top-k SLAS draws).

    python -m <package>.scripts.cred_parity_run build [--dir D]
    python -m <package>.scripts.cred_parity_run framework --mode full_graph|slas
    python -m <package>.scripts.cred_parity_run downstream
    python -m <package>.scripts.cred_parity_run report [--oracle PATH]

``build`` writes the heterograph (``hg.npz``), the latent quality
(``latent_q.npy``) and the aligned Stage-B graph with the md5 split
(``graph.npz``), array-equal to the JAX script's at the same seed.
``framework`` trains one mode for EPOCHS_A epochs (batch 1,024) and saves
``cred_<mode>.npy`` (the min-max scores) and ``framework_<mode>.json``
(holdout AUC a epoch, wall seconds, the card).  ``downstream`` trains
``cu_message`` and ``cred_eq322`` with each score vector (and all ones) for
EPOCHS_B epochs and writes ``downstream.json`` with the JAX keys.
``report`` applies the JAX report's verdict rule unchanged and shows the JAX
package's rows (``runs/cred_parity/stage_a.md``, ``downstream.json``) beside
the port's; with the JAX framework's own score vectors (``--jax-dir``) it
adds the rank correlation of each port mode with JAX's.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

DIR = "runs/torch_h100/cred_parity"
EPOCHS_A = 60          # Stage-A epochs (the JAX script's)
EPOCHS_B = 120         # Stage-B epochs for the downstream delta
BATCH_A = 1024
USERS, ITEMS = 3000, 6000   # the planted heterograph's size (the JAX one's)
MODES = ("full_graph", "slas")
SOURCES = ("oracle",) + MODES
STAGE_B = {
    "cu_message": dict(propagation="gauss_seidel", weight_mode="cu_message"),
    "cred_eq322": dict(propagation="bipartite_sync",
                       weight_mode="cred_eq322"),
}
RHO_MIN = 0.8          # the verdict: rank correlation with the oracle
PCT_TOL = 0.10         # and the slas mode's |delta percentile| at p10/50/90


def build_planted_heterograph(U=3000, I=6000, deg=10.0, seed=7):
    """Heterograph with PLANTED user quality q: labels, two informative user
    features and the 'verified' edge attribute all correlate with q (the
    JAX script's function: the same numpy draws in the same order, so the
    arrays are equal at every seed)."""
    from ..graph.hetero import CRED_GRAPH_FEATURE_KEYS, HeteroGraph
    rng = np.random.default_rng(seed)
    q = rng.uniform(0, 1, U)
    user_y = np.full(U, -1, np.int64)
    user_y[q > 0.62] = 1
    user_y[q < 0.38] = 0
    # 7 features: 2 informative (q + noise), 5 nuisance
    user_x = rng.normal(size=(U, 7)).astype(np.float32)
    user_x[:, 0] = q + rng.normal(0, 0.25, U)
    user_x[:, 1] = (1 - q) + rng.normal(0, 0.35, U)

    E = int(U * deg)
    u = rng.integers(0, U, E)
    p = 1.0 / np.arange(1, I + 1, dtype=np.float64)
    p /= p.sum()
    i = rng.choice(I, size=E, p=p)
    pairs = np.unique(np.stack([u, i], 1), axis=0)
    u, i = pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32)
    E = u.size

    rating = rng.integers(1, 6, E).astype(np.float32)
    mean_r = np.zeros(I)
    cnt = np.maximum(np.bincount(i, minlength=I), 1)
    np.add.at(mean_r, i, rating)
    mean_r = mean_r / cnt
    ts = rng.random(E).astype(np.float32)
    ts[rng.random(E) < 0.05] = np.nan
    verified = (rng.random(E) < (0.25 + 0.55 * q[u])).astype(np.float32)
    attr = np.stack([
        verified,
        1.0 - np.abs(rating - mean_r[i]) / 4.0,
        rating, ts,
        rng.integers(0, 12, E).astype(np.float32)], 1).astype(np.float32)
    hg = HeteroGraph(
        user_x=user_x, user_y=user_y,
        item_x=np.stack([mean_r, cnt], 1).astype(np.float32),
        edges=np.stack([u, i]), edge_attr=attr,
        feature_keys=list(CRED_GRAPH_FEATURE_KEYS),
        user_ids=[f"u{k}" for k in range(U)])
    return hg, q, (u, i)


def cmd_build(args) -> dict:
    from ..data.ingest import md5_split_bucket
    d = Path(args.dir)
    d.mkdir(parents=True, exist_ok=True)
    hg, q, (u, i) = build_planted_heterograph(U=USERS, I=ITEMS,
                                              seed=args.seed)
    hg.save_npz(d / "hg.npz")
    np.save(d / "latent_q.npy", q)
    # the aligned Stage-B graph from the SAME edges, md5 content-hash split
    buckets = np.array([md5_split_bucket(f"u{a}", f"i{b}")
                        for a, b in zip(u, i)], np.int8)

    def edges_of(b):
        m = buckets == b
        return np.stack([u[m], i[m]]).astype(np.int32)
    np.savez_compressed(d / "graph.npz", train_edges=edges_of(0),
                        val_edges=edges_of(1), test_edges=edges_of(2),
                        num_users=hg.num_users, num_items=hg.num_items)
    print(f"built: {hg.num_users} users / {hg.num_items} items / "
          f"{hg.num_edges} edges -> {d}")
    return {"users": hg.num_users, "items": hg.num_items,
            "edges": hg.num_edges}


def cmd_framework(args) -> dict:
    from ..graph.hetero import HeteroGraph
    from ..train.cred_trainer import CredTrainer
    from ..utils.config import CredConfig
    from ..utils.device import card_name, resolve_device
    dev = resolve_device(args.device)
    d = Path(args.dir)
    hg = HeteroGraph.load_npz(d / "hg.npz")
    cfg = CredConfig(trainer_mode=args.mode, epochs=args.epochs,
                     batch_size=BATCH_A, seed=args.seed)
    t0 = time.perf_counter()
    tr = CredTrainer(hg, cfg, device=dev, verbose=True)
    res = tr.fit()
    wall = time.perf_counter() - t0
    np.save(d / f"cred_{args.mode}.npy", res.cred_minmax)
    auc = res.history[-1]["holdout_auc"]
    rec = {"mode": args.mode, "seed": args.seed, "epochs": args.epochs,
           "batch_size": BATCH_A, "final_holdout_auc": auc,
           "holdout_auc": [h["holdout_auc"] for h in res.history],
           "loss": [h["loss"] for h in res.history],
           "percentiles": np.percentile(res.cred_minmax,
                                        [10, 50, 90, 99]).tolist(),
           "wall_seconds": wall, "card": card_name(dev)}
    (d / f"framework_{args.mode}.json").write_text(json.dumps(rec, indent=2))
    print(f"saved {d}/cred_{args.mode}.npy (final holdout AUC={auc:.4f})")
    return rec


def _graph(path):
    from ..graph.build import BipartiteGraph
    z = np.load(path)
    return BipartiteGraph(num_users=int(z["num_users"]),
                          num_items=int(z["num_items"]),
                          train_edges=z["train_edges"],
                          val_edges=z["val_edges"],
                          test_edges=z["test_edges"])


def cmd_downstream(args) -> dict:
    """Stage-B deltas: each score vector feeds cu_message and cred_eq322."""
    from ..train.trainer import RecTrainer
    from ..utils.config import RecConfig
    from ..utils.device import card_name, resolve_device
    dev = resolve_device(args.device)
    d = Path(args.dir)
    graph = _graph(d / "graph.npz")
    sources = {"ones": np.ones(graph.num_users, np.float32)}
    oracle = Path(args.oracle)
    for name in SOURCES:
        p = oracle if name == "oracle" else d / f"cred_{name}.npy"
        if p.exists():
            sources[name] = np.load(p).astype(np.float32)
    if args.sources:
        sources = {k: v for k, v in sources.items()
                   if k in args.sources.split(",")}
    out, walls = {}, {}
    for cname, cdict in STAGE_B.items():
        for sname, cred in sources.items():
            cfg = RecConfig(name=f"ds_{cname}_{sname}", table_layout="split",
                            epochs=args.epochs, eval_every=4, seed=args.seed,
                            **cdict)
            t0 = time.perf_counter()
            fit = RecTrainer(cfg, graph, cred=cred, device=dev,
                             verbose=False).fit()
            walls[f"{cname}/{sname}"] = time.perf_counter() - t0
            m = fit.test_metrics[20]
            out[f"{cname}/{sname}"] = {"recall": float(m["recall"]),
                                       "ndcg": float(m["ndcg"])}
            print(f"{cname}/{sname}: R@20={m['recall']:.4f} "
                  f"NDCG@20={m['ndcg']:.4f}", flush=True)
    (d / "downstream.json").write_text(json.dumps(out, indent=2))
    meta = {"epochs": args.epochs, "seed": args.seed, "wall_seconds": walls,
            "card": card_name(dev)}
    (d / "downstream_run.json").write_text(json.dumps(meta, indent=2))
    return out


def spearman(a, b):
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    ra -= ra.mean()
    rb -= rb.mean()
    return float((ra * rb).sum() / np.sqrt((ra**2).sum() * (rb**2).sum()))


def verdict(creds: dict, ds: dict) -> dict:
    """The JAX report's verdict rule, unchanged: ACCEPT when both framework
    modes' Spearman rho against the oracle is >= RHO_MIN and the slas
    mode's p10/p50/p90 are within PCT_TOL of the oracle's; also the largest
    downstream |R@20 delta| of a mode's scores against the oracle's."""
    rho, pct = {}, None
    if "oracle" in creds:
        for name in MODES:
            if name in creds:
                rho[name] = spearman(creds[name], creds["oracle"])
        if "slas" in creds:
            pct = np.abs(np.percentile(creds["slas"], [10, 50, 90])
                         - np.percentile(creds["oracle"], [10, 50, 90]))
    ok = all(r >= RHO_MIN for r in rho.values()) if rho else False
    if pct is not None:
        ok = ok and bool((pct <= PCT_TOL).all())
    deltas = []
    for cname in STAGE_B:
        o = ds.get(f"{cname}/oracle")
        for name in MODES:
            f = ds.get(f"{cname}/{name}")
            if o and f:
                deltas.append(abs(f["recall"] - o["recall"]))
    return {"accept": ok, "rho_vs_oracle": rho,
            "slas_pct_delta": None if pct is None else pct.tolist(),
            "max_downstream_delta": max(deltas) if deltas else None}


def verdict_line(v: dict) -> str:
    """The JAX report's verdict sentence."""
    pct = ds = ""
    if v["slas_pct_delta"] is not None:
        pct = (" Default-mode (slas) |Δ percentile| vs oracle at "
               "p10/p50/p90: "
               + "/".join(f"{d:.3f}" for d in v["slas_pct_delta"])
               + f" (threshold {PCT_TOL:.2f} each).")
    if v["max_downstream_delta"] is not None:
        ds = (f" Max downstream |R@20 delta| vs oracle-cred: "
              f"{v['max_downstream_delta']:.4f}.")
    return (f"**Verdict: {'ACCEPT' if v['accept'] else 'FLAG'}** — framework "
            "trainers' rank correlation vs the SLAS-subgraph oracle: "
            + ", ".join(f"{n}={r:.3f}" for n, r in v["rho_vs_oracle"].items())
            + f" (threshold {RHO_MIN}).{pct}{ds}")


def jax_rows(jax_md: Path) -> dict:
    """The JAX report's table rows (``stage_a.md``) by their first cell."""
    rows = {}
    if jax_md.exists():
        for ln in jax_md.read_text().splitlines():
            cells = [c.strip() for c in ln.strip().strip("|").split("|")]
            if ln.startswith("| ") and len(cells) >= 3 \
                    and not cells[0].startswith(("trainer", "config", "---")):
                rows[cells[0]] = cells[1:]
    return rows


def report_lines(d: Path, oracle: Path, jax_dir: Path, jax_cpu: Path) -> list:
    """The report: the port's modes against the oracle vector, with the JAX
    package's rows (``jax_dir``) and, where its CPU score vectors are in
    ``jax_cpu``, rho(port, JAX) for each mode."""
    q = np.load(d / "latent_q.npy")
    creds = {}
    if oracle.exists():
        creds["oracle"] = np.load(oracle)
    for name in MODES:
        p = d / f"cred_{name}.npy"
        if p.exists():
            creds[name] = np.load(p)
    jcpu = {n: np.load(jax_cpu / f"cred_{n}.npy") for n in MODES
            if (jax_cpu / f"cred_{n}.npy").exists()}
    jcpu = {n: v for n, v in jcpu.items() if v.shape == q.shape}
    ds = json.loads((d / "downstream.json").read_text()) \
        if (d / "downstream.json").exists() else {}
    jrows = jax_rows(jax_dir / "stage_a.md")
    jds = json.loads((jax_dir / "downstream.json").read_text()) \
        if (jax_dir / "downstream.json").exists() else {}
    runs = {n: json.loads((d / f"framework_{n}.json").read_text())
            for n in MODES if (d / f"framework_{n}.json").exists()}
    cards = sorted({r["card"] for r in runs.values() if r.get("card")})
    lines = ["## Stage-A parity: SLAS-subgraph oracle vs the port's trainers",
             "",
             "Planted-signal heterograph (latent user quality q drives "
             "labels, 2 of 7 features, and the verified edge attr; "
             f"`{d}/hg.npz`, equal to the JAX script's).  Oracle = "
             "`scripts/cred_oracle.py` (the reference's Python-SLAS 2-hop "
             f"training semantics, torch on the CPU; vector `{oracle}`).  "
             f"Port = `python -m <port>.scripts.cred_parity_run framework` "
             f"on {', '.join(cards) or 'no card recorded'}.  JAX = the JAX "
             f"package's record `{jax_dir}/stage_a.md` (TPU), shown beside.",
             "",
             "### Cred-score distributions",
             "",
             "| trainer | p10 | p50 | p90 | p99 | rho vs q | rho vs oracle "
             "| rho vs JAX (CPU) | JAX record: p10 / p50 / p90 / p99 / rho "
             "vs q / rho vs oracle |",
             "|---|---|---|---|---|---|---|---|---|"]
    for name, c in creds.items():
        p = np.percentile(c, [10, 50, 90, 99])
        r_o = spearman(c, creds["oracle"]) if "oracle" in creds else \
            float("nan")
        r_j = f"{spearman(c, jcpu[name]):.4f}" if name in jcpu else "n/a"
        lines.append(f"| {name} | {p[0]:.4f} | {p[1]:.4f} | {p[2]:.4f} | "
                     f"{p[3]:.4f} | {spearman(c, q):.4f} | {r_o:.4f} | {r_j} "
                     f"| {' / '.join(jrows.get(name, ['missing']))} |")
    if ds:
        lines += ["", "### Downstream Stage-B deltas (test, K=20)", "",
                  "| config / cred source | R@20 | NDCG@20 | JAX R@20 | JAX "
                  "NDCG@20 |", "|---|---|---|---|---|"]
        for k, v in ds.items():
            j = jds.get(k)
            jc = "missing | missing" if j is None else \
                f"{j['recall']:.4f} | {j['ndcg']:.4f}"
            lines.append(f"| {k} | {v['recall']:.4f} | {v['ndcg']:.4f} | "
                         f"{jc} |")
    lines += ["", verdict_line(verdict(creds, ds)), ""]
    return lines


def cmd_report(args) -> str:
    d = Path(args.dir)
    text = "\n".join(report_lines(d, Path(args.oracle), Path(args.jax_dir),
                                  Path(args.jax_cpu))) + "\n"
    out = Path(args.out or d / "stage_a.md")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    print(text, end="")
    return text


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, fn in (("build", cmd_build), ("framework", cmd_framework),
                     ("downstream", cmd_downstream), ("report", cmd_report)):
        p = sub.add_parser(name)
        p.add_argument("--seed", type=int, default=42)
        p.add_argument("--dir", default=DIR,
                       help="the run's directory (graph, vectors, records)")
        if name == "framework":
            p.add_argument("--mode", required=True, choices=list(MODES))
            p.add_argument("--epochs", type=int, default=EPOCHS_A)
        if name == "downstream":
            p.add_argument("--epochs", type=int, default=EPOCHS_B)
            p.add_argument("--sources", default=None,
                           help="comma list of the score vectors to train "
                                "with (default: all present: ones, oracle, "
                                "full_graph, slas)")
        if name in ("downstream", "report"):
            p.add_argument("--oracle", default=f"{DIR}/cred_oracle.npy",
                           help="the oracle's committed score vector")
        if name in ("framework", "downstream"):
            p.add_argument("--device", default="cuda",
                           help="torch device (default cuda; cpu runs on "
                                "the CPU)")
        if name == "report":
            p.add_argument("--out", default=None,
                           help="default: <dir>/stage_a.md")
            p.add_argument("--jax-dir", default="runs/cred_parity",
                           help="the JAX package's committed records")
            p.add_argument("--jax-cpu", default=f"{DIR}/jax_cpu",
                           help="the JAX framework's score vectors on the "
                                "CPU (rho(port, JAX) a mode)")
        p.set_defaults(fn=fn)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
