"""End-to-end walk-through: the counterpart of the JAX package's
``examples/end_to_end.py``.

Raw JSONL -> ingest -> features/labels -> graph -> Stage A and the
credibility CSV contract -> Stage-B training -> extended evaluation, on a
4,000-line demo stream (120 users, 90 items, and one broken line the
reader must survive).

    python -m <package>.examples.end_to_end [--epochs 8] [--cred-epochs 10]
        [--out DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path

import numpy as np


def make_demo_jsonl(path: Path, n: int = 4000, seed: int = 0):
    """The JAX example's demo stream: the same draws, so the same bytes."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            u, i = int(rng.integers(0, 120)), int(rng.zipf(1.4)) % 90
            f.write(json.dumps({
                "user_id": f"u{u}", "parent_asin": f"i{i}",
                "rating": float(rng.integers(1, 6)),
                "timestamp": int(1.5e12 + rng.integers(0, 3e10)),
                "helpful_vote": int(rng.integers(0, 12)),
                "verified_purchase": bool(rng.integers(0, 2)),
                "title": "great product",
                "text": "really liked the fit and color",
            }) + "\n")
        f.write("{broken json line\n")  # the reader must survive this


def main(argv=None):
    """Runs the walk-through; returns Stage B's ``FitResult``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=8,
                    help="Stage-B epochs (the JAX example's 8)")
    ap.add_argument("--cred-epochs", type=int, default=10,
                    help="Stage-A epochs (the JAX example's 10)")
    ap.add_argument("--out", default=None,
                    help="working directory (default: a new temporary one)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the CPU)")
    args = ap.parse_args(argv)

    from ..configs.presets import get_preset
    from ..data.features import build_user_labels, compute_user_features
    from ..data.ingest import ingest_jsonl
    from ..graph.build import build_bipartite_graph
    from ..graph.hetero import build_heterograph
    from ..train.cred_trainer import CredTrainer
    from ..train.trainer import RecTrainer
    from ..utils.config import CredConfig
    from ..utils.device import card_name, resolve_device
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))          # no fallback to the CPU
    print(f"[e2e] device: {dev} ({card_name(dev) or 'cpu'})")

    tmp = Path(args.out or tempfile.mkdtemp(prefix="bb_demo_"))
    tmp.mkdir(parents=True, exist_ok=True)
    jsonl = tmp / "reviews.jsonl"
    make_demo_jsonl(jsonl)

    table = ingest_jsonl(jsonl)
    print(f"[e2e] ingested: {table.num_records} records, "
          f"{table.num_users} users, {table.num_items} items")

    labels = build_user_labels(table)
    feats = compute_user_features(table)
    print(f"[e2e] labels: genuine={int((labels.label == 1).sum())} "
          f"fake={int((labels.label == 0).sum())} "
          f"unlabeled={int((labels.label == -1).sum())}")
    print(f"[e2e] features: {feats.values.shape} keys={feats.keys}")

    graph = build_bipartite_graph(table)
    print(f"[e2e] graph: {graph.summary()}")

    # Stage A: train the credibility model and export the CSV contract.
    hg = build_heterograph(table, feats)
    cred_trainer = CredTrainer(hg, CredConfig(epochs=args.cred_epochs,
                                              batch_size=64),
                               device=dev, verbose=False)
    cred_res = cred_trainer.fit()
    paths = cred_trainer.export(cred_res, tmp)
    print(f"[e2e] stage-A cred scores: p50="
          f"{float(np.median(cred_res.cred_minmax)):.4f}")

    cfg = get_preset("pop_extended").replace(
        batch_size=128, epochs=args.epochs, sampled_negatives=30,
        Ks=(5, 10), cred_csv_path=str(paths["csv"]))
    trainer = RecTrainer(cfg, graph, device=dev)
    res = trainer.fit()
    print(f"[e2e] best val recall@10 = {res.best_val_recall:.4f}")
    print(f"[e2e] test coverage@10 = "
          f"{res.test_metrics[10]['item_coverage']:.4f}")
    return res


if __name__ == "__main__":
    main()
