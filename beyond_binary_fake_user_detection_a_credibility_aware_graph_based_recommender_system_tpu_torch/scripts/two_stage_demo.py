"""The two-stage pipeline at reference scale: the counterpart of the JAX
package's ``scripts/two_stage_demo.py``.

Raw JSONL -> Stage A (credibility training, CSV export) -> Stage B
(credibility-weighted LightGCN), the reference's end-to-end flow on a
synthetic Amazon-class review stream: the native C++ reader, feature
engineering, the heterograph, ``CredTrainer`` in its default SLAS mode, the
CSV contract, and Stage B under the ``cred_eq322`` preset reading the real
scores (the reference's ``lightgcn_cu_fair.out`` configuration).

``--pad-deg`` caps SLAS's candidate pools (``CredConfig.slas_pad_deg``;
default None, uncapped, as the JAX script runs).  On one card the
600,000-line stream needs 128: uncapped, each of two SLAS tables takes
about 21 GB.  ``summary.json`` in ``--out`` has the JAX script's keys
(``test``, ``best_val_recall``, ``stage_b_wall_seconds``), the card (name
and power limit, null on the CPU) and Stage A's history (loss, holdout BCE
and AUC, seconds, an epoch).

    python -m <package>.scripts.two_stage_demo [--lines 600000] \\
        [--cred-epochs 60] [--rec-epochs 400] [--pad-deg 128] \\
        [--out runs/torch_h100/two_stage] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np


def make_synthetic_reviews(path: Path, n_lines: int, n_users: int,
                           n_items: int, seed: int = 0):
    """Amazon-class review stream: zipf item popularity, power-ish user
    activity, rating skew toward 4-5, bursty timestamps for some users.
    The JAX script's draws in its order, so the same bytes."""
    rng = np.random.default_rng(seed)
    t0 = time.time()
    # user activity ~ lognormal, item popularity ~ zipf
    user_w = rng.lognormal(0.0, 1.2, n_users)
    user_p = user_w / user_w.sum()
    item_w = 1.0 / np.arange(1, n_items + 1) ** 1.05
    item_p = item_w / item_w.sum()
    users = rng.choice(n_users, size=n_lines, p=user_p)
    items = rng.choice(n_items, size=n_lines, p=item_p)
    ratings = rng.choice([1.0, 2.0, 3.0, 4.0, 5.0], size=n_lines,
                         p=[0.06, 0.06, 0.13, 0.25, 0.50])
    ts = (1.45e12 + rng.integers(0, int(1.5e11), n_lines)).astype(np.int64)
    helpful = rng.choice([0, 1, 2, 3, 8, 15], size=n_lines,
                         p=[0.55, 0.2, 0.1, 0.05, 0.06, 0.04])
    verified = rng.random(n_lines) < 0.75
    texts = ["great fit and color really nice quality",
             "did not like it returned the item",
             "good value for the price would buy again",
             "terrible don't buy this product it broke"]
    with open(path, "w") as f:
        for k in range(n_lines):
            f.write(json.dumps({
                "user_id": f"U{users[k]:07d}",
                "parent_asin": f"B{items[k]:08d}",
                "rating": float(ratings[k]),
                "timestamp": int(ts[k]),
                "helpful_vote": int(helpful[k]),
                "verified_purchase": bool(verified[k]),
                "title": "review",
                "text": texts[k % 4],
            }) + "\n")
    print(f"[demo] wrote {n_lines:,} lines in {time.time()-t0:.1f}s")


def run(jsonl, out, cred_epochs: int = 60, rec_epochs: int = 400,
        pad_deg=None, device="cuda") -> dict:
    """Both stages on the review JSONL ``jsonl``; writes Stage A's
    artefacts and ``summary.json`` into ``out`` and returns the summary."""
    from ..configs.presets import get_preset
    from ..data.features import compute_user_features
    from ..data.ingest import ingest_jsonl
    from ..graph.build import build_bipartite_graph
    from ..graph.hetero import build_heterograph
    from ..train.cred_trainer import CredTrainer
    from ..train.trainer import RecTrainer
    from ..utils.config import CredConfig
    from ..utils.device import card_name, resolve_device

    dev = resolve_device(device)
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    table = ingest_jsonl(jsonl)
    print(f"[demo] ingest ({table.extra.get('backend', 'python')}): "
          f"{table.num_records:,} records, {table.num_users:,} users, "
          f"{table.num_items:,} items in {time.time()-t0:.1f}s")

    feats = compute_user_features(table)
    hg = build_heterograph(table, feats)
    lab = feats.labels.label
    print(f"[demo] labels: genuine={(lab == 1).sum():,} "
          f"fake={(lab == 0).sum():,} unlabeled={(lab == -1).sum():,}")

    ccfg = CredConfig(epochs=cred_epochs, slas_pad_deg=pad_deg)
    cred_tr = CredTrainer(hg, ccfg, device=dev)
    t0 = time.time()
    cred_res = cred_tr.fit()
    wall_a = time.time() - t0
    print(f"[demo] stage A: {cred_epochs} epochs in {wall_a:.1f}s")
    paths = cred_tr.export(cred_res, out)

    graph = build_bipartite_graph(table)
    print(f"[demo] stage B graph: {graph.summary()}")

    cfg = get_preset("cred_eq322").replace(
        epochs=rec_epochs, cred_csv_path=paths["csv"])
    rec_tr = RecTrainer(cfg, graph, device=dev)
    t0 = time.time()
    result = rec_tr.fit()
    wall = time.time() - t0
    print(f"\n[demo] stage B: {rec_epochs} epochs in {wall:.1f}s "
          f"({rec_epochs / wall * 3600:.0f} epochs/hour)")
    summary = {
        "test": {str(k): v for k, v in result.test_metrics.items()},
        "best_val_recall": result.best_val_recall,
        "stage_b_wall_seconds": wall,
        "card": card_name(dev),
        "stage_a": {"trainer_mode": ccfg.trainer_mode,
                    "slas_pad_deg": pad_deg, "wall_seconds": wall_a,
                    "history": cred_res.history},
    }
    with open(out / "summary.json", "w") as f:
        json.dump(summary, f, indent=2, default=float)
    return summary


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lines", type=int, default=600_000)
    ap.add_argument("--users", type=int, default=60_000)
    ap.add_argument("--items", type=int, default=250_000)
    ap.add_argument("--cred-epochs", type=int, default=60)
    ap.add_argument("--rec-epochs", type=int, default=400)
    ap.add_argument("--pad-deg", type=int, default=None,
                    help="SLAS candidate-pool cap (CredConfig.slas_pad_deg)")
    ap.add_argument("--out", default="runs/torch_h100/two_stage")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the CPU)")
    args = ap.parse_args(argv)
    from ..utils.device import card_name, resolve_device
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))          # no fallback to the CPU
    print(f"[demo] device: {dev} ({card_name(dev) or 'cpu'})")

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    jsonl = out / "reviews.jsonl"
    if not jsonl.exists():
        make_synthetic_reviews(jsonl, args.lines, args.users, args.items)
    return run(jsonl, out, cred_epochs=args.cred_epochs,
               rec_epochs=args.rec_epochs, pad_deg=args.pad_deg, device=dev)


if __name__ == "__main__":
    main()
