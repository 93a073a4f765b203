"""Two-stage pipeline at the north-star scale: the counterpart of the JAX
package's ``scripts/two_stage_10m.py``.

  Phase A: the planted 10M-edge bipartite interactions (the generator of
    the ``scaled_10m`` bench) become a heterograph through
    ``graph/hetero.synthetic_heterograph_from_edges`` (all three splits'
    edges; type-conditional labels, features and edge attributes);
    ``CredTrainer`` runs in its default SLAS mode with the candidate pool
    capped at ``--pad-deg`` (uncapped tables do not fit at this scale,
    ``ops/slas.SlasSampler.build``) and records its seconds an epoch, peak
    memory and holdout AUC; the scores are min-max exported to the CSV
    contract.

  Phase B: ``RecTrainer`` under the ``scaled_10m`` preset (fp32 messages,
    per_epoch cached propagation, full-catalogue evaluation with bf16
    scores) reads that CSV on the same planted graph and trains.

Stage A's device state is freed before Stage B.  ``summary.json`` in
``--out`` has the JAX script's keys, and the device and card (name and
power limit, ``nvidia-smi``); each stage's ``peak_hbm_gb`` is
``torch.cuda.max_memory_allocated`` over that stage, null on the CPU.

    python -m <package>.scripts.two_stage_10m --out runs/two_stage_10m
        [--cred-epochs 6] [--rec-epochs 12] [--pad-deg 128]
        [--skip-a] [--skip-b] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import gc
import json
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..bench import northstar_graph
from ..configs.presets import get_preset
from ..graph.hetero import synthetic_heterograph_from_edges
from ..train.cred_trainer import CredTrainer
from ..train.trainer import RecTrainer
from ..utils.config import CredConfig
from ..utils.device import card_name, resolve_device

CSV_NAME = "credibility_scores_minmax_with_user_id.csv"


def log(msg):
    print(msg, flush=True)


def peak_hbm_gb(device) -> Optional[float]:
    """GB of the card's memory allocated at the peak since the last reset;
    None on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 1e9


def _reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def run(graph, out, cred_epochs: int = 6, rec_epochs: int = 12,
        pad_deg: int = 128, skip_a: bool = False, skip_b: bool = False,
        device="cuda") -> dict:
    """Both stages on ``graph`` (a planted graph); writes the CSV and
    ``summary.json`` into ``out`` and returns the summary."""
    dev = resolve_device(device)
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    summary = {"device": dev.type, "card": card_name(dev)}
    csv_path = out / CSV_NAME

    if not skip_a:
        t0 = time.perf_counter()
        edges = np.concatenate(
            [graph.train_edges, graph.val_edges, graph.test_edges], axis=1)
        hg = synthetic_heterograph_from_edges(
            edges, graph.num_users, graph.num_items, seed=1)
        log(f"[10m] heterograph: U={hg.num_users:,} I={hg.num_items:,} "
            f"E={hg.num_edges:,} labeled={(hg.user_y >= 0).sum():,} "
            f"({time.perf_counter() - t0:.1f}s)")

        ccfg = CredConfig(epochs=cred_epochs, slas_pad_deg=pad_deg)
        _reset_peak(dev)
        t0 = time.perf_counter()
        tr = CredTrainer(hg, ccfg, device=dev)      # default slas mode
        t_build = time.perf_counter() - t0
        log(f"[10m] stage A setup (slas tables, pad={pad_deg}): "
            f"{t_build:.1f}s, peak HBM {peak_hbm_gb(dev)} GB")

        t0 = time.perf_counter()
        res = tr.fit()
        wall_a = time.perf_counter() - t0
        epoch_secs = [h["seconds"] for h in res.history]
        log(f"[10m] stage A: {cred_epochs} epochs in {wall_a:.1f}s "
            f"(median {np.median(epoch_secs):.3f} s/epoch), "
            f"peak HBM {peak_hbm_gb(dev)} GB")
        paths = tr.export(res, out)
        q = np.percentile(res.cred_minmax, [10, 50, 90])
        summary["stage_a"] = {
            "edges": int(hg.num_edges),
            "labeled_users": int((hg.user_y >= 0).sum()),
            "trainer_mode": ccfg.trainer_mode,
            "slas_pad_deg": pad_deg,
            "setup_seconds": t_build,
            "epochs": cred_epochs,
            "wall_seconds": wall_a,
            "seconds_per_epoch_median": float(np.median(epoch_secs)),
            "seconds_per_epoch": epoch_secs,
            "holdout_auc_final": res.history[-1]["holdout_auc"],
            "holdout_bce_final": res.history[-1]["holdout_bce"],
            "peak_hbm_gb": peak_hbm_gb(dev),
            "cred_percentiles_p10_p50_p90": [float(x) for x in q],
            "csv": paths["csv"],
        }
        (out / "summary.json").write_text(json.dumps(summary, indent=2))
        # free Stage A's device state before Stage B
        del tr, res, hg
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    if not skip_b:
        cfg = get_preset("scaled_10m", epochs=rec_epochs, seed=0,
                         cred_csv_path=str(csv_path))
        _reset_peak(dev)
        t0 = time.perf_counter()
        rtr = RecTrainer(cfg, graph, device=dev)
        log(f"[10m] stage B setup: {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        fit = rtr.fit()
        wall_b = time.perf_counter() - t0
        test = {str(K): {k: float(v)
                         for k, v in fit.test_metrics[K].items()
                         if isinstance(v, (int, float))}
                for K in fit.test_metrics}
        log(f"[10m] stage B: {rec_epochs} epochs in {wall_b:.1f}s, "
            f"TEST R@20={test['20']['recall']:.4f} "
            f"NDCG@20={test['20']['ndcg']:.4f}, "
            f"peak HBM {peak_hbm_gb(dev)} GB")
        summary.setdefault("stage_a", {"csv": str(csv_path),
                                       "note": "reused (--skip-a)"})
        summary["stage_b"] = {
            "preset": "scaled_10m (as shipped: fp32 messages, per_epoch, "
                      "full eval with bf16 scores, exact top-k)",
            "epochs": rec_epochs,
            "wall_seconds": wall_b,
            "best_val_recall": float(fit.best_val_recall),
            "test": test,
            "peak_hbm_gb": peak_hbm_gb(dev),
        }
        (out / "summary.json").write_text(json.dumps(summary, indent=2))

    log(f"[10m] DONE -> {out}/summary.json")
    return summary


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="runs/two_stage_10m")
    ap.add_argument("--users", type=int, default=500_000)
    ap.add_argument("--items", type=int, default=1_000_000)
    ap.add_argument("--edges-per-user", type=float, default=20.0)
    ap.add_argument("--cred-epochs", type=int, default=6)
    ap.add_argument("--rec-epochs", type=int, default=12)
    ap.add_argument("--pad-deg", type=int, default=128,
                    help="SLAS candidate-pool cap (max-degree tables are "
                         "memory-infeasible at this scale)")
    ap.add_argument("--skip-a", action="store_true",
                    help="reuse an existing Phase-A CSV in --out")
    ap.add_argument("--skip-b", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the CPU)")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))          # no fallback to the CPU
    log(f"[10m] device: {dev} ({card_name(dev) or 'cpu'})")

    t0 = time.perf_counter()
    graph = northstar_graph(args.users, args.items, args.edges_per_user)
    log(f"[10m] planted graph: {graph.summary()} "
        f"({time.perf_counter() - t0:.1f}s)")
    return run(graph, args.out, cred_epochs=args.cred_epochs,
               rec_epochs=args.rec_epochs, pad_deg=args.pad_deg,
               skip_a=args.skip_a, skip_b=args.skip_b, device=dev)


if __name__ == "__main__":
    main()
