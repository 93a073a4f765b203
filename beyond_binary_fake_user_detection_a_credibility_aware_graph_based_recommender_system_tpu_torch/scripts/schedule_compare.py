"""``per_batch`` against ``per_epoch`` propagation under ``scaled_10m``, the
port's side: the counterpart of the JAX package's
``scripts/schedule_compare.py``.

The same planted 10M graph and seed for both schedules, everything else
the preset's (full-catalogue evaluation every epoch, bf16 scores ranked
exactly).  ``per_batch`` runs the full K=4 propagate, forward and backward,
in every step (the reference's schedule); ``per_epoch`` caches the
neighbour term for an epoch and keeps the live ego term.

    python -m <package>.scripts.schedule_compare [EPOCHS] \\
        [--schedules per_epoch,per_batch] [--out FILE] [--device cuda|cpu]

Writes ``--out`` (default ``runs/torch_h100/schedule_compare.json``) with
the JAX record's keys (``seconds``: the trainer's set-up and fit) plus
``card``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from . import eval_equiv_r4

SCHEDULES = ("per_epoch", "per_batch")
EPOCHS = 12
PROTOCOL = ("scaled_10m preset defaults: full-catalog eval every epoch, "
            "eval_topk=approx, eval_score_dtype=bf16, planted 10M graph")


def run_schedule(graph, schedule: str, epochs: int, dev) -> dict:
    """One fit of ``scaled_10m`` under ``schedule``: the JAX record's
    entry for it."""
    from ..configs.presets import get_preset
    from ..train.trainer import RecTrainer
    cfg = get_preset("scaled_10m", propagation_schedule=schedule,
                     epochs=epochs, seed=0)
    t0 = time.time()
    tr = RecTrainer(cfg, graph, device=dev, verbose=True)
    fit = tr.fit()
    dt = time.time() - t0
    later = [e.seconds for e in fit.history[1:]] or \
        [e.seconds for e in fit.history]
    return {"epochs": epochs, "seconds": dt,
            "epoch_seconds_median": float(np.median(later)),
            "best_val_recall20": float(fit.best_val_recall),
            "test": {int(K): {m: float(v) for m, v in r.items()
                              if isinstance(v, (int, float))}
                     for K, r in fit.test_metrics.items()}}


def main(argv=None, graph=None) -> dict:
    """``graph``: the planted graph when the caller has built it already."""
    from ..utils.device import card_name, resolve_device
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("epochs", nargs="?", type=int, default=EPOCHS)
    ap.add_argument("--schedules", default=",".join(SCHEDULES))
    ap.add_argument("--out", default="runs/torch_h100/schedule_compare.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if graph is None:
        print("building planted 10M-edge graph...", flush=True)
        graph = eval_equiv_r4.build_graph()
    print(graph.summary(), flush=True)
    out = {"protocol": PROTOCOL, "card": card_name(dev)}
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    for schedule in args.schedules.split(","):
        if schedule not in SCHEDULES:
            ap.error(f"unknown schedule {schedule!r}")
        out[schedule] = run_schedule(graph, schedule, args.epochs, dev)
        print(f"[{schedule}] {out[schedule]['seconds']:.0f}s "
              f"testR@20={out[schedule]['test'][20]['recall']:.4f}",
              flush=True)
        path.write_text(json.dumps(out, indent=2))
    print("done")
    return out


if __name__ == "__main__":
    main()
