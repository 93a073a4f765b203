"""Reference regression runner: the counterpart of the JAX package's
``scripts/reference_regression.py``.

The protocol of the reference's six captured runs: the preset's
hyperparameters, a sampled VAL evaluation (1 positive + 99 negatives) every
epoch, best-on-val selection on Recall@20, a final TEST block, logged in
the reference's ``.out`` format (``Loaded edges.``, ``Epoch NN | loss=``,
the ``K=`` metric lines, ``[REGRESSION] ...``) so that a run diffs line by
line against the JAX package's ``runs/*_ref_scale.out``.  Without
``--jsonl`` the graph is the synthetic Amazon-class one of the JAX script
at the same arguments (``--scale small|ref|large``).

The metrics JSONL has one line an epoch (``epoch``, ``loss``, ``seconds``,
``val``) and a final line (``test``, ``best_val_recall``,
``wall_seconds``, and ``card``: the card's name and power limit, null on
the CPU).

    python -m <package>.scripts.reference_regression --preset vanilla \\
        --epochs 400 [--jsonl reviews.jsonl] [--cred cred.csv] \\
        [--scale small|ref|large] [--out run.out] \\
        [--metrics-jsonl run_metrics.jsonl] [--device cuda|cpu] [key=value ...]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from typing import Optional

from ..configs.presets import get_preset
from ..graph.build import build_bipartite_graph, synthetic_bipartite_graph
from ..train.trainer import RecTrainer
from ..utils.device import card_name, resolve_device

# the JAX script's three synthetic graphs: (users, items, edges a user,
# Zipf power), seed 0
SCALES = {"small": (2_000, 3_000, 16.0, 0.9),
          "ref": (58_867, 261_728, 7.9, 1.0),
          # north-star class: ~10M interactions (BASELINE.json config 5)
          "large": (500_000, 1_000_000, 20.0, 1.0)}


def scale_graph(scale: str):
    """The JAX script's synthetic graph at ``scale``."""
    users, items, epu, power = SCALES[scale]
    return synthetic_bipartite_graph(users, items, epu, seed=0, power=power)


class Tee:
    """A text stream that writes to each of ``streams``."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for f in self.streams:
            f.write(s)
        return len(s)

    def flush(self):
        for f in self.streams:
            f.flush()


def main(argv=None) -> dict:
    """Runs the protocol; returns the metrics JSONL's final record."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="vanilla")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--jsonl", default=None,
                    help="real dataset JSONL; synthetic ref-scale otherwise")
    ap.add_argument("--cred", default=None, help="credibility CSV")
    ap.add_argument("--scale", default="ref",
                    choices=["small", "ref", "large"])
    ap.add_argument("--out", default=None, help="also tee log to this file")
    ap.add_argument("--metrics-jsonl", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the CPU)")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))          # no fallback to the CPU

    cfg = get_preset(args.preset).with_overrides(args.overrides)
    if args.epochs:
        cfg = cfg.replace(epochs=args.epochs)
    if args.cred:
        cfg = cfg.replace(cred_csv_path=args.cred)

    if args.jsonl:
        from ..data.ingest import ingest_jsonl
        graph = build_bipartite_graph(ingest_jsonl(args.jsonl))
    else:
        graph = scale_graph(args.scale)

    card: Optional[str] = card_name(dev)
    with contextlib.ExitStack() as stack:
        copies = ([stack.enter_context(open(args.out, "w"))]
                  if args.out else [])
        stack.enter_context(contextlib.redirect_stdout(
            Tee(sys.stdout, *copies)))
        print(f"Loaded edges. {graph.summary()}")
        print("Using device:", dev if card is None else f"{dev} ({card})")

        trainer = RecTrainer(cfg, graph, device=dev)
        # E * K * 2 (forward and backward) * 2 (both directions) * steps
        E = graph.train_edges.shape[1]
        nb = -(-trainer.train_users.size // cfg.batch_size)
        edges_per_epoch = E * cfg.num_layers * 2 * 2 * nb

        t0 = time.perf_counter()
        result = trainer.fit()
        wall = time.perf_counter() - t0

        print(f"\n[REGRESSION] preset={cfg.name} epochs={cfg.epochs} "
              f"wall={wall:.1f}s epochs/hour={cfg.epochs / wall * 3600:.1f} "
              f"propagation_edges_per_sec="
              f"{edges_per_epoch * cfg.epochs / wall:,.0f}")
        sys.stdout.flush()

    final = {"test": {str(k): v for k, v in result.test_metrics.items()},
             "best_val_recall": result.best_val_recall,
             "wall_seconds": wall, "card": card}
    if args.metrics_jsonl:
        with open(args.metrics_jsonl, "w") as f:
            for h in result.history:
                f.write(json.dumps({
                    "epoch": h.epoch, "loss": h.loss, "seconds": h.seconds,
                    "val": {str(k): v for k, v in (h.val or {}).items()},
                }, default=float) + "\n")
            f.write(json.dumps(final, default=float) + "\n")
    return final


if __name__ == "__main__":
    main()
