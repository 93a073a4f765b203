"""The fp32-against-bf16 quality table: the counterpart of the JAX
package's ``scripts/precision_compare.py``.

Reads every ``*.jsonl`` in ``--dir`` (metrics files of
``scripts/reference_regression.py`` runs with ``spmm_precision=fp32|bf16``
overrides) and prints the JAX script's markdown table: a row a run, with
the epochs, the best val Recall@20, the mean val Recall@20 of the last 50
epochs, TEST Recall@20 and NDCG@20 and the wall seconds.  An incomplete
run (no test line) is skipped with a note on stderr.

    python -m <package>.scripts.precision_compare \\
        [--dir runs/torch_h100/precision_compare]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

HEADER = ["run", "epochs", "best_val_R20", "mean_last50_val_R20",
          "test_R20", "test_NDCG20", "wall_s"]


def load(path):
    epochs, test = [], None
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if "test" in rec:
                test = rec
            else:
                epochs.append(rec)
    return epochs, test


def val_recall_curve(epochs, K="20"):
    return np.array([e["val"][K]["recall"] for e in epochs if e.get("val")])


def rows(directory) -> list:
    out = []
    for path in sorted(Path(directory).glob("*.jsonl")):
        name = path.name.replace(".jsonl", "")
        epochs, test = load(path)
        if test is None:
            print(f"skipping incomplete {name}", file=sys.stderr)
            continue
        curve = val_recall_curve(epochs)
        t20 = test["test"]["20"]
        out.append({
            "run": name,
            "epochs": len(epochs),
            "best_val_R20": test["best_val_recall"],
            "mean_last50_val_R20": float(curve[-50:].mean()),
            "test_R20": t20["recall"],
            "test_NDCG20": t20["ndcg"],
            "wall_s": test["wall_seconds"],
        })
    return out


def table(directory) -> str:
    lines = ["| " + " | ".join(HEADER) + " |", "|" + "---|" * len(HEADER)]
    for r in rows(directory):
        lines.append("| " + " | ".join(
            f"{r[h]:.5f}" if isinstance(r[h], float) and h != "wall_s"
            else (f"{r[h]:.0f}" if h == "wall_s" else str(r[h]))
            for h in HEADER) + " |")
    return "\n".join(lines)


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default="runs/torch_h100/precision_compare")
    args = ap.parse_args(argv)
    text = table(args.dir)
    print(text)
    return text


if __name__ == "__main__":
    main()
