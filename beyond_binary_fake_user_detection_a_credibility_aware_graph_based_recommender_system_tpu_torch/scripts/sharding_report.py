"""The edge-sharded plan of ``scaled_10m``'s two operators, the port's side:
the counterpart of the JAX package's ``scripts/sharding_report.py``.

Plans both propagation directions of the ``scaled_10m`` preset
(``cu_message`` weights from a uniform(0.2, 1) credibility draw, seed 0) on
``bench.build_graph("large")`` (500,000 users, 1,000,000 items, 20 a user)
over a model axis of 4, through ``parallel/sharded_spmm``'s
``ShardedSpmmOperator`` on a ``ModelAxis`` (host planning: no process
group).  It records each operator's per-device padded edges, pad fraction,
halo ``h_max`` and the halo / all-gather row volumes, and the per-batch
full-evaluation exclusion rows (``eval/retrieval.py``).  The JAX record's
mesh was data 2 x model 4; the data axis does not change the plan.

    python -m <package>.scripts.sharding_report [--out FILE] \\
        [--jax-record runs/sharding_report.json] [--device cuda|cpu]

Writes ``--out`` (default ``runs/torch_h100/sharding_report.json``) with the
JAX record's keys, checks it against the JAX record element for element and
prints the JAX script's markdown table.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

OPERATORS = ("item_from_user", "user_from_item")
# the JAX record's mesh: data 2 x model 4 (the data axis does not change
# the plan)
DATA, MODEL = 2, 4
# the JAX record's keys of an operator's stats and of a direction's
OP_KEYS = ("mode", "n_devices", "num_src", "num_dst", "num_edges",
           "src_padded_rows", "dst_padded_rows", "fwd", "bwd", "halo_rows",
           "allgather_rows")
DIR_KEYS = ("edge_counts", "e_max", "pad_fraction", "h_max")


def graph_key(graph) -> dict:
    """The record's ``graph`` entry: users, items and train edges."""
    return {"users": graph.num_users, "items": graph.num_items,
            "train_edges": int(graph.train_edges.shape[1])}


def operator_stats(graph, model: int = MODEL) -> dict:
    """Each direction's halo-mode ``ShardedSpmmOperator.stats`` on a model
    axis of ``model``: ``scaled_10m``'s weights with the JAX script's
    credibility draw."""
    from ..configs.presets import get_preset
    from ..graph.operators import build_edge_maps
    from ..parallel.mesh import ModelAxis
    from ..parallel.sharded_spmm import ShardedSpmmOperator
    cred = np.random.default_rng(0).uniform(
        0.2, 1.0, graph.num_users).astype(np.float32)
    maps = build_edge_maps(graph, get_preset("scaled_10m").weight_mode, cred)
    return {name: ShardedSpmmOperator(em, ModelAxis(model), mode="halo").stats
            for name, em in zip(OPERATORS, maps)}


def record_stats(stats: dict) -> dict:
    """An operator's stats with the JAX record's keys."""
    out = {k: stats[k] for k in OP_KEYS}
    for d in ("fwd", "bwd"):
        out[d] = {k: stats[d][k] for k in DIR_KEYS}
    return out


def exclusion_block(graph, batch: int = 512) -> dict:
    """The per-batch full-evaluation exclusion rows of a random batch
    (seed 1) against the global (U, max degree) table they replace."""
    from ..eval.retrieval import exclusion_rows_for_users
    users = np.random.default_rng(1).integers(0, graph.num_users, batch)
    excl = exclusion_rows_for_users(graph, users)
    max_deg = int(graph.user_csr("train").degrees().max())
    return {"batch": batch, "batch_rows_shape": list(excl.shape),
            "batch_bytes": int(excl.nbytes),
            "global_table_bytes_would_be": int(graph.num_users * max_deg * 4)}


def differences(a, b, path: str = "") -> list:
    """Paths where ``a`` and ``b`` (JSON values) differ, element for
    element (floats exactly)."""
    if isinstance(a, dict) and isinstance(b, dict):
        out = [f"{path}/{k}: missing" for k in sorted(set(a) ^ set(b))]
        for k in sorted(set(a) & set(b)):
            out += differences(a[k], b[k], f"{path}/{k}")
        return out
    if isinstance(a, list) and isinstance(b, list):
        if len(a) != len(b):
            return [f"{path}: length {len(a)} != {len(b)}"]
        out = []
        for i, (x, y) in enumerate(zip(a, b)):
            out += differences(x, y, f"{path}[{i}]")
        return out
    return [] if a == b else [f"{path}: {a!r} != {b!r}"]


def table(report: dict, D: int) -> list:
    """The JAX script's markdown table."""
    lines = ["| operator | per-device edges (min..max) | e_max pad | halo "
             f"h_max | halo vol (MB, D={D}) | allgather vol (MB) |",
             "|---|---|---|---|---|---|"]
    for name, s in report["operators"].items():
        ec = s["fwd"]["edge_counts"]
        lines.append(
            f"| {name} | {min(ec):,}..{max(ec):,} (balance "
            f"{max(ec) / (sum(ec) / len(ec)):.3f}x) | "
            f"{s['fwd']['pad_fraction']:.1%} | {s['fwd']['h_max']:,} | "
            f"{s['halo_rows'] * D * 4 / 1e6:.1f} | "
            f"{s['allgather_rows'] * D * 4 / 1e6:.1f} |")
    fe = report["full_eval_exclusion"]
    lines += ["", f"full-eval exclusion rows: batch {fe['batch_rows_shape']} "
              f"= {fe['batch_bytes'] / 1e6:.2f} MB/batch vs "
              f"{fe['global_table_bytes_would_be'] / 1e9:.2f} GB global table"]
    return lines


def main(argv=None, graph=None) -> dict:
    """``graph``: ``bench.build_graph("large")`` when the caller has it."""
    from ..bench import build_graph
    from ..configs.presets import get_preset
    from ..utils.device import card_name, resolve_device
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="runs/torch_h100/sharding_report.json")
    ap.add_argument("--jax-record", default="runs/sharding_report.json")
    ap.add_argument("--device", default="cuda",
                    help="the card recorded beside the plan (default cuda; "
                         "cpu records none)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    graph = graph if graph is not None else build_graph("large")
    print(f"graph: {graph.summary()}", file=sys.stderr)
    report = {"config": "scaled_10m",
              "mesh": {"data": DATA, "model": MODEL},
              "graph": graph_key(graph),
              "operators": {k: record_stats(v) for k, v in
                            operator_stats(graph).items()},
              "full_eval_exclusion": exclusion_block(graph)}
    jax_path = Path(args.jax_record)
    diff = None
    if jax_path.exists():
        diff = differences(report, json.loads(jax_path.read_text()))
        print(f"against {jax_path}: " + ("equal, element for element"
                                         if not diff else
                                         f"{len(diff)} differences: "
                                         f"{diff[:5]}"), file=sys.stderr)
    out = {**report, "card": card_name(dev),
           "differences_from_jax_record": diff}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=2))
    print(f"wrote {args.out}", file=sys.stderr)
    print("\n".join(table(report, get_preset("scaled_10m").emb_dim)))
    return out


if __name__ == "__main__":
    main()
