"""A projection of ``scaled_10m``'s epoch on P = 2, 4, 8 cards: the port of
the JAX package's ``scripts/scaling_projection.py``.

No run on several cards has been made, so this is a projection, not a
measurement.  It combines

  * the planned collective volumes at P model shards: the port's planner
    (``parallel/sharded_spmm.ShardedSpmmOperator`` on a ``ModelAxis`` of P,
    ``mode="auto"``, all-ones credibility as JAX's) on the planted 10M-edge
    graph (``bench.northstar_graph``), host planning only;
  * the single-card terms measured on an H100
    (``probes/scaling_terms.py``: ``runs/torch_h100/scaling_terms.json``);
    terms that no CUDA card measured (JAX's ``runs/scaling_terms.json``
    says ``"TPU v5 lite0"``) are refused, as are terms of another message
    precision than the preset ships;
  * the H100 SXM's published bandwidths, stated as assumptions
    (``"measured": false``): HBM3 3.35 TB/s and NVLink 4, 900 GB/s a GPU in
    all, 450 GB/s each way (``--link-gbps`` overrides the link figure).

The model (one per_epoch training epoch):

  T(P) = t_prop/P + K * sum_dir V_dir(P) / BW_link + t_steps/P + t_fixed

with V_dir(P) the bytes the busiest card receives in one application of a
direction: halo P * h_max rows, all-gather (P-1)/P of the padded source
rows, whichever the planner picks, at D message elements of the preset's
bytes; efficiency = T(1) / (P * T(P)); an evaluation t_eval / P.

The P=4 halo volumes are checked against a ``sharding_report.py`` record
(``--sharding-report``, made with ``mode="halo"``) on the record's graph
(``bench.build_graph("large")`` for the committed one; the projection's own
P=4 plan when it is the projected graph, else a plan of it with
``mode="auto"``): each operator's ``rows_per_chip_halo`` times P must equal
the record's ``halo_rows`` (P^2 h_max).  A difference is an error.  The
halo rows do not depend on the edge weights (the planner builds them from
the source and destination slots alone), so the projection's all-ones
credibility checks a record made with any.

    python -m <package>.scripts.scaling_projection [--terms FILE]
        [--link-gbps 450] [--sharding-report FILE] [--out FILE]
        [--device cuda|cpu]

Writes ``--out`` (default ``runs/torch_h100/scaling_projection.json``).
"""

from __future__ import annotations

import argparse
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

import numpy as np

from ..probes._timing import HBM_BYTES_PER_S
from .sharding_report import graph_key

PROJECTED_P = (2, 4, 8)
CHECK_P = 4                  # the sharding report's model axis
CHECK_WEIGHTS = ("all-ones credibility on this side; halo rows do not "
                 "depend on the edge weights (the planner builds them from "
                 "the source and destination slots alone), so the record's "
                 "credibility does not enter the check")
LINK_GBPS = 450.0
ASSUMPTIONS = {
    "HBM_GBps": {"value": HBM_BYTES_PER_S / 1e9, "measured": False,
                 "source": "NVIDIA H100 SXM5 80GB datasheet: HBM3, "
                           "3.35 TB/s"},
    "link_GBps_per_gpu_each_way": {
        "value": LINK_GBPS, "measured": False,
        "source": "NVIDIA H100 SXM datasheet: NVLink 4, 900 GB/s a GPU in "
                  "all (18 links), 450 GB/s each way; every GPU of an "
                  "HGX H100 8-GPU board reaches every other through the "
                  "NVSwitches at that rate, so it is taken for P = 2, 4 "
                  "and 8 alike"},
}
LABEL = ("PROJECTION, not a measurement: single-card terms measured on the "
         "card, collective volumes from the planner, bandwidths the H100 "
         "SXM's published figures (not measured); only a run on several "
         "cards can replace them")


def preset_constants():
    """D, message bytes, K and the message precision of ``scaled_10m`` as
    the port ships it."""
    from ..configs.presets import get_preset
    cfg = get_preset("scaled_10m")
    return (cfg.emb_dim, 2 if cfg.spmm_precision == "bf16" else 4,
            cfg.num_layers, cfg.spmm_precision)


def build_graph():
    from ..bench import northstar_graph
    return northstar_graph()


def plan_volumes(graph, n_model: int) -> dict:
    """Each ``cu_message`` direction's per-application collective rows and
    bytes on the busiest card at ``n_model`` model shards (host planning,
    ``mode="auto"``, all-ones credibility)."""
    from ..graph.operators import build_edge_maps
    from ..parallel.mesh import ModelAxis
    from ..parallel.sharded_spmm import ShardedSpmmOperator
    D, nbytes, _, _ = preset_constants()
    maps = build_edge_maps(graph, "cu_message",
                           np.ones(graph.num_users, np.float32))
    out = {}
    for name, em in zip(("item_from_user", "user_from_item"), maps):
        s = ShardedSpmmOperator(em, ModelAxis(n_model), mode="auto").stats
        # the true halo plan's h_max, recorded by the auto decision even
        # when the all-gather wins (whose own h_max is a placeholder)
        halo_h_max = s["fwd"]["halo_h_max_considered"]
        per_chip = {"halo": n_model * halo_h_max,
                    "allgather": (n_model - 1) * s["src_padded_rows"]
                    // n_model}
        mode = s["fwd_mode"]
        out[name] = {
            "mode": mode,
            "h_max": halo_h_max,
            "src_padded_rows": s["src_padded_rows"],
            "rows_per_chip": per_chip[mode],
            "rows_per_chip_halo": per_chip["halo"],
            "rows_per_chip_allgather": per_chip["allgather"],
            "bytes_per_chip": per_chip[mode] * D * nbytes,
            "e_max": s["fwd"]["e_max"],
            "pad_fraction": s["fwd"]["pad_fraction"],
        }
    return out


def check_terms(terms: dict) -> None:
    """Refuse terms that no CUDA card measured, or measured under another
    message precision than the preset ships (JAX's assert, ``:152``)."""
    device, card = str(terms.get("device", "")), terms.get("card")
    if not device.startswith("cuda") or not card:
        raise ValueError(f"terms measured on device {device!r}, card "
                         f"{card!r}: the projection takes only terms a CUDA "
                         f"card measured (probes/scaling_terms.py)")
    precision = preset_constants()[3]
    if f"{precision} messages" not in terms.get("config", ""):
        raise ValueError(f"terms were measured under a different precision "
                         f"than the shipped preset ({precision}): "
                         f"{terms.get('config')!r}; rerun "
                         f"probes/scaling_terms.py")


def project(terms: dict, volumes: dict, link_gbps: float = LINK_GBPS) -> dict:
    """T(P), its collective part and the efficiency for each P of
    ``volumes`` (P to :func:`plan_volumes`'s dict)."""
    _, _, K, _ = preset_constants()
    t_prop, t_steps = terms["propagate_s"], terms["scan_steps_s"]
    t_fixed = terms.get("fixed_s", 0.05)
    t_eval = terms.get("eval_epoch_s")
    t1 = t_prop + t_steps + t_fixed
    rows = {}
    for P, vols in volumes.items():
        # K applications of each direction an epoch, forward only (the
        # per_epoch cache runs under no_grad)
        coll = sum(v["bytes_per_chip"] for v in vols.values()) * K
        t_coll = coll / (link_gbps * 1e9)
        tP = t_prop / P + t_steps / P + t_coll + t_fixed
        row = {"volumes": vols,
               "collective_bytes_per_epoch_per_chip": int(coll),
               "t_collective_s": t_coll, "t_epoch_projected_s": tP,
               "t_epoch_1chip_s": t1, "scaling_efficiency": t1 / (P * tP)}
        if t_eval is not None:
            # the score product is column-sharded over items: it splits by
            # P; the top-k merge is O(B * K * P)
            row["t_eval_projected_s"] = t_eval / P
        rows[str(P)] = row
    return rows


def cross_check(volumes: dict, record: dict, n_model: int = CHECK_P) -> dict:
    """Each operator's halo rows of ``volumes`` (planned at ``n_model``)
    against the sharding report's ``record``: P * rows_per_chip_halo must
    equal its ``halo_rows`` (P^2 h_max), and the h_max its forward h_max."""
    rows, ok = {}, True
    for name, v in volumes.items():
        r = record["operators"][name]
        same = (n_model * v["rows_per_chip_halo"] == r["halo_rows"]
                and v["h_max"] == r["fwd"]["h_max"])
        ok &= same
        rows[name] = {"rows_per_chip_halo": v["rows_per_chip_halo"],
                      "report_halo_rows": r["halo_rows"],
                      "h_max": v["h_max"], "report_h_max": r["fwd"]["h_max"],
                      "equal": same}
    return {"P": n_model, "operators": rows, "equal": ok}


def main(argv=None, graph=None, report_graph=None) -> dict:
    """``graph``: the planted graph when the caller has built it;
    ``report_graph``: the sharding record's graph (default
    ``bench.build_graph("large")``, the committed record's), planned again
    for the check unless it is ``graph``, whose P=4 plan is at hand."""
    from ..utils.device import card_name, resolve_device
    D, nbytes, K, precision = preset_constants()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--terms", default="runs/torch_h100/scaling_terms.json",
                    help="single-card terms (probes/scaling_terms.py)")
    ap.add_argument("--link-gbps", type=float, default=LINK_GBPS,
                    help="per-card link bandwidth each way, GB/s (default "
                         "NVLink 4's published 450)")
    ap.add_argument("--sharding-report",
                    default="runs/torch_h100/sharding_report.json",
                    help="the P=4 halo rows to check against ('' skips)")
    ap.add_argument("--out", default="runs/torch_h100/scaling_projection.json")
    ap.add_argument("--device", default="cuda",
                    help="the card recorded beside the projection (default "
                         "cuda; cpu records none); planning is host-only")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    terms = json.loads(Path(args.terms).read_text())
    check_terms(terms)
    graph = graph if graph is not None else build_graph()
    print(f"graph: {graph.summary()}", file=sys.stderr)
    # host planning: numpy releases the GIL in its sorts and gathers, so
    # the three plans share the host's cores
    with ThreadPoolExecutor(len(PROJECTED_P)) as pool:
        volumes = dict(zip(PROJECTED_P, pool.map(partial(plan_volumes, graph),
                                                 PROJECTED_P)))
    assumptions = {k: dict(v) for k, v in ASSUMPTIONS.items()}
    if args.link_gbps != LINK_GBPS:
        assumptions["link_GBps_per_gpu_each_way"] = {
            "value": args.link_gbps, "measured": False,
            "source": "--link-gbps"}
    report = {"label": LABEL, "assumptions": {
        **assumptions, "emb_dim": D, "message_bytes": nbytes, "layers": K,
        "message_precision": precision,
        "graph": graph_key(graph),
        "terms_measured": terms, "terms_file": args.terms,
        "model": "T(P) = t_prop/P + K*sum_dir V_dir(P)/BW_link + t_steps/P "
                 "+ t_fixed; V = bottleneck-card recv bytes per SpMM app"},
        "projections": project(terms, volumes, args.link_gbps)}
    for P, row in report["projections"].items():
        print(f"P={P}: t_epoch {row['t_epoch_projected_s']:.4f}s (coll "
              f"{row['t_collective_s'] * 1e3:.2f} ms) eff="
              f"{row['scaling_efficiency']:.3f} (projected)", file=sys.stderr)
    if args.sharding_report:
        record = json.loads(Path(args.sharding_report).read_text())
        if report_graph is None:
            from ..bench import build_graph as bench_graph
            report_graph = bench_graph("large")
        if graph_key(report_graph) != record["graph"]:
            raise ValueError(f"the record's graph is {record['graph']}, the "
                             f"graph planned for the check "
                             f"{graph_key(report_graph)}")
        planned = (volumes[CHECK_P] if report_graph is graph
                   else plan_volumes(report_graph, CHECK_P))
        check = cross_check(planned, record)
        check.update(record=args.sharding_report,
                     graph=graph_key(report_graph), weights=CHECK_WEIGHTS)
        report["sharding_report_check"] = check
        print(f"P={CHECK_P} halo rows against {args.sharding_report}: "
              + ("equal" if check["equal"] else f"DIFFER {check}"),
              file=sys.stderr)
        if not check["equal"]:
            raise AssertionError(f"halo rows differ from the sharding "
                                 f"record: {check['operators']}")
    report["card"] = card_name(dev)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=2))
    print(json.dumps({k: {"eff": round(v["scaling_efficiency"], 3),
                          "t_epoch_s": round(v["t_epoch_projected_s"], 3)}
                      for k, v in report["projections"].items()}))
    return report


if __name__ == "__main__":
    main()
