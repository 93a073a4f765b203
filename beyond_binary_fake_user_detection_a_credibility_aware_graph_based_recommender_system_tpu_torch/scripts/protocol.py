"""The reference protocol's full-length runs, in one process: every entry
point of ``scripts/`` called through its ``main`` with the arguments the JAX
package's records were made with.

Parts (run in the order given):

  reference   ``reference_regression`` for the six presets of the JAX
              package's ``runs/SUMMARY.md`` at ``--scale ref``, 400 epochs:
              ``<out>/<preset>_ref_scale_metrics.jsonl``;
  precision   ``reference_regression --preset cu_message`` with
              ``spmm_precision=fp32|bf16`` and ``seed=42|43``, 400 epochs:
              ``<out>/precision_compare/cu_message_<p>_s<seed>.jsonl``, then
              the ``precision_compare`` table (``PRECISION.md``);
  parity      ``parity_run build`` at its defaults, ``framework`` for every
              configuration and seed (200 epochs, ``--eval-every 2``) into
              ``<out>/parity/framework.jsonl``, ``--fast`` for vanilla,
              cu_message and pop_neg into ``framework_fast.jsonl``, then
              ``report`` into ``<out>/QUALITY_PARITY.md``;
  two_stage   ``two_stage_demo --pad-deg 128`` (Stage A 60 epochs, Stage B
              400): ``<out>/two_stage/summary.json``; then the all-ones
              ``cred_eq322`` run on the demo's own graph
              (``reference_regression --jsonl``, 400 epochs):
              ``<out>/two_stage/cred_eq322_ones_metrics.jsonl``;
  seeds       ``reference_regression`` for SEED_PRESETS at the seeds
              EXTRA_SEEDS, 400 epochs: ``<out>/seeds/<preset>_s<seed>.jsonl``
              (the spread of a preset's late-epoch loss over seeds);
  northstar   ``reference_regression --preset scaled_10m --scale large``,
              12 epochs: ``<out>/scaled_10m_large_metrics.jsonl``;
  summary     reads those records and the JAX package's (``--jax-runs``)
              and writes ``<out>/SUMMARY.md``: each run's quality and
              late-epoch loss beside the JAX record's, with its tolerance
              and verdict, and its wall time with the card (no device
              needed).

Each run's log goes to ``<out>/logs/<run>.out``; one line a run is printed
with its wall seconds and TEST Recall@20.

    python -m <package>.scripts.protocol reference precision parity \\
        two_stage seeds northstar summary --out runs/torch_h100 \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import statistics
import time
from pathlib import Path

import torch

from . import (parity_run, precision_compare, reference_regression,
               two_stage_demo)
from ..utils.device import card_name, resolve_device

REFERENCE_PRESETS = ("vanilla", "cu_message", "pop_neg", "degree_aware",
                     "pop_extended", "cred_eq322")
SCALE = "ref"                 # the reference and precision runs' graph
REFERENCE_EPOCHS = 400
PRECISIONS = ("fp32", "bf16")
PRECISION_SEEDS = (42, 43)
PARITY_SEEDS = (0, 1, 2)
PARITY_EPOCHS = 200
DEMO_EPOCHS = (60, 400)       # Stage A, Stage B
# the presets whose late-epoch loss is held to the spread of more seeds
# than the precision runs' two, and those seeds (the presets' own is 42)
SEED_PRESETS = ("vanilla", "degree_aware")
EXTRA_SEEDS = (43, 44, 45)
NORTHSTAR_EPOCHS = 12
# a run's loss row: the mean loss of its last LOSS_WINDOW epochs (all of
# them when it has fewer)
LOSS_WINDOW = 50
PARTS = ("reference", "precision", "parity", "two_stage", "seeds",
         "northstar", "summary")
# the JAX record of the north star's quality: scaled_10m on the same
# synthetic graph, 12 epochs, full-catalogue TEST
NORTHSTAR_JAX = "scaled_10m_r3_metrics.jsonl"


def _free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _run(out: Path, name: str, fn, argv: list, dev) -> dict:
    """``fn(argv)`` with its output in ``out/logs/name.out``; returns what
    it returned."""
    (out / "logs").mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with open(out / "logs" / f"{name}.out", "w") as log, \
            contextlib.redirect_stdout(log):
        ret = fn(argv)
    wall = time.perf_counter() - t0
    _free(dev)
    r20 = None
    if isinstance(ret, dict) and "test" in ret:
        t = ret["test"]
        r20 = (t.get("20") or t.get(20) or {}).get("recall")
    print(f"[protocol] {name}: {wall:.1f}s, TEST R@20 {r20}", flush=True)
    return ret


def _regression(out: Path, name: str, metrics: Path, argv: list,
                dev) -> dict:
    return _run(out, name, reference_regression.main,
                argv + ["--metrics-jsonl", str(metrics), "--device",
                        str(dev)], dev)


def part_reference(out: Path, dev) -> None:
    for p in REFERENCE_PRESETS:
        _regression(out, f"{p}_ref_scale",
                    out / f"{p}_ref_scale_metrics.jsonl",
                    ["--preset", p, "--epochs", str(REFERENCE_EPOCHS),
                     "--scale", SCALE], dev)


def part_precision(out: Path, dev) -> None:
    d = out / "precision_compare"
    d.mkdir(parents=True, exist_ok=True)
    for prec in PRECISIONS:
        for seed in PRECISION_SEEDS:
            name = f"cu_message_{prec}_s{seed}"
            _regression(out, name, d / f"{name}.jsonl",
                        ["--preset", "cu_message", "--epochs",
                         str(REFERENCE_EPOCHS), "--scale", SCALE,
                         f"spmm_precision={prec}", f"seed={seed}"], dev)
    text = precision_compare.table(d)
    (out / "PRECISION.md").write_text(text + "\n")
    print(text, flush=True)


def part_parity(out: Path, dev) -> None:
    d = out / "parity"
    graph = d / "graph.npz"
    _run(out, "parity_build", parity_run.main,
         ["build", "--out", str(graph)], dev)
    for fast in (False, True):
        for config in (parity_run.FAST_CONFIGS if fast
                       else parity_run.CONFIG_MAP):
            for seed in PARITY_SEEDS:
                rec = "framework_fast.jsonl" if fast else "framework.jsonl"
                _run(out, f"parity_{config}_s{seed}" + ("_fast" if fast
                                                          else ""),
                     parity_run.main,
                     ["framework", "--graph", str(graph), "--config", config,
                      "--seed", str(seed), "--epochs", str(PARITY_EPOCHS),
                      "--eval-every", "2", "--out", str(d / rec),
                      "--device", str(dev)] + (["--fast"] if fast else []),
                     dev)
    _run(out, "parity_report", parity_run.main,
         ["report", "--dir", str(d), "--report-out",
          str(out / "QUALITY_PARITY.md")], dev)


def part_two_stage(out: Path, dev) -> None:
    d = out / "two_stage"
    _run(out, "two_stage_demo", two_stage_demo.main,
         ["--pad-deg", "128", "--out", str(d), "--device", str(dev),
          "--cred-epochs", str(DEMO_EPOCHS[0]),
          "--rec-epochs", str(DEMO_EPOCHS[1])], dev)
    # the same Stage B with every credibility 1: the demo's yardstick
    _regression(out, "two_stage_cred_eq322_ones",
                d / "cred_eq322_ones_metrics.jsonl",
                ["--preset", "cred_eq322", "--epochs", str(DEMO_EPOCHS[1]),
                 "--jsonl", str(d / "reviews.jsonl")], dev)


def part_seeds(out: Path, dev) -> None:
    (out / "seeds").mkdir(parents=True, exist_ok=True)
    for p in SEED_PRESETS:
        for seed in EXTRA_SEEDS:
            _regression(out, f"{p}_s{seed}", out / "seeds" /
                        f"{p}_s{seed}.jsonl",
                        ["--preset", p, "--epochs", str(REFERENCE_EPOCHS),
                         "--scale", SCALE, f"seed={seed}"], dev)


def part_northstar(out: Path, dev) -> None:
    _regression(out, "scaled_10m_large",
                out / "scaled_10m_large_metrics.jsonl",
                ["--preset", "scaled_10m", "--scale", "large", "--epochs",
                 str(NORTHSTAR_EPOCHS)], dev)


def _final(path: Path):
    """The last line (the run's final record) of a metrics JSONL, or None
    when the run is missing."""
    if not path.exists():
        return None
    return json.loads(path.read_text().splitlines()[-1])


def _last_val_recall(path: Path):
    """VAL Recall@20 of a metrics JSONL's last epoch (the model after the
    whole run, where TEST scores the best-on-val one), or None."""
    if not path.exists():
        return None
    epochs = [json.loads(ln) for ln in path.read_text().splitlines()[:-1]]
    return epochs[-1]["val"]["20"]["recall"]


def _mean_loss(path: Path):
    """The mean loss of a metrics JSONL's last LOSS_WINDOW epochs, or None
    when the run is missing."""
    if not path.exists():
        return None
    losses = [json.loads(ln)["loss"]
              for ln in path.read_text().splitlines()[:-1]]
    return statistics.fmean(losses[-LOSS_WINDOW:])


def _loss_rel_tol(pc: Path):
    """The loss rows' limit, relative to the JAX value: 2x the pooled
    relative std of the late-epoch mean loss over the port's two precision
    seeds (one pair a precision), or None while a run is missing."""
    var = []
    for prec in PRECISIONS:
        a, b = (_mean_loss(pc / f"cu_message_{prec}_s{s}.jsonl")
                for s in PRECISION_SEEDS)
        if a is None or b is None:
            return None
        var.append(((a - b) / ((a + b) / 2)) ** 2 / 2)
    return 2 * statistics.fmean(var) ** 0.5


def _verdict(port, jax, tol, digits: int = 4) -> str:
    """A row's cells from the JAX value on: PENDING while a side or the
    limit is missing."""
    if port is None or jax is None or tol is None:
        cells = ["missing" if v is None else f"{v:.{digits}f}"
                 for v in (jax, port)]
        return f"| {cells[0]} | {cells[1]} | | | PENDING |"
    return (f"| {jax:.{digits}f} | {port:.{digits}f} | "
            + parity_run.judged(port - jax, tol, digits))


def _loss_row(label: str, port: Path, jax: Path, rel) -> str:
    j = _mean_loss(jax)
    return (f"| {label} | mean loss, last {LOSS_WINDOW} epochs "
            + _verdict(_mean_loss(port), j,
                       None if rel is None else rel * abs(j), 6) + " |")


def _wall(rec) -> str:
    return "missing" if rec is None else f"{rec['wall_seconds']:.1f}"


def summary_lines(out: Path, jax_runs: Path) -> list:
    """``SUMMARY.md``: the port's records in ``out`` against the JAX
    package's in ``jax_runs``.  Sampled rows: tol = max(0.01, 1% of the
    JAX value), the group recalls 0.03; the north star (full catalogue):
    2% of the JAX value; loss rows: the JAX value times ``_loss_rel_tol``."""
    cards = sorted({r["card"] for r in
                    (_final(f) for f in sorted(out.rglob("*.jsonl")))
                    if r and r.get("card")})
    pc = out / "precision_compare"
    rel = _loss_rel_tol(pc)
    lines = ["# The port's reference-protocol runs against the JAX "
             "package's records", "",
             "Records of `python -m <port>.scripts.protocol` (this "
             "directory) against the JAX package's (`runs/`, TPU v5e).  "
             f"Card: {', '.join(cards) or 'none recorded'}.  Wall seconds "
             "are the port's fit on that card and the JAX run's on the "
             "TPU (context only, no target).", "",
             "Loss rows: the mean training loss of a run's last "
             f"{LOSS_WINDOW} epochs (all of them when it has fewer); tol = "
             "the JAX value times 2x the pooled relative std of that mean "
             "over the port's two precision seeds ("
             + ("missing" if rel is None else f"{rel:.6f}") + ").", "",
             "## The six reference runs (400 epochs, sampled 1+99 TEST)", "",
             "TEST scores the best-on-val parameters; the last epoch's VAL "
             "row holds the model after all 400 epochs.", "",
             "| preset | metric | JAX | port | diff | tol | verdict | "
             "wall s (port / JAX) |", "|---|---|---|---|---|---|---|---|"]
    ext = (("item_coverage", None), ("avg_self_information", None),
           ("high_cred_recall", 0.03), ("low_cred_recall", 0.03))
    for p in REFERENCE_PRESETS:
        name = f"{p}_ref_scale_metrics.jsonl"
        ours = _final(out / name)
        jax = _final(jax_runs / name)
        metrics = [("recall", None), ("ndcg", None)] + \
            (list(ext) if p == "pop_extended" else [])
        for m, fixed in metrics:
            j = jax["test"]["20"][m]
            o = None if ours is None else ours["test"]["20"][m]
            tol = fixed or max(0.01, 0.01 * abs(j))
            lines.append(f"| {p} | {m}@20 " + _verdict(o, j, tol)
                         + f" {_wall(ours)} / {_wall(jax)} |")
        j = _last_val_recall(jax_runs / name)
        lines.append(f"| {p} | last epoch's VAL recall@20 " + _verdict(
            _last_val_recall(out / name), j, max(0.01, 0.01 * j)) + " |")
        lines.append(_loss_row(p, out / name, jax_runs / name, rel))
    lines += ["", "## Precision (cu_message, 400 epochs)", "",
              "| run | metric | JAX | port | diff | tol | verdict | "
              "wall s (port / JAX) |", "|---|---|---|---|---|---|---|---|"]
    for prec in PRECISIONS:
        for seed in PRECISION_SEEDS:
            name = f"cu_message_{prec}_s{seed}"
            ours = _final(pc / f"{name}.jsonl")
            jax = _final(jax_runs / "precision_compare" / f"{name}.jsonl")
            o = None if ours is None else ours["test"]["20"]["recall"]
            lines.append(f"| {name} | recall@20 "
                         + _verdict(o, jax["test"]["20"]["recall"], 0.01)
                         + f" {_wall(ours)} / {_wall(jax)} |")
            lines.append(_loss_row(name, pc / f"{name}.jsonl", jax_runs /
                                   "precision_compare" / f"{name}.jsonl",
                                   rel))
    for seed in PRECISION_SEEDS:
        f32, b16 = (_final(pc / f"cu_message_{p}_s{seed}.jsonl")
                    for p in PRECISIONS)
        lines.append(
            f"| port bf16 (port column) vs port fp32 (JAX column), seed "
            f"{seed} | recall@20 "
            + _verdict(None if b16 is None else b16["test"]["20"]["recall"],
                       None if f32 is None else f32["test"]["20"]["recall"],
                       0.01) + " |")
    seeds = [(p, [_mean_loss(out / f"{p}_ref_scale_metrics.jsonl")]
              + [_mean_loss(out / "seeds" / f"{p}_s{s}.jsonl")
                 for s in EXTRA_SEEDS]) for p in SEED_PRESETS]
    if any(v is not None for _, vs in seeds for v in vs[1:]):
        lines += ["", f"## The late-epoch loss over seeds (400 epochs, "
                  f"seeds 42 and {', '.join(map(str, EXTRA_SEEDS))})", "",
                  f"| preset | port's mean loss, last {LOSS_WINDOW} epochs, "
                  "by seed | port min / max | port mean +/- std | JAX | JAX "
                  "inside the port's range | (JAX - port mean) / std |",
                  "|---|---|---|---|---|---|---|"]
        for p, vs in seeds:
            got = [v for v in vs if v is not None]
            j = _mean_loss(jax_runs / f"{p}_ref_scale_metrics.jsonl")
            mean = statistics.fmean(got)
            std = statistics.stdev(got) if len(got) > 1 else None
            lines.append(
                f"| {p} | " + ", ".join("missing" if v is None else
                                        f"{v:.6f}" for v in vs)
                + f" | {min(got):.6f} / {max(got):.6f} | {mean:.6f} +/- "
                + ("n/a" if std is None else f"{std:.6f}") + f" | {j:.6f} | "
                + ("yes" if min(got) <= j <= max(got) else "no") + " | "
                + ("n/a" if not std else f"{(j - mean) / std:+.2f}") + " |")
    report = out / "QUALITY_PARITY.md"
    if report.exists():
        verdicts = [ln.rstrip(" |").rsplit("|", 1)[-1].strip()
                    for ln in report.read_text().splitlines()
                    if ln.startswith("| ") and ln.rstrip().endswith(
                        ("PASS |", "FAIL |", "PENDING |"))]
        lines += ["", "## Parity matrix (`QUALITY_PARITY.md`)", "",
                  f"{len(verdicts)} rows: {verdicts.count('PASS')} PASS, "
                  f"{verdicts.count('FAIL')} FAIL, "
                  f"{verdicts.count('PENDING')} PENDING (the JAX report's "
                  "rule)."]
    demo = out / "two_stage" / "summary.json"
    if demo.exists():
        d = json.loads(demo.read_text())
        ones = _final(out / "two_stage" / "cred_eq322_ones_metrics.jsonl")
        auc = [h["holdout_auc"] for h in d["stage_a"]["history"]]
        r20 = d["test"]["20"]["recall"]
        one = None if ones is None else ones["test"]["20"]["recall"]
        lines += ["", "## Two-stage demo (`--pad-deg 128`)", "",
                  f"Stage A {len(auc)} epochs in "
                  f"{d['stage_a']['wall_seconds']:.1f} s, holdout AUC "
                  f"first {auc[0]:.4f}, last {auc[-1]:.4f}, max "
                  f"{max(auc):.4f}; Stage B (real credibility) TEST R@20 "
                  f"{r20:.4f} in {d['stage_b_wall_seconds']:.1f} s, against "
                  f"the all-ones cred_eq322 run on the same graph's "
                  f"{'missing' if one is None else f'{one:.4f}'}: "
                  + ("PENDING" if one is None else
                     "PASS (real credibility depresses Stage B)"
                     if r20 < one else "FAIL (not below all-ones)")]
    name = "scaled_10m_large_metrics.jsonl"
    ns = _final(out / name)
    jns = _final(jax_runs / NORTHSTAR_JAX)
    lines += ["", "## North star (`scaled_10m --scale large`, 12 epochs, "
              "full-catalogue TEST)", "",
              "| run | metric | JAX | port | diff | tol | verdict | "
              "wall s (port / JAX) |", "|---|---|---|---|---|---|---|---|"]
    for m in ("recall", "ndcg"):
        j = jns["test"]["20"][m]
        o = None if ns is None else ns["test"]["20"][m]
        lines.append(f"| scaled_10m | {m}@20 " + _verdict(o, j, 0.02 * j)
                     + f" {_wall(ns)} / {_wall(jns)} |")
    lines.append(_loss_row("scaled_10m", out / name, jax_runs / NORTHSTAR_JAX,
                           rel))
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parts", nargs="+", choices=PARTS)
    ap.add_argument("--out", default="runs/torch_h100")
    ap.add_argument("--jax-runs", default="runs",
                    help="the JAX package's records (summary)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the CPU)")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.parts == ["summary"]:
        text = "\n".join(summary_lines(out, Path(args.jax_runs))) + "\n"
        (out / "SUMMARY.md").write_text(text)
        print(text, end="")
        return
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))          # no fallback to the CPU
    print(f"[protocol] device: {dev} ({card_name(dev) or 'cpu'}); parts "
          f"{args.parts} -> {out}", flush=True)
    for part in args.parts:
        t0 = time.perf_counter()
        if part == "summary":
            (out / "SUMMARY.md").write_text("\n".join(
                summary_lines(out, Path(args.jax_runs))) + "\n")
            continue
        globals()[f"part_{part}"](out, dev)
        print(f"[protocol] part {part}: {time.perf_counter() - t0:.1f}s",
              flush=True)
    (out / "card.json").write_text(json.dumps({"card": card_name(dev),
                                               "torch": torch.__version__}))


if __name__ == "__main__":
    main()
