"""Run one cell of the benchmark once and print its result line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Set-up (the graph, the port's trainer, the tables from the seed, the first
steps or requests, the warm-up) counts as ``setup_s``, from the start of
this module to the window's first timed unit.  ``--trace 0`` measures the
cell's end-to-end metrics over a window of ``--seconds``; ``--trace 1``
reads its per-layer metrics from a short traced window and the benchmark's
spans.  Either way the port's state is then freed and what it produced is
judged against the plain reference: every number compared is printed
beside its limit, on standard error and last in the result line.  Without a
CUDA card, or with fewer cards than the cell asks for, or with JAX or the
JAX package loaded, the run prints no result and exits with 2 or 3.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from . import registry  # noqa: E402
from .drivers import Run  # noqa: E402
from .imports import forbidden_loaded  # noqa: E402
from .tracing import Spans  # noqa: E402
from .window import readings  # noqa: E402


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(cell: registry.Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float = None) -> dict:
    """One run of ``cell``: its result line as a dict.  Off the card no
    metric is written: a time there is no device's.  The window's readings
    are reported under the names the traffic file's ``end_to_end`` maps
    them to."""
    t0 = time.perf_counter() if t0 is None else t0
    on_card = device.type == "cuda"
    spans = Spans()
    run = Run(cell, seed, device, spans)
    drv = registry.driver(run.kind, cell.here)(run)
    drv.start(seed)
    drv.warm()
    run.sync()
    # what set-up made lives for the whole run: the collector skips it
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0
    log(f"[bench] {cell.name} seed {seed}: set-up {setup_s:.3f} s "
        f"(graph {sum(spans.seconds['setup.graph_s']):.3f} s, trainer "
        f"{sum(spans.seconds['setup.trainer_s']):.3f} s)")
    win = None
    if trace:
        drv.trace()
        attempted = int(sum(run.counts.get(k, 0) for k in
                            ("epochs", "evaluations", "requests")))
    else:
        win = drv.window(seconds)
        attempted = win.units
        lat = sorted(win.latencies)
        log(f"[bench] window {win.elapsed:.3f} s, {win.units} units, "
            f"work {win.work:.0f}, unit s min {lat[0]:.4f} median "
            f"{lat[len(lat) // 2]:.4f} max {lat[-1]:.4f}")
    device_rec = {"platform": "gpu" if on_card else device.type,
                  "kind": (torch.cuda.get_device_name(device) if on_card
                           else "cpu"),
                  "count": 1 if on_card else 0,
                  "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                        if on_card else 0)}
    answer = drv.answer
    drv.release()
    if on_card:
        torch.cuda.empty_cache()
    checks = drv.judge(answer)
    limits = cell.traffic["limits"]
    correct = all(math.isfinite(v) and v <= limits[k]
                  for k, v in checks.items()) and drv.failed == 0
    metrics = {}
    if on_card and not trace:
        got = readings(win)
        e2e = {"setup_s": setup_s,
               **{name: got[what] for name, what
                  in cell.traffic["end_to_end"].items()}}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    elif on_card:
        metrics = registry.read_metrics(cell.per_layer, run, cell.here)
        # busy and idle from the last window even where it lost a record
        if run.last_trace is not None:
            device_rec["busy_s"] = run.last_trace.busy_s()
            device_rec["window_s"] = run.last_trace.window_s
        log(f"[bench] traced {run.timed['trace_tries']} window(s), "
            f"{'complete' if run.trace else 'none complete'}")
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": int(drv.failed), "metrics": metrics,
           "device": device_rec}
    if trace and on_card and run.last_trace is not None:
        out["breakdown"] = {"device_ops": run.last_trace.device_ops(),
                            "idle_gaps": run.last_trace.idle_gaps()}
    out["checks"] = {k: {"value": v if math.isfinite(v) else str(v),
                         "limit": limits[k]} for k, v in checks.items()}
    gc.unfreeze()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("[bench] no CUDA card: nothing measured")
        return 2
    cell = registry.find_cell(args.workload)
    if torch.cuda.device_count() < int(cell.spec["chips"]):
        log(f"[bench] {args.workload} needs {cell.spec['chips']} cards, "
            f"{torch.cuda.device_count()} present")
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), T0)
    bad = forbidden_loaded()
    if bad:
        log(f"[bench] loaded in this process: {', '.join(bad)}")
        return 3
    for k, c in out["checks"].items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
