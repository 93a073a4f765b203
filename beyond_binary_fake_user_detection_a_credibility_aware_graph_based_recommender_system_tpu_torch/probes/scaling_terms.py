"""Probe: the single-card terms of the scaling projection, at the north star.

The port of the JAX package's ``scripts/probe_scaling_terms.py``.  On the
``scaled_10m`` preset (D=128, K=4, batch 8,192, per_epoch) over the
planted 10M-edge graph (``bench.northstar_graph``: 500,000 users,
1,000,000 items, 6,899,612 train edges) it times

  propagate_s     one K-layer propagate under ``no_grad`` (the per_epoch
                  cache's);
  epoch_s         one training epoch as ``fit`` runs it: ``draw_epoch``
                  then ``run_epoch`` (the cache's propagate and the 62
                  steps), the parameters, Adam moments and generator
                  carried from one epoch to the next;
  scan_steps_s    epoch_s - propagate_s, floored at 0;
  eval_epoch_s    one full-catalogue evaluation on val under the preset's
                  flags (bf16 tables, fp32 scores): the second call;
  fixed_s         0 (the host's share is inside epoch_s, as in JAX's).

Each loop runs one call first and waits for the card before its timed
window opens (``utils/profiling.time_fn``): an unfenced warm call leaks its
tail into the window (JAX's own record of that bias: 0.58 s against the
true 0.40 s propagate).  The window is the host clock around a
``torch.cuda.synchronize``.  ``--spmm-precision`` overrides the preset's
message precision for an A/B of the terms; ``config`` names the precision
the terms were measured under, in the JAX record's form, and
``scripts/scaling_projection.py`` refuses terms of another precision than
the preset ships, and terms no CUDA card measured.

    python -m <package>.probes.scaling_terms [--spmm-precision
        preset|fp32|bf16] [--iters 3] [--out FILE] [--device cuda|cpu]

Writes ``--out`` (default ``runs/torch_h100/scaling_terms.json``): JAX's
keys plus ``card`` (``nvidia-smi`` name and power limit), ``iters`` and
``clock``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from ..utils.device import card_name, resolve_device
from ..utils.profiling import time_fn

PRECISIONS = ("preset", "fp32", "bf16")


def config_label(cfg) -> str:
    """The terms' ``config`` exactly as the JAX probe forms it (from the
    trainer's actual configuration)."""
    return (f"scaled_10m(planted 10M, {cfg.spmm_precision} messages, "
            f"{cfg.propagation_schedule})")


def measure(tr, iters: int = 3) -> dict:
    """The terms of the north-star trainer ``tr`` (a
    ``bench.northstar_trainer``): ``iters`` timed calls a loop after one
    untimed one; the evaluation's second call."""
    dev = tr.device
    params, opt_state, gen = tr.init_state()
    with torch.no_grad():
        t_prop = time_fn(tr.model.propagate, params, iters=iters, warmup=1)
    print(f"propagate_s={t_prop:.4f}", file=sys.stderr)
    # run_epoch updates params and moments in place and draw_epoch advances
    # the generator: the state is carried from one epoch to the next
    t_epoch = time_fn(lambda: tr.run_epoch(params, opt_state,
                                           tr.draw_epoch(gen)),
                      iters=iters, warmup=1)
    print(f"epoch_s={t_epoch:.4f}", file=sys.stderr)
    t_eval = None
    for _ in range(2):                          # the first call is the warm
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        tr.evaluate(params, "val")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_eval = time.perf_counter() - t0
    print(f"eval_epoch_s={t_eval:.4f}", file=sys.stderr)
    return {"propagate_s": t_prop, "epoch_s": t_epoch,
            "scan_steps_s": max(t_epoch - t_prop, 0.0),
            "eval_epoch_s": t_eval, "fixed_s": 0.0, "device": str(dev),
            "config": config_label(tr.cfg), "card": card_name(dev),
            "iters": iters,
            "clock": ("host clock around torch.cuda.synchronize"
                      if dev.type == "cuda" else "host clock, cpu")}


def main(argv=None, graph=None, trainer=None) -> dict:
    """``graph``: the planted graph when the caller has built it (default
    ``bench.northstar_graph()``); ``trainer``: a ``northstar_trainer`` of
    the asked precision already built on it."""
    from ..bench import northstar_graph, northstar_trainer
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--spmm-precision", default="preset", choices=PRECISIONS,
                    help="override the preset's message precision (an A/B "
                         "of the terms)")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--out", default="runs/torch_h100/scaling_terms.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the CPU)")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))          # no fallback to the CPU
    overrides = ({} if args.spmm_precision == "preset"
                 else {"spmm_precision": args.spmm_precision})
    if trainer is None:
        graph = graph if graph is not None else northstar_graph()
        print(f"graph: {graph.summary()}", file=sys.stderr)
        trainer = northstar_trainer(graph, dev, **overrides)
    elif overrides and trainer.cfg.spmm_precision != args.spmm_precision:
        raise ValueError(f"the trainer's messages are "
                         f"{trainer.cfg.spmm_precision}, not "
                         f"{args.spmm_precision}")
    print(f"device: {trainer.device} ({card_name(trainer.device) or 'cpu'})",
          file=sys.stderr)
    out = measure(trainer, args.iters)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=2))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
