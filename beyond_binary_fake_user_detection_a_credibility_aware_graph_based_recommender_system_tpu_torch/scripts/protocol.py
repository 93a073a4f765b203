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
  seeds_parity  F7's seed spread on the parity harness's graph: ``parity_run
              framework --verbose`` for SPREAD_PRESETS at SPREAD_SEEDS, 400
              epochs, each log in ``<out>/seeds/port_<card|cpu>/`` (the
              JAX package's, made with its own ``scripts/parity_run.py``
              on a CPU, are ``runs/torch_h100/seeds/jax_cpu/``);
  f10_replay  F10's paired replay on the parity harness's graph: for
              REPLAY_SEEDS, the port trains SPREAD_EPOCHS epochs from the
              JAX trainer's own initial parameters and on its own epoch
              draws (``scripts/jax_streams.py``: JAX's threefry streams in
              numpy), no evaluation, one ``Epoch NN | loss=...`` line an
              epoch in ``<out>/f10/replay_<card|cpu>/<preset>_s<seed>.out``,
              the same seeds' JAX logs (SPREAD_JAX) being the other side;
  f10_seeds   degree_aware at F10_SEEDS, each seed twice: the port on its
              own streams (as ``seeds_parity``) in
              ``<out>/f10/port_<card|cpu>/`` and the replay of JAX's
              streams in ``<out>/f10/replay_<card|cpu>/``;
  f10_mixed   for each of F10_ARMS, degree_aware at all of F10's seeds with
              that part of the stream from the port's own generator and the
              rest JAX's: ``<out>/f10/mixed_<arm>_<card|cpu>/``;
  f10_fresh   F10's decision on F10_FRESH_SEEDS (fixed before any run),
              three arms a seed: ``own`` (``parity_run framework``, the
              port's own streams) in ``<out>/f10/port_<card|cpu>/``,
              ``jax`` (the replay of JAX's streams) in ``replay_<...>/``
              and ``twogen`` (the replay on the port's streams with the
              epochs from a second generator seeded seed +
              F10_EPOCH_SEED_OFFSET) in ``twogen_<...>/``;
  cred_parity ``cred_parity_run build``, ``framework`` in both modes (60
              epochs), ``downstream`` (120 epochs) and ``report`` against
              the committed oracle vector: ``<out>/cred_parity/``;
  cred_seeds  ``framework`` in both modes at CRED_SEEDS on that
              heterograph: ``<out>/cred_parity/seeds/s<seed>/``;
  eval_equiv  ``eval_equiv_r4 train`` in each mode (12 epochs on the planted
              10M graph), ``overlap`` and ``report``:
              ``<out>/eval_equiv_r4/`` (the parameters are removed after);
  schedule    ``schedule_compare`` (12 epochs, both schedules) on the same
              graph: ``<out>/schedule_compare.json``;
  ingest      ``ingest_bench`` (10M lines): ``<out>/ingest_bench.json``;
  sharding    ``sharding_report`` on ``bench.build_graph("large")``:
              ``<out>/sharding_report.json``;
  eval_breakdown  ``probes/eval_breakdown`` on the same graph:
              ``<out>/eval_breakdown.json``;
  scaling_terms  ``probes/scaling_terms`` on the planted 10M graph at the
              preset's precision, then with ``--spmm-precision fp32`` and
              ``bf16``: ``<out>/scaling_terms.json``,
              ``scaling_terms_fp32.json``, ``scaling_terms_bf16.json``
              (the preset's messages are fp32: its trainer serves both);
  sampling_costs  ``probes/sampling_costs`` at its defaults:
              ``<out>/sampling_costs.json``;
  scaling_projection  ``scripts/scaling_projection`` on
              ``<out>/scaling_terms.json`` with its P=4 check against
              ``<out>/sharding_report.json``:
              ``<out>/scaling_projection.json`` (a projection: host
              planning and stated bandwidths);
  summary     reads those records and the JAX package's (``--jax-runs``)
              and writes ``<out>/SUMMARY.md``: each run's quality and
              late-epoch loss beside the JAX record's, with its tolerance
              and verdict, and its wall time with the card (no device
              needed).

Each run's log goes to ``<out>/logs/<run>.out``; one line a run is printed
with its wall seconds and TEST Recall@20.

    python -m <package>.scripts.protocol reference precision parity \\
        two_stage seeds northstar seeds_parity cred_parity cred_seeds \\
        eval_equiv schedule ingest sharding eval_breakdown scaling_terms \\
        sampling_costs scaling_projection summary \\
        --out runs/torch_h100 [--device cuda|cpu]

``--only PRESET:SEED`` (repeatable) limits the ``f10_`` parts to those
runs (the CPU's replay of degree_aware at seed 42: ``f10_replay --device
cpu --only degree_aware:42``).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import re
import shutil
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from . import (cred_parity_run, eval_equiv_r4, ingest_bench, jax_streams,
               parity_run, precision_compare, reference_regression,
               scaling_projection, schedule_compare, sharding_report,
               two_stage_demo)
from ..probes import eval_breakdown, sampling_costs, scaling_terms
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
SEED_PRESETS = ("vanilla", "cu_message", "degree_aware")
EXTRA_SEEDS = (43, 44, 45)
NORTHSTAR_EPOCHS = 12
# a run's loss row: the mean loss of its last LOSS_WINDOW epochs (all of
# them when it has fewer)
LOSS_WINDOW = 50
# F7's seed spread on the parity harness's graph (both sides' own seeds);
# degree_aware's at eight seeds a side (F10)
SPREAD_PRESETS = ("vanilla", "degree_aware")
SPREAD_SEEDS = (42, 43, 44, 45)
SPREAD_SEEDS_BY_PRESET = {"degree_aware": tuple(range(42, 50))}
SPREAD_EPOCHS = 400
# the committed Stage-A oracle vector and the JAX framework's CPU vectors
CRED_ORACLE = "runs/torch_h100/cred_parity/cred_oracle.npy"
CRED_JAX_CPU = "runs/torch_h100/cred_parity/jax_cpu"
# Stage A's seed spread (the oracle's and the main run's seed is 42; F9)
CRED_SEEDS = tuple(range(43, 54))
# the JAX package's side of the seed spread: its scripts/parity_run.py
# framework --verbose on a CPU, one log a preset and seed
SPREAD_JAX = "runs/torch_h100/seeds/jax_cpu"
# ... and at reference scale (reference_regression on a CPU, EXTRA_SEEDS:
# with the JAX record of the preset's own seed, JAX's seed spread there)
SPREAD_JAX_REF = "runs/torch_h100/seeds/jax_cpu/ref_scale"
SPREAD_MIN = 3                 # seeds that make a spread
# F10's paired replay: the seeds whose JAX logs are committed (SPREAD_JAX),
# each replayed on the JAX trainer's own streams
REPLAY_SEEDS = {"degree_aware": tuple(range(42, 50)),
                "vanilla": SPREAD_SEEDS}
# a replay's last-LOSS_WINDOW mean within this share of JAX's
REPLAY_REL_TOL = 1e-4
# an epoch's |replay - JAX| past the logs' 6-decimal rounding
LOG_RTOL, LOG_ATOL = 2e-6, 5e-7
# F10's further seeds, fixed before any run: the port's own streams against
# the replay of JAX's, with SPREAD_SEEDS_BY_PRESET's eight: n = 32 a side
F10_PRESET = "degree_aware"
F10_SEEDS = tuple(range(50, 74))
# F10's bisection: each arm takes parts of the stream from the port's own
# generator and the rest from JAX's, at all 32 seeds
F10_ARMS = ("init", "perm", "samples", "perm+samples")
# F10's decision, fixed before any run: 64 seeds never used before, three
# arms a seed (the directory of each arm's logs under <out>/f10/); the
# twogen arm draws its epochs from a second generator seeded seed + the
# offset (10,074-10,137 meet no seed used so far, the evaluation's seed +
# 999 included); two means differ when apart by more than F10_SE_LIMIT
# pooled SE (2 sqrt(s_a^2 / n_a + s_b^2 / n_b)); the seed spreads' F test
# opens F11 below F10_SPREAD_P
F10_FRESH_SEEDS = tuple(range(74, 138))
F10_ARM_DIRS = {"own": "port", "jax": "replay", "twogen": "twogen"}
F10_FRESH_ARMS = tuple(F10_ARM_DIRS)
F10_EPOCH_SEED_OFFSET = 10_000
F10_SE_LIMIT = 2.0
F10_SPREAD_P = 0.01
R20_TOL = 0.002                # a 10M run's TEST R@20 against JAX's
INGEST_LINES = 10_000_000      # the ingest bench's stream (the JAX record's)
PARTS = ("reference", "precision", "parity", "two_stage", "seeds",
         "northstar", "seeds_parity", "f10_replay", "f10_seeds",
         "f10_mixed", "f10_fresh",
         "cred_parity", "cred_seeds",
         "eval_equiv", "schedule", "ingest", "sharding", "eval_breakdown",
         "scaling_terms", "sampling_costs", "scaling_projection", "summary")
# the JAX record of the north star's quality: scaled_10m on the same
# synthetic graph, 12 epochs, full-catalogue TEST
NORTHSTAR_JAX = "scaled_10m_r3_metrics.jsonl"


def _free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _run(out: Path, name: str, fn, argv: list, dev,
         log_path: Path = None) -> dict:
    """``fn(argv)`` with its output in ``log_path`` (default
    ``out/logs/name.out``); returns what it returned."""
    log_path = log_path or out / "logs" / f"{name}.out"
    log_path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with open(log_path, "w") as log, contextlib.redirect_stdout(log):
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


def _side(dev) -> str:
    return "h100" if dev.type == "cuda" else dev.type


def part_seeds_parity(out: Path, dev) -> None:
    d = out / "seeds"
    graph = d / "parity_graph.npz"
    _run(out, "seeds_parity_build", parity_run.main,
         ["build", "--out", str(graph)], dev)
    side = d / f"port_{_side(dev)}"
    for p in SPREAD_PRESETS:
        for seed in spread_seeds(p):
            _run(out, f"seeds_parity_{p}_s{seed}", parity_run.main,
                 ["framework", "--graph", str(graph), "--config", p,
                  "--seed", str(seed), "--epochs", str(SPREAD_EPOCHS),
                  "--eval-every", "2", "--verbose", "--device", str(dev),
                  "--out", str(side / "framework.jsonl")], dev,
                 log_path=side / f"{p}_s{seed}.out")


def _f10_graph(out: Path, dev) -> Path:
    """The parity harness's graph for F10's parts (built once)."""
    graph = out / "f10" / "parity_graph.npz"
    if not graph.exists():
        _run(out, "f10_build", parity_run.main,
             ["build", "--out", str(graph)], dev)
    return graph


def _wanted(preset: str, seed: int, only) -> bool:
    return not only or f"{preset}:{seed}" in only


PORT_STREAMS = ("init", "perm", "samples")


def replay_streams(tr, seed: int, port_streams=(), epoch_seed=None):
    """``replay``'s streams for the trainer ``tr`` at ``seed``:
    ``(params, key, draw)``, the initial tables and ``draw(key) ->
    (batches, key)``, one epoch's ``(users, pos, neg, mask)`` (numpy,
    ``(nb, batch_size)``) a call and the JAX key after it.  A part of
    PORT_STREAMS in ``port_streams`` comes from the port's own stream, a
    ``torch.Generator`` on the trainer's device seeded ``seed`` and drawn
    in ``fit``'s order (the initial tables, then each epoch's
    permutation, positives and negatives); the others from the JAX
    trainer's (``scripts/jax_streams.py``).  ``epoch_seed`` draws the
    port's epoch parts from a second generator seeded ``epoch_seed``
    instead (the initial tables stay the first one's)."""
    from ..models.lightgcn import init_params, params_from_jax
    from ..ops.sampling import PopMixSampler

    unknown = set(port_streams) - set(PORT_STREAMS)
    if unknown:
        raise ValueError(f"unknown streams {sorted(unknown)}")
    ours = set(port_streams)
    if epoch_seed is not None and not {"perm", "samples"} & ours:
        raise ValueError("epoch_seed needs the port's perm or samples")
    cfg, graph, dev = tr.cfg, tr.graph, tr.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    init, key = jax_streams.init_state(seed, cfg, graph.num_users,
                                       graph.num_items)
    if "init" in ours:
        params = init_params(gen, cfg, graph.num_users, graph.num_items)
    else:
        params = params_from_jax(init, dev)
    if epoch_seed is not None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(epoch_seed)
    csr = graph.user_csr("train")
    popmix = None
    if cfg.negative_sampler == "popmix":
        popmix = PopMixSampler.build(graph.train_item_degrees(), "cpu",
                                     mix_pop=cfg.neg_mix_pop,
                                     gamma=cfg.neg_pop_gamma)
    B, n = cfg.batch_size, tr.train_users.size
    nb = -(-n // B)

    def draw(key):
        if not {"perm", "samples"} & ours:
            return jax_streams.epoch_draws(key, tr.train_users, csr, cfg,
                                           graph.num_items, popmix)
        if {"perm", "samples"} <= ours:
            return tuple(b.cpu().numpy() for b in tr.draw_epoch(gen)), key
        kperm, ksamp, key = jax_streams.split(key, 3)
        if "perm" in ours:
            perm = tr.train_users[torch.randperm(
                n, generator=gen, device=dev).cpu().numpy()]
        else:
            perm = jax_streams.permutation(kperm,
                                           tr.train_users.astype(np.int32))
        users = np.concatenate([perm, np.zeros(nb * B - n, perm.dtype)])
        if "samples" in ours:
            pos, neg = (x.cpu().numpy() for x in tr._sample_epoch(
                gen, torch.as_tensor(users, dtype=torch.int64, device=dev)))
        else:
            pos, neg = jax_streams.epoch_samples(ksamp, users, csr, cfg,
                                                 graph.num_items, popmix)
        mask = np.arange(nb * B) < n
        return tuple(np.asarray(x, np.int64).reshape(nb, B)
                     for x in (users, pos, neg)) + (mask.reshape(nb, B),), key

    return params, key, draw


def replay(graph_path: Path, preset: str, seed: int, epochs: int, dev,
           log_path: Path, port_streams=(), epoch_seed=None) -> float:
    """``epochs`` epochs of ``parity_run framework``'s configuration of
    ``preset`` on the JAX trainer's streams at ``seed``: its initial
    parameters and every epoch's draws from ``scripts/jax_streams.py``,
    trained by ``RecTrainer.run_epoch`` on ``dev``; one ``Epoch NN |
    loss=...`` line an epoch, as ``fit`` logs it.  No evaluation: it does
    not touch the training loss.  ``port_streams`` and ``epoch_seed`` take
    parts from the port's own streams (``replay_streams``); with all three
    parts and no ``epoch_seed`` it is ``fit``'s own stream.  Returns the
    wall seconds."""
    from ..ops.adam import adam_init
    from ..train.trainer import RecTrainer

    graph = parity_run.load_graph(graph_path)
    cfg = parity_run.framework_config(preset, epochs, 2, seed)
    cred = None
    if preset in parity_run.REAL_CRED:
        cred = np.load(Path(graph_path).parent / "cred.npy").astype(
            np.float32)
    t0 = time.perf_counter()
    tr = RecTrainer(cfg, graph, cred=cred, device=dev, verbose=False)
    params, key, draw = replay_streams(tr, seed, port_streams, epoch_seed)
    opt = adam_init(params)
    what = ("the JAX trainer's init and draws (scripts/jax_streams.py)"
            if not port_streams else "the port's own " + ", ".join(
                s for s in PORT_STREAMS if s in port_streams)
            + ", the JAX trainer's " + (", ".join(
                s for s in PORT_STREAMS if s not in port_streams) or
                "nothing"))
    if epoch_seed is not None:
        what += f"; the epochs from a second generator seeded {epoch_seed}"
    log_path.parent.mkdir(parents=True, exist_ok=True)
    with open(log_path, "w") as log:
        print(f"[replay] {preset} seed {seed}: {what}, {epochs} epochs on "
              f"{card_name(dev) or dev.type}", file=log)
        batches, key = draw(key)
        for epoch in range(1, epochs + 1):
            losses = tr.run_epoch(params, opt, tuple(
                torch.as_tensor(b, device=dev) for b in batches))
            if epoch < epochs:
                batches, key = draw(key)
            print(f"Epoch {epoch:02d} | loss={float(losses.mean()):.6f}",
                  file=log, flush=True)
        wall = time.perf_counter() - t0
        print(f"[replay] wall {wall:.1f}s", file=log)
    _free(dev)
    print(f"[protocol] replay {preset} s{seed}"
          + (f" ({'+'.join(port_streams)} the port's)" if port_streams
             else "")
          + (f" (epochs seeded {epoch_seed})" if epoch_seed is not None
             else "") + f": {wall:.1f}s", flush=True)
    return wall


def part_f10_replay(out: Path, dev, only=()) -> None:
    graph = _f10_graph(out, dev)
    side = out / "f10" / f"replay_{_side(dev)}"
    for p, seeds in REPLAY_SEEDS.items():
        for seed in seeds:
            if _wanted(p, seed, only):
                replay(graph, p, seed, SPREAD_EPOCHS, dev,
                       side / f"{p}_s{seed}.out")


def part_f10_seeds(out: Path, dev, only=()) -> None:
    graph = _f10_graph(out, dev)
    d = out / "f10"
    port = d / f"port_{_side(dev)}"
    for seed in F10_SEEDS:
        if not _wanted(F10_PRESET, seed, only):
            continue
        _run(out, f"f10_seeds_{F10_PRESET}_s{seed}", parity_run.main,
             ["framework", "--graph", str(graph), "--config", F10_PRESET,
              "--seed", str(seed), "--epochs", str(SPREAD_EPOCHS),
              "--eval-every", "2", "--verbose", "--device", str(dev),
              "--out", str(port / "framework.jsonl")], dev,
             log_path=port / f"{F10_PRESET}_s{seed}.out")
        replay(graph, F10_PRESET, seed, SPREAD_EPOCHS, dev,
               d / f"replay_{_side(dev)}" / f"{F10_PRESET}_s{seed}.out")


def part_f10_mixed(out: Path, dev, only=()) -> None:
    graph = _f10_graph(out, dev)
    for arm in F10_ARMS:
        d = out / "f10" / f"mixed_{arm}_{_side(dev)}"
        for seed in spread_seeds(F10_PRESET) + F10_SEEDS:
            if _wanted(F10_PRESET, seed, only):
                replay(graph, F10_PRESET, seed, SPREAD_EPOCHS, dev,
                       d / f"{F10_PRESET}_s{seed}.out",
                       port_streams=tuple(arm.split("+")))


def _f10_log(out: Path, arm: str, dev, seed: int) -> Path:
    return (out / "f10" / f"{F10_ARM_DIRS[arm]}_{_side(dev)}"
            / f"{F10_PRESET}_s{seed}.out")


def part_f10_fresh(out: Path, dev, only=()) -> None:
    graph = _f10_graph(out, dev)
    for seed in F10_FRESH_SEEDS:
        if not _wanted(F10_PRESET, seed, only):
            continue
        log = _f10_log(out, "own", dev, seed)
        argv = ["framework", "--graph", str(graph), "--config", F10_PRESET,
                "--seed", str(seed), "--epochs", str(SPREAD_EPOCHS),
                "--eval-every", "2", "--verbose", "--device", str(dev),
                "--out", str(log.parent / "framework.jsonl")]
        header = (f"[f10_fresh] own: parity_run {' '.join(argv[:11])} on "
                  f"{card_name(dev) or dev.type}")

        def own(argv):
            print(header)
            return parity_run.main(argv)

        _run(out, f"f10_fresh_own_s{seed}", own, argv, dev, log_path=log)
        replay(graph, F10_PRESET, seed, SPREAD_EPOCHS, dev,
               _f10_log(out, "jax", dev, seed))
        replay(graph, F10_PRESET, seed, SPREAD_EPOCHS, dev,
               _f10_log(out, "twogen", dev, seed), port_streams=PORT_STREAMS,
               epoch_seed=seed + F10_EPOCH_SEED_OFFSET)


def part_cred_parity(out: Path, dev) -> None:
    d = str(out / "cred_parity")
    run = cred_parity_run.main
    _run(out, "cred_parity_build", run, ["build", "--dir", d], dev)
    for mode in cred_parity_run.MODES:
        _run(out, f"cred_parity_{mode}", run,
             ["framework", "--mode", mode, "--dir", d, "--epochs",
              str(cred_parity_run.EPOCHS_A), "--device", str(dev)], dev)
    _run(out, "cred_parity_downstream", run,
         ["downstream", "--dir", d, "--oracle", CRED_ORACLE, "--epochs",
          str(cred_parity_run.EPOCHS_B), "--device", str(dev)], dev)
    _run(out, "cred_parity_report", run,
         ["report", "--dir", d, "--oracle", CRED_ORACLE, "--jax-cpu",
          CRED_JAX_CPU], dev)


def part_cred_seeds(out: Path, dev) -> None:
    """Both Stage-A modes at CRED_SEEDS on ``cred_parity``'s heterograph
    (built here when that part has not run): the seed spread of the
    verdict's percentiles."""
    base = out / "cred_parity"
    if not (base / "hg.npz").exists():
        _run(out, "cred_parity_build", cred_parity_run.main,
             ["build", "--dir", str(base)], dev)
    for seed in CRED_SEEDS:
        d = base / "seeds" / f"s{seed}"
        d.mkdir(parents=True, exist_ok=True)
        for f in ("hg.npz", "latent_q.npy"):
            shutil.copy(base / f, d / f)
        for mode in cred_parity_run.MODES:
            _run(out, f"cred_seeds_{mode}_s{seed}", cred_parity_run.main,
                 ["framework", "--mode", mode, "--seed", str(seed), "--dir",
                  str(d), "--device", str(dev)], dev)


# the graphs the 10M parts share, built once a process
_GRAPHS = {}


def _graph(name: str):
    if name not in _GRAPHS:
        from ..bench import build_graph
        _GRAPHS[name] = (eval_equiv_r4.build_graph() if name == "planted"
                         else build_graph(name))
    return _GRAPHS[name]


def part_eval_equiv(out: Path, dev) -> None:
    d = out / "eval_equiv_r4"
    g = _graph("planted")

    def run(argv):
        return eval_equiv_r4.main(argv, graph=g)
    for mode in eval_equiv_r4.MODES:
        _run(out, f"eval_equiv_{mode}", run,
             ["train", "--mode", mode, "--dir", str(d), "--device",
              str(dev)], dev)
    _run(out, "eval_equiv_overlap", run,
         ["overlap", "--dir", str(d), "--device", str(dev)], dev)
    _run(out, "eval_equiv_report", run, ["report", "--dir", str(d)], dev)
    for p in d.glob("params_*.npz"):
        p.unlink()                    # 768 MB each: not a record


def part_schedule(out: Path, dev) -> None:
    g = _graph("planted")
    _run(out, "schedule_compare",
         lambda argv: schedule_compare.main(argv, graph=g),
         ["--out", str(out / "schedule_compare.json"), "--device",
          str(dev)], dev)


def part_ingest(out: Path, dev) -> None:
    _run(out, "ingest_bench", ingest_bench.main,
         ["--lines", str(INGEST_LINES), "--out",
          str(out / "ingest_bench.json"), "--device", str(dev)], dev)


def part_sharding(out: Path, dev) -> None:
    g = _graph("large")
    _run(out, "sharding_report",
         lambda argv: sharding_report.main(argv, graph=g),
         ["--out", str(out / "sharding_report.json"), "--device", str(dev)],
         dev)


def part_eval_breakdown(out: Path, dev) -> None:
    g = _graph("large")
    _run(out, "eval_breakdown",
         lambda argv: eval_breakdown.main(argv, graph=g),
         ["--out", str(out / "eval_breakdown.json"), "--device", str(dev)],
         dev)


def part_scaling_terms(out: Path, dev) -> None:
    from ..bench import northstar_trainer
    g = _graph("planted")
    tr = northstar_trainer(g, dev)
    for prec in scaling_terms.PRECISIONS:
        name = ("scaling_terms.json" if prec == "preset"
                else f"scaling_terms_{prec}.json")
        # the preset's own messages share its trainer; another precision
        # builds one
        kw = ({"trainer": tr} if prec in ("preset", tr.cfg.spmm_precision)
              else {"graph": g})
        _run(out, f"scaling_terms_{prec}",
             lambda argv, kw=kw: scaling_terms.main(argv, **kw),
             ["--spmm-precision", prec, "--out", str(out / name),
              "--device", str(dev)], dev)


def part_sampling_costs(out: Path, dev) -> None:
    _run(out, "sampling_costs", sampling_costs.main,
         ["--out", str(out / "sampling_costs.json"), "--device", str(dev)],
         dev)


def part_scaling_projection(out: Path, dev) -> None:
    g, large = _graph("planted"), _graph("large")
    _run(out, "scaling_projection",
         lambda argv: scaling_projection.main(argv, graph=g,
                                              report_graph=large),
         ["--terms", str(out / "scaling_terms.json"), "--sharding-report",
          str(out / "sharding_report.json"), "--out",
          str(out / "scaling_projection.json"), "--device", str(dev)], dev)


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


def _rel_std(values):
    """The relative std of late-epoch mean losses, or None with fewer than
    SPREAD_MIN of them."""
    got = [v for v in values if v is not None]
    if len(got) < SPREAD_MIN:
        return None
    return statistics.stdev(got) / statistics.fmean(got)


def _loss_rel_tol(pc: Path, s_port=None, s_jax=None):
    """A loss row's limit, relative to the JAX value.  Where both sides'
    relative seed std of the late-epoch mean loss is measured: 2x the std
    of the difference of two runs on independent random streams,
    2 * sqrt(s_port^2 + s_jax^2).  Else 2x the pooled relative std over
    the port's two precision seeds (one pair a precision), or None while a
    precision run is missing."""
    if s_port is not None and s_jax is not None:
        return 2 * (s_port ** 2 + s_jax ** 2) ** 0.5
    var = []
    for prec in PRECISIONS:
        a, b = (_mean_loss(pc / f"cu_message_{prec}_s{s}.jsonl")
                for s in PRECISION_SEEDS)
        if a is None or b is None:
            return None
        var.append(((a - b) / ((a + b) / 2)) ** 2 / 2)
    return 2 * statistics.fmean(var) ** 0.5


def _seed_spread(out: Path, jax_runs: Path, preset: str):
    """(port, JAX) relative seed std of a preset's late-epoch mean loss at
    reference scale: the preset's run and its EXTRA_SEEDS runs on each side
    (the port's ``seeds`` part; JAX's on a CPU in SPREAD_JAX_REF), None
    where fewer than SPREAD_MIN are there."""
    name = f"{preset}_ref_scale_metrics.jsonl"
    port = [_mean_loss(out / name)] + [
        _mean_loss(out / "seeds" / f"{preset}_s{s}.jsonl")
        for s in EXTRA_SEEDS]
    jax = [_mean_loss(jax_runs / name)] + [
        _mean_loss(Path(SPREAD_JAX_REF) / f"{preset}_s{s}.jsonl")
        for s in EXTRA_SEEDS]
    return _rel_std(port), _rel_std(jax)


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


def _pct(x) -> str:
    return "not measured" if x is None else f"{100 * x:.2f}%"


def _wall(rec) -> str:
    return "missing" if rec is None else f"{rec['wall_seconds']:.1f}"


def summary_lines(out: Path, jax_runs: Path) -> list:
    """``SUMMARY.md``: the port's records in ``out`` against the JAX
    package's in ``jax_runs``.  Sampled rows: tol = max(0.01, 1% of the
    JAX value), the group recalls 0.03; the north star (full catalogue):
    2% of the JAX value; loss rows: the JAX value times ``_loss_rel_tol``
    (from both sides' seed spread where measured)."""
    cards = sorted({r["card"] for r in
                    (_final(f) for f in sorted(out.rglob("*.jsonl")))
                    if r and r.get("card")})
    pc = out / "precision_compare"
    rel = _loss_rel_tol(pc)
    spreads = {p: _seed_spread(out, jax_runs, p) for p in SEED_PRESETS}
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
             + ("missing" if rel is None else f"{rel:.6f}") + ").  Where "
             "both sides' seed spread at reference scale is measured, the "
             "row compares one run of each side on independent random "
             "streams, and tol = the JAX value times 2x the std of such a "
             "difference, 2 * sqrt(s_port^2 + s_JAX^2), with s a side's "
             "relative seed std of that mean: "
             + ", ".join(f"{p} (port {_pct(sp)}, JAX {_pct(sj)}"
                         + ("" if sp is not None and sj is not None else
                            ": not both measured, the precision seeds' "
                            "tol") + ")"
                         for p, (sp, sj) in spreads.items()) + ".", "",
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
        lines.append(_loss_row(p, out / name, jax_runs / name,
                               _loss_rel_tol(pc, *spreads[p])
                               if p in spreads else rel))
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
                  "inside the port's range | (JAX - port mean) / std | "
                  "JAX's seeds (the record, then on a CPU) | JAX mean +/- "
                  "std | (port mean - JAX mean) / SE |",
                  "|---|---|---|---|---|---|---|---|---|---|"]
        for p, vs in seeds:
            got = [v for v in vs if v is not None]
            j = _mean_loss(jax_runs / f"{p}_ref_scale_metrics.jsonl")
            mean = statistics.fmean(got)
            std = statistics.stdev(got) if len(got) > 1 else None
            jv = [j] + [_mean_loss(Path(SPREAD_JAX_REF) / f"{p}_s{s}.jsonl")
                        for s in EXTRA_SEEDS]
            jgot = [v for v in jv if v is not None]
            tail = " | |"
            if len(jgot) > 1 and std:
                jm, js = statistics.fmean(jgot), statistics.stdev(jgot)
                se = (std ** 2 / len(got) + js ** 2 / len(jgot)) ** 0.5
                tail = (f"{jm:.6f} +/- {js:.6f} | {(mean - jm) / se:+.2f} |")
            lines.append(
                f"| {p} | " + ", ".join("missing" if v is None else
                                        f"{v:.6f}" for v in vs)
                + f" | {min(got):.6f} / {max(got):.6f} | {mean:.6f} +/- "
                + ("n/a" if std is None else f"{std:.6f}") + f" | {j:.6f} | "
                + ("yes" if min(got) <= j <= max(got) else "no") + " | "
                + ("n/a" if not std else f"{(j - mean) / std:+.2f}") + " | "
                + ", ".join("missing" if v is None else f"{v:.6f}"
                            for v in jv) + " | " + tail)
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
    lines += spread_lines(out, Path(SPREAD_JAX))
    lines += f10_lines(out, Path(SPREAD_JAX))
    lines += fresh_lines(out, Path(SPREAD_JAX))
    lines += driver_lines(out, jax_runs)
    return lines


_EPOCH_LOSS = re.compile(r"^Epoch \d+ \| loss=([\d.]+)$", re.M)


def log_mean_loss(path: Path):
    """The mean loss of the last LOSS_WINDOW epochs of a ``--verbose``
    training log (``Epoch NN | loss=...`` lines), or None while the run is
    missing or short of SPREAD_EPOCHS epochs."""
    if not path.exists():
        return None
    losses = [float(x) for x in _EPOCH_LOSS.findall(path.read_text())]
    if len(losses) < SPREAD_EPOCHS:
        return None
    return statistics.fmean(losses[-LOSS_WINDOW:])


def log_losses(path: Path):
    """Every epoch's loss of a training log, or None while the run is
    missing or short of SPREAD_EPOCHS epochs."""
    if not path.exists():
        return None
    losses = [float(x) for x in _EPOCH_LOSS.findall(path.read_text())]
    return losses if len(losses) >= SPREAD_EPOCHS else None


def replay_row(preset: str, seed: int, side: str, replay_log: Path,
               jax_log: Path):
    """One replay row against the same seed's JAX log, and its verdict
    (None while a side is missing): the last-LOSS_WINDOW means within
    REPLAY_REL_TOL of JAX's; beside it, not judged, the largest
    per-epoch |diff| / loss and the first epoch whose |diff| is past the
    logs' rounding (LOG_RTOL * loss + LOG_ATOL)."""
    r, j = log_losses(replay_log), log_losses(jax_log)
    head = f"| {preset} | {seed} | {side} | "
    if r is None or j is None:
        return head + " | ".join(
            "missing" if v is None else
            f"{statistics.fmean(v[-LOSS_WINDOW:]):.6f}" for v in (j, r)) \
            + " | | | PENDING | | |", None
    mr = statistics.fmean(r[-LOSS_WINDOW:])
    mj = statistics.fmean(j[-LOSS_WINDOW:])
    n = min(len(r), len(j))
    r, j = np.array(r[:n]), np.array(j[:n])
    diff = np.abs(r - j)
    past = np.nonzero(diff > LOG_RTOL * j + LOG_ATOL)[0]
    ok = abs(mr - mj) <= REPLAY_REL_TOL * abs(mj)
    return (head + f"{mj:.6f} | {mr:.6f} | {mr - mj:+.7f} | "
            f"{REPLAY_REL_TOL * abs(mj):.7f} | {'PASS' if ok else 'FAIL'} | "
            f"{float((diff / j).max()):.2e} | "
            + (f"{int(past[0]) + 1}" if past.size else "none") + " |"), ok


def f10_lines(out: Path, jax_dir: Path) -> list:
    """F10's records: a replay row a seed on the card, and one a seed
    replayed on another side (``f10_replay``), then
    ``f10_seeds``' seeds and the row of the port's own streams against
    JAX's at n = SPREAD_SEEDS_BY_PRESET's + F10_SEEDS a side, within 2
    pooled SE (``spread_lines``' limit).  JAX's side is its logs at the
    first seeds and the card's replay at F10_SEEDS, which stands for JAX
    only when every replay row on the card passes."""
    d = out / "f10"
    sides = sorted(p for p in d.glob("replay_*") if p.is_dir())
    if not sides:
        return []
    rows, verdicts = [], {}
    for side in sides:
        for p, seeds in REPLAY_SEEDS.items():
            for seed in seeds:
                log = side / f"{p}_s{seed}.out"
                if side.name != "replay_h100" and not log.exists():
                    continue          # another side replays some seeds
                row, ok = replay_row(p, seed, side.name[7:], log,
                                     jax_dir / f"{p}_s{seed}.out")
                rows.append(row)
                verdicts.setdefault(side.name[7:], []).append(ok)
    lines = ["", f"## F10: the port on the JAX trainer's own random streams "
             f"(paired replay, parity graph, {SPREAD_EPOCHS} epochs)", "",
             "`protocol f10_replay`: the port trains from the JAX trainer's "
             "initial parameters on its own epoch draws, reproduced in numpy "
             "by `scripts/jax_streams.py` (bit-equal to `jax.random` and to "
             "the JAX epoch's draws, `tests/test_torch_jax_streams.py`), "
             "against the JAX package's logs of the same seeds "
             f"(`{jax_dir}/`).  Last-{LOSS_WINDOW} means; tol = "
             f"{REPLAY_REL_TOL:g} x JAX's.  Not judged: the largest "
             "per-epoch |diff| / loss, and the first epoch whose |diff| "
             f"exceeds {LOG_RTOL:g} x loss + {LOG_ATOL:g} (the logs' "
             "6-decimal rounding).", "",
             "| preset | seed | side | JAX | replay | diff | tol | verdict | "
             "max epoch |diff| / loss | first epoch past rounding |",
             "|---|---|---|---|---|---|---|---|---|---|"] + rows
    # the n = 32 row: the port's own streams on the card against JAX's
    first = spread_seeds(F10_PRESET)
    port = ([log_mean_loss(out / "seeds" / "port_h100" /
                           f"{F10_PRESET}_s{s}.out") for s in first]
            + [log_mean_loss(d / "port_h100" / f"{F10_PRESET}_s{s}.out")
               for s in F10_SEEDS])
    jax = ([log_mean_loss(jax_dir / f"{F10_PRESET}_s{s}.out")
            for s in first]
           + [log_mean_loss(d / "replay_h100" / f"{F10_PRESET}_s{s}.out")
              for s in F10_SEEDS])
    seeds = list(first) + list(F10_SEEDS)

    def cell(v):
        return "missing" if v is None else f"{v:.6f}"

    lines += ["", f"`protocol f10_seeds`: {F10_PRESET} at seeds "
              f"{min(F10_SEEDS)}-{max(F10_SEEDS)} (fixed before any run) "
              "beside seeds " + f"{min(first)}-{max(first)}: the port on "
              "its own streams on the card (`seeds_parity`'s and "
              "`f10_seeds`' logs) against JAX's streams (its logs at "
              f"{min(first)}-{max(first)}, the card's replay at "
              f"{min(F10_SEEDS)}-{max(F10_SEEDS)}).  Every seed is "
              "reported.", "",
              "| seed | port's own streams | JAX's streams |", "|---|---|---|"]
    lines += [f"| {s} | {cell(a)} | {cell(b)}"
              + (" (replay)" if s in F10_SEEDS and b is not None else "")
              + " |" for s, a, b in zip(seeds, port, jax)]
    card = verdicts.get("h100", [])
    got_p = [v for v in port if v is not None]
    got_j = [v for v in jax if v is not None]
    row = f"| {F10_PRESET}, parity graph | {len(got_p)} / {len(got_j)} | "
    if len(got_p) < 2 or len(got_j) < 2:
        row += "| | | | PENDING |"
    else:
        mp, mj = statistics.fmean(got_p), statistics.fmean(got_j)
        sp, sj = statistics.stdev(got_p), statistics.stdev(got_j)
        tol = 2 * (sp ** 2 / len(got_p) + sj ** 2 / len(got_j)) ** 0.5
        row += f"{mp:.6f} +/- {sp:.6f} | {mj:.6f} +/- {sj:.6f} | "
        if len(got_p) < len(port) or len(got_j) < len(jax) or not card \
                or None in card:
            row += f"{mp - mj:+.6f} | {tol:.6f} | PENDING |"
        elif not all(card):
            row += (f"{mp - mj:+.6f} | {tol:.6f} | NOT JUDGED: a replay "
                    "row fails on the card, so the replay does not stand "
                    "for JAX |")
        else:
            row += parity_run.judged(mp - mj, tol, 6)
    lines += ["", "| preset | n (port / JAX) | port mean +/- std | JAX mean "
              "+/- std | diff | tol (2 pooled SE) | verdict |",
              "|---|---|---|---|---|---|---|", row]
    return lines + mixed_lines(d, seeds, jax)


def mixed_lines(d: Path, seeds: list, jax: list) -> list:
    """``f10_mixed``' rows: each arm's late-epoch mean loss a seed against
    JAX's streams at the same seed (``jax``, as ``f10_lines`` reads them),
    the arm sharing the rest of the stream: the mean of the per-seed
    differences within 2 of its standard errors."""
    arms = [a for a in F10_ARMS if (d / f"mixed_{a}_h100").is_dir()]
    if not arms:
        return []
    rows = []
    for arm in arms:
        vals = [log_mean_loss(d / f"mixed_{arm}_h100" /
                              f"{F10_PRESET}_s{s}.out") for s in seeds]
        diffs = [a - b for a, b in zip(vals, jax)
                 if a is not None and b is not None]
        head = f"| {arm} | {len(diffs)} | "
        if len(diffs) < 2:
            rows.append(head + "| | | PENDING |")
            continue
        m, sd = statistics.fmean(diffs), statistics.stdev(diffs)
        tol = 2 * sd / len(diffs) ** 0.5
        verdict = (parity_run.judged(m, tol, 6) if len(diffs) == len(seeds)
                   else f"{m:+.6f} | {tol:.6f} | PENDING |")
        mean = statistics.fmean(v for v in vals if v is not None)
        rows.append(head + f"{mean:.6f} | {sd:.6f} | " + verdict)
    return ["", "`protocol f10_mixed`: the same seeds with one part of the "
            "stream from the port's own generator (a `torch.Generator` on "
            "the card seeded with the seed, drawn in `fit`'s order) and the "
            "rest from JAX's (`scripts/jax_streams.py`): `init` the initial "
            "tables, `perm` the epoch's permutation, `samples` its "
            "positives and negatives, `perm+samples` both from one "
            "generator, as `fit` draws them.  A row: the arm's late-epoch "
            "mean loss minus JAX's streams' at the same seed, their mean "
            "within 2 standard errors of it (PASS: that part alone moves "
            "the loss by less than the noise can show).", "",
            "| port's part | n | arm mean | std of the per-seed diff | "
            "mean diff | tol (2 SE) | verdict |",
            "|---|---|---|---|---|---|---|"] + rows


def two_means(a, b) -> dict:
    """Two independent samples of late-epoch means: ``diff`` = mean(a) -
    mean(b), its ``limit`` F10_SE_LIMIT x sqrt(s_a^2 / n_a + s_b^2 / n_b)
    (Welch's standard error), ``beyond`` = |diff| > limit, Welch's
    two-sided ``p``, the spread ``ratio`` s_a / s_b and the two-sided F
    test's ``f_p`` on it."""
    from scipy import stats
    ma, mb = statistics.fmean(a), statistics.fmean(b)
    sa, sb = statistics.stdev(a), statistics.stdev(b)
    limit = F10_SE_LIMIT * (sa ** 2 / len(a) + sb ** 2 / len(b)) ** 0.5
    f, dfa, dfb = sa ** 2 / sb ** 2, len(a) - 1, len(b) - 1
    return {"n": (len(a), len(b)), "mean": (ma, mb), "std": (sa, sb),
            "diff": ma - mb, "limit": limit, "beyond": abs(ma - mb) > limit,
            "p": float(stats.ttest_ind(a, b, equal_var=False).pvalue),
            "ratio": sa / sb,
            "f_p": float(min(1.0, 2 * min(stats.f.cdf(f, dfa, dfb),
                                          stats.f.sf(f, dfa, dfb))))}


def f10_branch(own, jax, twogen) -> str:
    """F10's verdict on the fresh seeds (the rule fixed before any run):
    "A" when own - jax is within its limit (not a fault); "B1" when it is
    beyond, twogen - jax is within its own limit and own - twogen beyond
    its own (drawing init and epochs from one generator); "B2" else (a
    fault with no located cause)."""
    if not two_means(own, jax)["beyond"]:
        return "A"
    if not two_means(twogen, jax)["beyond"] and two_means(own,
                                                          twogen)["beyond"]:
        return "B1"
    return "B2"


F10_BRANCHES = {
    "A": "F10 is checked and is not a fault; `fit` is unchanged",
    "B1": "F10 is a fault of drawing init and epochs from one generator: "
          "`fit` draws its epochs from a generator of their own",
    "B2": "F10 stays open, a measured fault with no located cause",
}


def fresh_lines(out: Path, jax_dir: Path) -> list:
    """F10's decision on F10_FRESH_SEEDS: each arm's late-epoch mean a
    seed, the comparisons of the rule (own - jax, twogen - jax, own -
    twogen; each within F10_SE_LIMIT pooled SE), the branch, then, not
    judged, the spread ratio s_own / s_jax with its F test (F11 opens
    below F10_SPREAD_P) and the pooled rows over every seed from the
    first F10 seeds on.  The jax arm is the card's replay of JAX's
    streams: the branch is judged only when every replay row on the card
    (``f10_lines``) passes."""
    d = out / "f10"
    if not (d / "twogen_h100").is_dir():
        return []
    arms = F10_FRESH_ARMS
    vals = {a: [log_mean_loss(d / f"{F10_ARM_DIRS[a]}_h100" /
                              f"{F10_PRESET}_s{s}.out")
                for s in F10_FRESH_SEEDS] for a in arms}

    def cell(v):
        return "missing" if v is None else f"{v:.6f}"

    lines = ["", f"## F10 decided: {F10_PRESET} on seeds "
             f"{min(F10_FRESH_SEEDS)}-{max(F10_FRESH_SEEDS)} (fixed before "
             "any run, none used before)", "",
             f"`protocol f10_fresh`, {SPREAD_EPOCHS} epochs on the parity "
             "graph, three arms a seed: `own` is `parity_run framework` "
             "(`fit` on the port's own streams), `jax` the card's replay of "
             "the JAX trainer's streams (`replay`), `twogen` the replay on "
             "the port's streams with the initial tables from a generator "
             "seeded with the seed and every epoch's draws from a second "
             f"one seeded seed + {F10_EPOCH_SEED_OFFSET:,}.  A cell: the "
             f"mean loss of the last {LOSS_WINDOW} epochs.", "",
             "| seed | " + " | ".join(arms) + " |",
             "|---" * (len(arms) + 1) + "|"]
    lines += [f"| {s} | " + " | ".join(cell(vals[a][i]) for a in arms)
              + " |" for i, s in enumerate(F10_FRESH_SEEDS)]
    complete = {a: None not in v for a, v in vals.items()}
    card = []
    for p, seeds in REPLAY_SEEDS.items():
        for seed in seeds:
            card.append(replay_row(p, seed, "h100", d / "replay_h100" /
                                   f"{p}_s{seed}.out",
                                   jax_dir / f"{p}_s{seed}.out")[1])
    rule = [("own", "jax", "primary: F10's verdict"),
            ("twogen", "jax", "B1's second condition"),
            ("own", "twogen", "B1's third condition")]
    lines += ["", "| comparison | role | n | mean +/- std | mean +/- std | "
              f"diff | limit ({F10_SE_LIMIT:g} pooled SE) | Welch p | "
              "beyond the limit |", "|---|---|---|---|---|---|---|---|---|"]
    for x, y, role in rule:
        head = f"| {x} - {y} | {role} | "
        if not (complete[x] and complete[y]):
            lines.append(head + "| | | | | | PENDING |")
            continue
        t = two_means(vals[x], vals[y])
        lines.append(
            head + f"{t['n'][0]} / {t['n'][1]} | {t['mean'][0]:.6f} +/- "
            f"{t['std'][0]:.6f} | {t['mean'][1]:.6f} +/- {t['std'][1]:.6f} "
            f"| {t['diff']:+.6f} | {t['limit']:.6f} | {t['p']:.3g} | "
            + ("yes" if t["beyond"] else "no") + " |")
    if not all(complete.values()) or None in card:
        branch = "PENDING"
    elif not all(card):
        branch = ("NOT JUDGED: a replay row fails on the card, so the "
                  "replay does not stand for JAX")
    else:
        b = f10_branch(vals["own"], vals["jax"], vals["twogen"])
        branch = f"{b}: {F10_BRANCHES[b]}"
    lines += ["", f"**Branch: {branch}.**"]
    if complete["own"] and complete["jax"]:
        t = two_means(vals["own"], vals["jax"])
        lines += ["", "Not judged: the seed spreads, s_own / s_jax "
                  f"{t['ratio']:.3f} ({t['std'][0]:.6f} / {t['std'][1]:.6f},"
                  f" n {t['n'][0]} / {t['n'][1]}), two-sided F test p "
                  f"{t['f_p']:.3g}: F11 " + (
                      "opens" if t["f_p"] < F10_SPREAD_P else
                      "does not open") + f" (below {F10_SPREAD_P:g} it "
                  "does)."]
    first = spread_seeds(F10_PRESET)
    own = ([log_mean_loss(out / "seeds" / "port_h100" /
                          f"{F10_PRESET}_s{s}.out") for s in first]
           + [log_mean_loss(d / "port_h100" / f"{F10_PRESET}_s{s}.out")
              for s in F10_SEEDS] + vals["own"])
    jax = ([log_mean_loss(jax_dir / f"{F10_PRESET}_s{s}.out")
            for s in first]
           + [log_mean_loss(d / "replay_h100" / f"{F10_PRESET}_s{s}.out")
              for s in F10_SEEDS] + vals["jax"])
    if None not in own and None not in jax:
        t = two_means(own, jax)
        lines += ["", f"Context, not judged: every seed from {min(first)} "
                  f"to {max(F10_FRESH_SEEDS)} (n {t['n'][0]} / "
                  f"{t['n'][1]}; JAX's logs at {min(first)}-{max(first)}, "
                  "the card's replay after): own "
                  f"{t['mean'][0]:.6f} +/- {t['std'][0]:.6f}, jax "
                  f"{t['mean'][1]:.6f} +/- {t['std'][1]:.6f}, diff "
                  f"{t['diff']:+.6f} against {t['limit']:.6f} (Welch p "
                  f"{t['p']:.3g}); s_own / s_jax {t['ratio']:.3f} (F test "
                  f"p {t['f_p']:.3g})."]
    return lines


def spread_seeds(preset: str) -> tuple:
    """The seeds of a preset's spread on the parity graph."""
    return SPREAD_SEEDS_BY_PRESET.get(preset, SPREAD_SEEDS)


def spread_lines(out: Path, jax_dir: Path) -> list:
    """F7's seed spread on the parity graph: each side's late-epoch mean
    loss at the preset's seeds (``spread_seeds``), their means and stds,
    and the port's mean against JAX's within 2x the pooled std of a side's
    mean (the difference of two means of n seeds: sqrt(s_port^2 / n_port +
    s_jax^2 / n_jax))."""
    sides = [("JAX, CPU", jax_dir)] + [
        (f"port, {d.name[5:]}", d) for d in sorted(
            (out / "seeds").glob("port_*")) if d.is_dir()]
    rows = []
    for p in SPREAD_PRESETS:
        vals = {name: [log_mean_loss(d / f"{p}_s{s}.out")
                       for s in spread_seeds(p)] for name, d in sides}
        j = [v for v in vals["JAX, CPU"] if v is not None]
        for name, vs in vals.items():
            got = [v for v in vs if v is not None]
            cells = ", ".join("missing" if v is None else f"{v:.6f}"
                              for v in vs)
            if len(got) < 2:
                rows.append(f"| {p}, parity graph | {name} | {cells} | | | | "
                            "PENDING |")
                continue
            m, sd = statistics.fmean(got), statistics.stdev(got)
            tail = "| | |"
            if name != "JAX, CPU" and len(j) > 1:
                se = (sd ** 2 / len(got) + statistics.stdev(j) ** 2
                      / len(j)) ** 0.5
                tail = parity_run.judged(m - statistics.fmean(j), 2 * se, 6)
            rows.append(f"| {p}, parity graph | {name} | {cells} | {m:.6f} "
                        f"+/- {sd:.6f} ({100 * sd / m:.2f}%, n {len(got)}) "
                        "| " + tail)
    if not any("+/-" in r for r in rows):
        return []
    return ["", f"## F7 and F10: the late-epoch loss over seeds on the parity "
            f"graph ({SPREAD_EPOCHS} epochs; seeds " + "; ".join(
                f"{p} {min(spread_seeds(p))}-{max(spread_seeds(p))}"
                for p in SPREAD_PRESETS) + ")", "",
            "`parity_run framework --verbose` on `parity_run build`'s graph "
            "(8,000 users, 24,000 items; the harness's configuration of "
            "each preset), both sides with their own random streams: JAX's "
            "records from the JAX package's `scripts/parity_run.py` on a "
            f"CPU (`{jax_dir}/`), the port's from `protocol seeds_parity`.  "
            f"A row: the mean loss of the last {LOSS_WINDOW} epochs a seed; "
            "diff = port mean - JAX mean; tol = 2x the std of that "
            "difference of two means (each side's seed std / sqrt(n)).", "",
            "| preset | side | mean loss by seed | mean +/- std (rel) | diff "
            "| tol | verdict |", "|---|---|---|---|---|---|---|"] + rows


def _json(path: Path):
    return json.loads(path.read_text()) if path.exists() else None


def _check(label: str, value: str, limit: str, ok) -> str:
    """A row of a check: PENDING while its value is missing."""
    verdict = "PENDING" if ok is None else "PASS" if ok else "FAIL"
    return f"| {label} | {value} | {limit} | {verdict} |"


def driver_lines(out: Path, jax_runs: Path) -> list:
    """The rows of the parts cred_parity ... sampling_costs against the JAX
    records: Stage-A parity (JAX's verdict rule), eval equivalence and the
    schedules (TEST R@20 within R20_TOL of JAX's), ingest (every line
    kept), the sharding report (equal element for element), the ranking
    probe (chunked top-k sets equal to full width), the projection's P=4
    halo rows (equal to the sharding report's) and the sampler probe's
    membership checks."""
    lines = ["", "## The remaining protocol drivers (`cred_parity`, "
             "`eval_equiv`, `schedule`, `ingest`, `sharding`, "
             "`eval_breakdown`, `scaling_projection`, `sampling_costs`)",
             "",
             "| check | port (JAX) | limit | verdict |", "|---|---|---|---|"]
    d = out / "cred_parity"
    oracle = Path(CRED_ORACLE)
    creds = {}
    if oracle.exists():
        creds["oracle"] = np.load(oracle)
        # the port's vectors over the oracle's users (a smaller run's do not
        # compare)
        creds.update({n: v for n, v in (
            (n, np.load(d / f"cred_{n}.npy")) for n in cred_parity_run.MODES
            if (d / f"cred_{n}.npy").exists())
            if v.shape == creds["oracle"].shape})
    ds = _json(d / "downstream.json") or {}
    v = cred_parity_run.verdict(creds, ds)
    jrow = cred_parity_run.jax_rows(jax_runs / "cred_parity" / "stage_a.md")
    for n in cred_parity_run.MODES:
        r = v["rho_vs_oracle"].get(n)
        lines.append(_check(
            f"Stage A: rho({n}, oracle)",
            "missing" if r is None else f"{r:.4f} ({jrow[n][5]})",
            f">= {cred_parity_run.RHO_MIN}",
            None if r is None else r >= cred_parity_run.RHO_MIN))
    pct = v["slas_pct_delta"]
    lines.append(_check(
        "Stage A: slas abs. delta of p10/p50/p90 vs oracle",
        "missing" if pct is None else "/".join(f"{x:.3f}" for x in pct),
        f"<= {cred_parity_run.PCT_TOL:.2f} each",
        None if pct is None else max(pct) <= cred_parity_run.PCT_TOL))
    lines.append(_check("Stage A: JAX's verdict rule",
                        ("ACCEPT" if v["accept"] else "FLAG")
                        if len(creds) == 3 else "missing", "ACCEPT",
                        v["accept"] if len(creds) == 3 else None))
    q = np.load(d / "latent_q.npy") if (d / "latent_q.npy").exists() \
        else None
    if "oracle" in creds and q is not None \
            and q.shape == creds["oracle"].shape:
        got = list(np.percentile(creds["oracle"], [10, 50, 90, 99])) + [
            cred_parity_run.spearman(creds["oracle"], q)]
        want = [float(x) for x in jrow["oracle"][:5]]
        dev = max(abs(a - b) for a, b in zip(got, want))
        lines.append(_check(
            "Stage A: the oracle vector against stage_a.md's oracle row "
            "(p10/p50/p90/p99/rho vs q)",
            "/".join(f"{x:.4f}" for x in got) + f" (max abs. diff {dev:.4f})",
            "0.01", dev <= 0.01))
    jcpu = Path(CRED_JAX_CPU)
    lines += _cred_seed_rows(d, creds.get("oracle"), jcpu)
    lines += _cred_spread_rows(d, creds.get("oracle"), jcpu)
    for n in cred_parity_run.MODES:
        if n in creds and (jcpu / f"cred_{n}.npy").exists():
            j = np.load(jcpu / f"cred_{n}.npy")
            lines.append(f"| Stage A: rho({n}, JAX {n} on a CPU) | "
                         f"{cred_parity_run.spearman(creds[n], j):.4f} | "
                         "(context) | |")
    ee = out / "eval_equiv_r4"
    jee = jax_runs / "eval_equiv_r4"
    for m in eval_equiv_r4.MODES:
        r, j = _json(ee / f"train_{m}.json"), _json(jee / f"train_{m}.json")
        lines.append(_r20_row(f"eval_equiv {m}: TEST R@20", r, j,
                              "wall_seconds"))
    ov, jov = _json(ee / "overlap.json"), _json(jee / "overlap.json")
    b = None if ov is None else ov["jaccard_bf16_vs_exact"]["mean"]
    lines.append(_check(
        "eval_equiv: bf16 mean Jaccard@20 vs exact",
        ("missing" if b is None else f"{b:.4f}")
        + f" ({jov['jaccard_bf16_vs_exact']['mean']:.4f})",
        f">= {eval_equiv_r4.JACCARD_MIN}",
        None if b is None else b >= eval_equiv_r4.JACCARD_MIN))
    ex, ap = _json(ee / "train_exact.json"), _json(ee / "train_approx.json")
    lines.append(_check(
        "eval_equiv: approx arm equal to exact (the port ranks it exactly)",
        "missing" if ex is None or ap is None else
        "yes" if ex["test"] == ap["test"] else "no", "yes",
        None if ex is None or ap is None else ex["test"] == ap["test"]))
    sc = _json(out / "schedule_compare.json") or {}
    jsc = _json(jax_runs / "schedule_compare.json")
    for s in schedule_compare.SCHEDULES:
        lines.append(_r20_row(f"schedule {s}: TEST R@20", sc.get(s), jsc[s],
                              "seconds"))
    ib, jib = _json(out / "ingest_bench.json"), \
        _json(jax_runs / "ingest_bench.json")
    lines.append(_check(
        "ingest: rows_kept of 10,000,000 lines",
        ("missing" if ib is None else f"{ib['rows_kept']:,}")
        + f" ({jib['rows_kept']:,}); native s "
        + ("missing" if ib is None else f"{ib['native_s']:.1f}")
        + f" ({jib['native_s']:.1f}), Python projected s "
        + ("missing" if ib is None else f"{ib['python_projected_s']:.1f}")
        + f" ({jib['python_projected_s']:.1f})",
        "10,000,000", None if ib is None else
        ib["rows_kept"] == ib["lines"] == 10_000_000))
    sh = _json(out / "sharding_report.json")
    diff = None if sh is None else sh["differences_from_jax_record"]
    lines.append(_check(
        "sharding report against runs/sharding_report.json",
        "missing" if sh is None else f"{len(diff or [])} differences",
        "equal element for element", None if sh is None else diff == []))
    eb = _json(out / "eval_breakdown.json")
    agree = None if eb is None else min(eb["sets_agree_min"].values())
    lines.append(_check(
        "ranking probe: chunked top-k sets equal to full width (min share)",
        "missing" if eb is None else f"{agree:.4f}", "1.0",
        None if eb is None else agree == 1.0))
    pj = _json(out / "scaling_projection.json")
    chk = None if pj is None else pj.get("sharding_report_check")
    lines.append(_check(
        "scaling projection (a projection): P=4 halo rows against the "
        "sharding report",
        "missing" if chk is None else "equal" if chk["equal"] else "differ",
        "equal", None if chk is None else chk["equal"]))
    sg = _json(out / "sampling_costs.json")
    m = None if sg is None else sg["membership"]
    lines.append(_check(
        "sampling costs: hash table and binary search agree, members found",
        "missing" if m is None else f"{m['agree']}, {m['members_found']}",
        "True, True", None if m is None else m["agree"] and m["members_found"]))
    cards = sorted({r["card"] for r in (ex, ap, sc, ib, sh, eb, pj, sg) if r
                    and r.get("card")})
    return lines + ["", "Cards: " + (", ".join(cards) or "none recorded")
                    + "; JAX values in brackets (TPU v5e records)."]


def _cred_seed_rows(d: Path, oracle, jcpu: Path) -> list:
    """Context rows: JAX's verdict rule at each of CRED_SEEDS for the port
    (``d/seeds/s<seed>``) and for the JAX framework on a CPU
    (``jcpu/seeds``), against the seed-42 oracle."""
    if oracle is None:
        return []
    rows = []
    for seed in CRED_SEEDS:
        cells = []
        for side, paths in (
                ("port", {n: d / "seeds" / f"s{seed}" / f"cred_{n}.npy"
                          for n in cred_parity_run.MODES}),
                ("JAX on a CPU", {n: jcpu / "seeds" / f"cred_{n}_s{seed}.npy"
                                  for n in cred_parity_run.MODES})):
            if not all(p.exists() for p in paths.values()):
                cells.append(f"{side} missing")
                continue
            creds = {"oracle": oracle,
                     **{n: np.load(p) for n, p in paths.items()}}
            v = cred_parity_run.verdict(creds, {})
            cells.append(
                f"{side} {'ACCEPT' if v['accept'] else 'FLAG'} (rho "
                + "/".join(f"{r:.3f}" for r in v["rho_vs_oracle"].values())
                + ", slas abs. delta p10/p50/p90 "
                + "/".join(f"{x:.3f}" for x in v["slas_pct_delta"]) + ")")
        rows.append(f"| Stage A at seed {seed}: JAX's verdict rule | "
                    + "; ".join(cells) + " | (context) | |")
    return rows


def _p10_offsets(oracle, paths) -> list:
    """p10(vector) - p10(oracle) of each saved slas vector in ``paths`` of
    the oracle's shape; the missing ones are skipped."""
    base = np.percentile(oracle, 10)
    vecs = [np.load(p) for p in paths if p.exists()]
    return [float(np.percentile(v, 10) - base) for v in vecs
            if v.shape == oracle.shape]


def _cred_spread_rows(d: Path, oracle, jcpu: Path) -> list:
    """F9's context row: the slas mode's p10 offset from the oracle's over
    seeds 42 and CRED_SEEDS, mean +/- std and n for each side (the port's
    ``d`` and ``d/seeds/s<seed>``, JAX on a CPU ``jcpu`` and
    ``jcpu/seeds``), and the port's mean against JAX's within 2 pooled SE
    (sqrt(s_port^2 / n_port + s_jax^2 / n_jax)).  JAX's one-seed rule
    above is unchanged."""
    if oracle is None:
        return []
    sides = {"port": _p10_offsets(oracle, [d / "cred_slas.npy"] + [
                 d / "seeds" / f"s{s}" / "cred_slas.npy" for s in CRED_SEEDS]),
             "JAX on a CPU": _p10_offsets(oracle, [jcpu / "cred_slas.npy"] + [
                 jcpu / "seeds" / f"cred_slas_s{s}.npy" for s in CRED_SEEDS])}
    cells, stat = [], {}
    for side, xs in sides.items():
        if len(xs) < 2:
            cells.append(f"{side} n {len(xs)}")
            continue
        stat[side] = (statistics.fmean(xs), statistics.stdev(xs), len(xs))
        cells.append(f"{side} {stat[side][0]:+.4f} +/- {stat[side][1]:.4f} "
                     f"(n {len(xs)})")
    if len(stat) == 2:
        (mp, sp, np_), (mj, sj, nj) = stat["port"], stat["JAX on a CPU"]
        se2 = 2 * (sp ** 2 / np_ + sj ** 2 / nj) ** 0.5
        cells.append(f"diff {mp - mj:+.4f}, 2 pooled SE {se2:.4f}: "
                     + ("within" if abs(mp - mj) <= se2 else "outside"))
    return [f"| Stage A: slas p10 - oracle p10 over seeds 42 and "
            f"{min(CRED_SEEDS)}-{max(CRED_SEEDS)} (mean +/- std) | "
            + "; ".join(cells) + " | (context) | |"]


def _r20_row(label: str, rec, jax, wall_key: str) -> str:
    """TEST R@20 of a 12-epoch record against the JAX record's, within
    R20_TOL; its wall beside JAX's."""
    j = jax["test"]["20"]["recall"]
    if rec is None:
        return _check(label, f"missing ({j:.4f})", f"+/- {R20_TOL}", None)
    t = rec["test"]
    o = (t.get("20") or t.get(20))["recall"]
    return _check(label, f"{o:.4f} ({j:.4f}; diff {o - j:+.4f}); wall "
                  f"{rec[wall_key]:.1f} s ({jax[wall_key]:.1f})",
                  f"+/- {R20_TOL}", abs(o - j) <= R20_TOL)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parts", nargs="+", choices=PARTS)
    ap.add_argument("--out", default="runs/torch_h100")
    ap.add_argument("--jax-runs", default="runs",
                    help="the JAX package's records (summary)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the CPU)")
    ap.add_argument("--only", action="append", default=[],
                    metavar="PRESET:SEED",
                    help="limit the f10_ parts to these runs")
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
        if part.startswith("f10_"):
            globals()[f"part_{part}"](out, dev, only=args.only)
        else:
            globals()[f"part_{part}"](out, dev)
        print(f"[protocol] part {part}: {time.perf_counter() - t0:.1f}s",
              flush=True)
    (out / "card.json").write_text(json.dumps({"card": card_name(dev),
                                               "torch": torch.__version__}))


if __name__ == "__main__":
    main()
