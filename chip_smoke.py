#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py [--out results.json]

Phases (each prints one line; any failure exits non-zero):
  1. the card's name and power limit (nvidia-smi), and the kernels' builds
     from ``csrc/segment_spmm.cu``, ``csrc/fused_adam.cu``,
     ``csrc/chunk_spmm.cu``, ``csrc/row_gather.cu`` and
     ``csrc/topk_select.cu`` (one nvcc per source, for sm_90a, started
     together);
  2. the SpMM kernel against its plain PyTorch version on the card: random
     edges, empty rows, duplicate edges, a zero-edge operator and a Zipf hub
     graph, with long rows cut at LONG_ROW_EDGES and at 8 edges, at D in
     {8, 33, 64, 128} (33: the scalar path), fp32 and bf16, a misaligned
     table, and both reference-scale directions; two launches must be
     bit-identical and every case bit-equal to the plain version's ordered
     CPU sums;
  2b. the fused Adam kernel against its plain version on the card: single
     leaves of the two reference-scale tables, (1, 1), (1001, 3) and a
     misaligned view, then lists in one launch (Stage A's ten leaves, both
     reference-scale tables, Stage A's leaves with a misaligned leaf and
     both tables) and a list of 70 leaves (three launches of at most 32), at
     t = 1 and t = 1000; two launches must be bit-identical and every list
     bit-equal to the plain version;
  2c. the row gathers' backward (``ops/gather.py``: the SpMM kernel as a
     unit-weight segment-sum, counted as ``gather_backward``) on the card:
     Stage A's hub shape (600,000 ids into 85,675 rows, one row of 60,954)
     and a Stage-B step's items (8,192 ids into 261,728 rows) with long rows
     cut at LONG_ROW_EDGES, and the Stage-B shape cut at 8, fp32 and bf16;
     the plans built on the card equal the host's, two launches and the
     autograd backward are bit-identical, and every case is bit-equal to
     the plain version's ordered CPU sums;
  3. the serving slice at full width: the reference-scale graph
     (58,867 users, 261,728 items), the cu_message preset (D=64, K=3), the
     CLI's merge-user-ids, then evaluate --split test in sampled and full
     mode, then topk_for_users for 512 users at k=20; the launch counters
     must show 6 SpMM launches per propagate, and one top-k select a batch
     of the full evaluation plus one for topk_for_users;
  4. the same parameters through the plain path (spmm_backend=torch) on the
     card: propagated tables, metrics and top-20 sets must agree;
  5. times (CUDA events) of each operator direction through the kernel, the
     plain version and torch.sparse.mm, with its share of the bound, its
     device time and CUDA launches per application by CUDA kernel
     (profiler) and the wrapper's host time; a sweep of the long-row piece
     length L in {32, ..., 512}, each held bit for bit against the plain
     version; one propagate, and one sampled and one full evaluate;
  6. the training slice at full width: the CLI's train-rec with the
     cu_message preset (D=64, K=3, batch 4096: 15 steps per epoch) for 2
     epochs with checkpoints; the launch counters must show 12 SpMM, 10
     gather-backward and 1 Adam launch per step plus 6 SpMM per
     evaluation; the losses must be finite and evaluate on the written
     best_model.npz must reproduce test_metrics.json;
  7. 3 train steps from one set of parameters and batches through the
     kernels and through the plain path (spmm_backend=torch): parameters
     within rtol 1e-5 / atol 1e-6, losses within 1e-6; two kernel-path
     runs bit-identical;
  8. times (CUDA events, host clock for the epoch): one train step split
     into forward+loss, backward and Adam; each backward SpMM direction;
     a step's two gather backwards against their bound, their plain
     version, index_add_ and the deterministic index_put_ they replace;
     the Adam kernel per table and on both tables in one launch against its
     plain version, torch.optim.Adam(fused=True) and its bound, with its
     device time (the calls queued ahead of the card) and the host's time
     of the wrapper and of adam_step; one epoch; a profiled
     window of 3 steps (device busy share, device time by kernel), which
     must show no indexing_backward_kernel;
  9. the chunked SpMM kernels (``csrc/chunk_spmm.cu``: P3 full-block, P1
     window and P2 int16-id chunks, all through the staged kernel, one
     launch an apply) against their plain version on the card: the phase-2
     graphs, a source row 0 of inf (pad edges must be skipped) and a hub
     block of more than 80 chunks, on 16 layouts (T 30, 32, 36, 256 and
     1024, int16 ids at each; windows W in {16, 64, 128, 256}) at D 8, 64
     and 128, and D=63, D=256 and a misaligned table on three graphs, and
     the reference graph in both directions; two launches bit-identical and
     bit-equal to the plain version's sequential CPU sum, pad and empty
     rows exact zeros, bf16 tables on the int32 layouts of three graphs
     (D 64, 63, 256, a misaligned table), a K=3 padded chain; the staged
     kernel rebuilt with lagging warps (``probes/chunk_race.py``: every warp
     but the first, or the first alone, sleeps where the CTA's warps part
     ways) bit-equal to the CPU sum on rows that span chunks at D 63/256,
     fp32 and bf16, bulk- and thread-loaded plans; then the slab
     row gather
     (``csrc/row_gather.cu``) at S in {512, 768, 2048, 8192, 16384},
     bit-exact, the L2 route at every S and the shared-memory route in
     clusters of 1, 2, 4 and 8 CTAs at S <= 768, on an aligned slab
     (multicast bulk copies) and a misaligned one (the threads' load);
 10. the three probes (``probes/window_kernel.py``, ``kernel_grid.py``,
     ``vmem_gather.py``) at reference scale, counted: every chunked and
     gather kernel must launch there; P1's, P2's and P3's device time
     (calls queued ahead of the card) and loop time in both directions
     beside their bound, ``torch.sparse.mm`` and the CSR kernel; each
     chunked kernel's CUDA launches an apply from the profiler (one
     ``chunk_staged_kernel`` and at most one other record, the counters'
     memset);
     the gather's loop and device times for every route, cluster size and
     S, and ``index_select``'s;
 11. Stage A: a synthetic review JSONL at the two-stage scale of
     ``scripts/two_stage_demo.py`` (600,000 lines, 60,000 users, 250,000
     items), read by the native C++ reader (``backend="native"``: a failed
     build fails the run) and by the Python reader, timed, equal tables;
     then the CLI's train-cred in its default SLAS mode for 2 epochs with
     slas_pad_deg=128: no SpMM and no gather-backward launch, 1 Adam
     launch a step, finite epoch losses, the six artefacts, min-max
     scores in [0, 1];
 12. full-graph mode on the same heterograph for 2 epochs: 8 SpMM and 5
     gather-backward launches a step plus 2 SpMM per holdout evaluation and
     2 for the inference, 1 Adam launch a step; 3 steps against the
     plain path (parameters within rtol 1e-5 / atol 1e-6, losses within
     1e-6) and two kernel-path runs bit-identical;
 13. the two-stage contract: build-graph on the same JSONL with the native
     reader, then train-rec --cred on the CSV train-cred wrote (one finite
     score per graph user, some taken from the CSV, finite metrics);
 14. Stage-A times: a step split into forward+loss, backward and Adam, one
     epoch and a profiled 3-step window in both modes (full-graph: no
     indexing_backward_kernel), train-cred's wall in full-graph mode, the
     SpMM in Stage A's directions against its bound and torch.sparse.mm,
     the smoothness term's two gather backwards against their bound, plain
     version, index_add_ and index_put_, the Adam kernel on the ten Stage-A
     leaves (one launch) against its plain version,
     torch.optim.Adam(fused=True) and its bound, with its device time, and
     gumbel_topk at the user draw's shape;
 15. serving on a mesh (``parallel/``) with phase 3's graph, credibility CSV
     and parameters: (a) the CLI's evaluate --mesh 1 (a world of one over
     NCCL, in a subprocess) in sampled and full mode, metrics within 1e-6
     of phase 3's; then in this process, counted, RecTrainer on a mesh of
     one evaluates both modes and one sharded propagate runs in each of
     "halo", "allgather" and "auto" (6 ``sharded_spmm`` launches each, no
     other kernel), tables bit-equal to the single-device kernel path,
     metrics within 1e-6, the mesh top-20 Jaccard >= 0.99, no
     indexing_backward_kernel or index_put_ in a profiled propagate; times
     of the sharded and single-device propagate in turns, both evaluates,
     and the local sums against their bound, plain version and
     torch.sparse.mm; (b) two ranks of this script on the one card over
     gloo (NCCL takes one rank a device), each propagating in both
     exchanges and evaluating on the (1, 2) mesh: tables bit-equal to
     (a)'s, identical metrics on both ranks.
 16. training on a mesh (``parallel/sharding.py``): (a) in this process, a
     world of one over NCCL, 3 sharded train steps from phase 7's
     parameters and batches against phase 7's one-card kernel path
     (parameters rtol 1e-5 / atol 1e-6, losses 1e-6; whether bit-equal),
     12 ``sharded_spmm``, 4 ``gather_backward`` and 1 ``fused_adam`` launch
     a step, no index_put / index_add / indexing_backward in a profiled
     step, the step's times beside one card's in turns (CUDA events,
     profiler device and window ms, host us) and the host cost of the
     parameter all-gather and the gradient all-reduce; (b) the CLI's
     train-rec --mesh 1 for 2 epochs with checkpoints, counted (in this
     process): finite losses, exact-row best_model.npz, evaluate
     reproduces test_metrics.json, its wall beside phase 6's; (c) Stage A
     on a world of one: 3 full-graph steps against phase 12's kernel path
     (8 ``sharded_spmm``, 5 ``gather_backward``, 1 ``fused_adam`` a step),
     then the CLI's train-cred --mesh 1 trainer_mode=full_graph for 1
     epoch on phase 11's JSONL, counted, scores finite in [0, 1]; (d) two
     ranks of this script on the one card over gloo, each training the
     3 steps on the (1, 2) mesh and then on the (2, 1) mesh in the same
     process: losses identical on both ranks, parameters and losses within
     phase 7's tolerances of its one-card kernel path.
 17. the chunked backend (``spmm_backend=chunked``: dst-sliced chunk plans
     in the padded chain through ``chunk_spmm_block`` / ``chunk_spmm_window``,
     the JAX package's Pallas path): (a) with phase 3's graph, CSV and
     parameters, the CLI's evaluate in sampled and full mode, a propagate
     and topk_for_users, counted (S launches an apply, segment_spmm 0):
     tables within the fp32 bound of the CSR kernel's, metrics within 1e-6
     of phase 3's, top-20 Jaccard >= 0.99; every plan of the path, fp32 and
     bf16, bit-equal to the plain version's ordered CPU sums; (b) bf16
     within BF16_ROW_TOL of the plain chunked version on the card; (c)
     sliced and unsliced (slices=1) propagates and two runs bit-equal; (d)
     the CLI's train-rec spmm_backend=chunked for 2 epochs with
     checkpoints, counted, evaluate reproducing test_metrics.json, then 3
     steps from phase 7's parameters and batches against phase 7's CSR
     kernel path (its tolerances), two runs bit-identical, no
     indexing_backward_kernel in a profiled step; (e) 3 Stage-A full-graph
     steps on chunk plans against phase 12's kernel path, counted; (f) times
     in turns with the CSR path: each direction's apply at S = auto and
     S = 1, fp32 and bf16 (bound, torch.sparse.mm), the propagate and the
     train step (CUDA events, profiler device ms, host us).
 18. the north star (``bench.py``, ``scripts/two_stage_10m.py``): (a) the
     port's ``bench.main`` in process at reference scale in ``--mode
     epoch`` and ``--mode step``: one JSON line each with the JAX bench's
     keys, a finite positive value, edges_per_step = E*K*2*2 (E = 360,207);
     (b) the planted 10M-edge graph (500,000 users, 1,000,000 items; its
     split must be 6,899,612 / 864,551 / 861,347 edges) under
     ``scaled_10m`` (D=128, K=4, batch 8,192, per_epoch), counted as the
     ``northstar`` path: ``bench_northstar`` (8 ``segment_spmm`` a
     propagate; an epoch 8 for its cache, then 4 ``gather_backward`` and 1
     ``fused_adam`` a step) and one full evaluate on val (8 more, and one
     ``topk_select`` a batch of 512); held
     against the plain path on the card: propagated tables (rtol 1e-5 /
     atol 1e-6), 3 steps (phase 7's tolerances), the top-20 of 4,096 val
     users (Jaccard >= 0.99), no stock scatter in a profiled step; times:
     the host's set-up by part, the propagate (events, device time by
     kernel, the hub's pieces), the epoch by part, the step split, K1/K2,
     the step's two gather backwards and Adam on both tables against
     their bounds, plain versions and library calls, the peak memory by
     part; (c) the port's ``scripts/two_stage_10m.run`` on the same graph,
     counted as the ``northstar_two_stage`` path: Stage A in SLAS mode
     (``slas_pad_deg=128``; 1 ``fused_adam`` a step, no SpMM, no gather
     backward) for 1 epoch of 6, the CSV, Stage B under ``scaled_10m`` for
     1 epoch of 12 reading all 500,000 users from it; scores finite in
     [0, 1], finite metrics.
 19. the reference protocol's entry points (``scripts/reference_regression.py``,
     ``parity_run.py``, ``two_stage_demo.py``, ``examples/end_to_end.py``),
     in process at full width and short depth, each counted as its own
     path: (a) ``reference_regression --scale ref --epochs 1`` for the six
     presets of the JAX package's ``runs/SUMMARY.md`` (``reference_regression``):
     every printed line in the reference's log format (``LOG_LINE``), the
     metrics JSONL with the keys of the JAX record of the same preset plus
     ``card``, finite test metrics, each preset's launches as the trainer's
     code gives them; (b) ``parity_run build`` at its defaults,
     ``framework`` on the seven configurations (seed 0, 4 epochs, val every
     2) and ``--fast`` on cu_message (``parity_framework``; its full
     evaluations one ``topk_select`` a batch), then ``report``
     against the committed oracle records: a row a configuration and
     metric, each with a verdict; (c) ``two_stage_demo.run`` on phase 11's
     JSONL with ``--pad-deg 128``, Stage A 1 epoch (1 ``fused_adam`` a
     step, nothing else), Stage B 2 epochs (``two_stage_demo``): scores
     finite in [0, 1], ``summary.json`` with the JAX script's keys, a score
     from the CSV for every graph user; (d) ``examples/end_to_end`` at its
     own size (``end_to_end``): finite metrics.  After each path is read,
     the shapes it gave the kernels that no earlier phase holds are held
     against the plain path (``spmm_backend="torch"``) from one seed: one
     propagate's tables and 3 train steps at phase 7's tolerances, for
     vanilla's joint table and degree_aware's and cred_eq322's weights at
     reference scale in (a), the seven configurations on the parity graph
     in (b) and Stage B on the demo's graph with its credibility in (c).
 20. the remaining protocol drivers (``scripts/cred_parity_run.py``,
     ``eval_equiv_r4.py``, ``schedule_compare.py``, ``ingest_bench.py``,
     ``probes/eval_breakdown.py``) in process at full width and short
     depth, each counted as its own path: (a) ``cred_parity_run build``
     (3,000 users), ``framework`` in both modes for 2 epochs and a
     ``downstream`` pair (cu_message and cred_eq322 on the oracle's scores)
     for 2 epochs (``cred_parity``; full-graph mode 8 SpMM, 5 gather
     backwards and 1 Adam a step, 2 SpMM a holdout and 2 for the
     inference; SLAS 1 Adam a step), then ``report`` against the committed
     oracle vector: its rows and verdict line; (b) on phase 18's planted
     graph, ``schedule_compare`` with ``per_batch`` for 1 epoch
     (``schedule_compare``: 16 SpMM, 12 gather backwards and 1 Adam a
     step, one ``topk_select`` a batch of its full evaluations), the JAX
     record's keys, then one propagate and 3 ``per_batch``
     steps held against ``spmm_backend="torch"`` on the card (phase 7's
     tolerances); (c) ``eval_equiv_r4 overlap`` in all three modes on
     4,096 val users, on (b)'s kernel trainer after one epoch
     (``eval_equiv``: one propagate, one ``topk_select`` a batch of 512 in
     each mode): approx equal to exact, bf16 mean
     Jaccard@20 >= 0.9; (d) ``ingest_bench`` on phase 11's JSONL: every line
     kept, no kernel launched; (e) ``eval_breakdown`` for 2 batches of 512
     val users over the 1,000,000 items: every part timed, chunked top-k
     sets equal to full-width ones, no kernel launched but the top-k
     select of its two ``_full_batch`` calls a batch.
 21. the last three modules (``probes/scaling_terms.py``,
     ``probes/sampling_costs.py``, ``scripts/scaling_projection.py``) in
     process, each counted as its own path: (a) the scaling terms on phase
     18's trainer and graph at one timed call a loop (``scaling_terms``: a
     propagate 8 ``segment_spmm``; an epoch 8 for its cache, then 4
     ``gather_backward`` and 1 ``fused_adam`` a step; each loop one untimed
     call first; the evaluation's two calls a propagate and a top-k
     select a batch each): the JAX
     record's keys, finite positive terms, scan_steps_s = epoch_s -
     propagate_s, the JAX record's ``config``; (b) the sampler probe at 3
     timed calls over JAX's catalogues and the north star's
     (``sampling_costs``): draws in range, hash table and binary search
     agreeing, every member found, no kernel launched; (c) the projection on
     (a)'s terms (``scaling_projection``): rows for P = 2, 4, 8, the
     bandwidths not measured, the P=4 halo rows equal to a halo-mode
     sharding record of the same graph and weights, JAX's TPU terms
     refused, no kernel launched.
 22. the JAX trainer's own random streams (``scripts/jax_streams.py``, a
     numpy replica of its threefry draws) driving the port, counted
     (``jax_streams_replay``): degree_aware on a 150 x 80 graph at seed 5,
     20 epochs from the replica's initial parameters, each on the
     replica's draws through ``RecTrainer.run_epoch``; the parameters' and
     every epoch's draws' sha256 equal to the JAX package's, written on a
     CPU in ``runs/torch_h100/f10/jax_small.json``, and every epoch's mean
     loss within rtol 2e-6 of JAX's jitted epoch there (12 SpMM, 10 gather
     backwards and 1 Adam launch a step); then one propagate and 3 steps
     on the graph held against the plain path; (b) ``protocol f10_fresh``'s
     twogen arm on that graph, counted (``twogen_replay``): ``replay`` of
     degree_aware's parity configuration (one step an epoch) for 20
     epochs, the initial tables from a generator seeded 5 and the epochs
     from a second one seeded 10,005: the tables bit-equal to
     ``RecTrainer.init_state``'s, every epoch's draws bit-equal to
     ``draw_epoch`` on the second generator, the logged losses finite and
     equal to ``run_epoch``'s on them.
 23. the top-k select (``csrc/topk_select.cu``, through
     ``ops/topk_select.topk_select``) on the cells' own masked score
     matrices, tables propagated from ``init_state(0)``: 512 test users'
     bf16 scores over phase 18's 1,000,000 items (train items at -1e9),
     and 256 and 1,024 users' fp32 scores over the reference-scale graph's
     261,728 items (train items at -inf); ids and value bits equal to the
     plain version's (a stable sort), one counted call and two CUDA
     launches a call (a captured graph); its ms, device ms by kernel,
     bound, the plain version's and torch.topk's ms, and the share of
     scores that entered a thread queue.  The paths of phases 3-22 count
     its launches with every other kernel's.

Every kernel's launch counter is set to 0 before each counted path (phases
3, 6, 10, 11, 12, 15, 16 (b), (c), 17 (a), (d), (e), 18 (b), (c), 19
(a)-(d), 20 (a)-(e), 21 (a)-(c) and 22 (a), (b)) and read after it; a kernel that is not on that
path must show 0 there.  It imports nothing of the JAX package.  It needs one CUDA card and
exits non-zero without one.  A line before the card's name gives the
command's seconds.  The line before the last holds the kernels'
JSON; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

PKG = ("beyond_binary_fake_user_detection_a_credibility_aware_graph_based_"
       "recommender_system_tpu_torch")
REPLACES = ("beyond_binary_fake_user_detection_a_credibility_aware_graph_"
            "based_recommender_system_tpu/ops/spmm_pallas.py:406 "
            "(_segment_kernel, K1) and :427 (_window_kernel, K2); "
            "pallas_call at :500")
REPLACES_ADAM = ("scripts/probe_fused_adam.py:71 (pallas_adam_leaf, P5; body "
                 "_adam_kernel :60); pallas_call at :79")
REPLACES_P1 = ("scripts/probe_window_kernel.py:127 (apply_window, P1; body "
               "_window_kernel :109); pallas_call at :148")
REPLACES_P2 = ("scripts/probe_window_kernel.py:182 (apply_i16, P2; body "
               "_i16_kernel :166); pallas_call at :204")
REPLACES_P3 = ("scripts/probe_kernel_grid.py:128 (apply_nopad_trunc, P3; body "
               "_segment_kernel, ops/spmm_pallas.py:406); pallas_call at :153")
REPLACES_P4 = ("scripts/probe_vmem_gather.py:34 (probe.call, P4; body kernel "
               ":29); pallas_call at :35")
REPLACES_GATHER = ("no Pallas kernel: XLA's scatter-add, the backward of the "
                   "JAX package's row gathers (models/losses.py:76, "
                   "models/lightgcn.py:267-302, train/trainer.py:254-263, "
                   "train/cred_trainer.py:143-150); the same source as K1/K2")
# the reference-scale graph (bench.py --scale ref)
GRAPH = dict(num_users=58_867, num_items=261_728, edges_per_user=7.9, seed=0,
             power=1.0)
TRAIN_EPOCHS = 2
PARITY_STEPS = 3
ADAM_BYTES = 28               # per element: read p, g, m, v; write p, m, v
ADAM_FLOPS = 13               # per element: 3 for m, 4 for v, 3 + 3 for p
# fp32: |kernel - plain| <= FP32_ATOL + FP32_RTOL * sum_e |w_e * x_src(e)|,
# the summation error bound (the plain version on the card sums with atomics
# in another order, so a cancelling sum of O(1) terms can end near 0 with an
# absolute error of a few 1e-6)
FP32_RTOL, FP32_ATOL = 1e-5, 1e-6
BF16_ROW_TOL = 2e-2           # |kernel - plain| <= 2e-2 * max|plain row|
# training, kernel path vs plain path: the SpMM sums in another order (the
# plain path's index_add_), Adam divides by sqrt(v) + eps
TRAIN_RTOL, TRAIN_ATOL, LOSS_ATOL = 1e-5, 1e-6, 1e-6
# Stage A's losses (O(1e4)) on another SpMM's summation order: at most four
# fp32 ulps (an ulp is 2**-24 to 2**-23 of the value)
STAGE_A_LOSS_RTOL = 2.0 ** -22


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(op, D: int, itemsize: int) -> float:
    """Least time for one CSR application (``probes/_timing.py``)."""
    from importlib import import_module
    return import_module(f"{PKG}.probes._timing").csr_bound_ms(op, D, itemsize)


def kernel_counters() -> dict:
    """Every kernel wrapper of the package, by its name; each counts its
    launches in ``launches``."""
    from importlib import import_module
    mods = [import_module(f"{PKG}.ops.{m}") for m in
            ("spmm_cuda", "adam_cuda", "chunk_spmm_cuda", "row_gather_cuda",
             "topk_select_cuda")]
    return {k.name: k for m in mods
            for k in getattr(m, "KERNELS", None) or (m.KERNEL,)}


def full_eval_calls(graph, split: str, batch: int = 512) -> int:
    """``topk_select`` calls of one single-device full evaluation of
    ``split`` (``eval/ranking.evaluate_full``): one a batch of the split's
    users, the batch clamped as ``evaluate_full`` clamps it."""
    n = int((graph.user_csr(split).degrees() > 0).sum())
    batch = min(batch, 1 << max(int(n - 1).bit_length(), 0))
    return -(-n // batch)


def reset_counts() -> None:
    for k in kernel_counters().values():
        k.launches = 0


def read_counts(expected: dict, path: str) -> dict:
    """Every kernel's launches since :func:`reset_counts`; a kernel not
    named in ``expected`` must not have launched."""
    got = {name: k.launches for name, k in kernel_counters().items()}
    want = {name: expected.get(name, 0) for name in got}
    if got != want:
        raise AssertionError(f"{path}: launches {got}, expected {want}")
    return got


def _counts_now() -> dict:
    return {name: k.launches for name, k in kernel_counters().items()}


def _launched(before: dict, want: dict, tag: str) -> dict:
    """Every kernel's launches since ``before``; a kernel not named in
    ``want`` must not have launched."""
    got = {n: k.launches - before[n] for n, k in kernel_counters().items()}
    full = {n: want.get(n, 0) for n in got}
    if got != full:
        raise AssertionError(f"{tag}: launches {got}, expected {full}")
    return got


def _held(params: dict, losses, ref: dict, tag: str,
          loss_rtol: float = 0.0) -> tuple:
    """Train steps' ``params`` and ``losses`` against ``ref``'s at phase 7's
    tolerances (parameters TRAIN_RTOL / TRAIN_ATOL, losses LOSS_ATOL +
    ``loss_rtol`` * |ref|): (loss diff, parameter diff, bit-equal)."""
    import torch
    loss_diff = (losses - ref["losses"]).abs()
    loss_err = float(loss_diff.max())
    if bool((loss_diff > LOSS_ATOL + loss_rtol * ref["losses"].abs()).any()) \
            or not torch.isfinite(losses).all():
        raise AssertionError(f"{tag}: losses differ by {loss_err} > "
                             f"{LOSS_ATOL} + {loss_rtol:g}*|ref|")
    p_err = 0.0
    for k, want in ref["params"].items():
        diff = (params[k].to(want.device) - want).abs()
        if bool((diff > TRAIN_ATOL + TRAIN_RTOL * want.abs()).any()):
            raise AssertionError(f"{tag}: {k} differs by "
                                 f"{float(diff.max())}")
        p_err = max(p_err, float(diff.max()))
    bit = torch.equal(losses.to(ref["losses"].device), ref["losses"]) and all(
        torch.equal(params[k].to(v.device), v)
        for k, v in ref["params"].items())
    return loss_err, p_err, bit


# --------------------------------------------------------------------------
# phase 2
# --------------------------------------------------------------------------

def _cases(rng):
    def rand(ns, nd, E, dst_hi=None):
        dst = rng.integers(0, dst_hi or nd, E)
        return rng.integers(0, ns, E), dst, rng.normal(size=E), ns, nd

    zipf_nd, zipf_E = 20_000, 200_000
    p = 1.0 / np.arange(1, zipf_nd + 1)
    zipf_dst = rng.choice(zipf_nd, size=zipf_E, p=p / p.sum())
    dup_src = np.repeat(rng.integers(0, 50, 400), 5)
    dup_dst = np.repeat(rng.integers(0, 300, 400), 5)
    return {
        "random": rand(5_000, 3_000, 40_000),
        "empty_rows": rand(2_000, 3_000, 10_000, dst_hi=1_000),
        "duplicates": (dup_src, dup_dst, rng.normal(size=2_000), 50, 300),
        "zero_edges": (np.zeros(0, np.int64), np.zeros(0, np.int64),
                       np.zeros(0), 40, 100),
        "zipf_hub": (rng.integers(0, 60_000, zipf_E), zipf_dst,
                     rng.uniform(0.0, 0.01, zipf_E), 60_000, zipf_nd),
    }


def _spmm_check(sc, d, x, pieces, tag, worst) -> None:
    """One kernel application against the plain version on the card (fp32
    summation bound, or the bf16 row bound) and bit for bit against the
    plain version's ordered CPU sums; two launches bit-identical, empty rows
    exact zeros."""
    import torch
    L = pieces.edges_per_piece
    y1 = sc.KERNEL(d.indptr, d.src, d.w, x, pieces=pieces)
    y2 = sc.KERNEL(d.indptr, d.src, d.w, x, pieces=pieces)
    ref = sc.segment_spmm_reference(d.indptr, d.src, d.w, x, long_row_edges=L)
    torch.cuda.synchronize()
    if not torch.equal(y1, y2):
        raise AssertionError(f"{tag}: two launches differ")
    if y1.dtype != x.dtype or y1.shape != (d.num_dst, x.shape[1]):
        raise AssertionError(f"{tag}: wrong output {y1.dtype} "
                             f"{tuple(y1.shape)}")
    if bool((y1[d.indptr[1:] == d.indptr[:-1]] != 0).any()):
        raise AssertionError(f"{tag}: empty row not zero")
    diff = (y1.float() - ref.float()).abs()
    if x.dtype == torch.float32:
        mag = sc.segment_spmm_reference(d.indptr, d.src, d.w.abs(), x.abs(),
                                        long_row_edges=L)
        bad = diff > FP32_ATOL + FP32_RTOL * mag
        worst["fp32"] = max(worst["fp32"], float(diff.max())
                            if diff.numel() else 0.0)
    else:
        row = ref.float().abs().amax(dim=1, keepdim=True)
        bad = diff > BF16_ROW_TOL * row + FP32_ATOL
        rel = diff / (row + 1e-30)
        worst["bf16_rel"] = max(worst["bf16_rel"], float(rel.max())
                                if rel.numel() else 0.0)
    if bool(bad.any()):
        raise AssertionError(f"{tag}: kernel disagrees with the plain "
                             f"version, max {float(diff.max())}")
    # the kernel sums in the plain version's order: short rows and pieces
    # in edge order, long rows' partials in piece order, no atomics
    seq = sc.segment_spmm_reference(d.indptr.cpu(), d.src.cpu(), d.w.cpu(),
                                    x.cpu(), long_row_edges=L)
    if not torch.equal(y1.cpu(), seq):
        raise AssertionError(f"{tag}: not bit-equal to the plain version's "
                             f"ordered CPU sums")


def phase_kernel_vs_plain(dev, dirs) -> dict:
    """The SpMM kernel against its plain version: the phase-2 graphs at
    D in {8, 33, 64, 128} (33: the scalar path) with long rows cut at
    LONG_ROW_EDGES and at 8, a misaligned table (the scalar path at D=64),
    and both reference-scale directions (``dirs``, the probe graph)."""
    import torch
    from importlib import import_module
    spmm = import_module(f"{PKG}.ops.spmm")
    sc = import_module(f"{PKG}.ops.spmm_cuda")
    rng = np.random.default_rng(0)
    worst = {"fp32": 0.0, "bf16_rel": 0.0}
    hub = 0
    n = 0
    for name, (src, dst, w, ns, nd) in _cases(rng).items():
        d = spmm.CsrDirection.from_edges(src, dst, w, ns, nd, dev)
        hub = max(hub, int((d.indptr[1:] - d.indptr[:-1]).max()))
        for L in (sc.LONG_ROW_EDGES, 8):
            pieces = sc.long_row_pieces(d.indptr, L)
            for D in (8, 33, 64, 128):
                x32 = torch.randn(ns, D, device=dev, dtype=torch.float32)
                for dt in (torch.float32, torch.bfloat16):
                    _spmm_check(sc, d, x32.to(dt), pieces,
                                f"{name} L={L} D={D} {dt}", worst)
                    n += 1
            # a table one element off 16-byte alignment
            buf = torch.randn(ns * 64 + 1, device=dev)
            _spmm_check(sc, d, buf[1:].view(ns, 64), pieces,
                        f"{name} L={L} D=64 misaligned", worst)
            n += 1
    for name, p in dirs.items():
        d = p["csr"]
        for dt in (torch.float32, torch.bfloat16):
            _spmm_check(sc, d, p["x"].to(dt), d.pieces,
                        f"reference {name} D=64 {dt}", worst)
            n += 1
    log(f"[phase 2] kernel vs plain: {n} cases ok (5 graphs x L "
        f"{sc.LONG_ROW_EDGES}/8 x D 8/33/64/128 x fp32/bf16, a misaligned "
        f"table, both reference directions x fp32/bf16), bit-identical "
        f"reruns, empty rows zero, hub row {hub} edges; max fp32 abs err "
        f"{worst['fp32']:.3g} (tol {FP32_ATOL:g} + {FP32_RTOL:g}*sum|w*x|), "
        f"max bf16 err/row-max {worst['bf16_rel']:.3g} (tol "
        f"{BF16_ROW_TOL:g}); every case bit-equal to the plain version's "
        f"ordered CPU sums")
    worst["cases"] = n
    return worst


# --------------------------------------------------------------------------
# phase 2c: the row gathers' backward
# --------------------------------------------------------------------------

# (ids, table rows, hub row's ids, L): Stage A's h_i1[dst] (the two-stage
# graph's early view: 600,000 edges, 85,675 items, a hub item of 60,954)
# and a Stage-B step's items (2 x 4,096 into the reference graph's 261,728)
GATHER_CASES = {"stage_a_hub": (600_000, 85_675, 60_954, 64),
                "stage_b_items": (8_192, 261_728, 0, 64),
                "stage_b_items_L8": (8_192, 261_728, 0, 8)}


def _gather_ids(rng, ids: int, rows: int, hub: int) -> np.ndarray:
    """``hub`` ids of row 0, the rest zipf-1 over rows 1..rows-1, shuffled
    (a zipf-1 head row gets ~ids / 13 at 261,728 rows: long rows)."""
    p = 1.0 / np.arange(1, rows)
    rest = 1 + rng.choice(rows - 1, size=ids - hub, p=p / p.sum())
    return rng.permutation(np.concatenate([np.zeros(hub, np.int64), rest]))


def phase_gather_vs_plain(dev) -> dict:
    """The gathers' backward (the SpMM kernel through ``GATHER_KERNEL``)
    against its plain version: the plan built on the card equals the
    host's definition, two launches and the autograd backward of
    ``gather_rows`` are bit-identical, and each case is bit-equal to the
    plain version's ordered CPU sums (fp32 and bf16)."""
    import torch
    from importlib import import_module
    sc = import_module(f"{PKG}.ops.spmm_cuda")
    spmm = import_module(f"{PKG}.ops.spmm")
    ga = import_module(f"{PKG}.ops.gather")
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    worst, rows = 0.0, []
    for name, (E, N, hub, L) in GATHER_CASES.items():
        idx_np = _gather_ids(rng, E, N, hub)
        idx = torch.as_tensor(idx_np, device=dev)
        plan = ga.gather_plans(idx[None], N, L)[0]
        host = spmm.CsrDirection.from_edges(np.arange(E), idx_np, np.ones(E),
                                            E, N, "cpu", L)
        same = all(torch.equal(getattr(plan, f).cpu(), getattr(host, f))
                   for f in ("indptr", "src", "w")) and all(
            torch.equal(getattr(plan.pieces, f).cpu(),
                        getattr(host.pieces, f))
            for f in ("start", "row", "rows", "first"))
        if not same:
            raise AssertionError(f"gather {name}: the plan built on the card "
                                 f"differs from the host's")
        for dt in (torch.float32, torch.bfloat16):
            tag = f"gather {name} {dt}"
            g = torch.randn(E, 64, device=dev, generator=gen).to(dt)
            y1 = sc.GATHER_KERNEL(plan.indptr, plan.src, plan.w, g,
                                  pieces=plan.pieces)
            y2 = sc.GATHER_KERNEL(plan.indptr, plan.src, plan.w, g,
                                  pieces=plan.pieces)
            table = torch.zeros(N, 64, dtype=dt, device=dev,
                                requires_grad=True)
            ga.gather_rows(table, idx, plan).backward(g)
            ref = sc.segment_spmm_reference(plan.indptr, plan.src, plan.w, g,
                                            long_row_edges=L)
            torch.cuda.synchronize()
            if not (torch.equal(y1, y2) and torch.equal(table.grad, y1)):
                raise AssertionError(f"{tag}: launches or the autograd "
                                     f"backward differ")
            seq = sc.segment_spmm_reference(
                plan.indptr.cpu(), plan.src.cpu(), plan.w.cpu(), g.cpu(),
                long_row_edges=L)
            if not torch.equal(y1.cpu(), seq):
                raise AssertionError(f"{tag}: not bit-equal to the plain "
                                     f"version's ordered CPU sums")
            if dt == torch.float32:
                worst = max(worst, float((y1 - ref).abs().max()))
        deg = plan.indptr[1:] - plan.indptr[:-1]
        rows.append({"case": name, "ids": E, "rows": N, "L": L,
                     "max_row_ids": int(deg.max()),
                     "long_rows": plan.pieces.num_long,
                     "pieces": plan.pieces.num_pieces})
    log("[phase 2c] gather backward (segment_spmm.cu as gather_backward) vs "
        "plain: " + "; ".join(
            f"{r['case']} ({r['ids']:,} ids into {r['rows']:,} rows, largest "
            f"row {r['max_row_ids']:,}, L={r['L']}: {r['long_rows']} long "
            f"rows, {r['pieces']} pieces)" for r in rows)
        + f"; fp32 and bf16, plans built on the card equal the host's, "
        f"bit-identical reruns and autograd backward, every case bit-equal "
        f"to the plain version's ordered CPU sums; max fp32 abs err vs the "
        f"plain version on the card {worst:.3g}")
    return {"max_abs_err": worst, "cases": rows}


def time_gather(role: str, plan, idx, D: int, gen) -> dict:
    """One gather backward at a plan's shape: the kernel (plain, kernel,
    kernel, plain, best of each), its bound, the atomic ``index_add_`` (the
    library call) and the deterministic sorted ``index_put_`` that ATen
    runs as the stock gather's backward."""
    import torch
    from importlib import import_module
    sc = import_module(f"{PKG}.ops.spmm_cuda")
    trainer_mod = import_module(f"{PKG}.train.trainer")
    tm = import_module(f"{PKG}.probes._timing")
    dev = idx.device
    N, E, L = plan.num_dst, plan.num_src, plan.pieces.edges_per_piece
    g = torch.randn(E, D, device=dev, generator=gen)

    def kern():
        sc.GATHER_KERNEL(plan.indptr, plan.src, plan.w, g, pieces=plan.pieces)

    def plain():
        sc.segment_spmm_reference(plan.indptr, plan.src, plan.w, g,
                                  long_row_edges=L)

    p1 = cuda_time_ms(plain, 10)
    k1 = cuda_time_ms(kern, 30)
    k2 = cuda_time_ms(kern, 30)
    p2 = cuda_time_ms(plain, 10)
    lib = cuda_time_ms(lambda: torch.zeros(N, D, device=dev).index_add_(
        0, idx, g), 20)
    with trainer_mod.deterministic_algorithms():
        put = cuda_time_ms(lambda: torch.zeros(N, D, device=dev).index_put_(
            (idx,), g, accumulate=True), 5, warmup=1)
    deg = plan.indptr[1:] - plan.indptr[:-1]
    return {"role": role, "ids": E, "rows": N, "max_row_ids": int(deg.max()),
            "long_rows": plan.pieces.num_long,
            "pieces": plan.pieces.num_pieces, "ms": min(k1, k2),
            "plain_ms": min(p1, p2), "library_ms": lib, "index_put_ms": put,
            "bound_ms": tm.csr_bound_ms(plan, D, 4)}


def _gather_line(rows) -> str:
    return "; ".join(
        f"gather backward {r['role']} ({r['ids']:,} ids into {r['rows']:,} "
        f"rows, largest {r['max_row_ids']:,}) kernel {r['ms']:.4f} plain "
        f"{r['plain_ms']:.4f} index_add_ {r['library_ms']:.4f} index_put_ "
        f"(deterministic) {r['index_put_ms']:.4f} bound {r['bound_ms']:.4f}"
        for r in rows)


# --------------------------------------------------------------------------
# phases 3-5
# --------------------------------------------------------------------------

def _xavier(rng, n, d):
    lim = np.sqrt(6.0 / (n + d))
    return rng.uniform(-lim, lim, (n, d)).astype(np.float32)


def _close(a, b) -> bool:
    import torch
    return bool(((a - b).abs() <= FP32_ATOL + FP32_RTOL * b.abs()).all()
                and torch.isfinite(a).all())


def _metrics_equal(a: dict, b: dict, tol: float = 1e-6) -> float:
    worst = 0.0
    for K in a:
        for m in ("precision", "recall", "ndcg"):
            worst = max(worst, abs(a[K][m] - b[K][m]))
        if a[K]["users_eval"] != b[K]["users_eval"]:
            raise AssertionError("users_eval differs")
    if worst > tol:
        raise AssertionError(f"metrics differ by {worst} > {tol}")
    return worst


SWEEP_L = (32, 64, 128, 256, 512)


def sweep_long_row_edges(sc, d, x) -> list:
    """The kernel at each piece length L in SWEEP_L on one direction, each
    held bit for bit against the plain version's ordered CPU sums at that
    L; times (CUDA events) taken in order and in reverse, best of both."""
    import torch
    tables = {L: sc.long_row_pieces(d.indptr, L) for L in SWEEP_L}
    cpu = (d.indptr.cpu(), d.src.cpu(), d.w.cpu(), x.cpu())
    rows = []
    for L, pc in tables.items():
        y = sc.KERNEL(d.indptr, d.src, d.w, x, pieces=pc)
        if not torch.equal(y.cpu(), sc.segment_spmm_reference(
                *cpu, long_row_edges=L)):
            raise AssertionError(f"L={L}: kernel not bit-equal to the plain "
                                 f"version's ordered CPU sums")
        rows.append({"L": L, "long_rows": pc.num_long,
                     "pieces": pc.num_pieces})
    ms = {L: [] for L in tables}
    for order in (SWEEP_L, SWEEP_L[::-1]):
        for L in order:
            pc = tables[L]
            ms[L].append(cuda_time_ms(
                lambda: sc.KERNEL(d.indptr, d.src, d.w, x, pieces=pc), 50))
    for r in rows:
        r["ms"] = min(ms[r["L"]])
    return rows


def host_us_per_call(fn, calls: int = 200) -> float:
    """Host microseconds a call of ``fn`` takes to return (the launches are
    queued, not waited for; ``calls`` stays below the launch queue's
    depth)."""
    import torch
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = 1e6 * (time.perf_counter() - h0) / calls
    torch.cuda.synchronize()
    return us


def profile_split(fn, kinds, calls: int = 10) -> tuple:
    """Device ms and CUDA launches per call of ``fn`` by CUDA kernel (two
    dicts), from the profiler over ``calls`` calls after one warm-up;
    ``kinds`` maps a label to a kernel name fragment, tried in order (the
    first match labels a kernel).  The profiler can drop a kernel's record
    (one of ten was missing in a run on the H100), so a kernel's launches
    per call are its record count over ``calls`` rounded to a whole number,
    and its time per call is its mean record's time times that."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split, count = {}, {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.count:
            name = next((k for k, frag in kinds.items() if frag in e.key),
                        "other")
            launches = round(e.count / calls)
            split[name] = (split.get(name, 0.0) + e.self_device_time_total
                           / 1e3 / e.count * launches)
            count[name] = count.get(name, 0) + launches
    return split, count


def graph_node_counts(dot: str, kinds: dict) -> dict:
    """Nodes of a CUDA graph's DOT dump (cuGraphDebugDotPrint, verbose) by
    label: a kernel node by the first of ``kinds``' name fragments in its
    label, else "other"; any other node by its type in lower case
    ("memset", "memcpy", ...)."""
    import re
    count = {}
    for block in re.split(r'\n\s*"graph_\d+_node_\d+"\s*\[', "\n" + dot)[1:]:
        kind = re.search(r'label="\{(\w+)', block)
        if kind is None:
            raise AssertionError(f"CUDA graph node without a type: "
                                 f"{block[:200]!r}")
        name = (next((k for k, frag in kinds.items() if frag in block),
                     "other") if kind[1] == "KERNEL" else kind[1].lower())
        count[name] = count.get(name, 0) + 1
    return count


def graph_launches(fn, kinds) -> dict:
    """CUDA launches of one call of ``fn``, by label: the nodes of a CUDA
    graph captured from the call (``graph_node_counts``).  Unlike the
    profiler's records, which a window can lose, a captured graph holds
    every kernel and memset the call puts on its stream."""
    import ctypes
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "graph.dot"
        # the driver's cuGraphDebugDotPrint, CU_GRAPH_DEBUG_DOT_FLAGS_VERBOSE
        rc = ctypes.CDLL("libcuda.so.1").cuGraphDebugDotPrint(
            ctypes.c_void_p(g.raw_cuda_graph()), str(path).encode(),
            ctypes.c_uint(1))
        if rc:
            raise AssertionError(f"cuGraphDebugDotPrint returned {rc}")
        dot = path.read_text()
    del g
    count = graph_node_counts(dot, kinds)
    if not count:
        raise AssertionError(f"empty CUDA graph dump: {dot[:400]!r}")
    return count


def profile_matching(fn, kinds, want: dict, calls: int = 10,
                     windows: int = 3):
    """Device ms per call by CUDA kernel (``profile_split``) from the first
    of up to ``windows`` profiler windows whose launches per call equal
    ``want`` (the captured graph's count), else None: the profiler dropped
    records in every window, and the device ms are not measured."""
    for _ in range(windows):
        split, count = profile_split(fn, kinds, calls)
        if count == want:
            return split
    return None


def spmm_profile_split(sc, d, x, want: dict):
    """Device ms per application of each CUDA kernel one application
    launches (the row kernel and the long rows' reduction), or None where
    the profiler dropped records (``profile_matching``)."""
    return profile_matching(
        lambda: sc.KERNEL(d.indptr, d.src, d.w, x, pieces=d.pieces),
        SEGMENT_KINDS, want)


SEGMENT_KINDS = {"long_rows": "long_rows_kernel", "rows": "rows_kernel"}


def spmm_graph_launches(sc, d, x) -> dict:
    """CUDA launches of one application by CUDA kernel (captured graph)."""
    return graph_launches(
        lambda: sc.KERNEL(d.indptr, d.src, d.w, x, pieces=d.pieces),
        SEGMENT_KINDS)


def phase_slice(dev, tmp: Path) -> dict:
    import torch
    from importlib import import_module
    build = import_module(f"{PKG}.graph.build")
    cli = import_module(f"{PKG}.cli.main")
    presets = import_module(f"{PKG}.configs.presets")
    ckpt = import_module(f"{PKG}.train.checkpoint")
    trainer_mod = import_module(f"{PKG}.train.trainer")
    retrieval = import_module(f"{PKG}.eval.retrieval")
    sc = import_module(f"{PKG}.ops.spmm_cuda")

    t0 = time.perf_counter()
    graph = build.synthetic_bipartite_graph(**GRAPH)
    cred = np.random.default_rng(0).uniform(
        0.2, 1.0, graph.num_users).astype(np.float32)
    cfg = presets.get_preset("cu_message")
    prng = np.random.default_rng(0)
    params_np = {"user_emb": _xavier(prng, graph.num_users, cfg.emb_dim),
                 "item_emb": _xavier(prng, graph.num_items, cfg.emb_dim)}
    graph.save_npz(tmp / "graph.npz")
    np.save(tmp / "cred.npy", cred)
    np.savez(tmp / "best_model.npz", **params_np)
    setup_s = time.perf_counter() - t0

    cli.run(["merge-user-ids", "--npy", str(tmp / "cred.npy"),
              "--graph", str(tmp / "graph.npz"),
              "--out", str(tmp / "cred.csv"), "--device", str(dev)])
    # every trainer below reads the same CSV as the CLI's evaluate
    cfg = cfg.replace(cred_csv_path=str(tmp / "cred.csv"))
    base = ["evaluate", "--graph", str(tmp / "graph.npz"),
            "--params", str(tmp / "best_model.npz"), "--preset", "cu_message",
            "--cred", str(tmp / "cred.csv"), "--split", "test",
            "--device", str(dev)]

    # ---- phase 3: the main path, counted (every kernel's count) ----
    reset_counts()
    t1 = time.perf_counter()
    res_s = cli.run(base + ["eval_mode=sampled"])
    res_f = cli.run(base + ["eval_mode=full"])
    tr = trainer_mod.RecTrainer(cfg, graph, device=dev)
    params = ckpt.load_params_npz(tmp / "best_model.npz", device=dev)
    with torch.no_grad():
        user_emb, item_emb = tr.model.propagate(params)
    users = torch.as_tensor(tr.ctx.eval_users["test"][:512], device=dev)
    excl = torch.as_tensor(
        retrieval.exclusion_rows_for_users(graph, users.cpu().numpy()),
        device=dev)
    top_s, top_i = retrieval.topk_for_users(user_emb, item_emb, users, 20,
                                            exclude_batch_rows=excl)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t1
    n_prop = 3
    # 6 SpMM launches per propagate; one top-k select a batch of the full
    # evaluation and one for topk_for_users; no other kernel is on this path
    n_topk = full_eval_calls(graph, "test") + 1
    counts = read_counts({"segment_spmm": 6 * n_prop, "topk_select": n_topk},
                         "serving path")
    launches = counts["segment_spmm"]
    for K in res_f:
        for r in (res_s[K], res_f[K]):
            if not all(np.isfinite(r[m]) and 0.0 <= r[m] <= 1.0
                       for m in ("precision", "recall", "ndcg")):
                raise AssertionError(f"metric out of range: {r}")
    if top_i.shape != (users.numel(), 20) or not torch.isfinite(top_s).all():
        raise AssertionError("topk_for_users output malformed")
    seen = torch.zeros(users.numel(), graph.num_items + 1, dtype=torch.bool,
                       device=dev)
    seen.scatter_(1, excl.long(), True)
    if bool(seen.gather(1, top_i).any()):
        raise AssertionError("topk_for_users returned an excluded item")
    log(f"[phase 3] slice at reference scale ({graph.summary()}, cu_message "
        f"D={cfg.emb_dim} K={cfg.num_layers}): sampled R@20="
        f"{res_s[20]['recall']:.6f} full R@20={res_f[20]['recall']:.6f} "
        f"users={res_f[20]['users_eval']}; topk_for_users 512x20 ok; kernel "
        f"launches {launches} = 6 x {n_prop} propagates, topk_select "
        f"{counts['topk_select']} = {n_topk - 1} batches + 1; setup "
        f"{setup_s:.1f}s, path {main_s:.1f}s")

    # ---- phase 4: the plain path on the card ----
    cfg_t = cfg.replace(spmm_backend="torch")
    tr_t = trainer_mod.RecTrainer(cfg_t, graph, device=dev)
    before = sc.KERNEL.launches
    with torch.no_grad():
        u_t, i_t = tr_t.model.propagate(params)
    if not (_close(user_emb, u_t) and _close(item_emb, i_t)):
        raise AssertionError("propagated tables differ from the plain path")
    tab_err = max(float((user_emb - u_t).abs().max()),
                  float((item_emb - i_t).abs().max()))
    res_s_t = tr_t.evaluate(params, "test")
    full_t = trainer_mod.RecTrainer(cfg_t.replace(eval_mode="full"), graph,
                                    device=dev)
    res_f_t = full_t.evaluate(params, "test")
    if sc.KERNEL.launches != before:
        raise AssertionError("the plain path launched the kernel")
    err_s = _metrics_equal(res_s, res_s_t)
    err_f = _metrics_equal(res_f, res_f_t)
    _, top_t = retrieval.topk_for_users(u_t, i_t, users, 20,
                                        exclude_batch_rows=excl)
    a, b = top_i.cpu().numpy(), top_t.cpu().numpy()
    jac = np.array([len(set(x) & set(y)) / len(set(x) | set(y))
                    for x, y in zip(a, b)])
    if jac.mean() < 0.99:
        raise AssertionError(f"top-20 Jaccard {jac.mean()} < 0.99")
    log(f"[phase 4] vs plain path on the card: tables max abs diff "
        f"{tab_err:.3g} (tol {FP32_ATOL:g} + {FP32_RTOL:g}*|ref|), sampled "
        f"metrics diff {err_s:.3g}, full metrics diff {err_f:.3g} (tol 1e-6), "
        f"top-20 Jaccard mean {jac.mean():.6f} min {jac.min():.4f}")

    # ---- phase 5: times ----
    dirs = {"K1 item<-user": tr.model.item_from_user.fwd,
            "K2 user<-item": tr.model.user_from_item.fwd}
    tables = {"K1 item<-user": params["user_emb"],
              "K2 user<-item": params["item_emb"]}
    per_dir = []
    for role, d in dirs.items():
        x32 = tables[role].contiguous()
        xb = x32.to(torch.bfloat16)
        pc = d.pieces
        csr = torch.sparse_csr_tensor(d.indptr, d.src.long(), d.w,
                                      size=(d.num_dst, d.num_src))
        deg = d.indptr[1:] - d.indptr[:-1]
        entry = {"role": role, "num_dst": d.num_dst, "num_src": d.num_src,
                 "edges": int(d.src.numel()), "max_dst_degree": int(deg.max()),
                 "empty_dst_rows": int((deg == 0).sum()),
                 "long_row_edges": pc.edges_per_piece,
                 "long_rows": pc.num_long, "pieces": pc.num_pieces}
        # plain, kernel, kernel, plain: compare within one call
        p1 = cuda_time_ms(lambda: sc.segment_spmm_reference(
            d.indptr, d.src, d.w, x32), 20)
        k1 = cuda_time_ms(lambda: sc.KERNEL(d.indptr, d.src, d.w, x32,
                                            pieces=pc), 50)
        k2 = cuda_time_ms(lambda: sc.KERNEL(d.indptr, d.src, d.w, x32,
                                            pieces=pc), 50)
        p2 = cuda_time_ms(lambda: sc.segment_spmm_reference(
            d.indptr, d.src, d.w, x32), 20)
        entry["ms"] = min(k1, k2)
        entry["plain_ms"] = min(p1, p2)
        entry["library_ms"] = cuda_time_ms(lambda: torch.sparse.mm(csr, x32),
                                           20)
        entry["bound_ms"] = bound_ms(d, x32.shape[1], 4)
        entry["bound_share"] = entry["bound_ms"] / entry["ms"]
        entry["bf16_ms"] = cuda_time_ms(
            lambda: sc.KERNEL(d.indptr, d.src, d.w, xb, pieces=pc), 50)
        entry["bf16_plain_ms"] = cuda_time_ms(
            lambda: sc.segment_spmm_reference(d.indptr, d.src, d.w, xb), 20)
        entry["bf16_bound_ms"] = bound_ms(d, xb.shape[1], 2)
        entry["sweep"] = sweep_long_row_edges(sc, d, x32)
        # device time alone: back-to-back calls of a short kernel can be
        # held to the host's pace, which the events above then measure.
        # The row kernel, and the reduction when a row is long, counted in
        # a captured CUDA graph of one application; their device ms from
        # the profiler, whose windows may drop records (one of a run on the
        # H100 came back empty): a window is taken again, up to three, as
        # phase 10 does, else the device ms are not measured
        entry["cuda_launches_by_kernel"] = spmm_graph_launches(sc, d, x32)
        entry["cuda_launches_per_application"] = sum(
            entry["cuda_launches_by_kernel"].values())
        want = {"rows": 1, **({"long_rows": 1} if pc.num_long else {})}
        if entry["cuda_launches_by_kernel"] != want:
            raise AssertionError(
                f"{role}: {entry['cuda_launches_by_kernel']} CUDA launches "
                f"an application, {pc.num_long} long rows")
        entry["device_split_ms"] = spmm_profile_split(sc, d, x32, want)
        entry["device_ms"] = (None if entry["device_split_ms"] is None
                              else sum(entry["device_split_ms"].values()))
        entry["host_us_per_call"] = host_us_per_call(
            lambda: sc.KERNEL(d.indptr, d.src, d.w, x32, pieces=pc))
        per_dir.append(entry)
    split = per_dir[0]["device_split_ms"]
    with torch.no_grad():
        prop_ms = cuda_time_ms(lambda: tr.model.propagate(params), 10)
        prop_plain_ms = cuda_time_ms(lambda: tr_t.model.propagate(params), 5)
    full_k = trainer_mod.RecTrainer(cfg.replace(eval_mode="full"), graph,
                                    device=dev)
    evals = {}
    for name, t in (("sampled", tr), ("full", full_k)):
        t.evaluate(params, "test")
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        t.evaluate(params, "test")
        torch.cuda.synchronize()
        evals[name] = 1e3 * (time.perf_counter() - h0)
    log("[phase 5] times (ms): " + "; ".join(
        f"{e['role']} (L={e['long_row_edges']}: {e['long_rows']} long rows, "
        f"{e['pieces']} pieces, {e['cuda_launches_per_application']:g} CUDA "
        f"launches an application, captured graph) kernel {e['ms']:.4f} "
        f"plain "
        f"{e['plain_ms']:.4f} sparse.mm {e['library_ms']:.4f} bound {e['bound_ms']:.4f} "
        f"({100 * e['bound_share']:.1f}% of bound; device time "
        f"{_ms(e['device_ms'])}; wrapper host time "
        f"{e['host_us_per_call']:.1f}"
        f" us a call) | bf16 kernel "
        f"{e['bf16_ms']:.4f} plain {e['bf16_plain_ms']:.4f} bound "
        f"{e['bf16_bound_ms']:.4f} | L sweep " + ", ".join(
            f"{r['L']}: {r['ms']:.4f}" for r in e["sweep"])
        for e in per_dir)
        + f"; K1 by CUDA kernel (profiler, ms per apply) " + (
            "not measured" if split is None else ", ".join(
                f"{k} {v:.4f}" for k, v in split.items()))
        + f"; propagate kernel {prop_ms:.3f} plain {prop_plain_ms:.3f}; "
        f"evaluate sampled {evals['sampled']:.1f} full {evals['full']:.1f}")
    return {"launches": launches, "launches_by_kernel": counts,
            "directions": per_dir, "item_from_user_split_ms": split,
            "propagate_ms": prop_ms, "propagate_plain_ms": prop_plain_ms,
            "evaluate_ms": evals, "metrics_sampled": res_s,
            "metrics_full": res_f, "jaccard_mean": float(jac.mean()),
            "_ctx": {"graph": graph, "cfg": cfg, "params_np": params_np}}

# --------------------------------------------------------------------------
# phase 2b
# --------------------------------------------------------------------------

def _ulps(a, b) -> int:
    """Largest distance in units of the last place between two fp32
    tensors of one sign pattern (0 when bit-identical)."""
    import torch
    ia, ib = a.view(torch.int32).long(), b.view(torch.int32).long()
    return int((ia - ib).abs().max()) if a.numel() else 0


def _adam_leaf(dev, gen, shape, t: int, misaligned: bool = False) -> tuple:
    """A random (p, g, m, v) leaf of ``shape`` on ``dev`` with moments as
    at step ``t`` (zero at t = 1); ``misaligned``: views one float off
    16-byte alignment (the kernel's scalar body)."""
    import torch
    numel = int(np.prod(shape))
    base = [torch.randn(numel + 1, device=dev, generator=gen)
            for _ in range(4)]
    p, g, m, v = ((x[1:] if misaligned else x[:numel]).view(shape)
                  for x in base)
    g.mul_(1e-2)
    v.abs_().mul_(1e-4 if t > 1 else 0.0)
    m.mul_(1e-2 if t > 1 else 0.0)
    return p, g, m, v


def _adam_check(ac, leaves, a, b, launches: int, tag: str, worst: dict,
                max_ulp: int) -> None:
    """One call of the kernel over ``leaves`` (in place) against a second
    call on 16-byte aligned copies and the plain version: ``launches``
    launches, bit-identical calls, within ``max_ulp`` of the plain version
    (0: bit-equal)."""
    import torch
    ref = [tuple(x.clone() for x in leaf) for leaf in leaves]
    k2 = [tuple(x.clone() for x in leaf) for leaf in leaves]
    before = ac.KERNEL.launches
    ac.KERNEL(leaves, a, b)
    got = ac.KERNEL.launches - before
    if got != launches:
        raise AssertionError(f"{tag}: {got} launches, expected {launches}")
    ac.KERNEL(k2, a, b)
    ac.fused_adam_leaves_reference(ref, a, b)
    torch.cuda.synchronize()
    for j, (k1, kk, rr) in enumerate(zip(leaves, k2, ref)):
        for name, i in (("p", 0), ("m", 2), ("v", 3)):
            if not torch.equal(k1[i], kk[i]):
                raise AssertionError(f"{tag} leaf {j}: two launches differ in "
                                     f"{name}")
            if not torch.isfinite(k1[i]).all():
                raise AssertionError(f"{tag} leaf {j}: non-finite {name}")
            err = float((k1[i] - rr[i]).abs().max())
            ulp = _ulps(k1[i], rr[i])
            worst["max_abs_err"] = max(worst["max_abs_err"], err)
            worst["max_ulp"] = max(worst["max_ulp"], ulp)
            if ulp > max_ulp:
                raise AssertionError(f"{tag} leaf {j}: {name} differs from the "
                                     f"plain version by {ulp} ulp")


def phase_adam_vs_plain(dev) -> dict:
    import torch
    from importlib import import_module
    ac = import_module(f"{PKG}.ops.adam_cuda")
    adam = import_module(f"{PKG}.ops.adam")
    cm = import_module(f"{PKG}.models.cred_model")
    gen = torch.Generator(device=dev).manual_seed(0)
    tables = [(GRAPH["num_users"], 64), (GRAPH["num_items"], 64)]
    shapes = tables + [(1, 1), (1001, 3), (4099,)]
    # Stage A's ten leaves: 7 user and 2 item features, hidden 64
    stage_a = [tuple(p.shape) for p in cm.init_cred_params(
        torch.Generator(device=dev).manual_seed(0), 7, 2, 64).values()]
    worst = {"max_abs_err": 0.0, "max_ulp": 0}
    n = 0
    for t in (1, 1000):
        a, b = adam.adam_scalars(t, 1e-3)
        # one leaf a launch; the last shape is a 1-D view one float off
        # 16-byte alignment (the kernel's scalar body)
        for shape in shapes:
            leaf = _adam_leaf(dev, gen, shape, t, misaligned=len(shape) == 1)
            _adam_check(ac, [leaf], a, b, 1, f"adam {shape} t={t}", worst, 2)
            n += 1
        # lists in one launch, and a list longer than MAX_LEAVES
        lists = {
            "stage_a": [_adam_leaf(dev, gen, s, t) for s in stage_a],
            "stage_b": [_adam_leaf(dev, gen, s, t) for s in tables],
            "stage_a+misaligned+stage_b":
                [_adam_leaf(dev, gen, s, t) for s in stage_a]
                + [_adam_leaf(dev, gen, (1001, 3), t, misaligned=True)]
                + [_adam_leaf(dev, gen, s, t) for s in tables],
            "70 leaves": [_adam_leaf(dev, gen, (1 + i % 13, 5), t,
                                     misaligned=i % 5 == 0)
                          for i in range(70)]}
        for name, leaves in lists.items():
            launches = -(-len(leaves) // ac.MAX_LEAVES)
            _adam_check(ac, leaves, a, b, launches,
                        f"adam list {name} t={t}", worst, 0)
            n += 1
    log(f"[phase 2b] fused Adam kernel vs plain: {n} cases (single leaves "
        f"{shapes}, the last a misaligned view; lists in one launch: Stage "
        f"A's ten leaves, both tables, Stage A + a misaligned leaf + both "
        f"tables; 70 leaves in {-(-70 // ac.MAX_LEAVES)} launches; t "
        f"1/1000) ok, bit-identical reruns, every list bit-equal to the plain "
        f"version; bit-identical to the plain version: {worst['max_ulp'] == 0} "
        f"(max {worst['max_ulp']} ulp, max abs err {worst['max_abs_err']:.3g})")
    return worst


# --------------------------------------------------------------------------
# phases 6-8: training
# --------------------------------------------------------------------------

def phase_train(dev, tmp: Path, ctx: dict) -> dict:
    import torch
    from importlib import import_module
    cli = import_module(f"{PKG}.cli.main")
    graph, cfg = ctx["graph"], ctx["cfg"]
    K = cfg.num_layers
    n_train = int((graph.user_csr("train").degrees() > 0).sum())
    nb = -(-n_train // cfg.batch_size)
    n_evals = TRAIN_EPOCHS // cfg.eval_every + 1      # val per epoch + test
    out = tmp / "rec"

    # ---- the main path, counted (every kernel's count) ----
    reset_counts()
    t0 = time.perf_counter()
    res = cli.run(["train-rec", "--graph", str(tmp / "graph.npz"),
                   "--preset", "cu_message", "--cred", str(tmp / "cred.csv"),
                   "--out", str(out), "--checkpoint", "--device", str(dev),
                   f"epochs={TRAIN_EPOCHS}"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # segment_spmm: 4K per step x nb steps x epochs + 2K per evaluation;
    # gather_backward: K+1 user and K+1 item gathers of the propagation and
    # the two ego gathers a step; fused_adam: 1 per step (both tables in one
    # launch); no other kernel is on this path
    counts = read_counts(
        {"segment_spmm": 4 * K * nb * TRAIN_EPOCHS + 2 * K * n_evals,
         "gather_backward": (2 * K + 4) * nb * TRAIN_EPOCHS,
         "fused_adam": nb * TRAIN_EPOCHS}, "training path")
    spmm_n, adam_n = counts["segment_spmm"], counts["fused_adam"]
    gather_n = counts["gather_backward"]

    losses = [h.loss for h in res.history]
    if len(losses) != TRAIN_EPOCHS or not all(np.isfinite(losses)):
        raise AssertionError(f"epoch losses {losses}")
    for name in ("best_model.npz", "test_metrics.json", "metrics.jsonl"):
        if not (out / name).is_file():
            raise AssertionError(f"train-rec wrote no {name}")
    if not any((out / "ckpt").glob("*.pt")):
        raise AssertionError("train-rec wrote no checkpoint")
    written = json.loads((out / "test_metrics.json").read_text())
    with np.load(out / "best_model.npz") as z:
        shapes = {k: z[k].shape for k in z.files}
    if shapes != {"user_emb": (graph.num_users, cfg.emb_dim),
                  "item_emb": (graph.num_items, cfg.emb_dim)}:
        raise AssertionError(f"best_model.npz holds {shapes}")
    ev = cli.run(["evaluate", "--graph", str(tmp / "graph.npz"),
                  "--params", str(out / "best_model.npz"),
                  "--preset", "cu_message", "--cred", str(tmp / "cred.csv"),
                  "--split", "test", "--device", str(dev)])
    err = _metrics_equal({int(k): v for k, v in written.items()}, ev)
    log(f"[phase 6] train-rec at reference scale (cu_message D={cfg.emb_dim} "
        f"K={K} batch {cfg.batch_size}: {nb} steps per epoch): "
        f"{TRAIN_EPOCHS} epochs in {wall:.1f}s, epoch losses "
        f"{[round(x, 6) for x in losses]}, epoch seconds "
        f"{[round(h.seconds, 3) for h in res.history]}, best val "
        f"R@{max(cfg.Ks)} {res.best_val_recall:.6f}, test R@20 "
        f"{written['20']['recall']:.6f}; launches segment_spmm {spmm_n} = "
        f"{4 * K} x {nb} x {TRAIN_EPOCHS} + {2 * K} x {n_evals}, "
        f"gather_backward {gather_n} = {2 * K + 4} x {nb} x {TRAIN_EPOCHS}, "
        f"fused_adam {adam_n} = 1 x {nb} x {TRAIN_EPOCHS}; evaluate on "
        f"best_model.npz reproduces test_metrics.json (diff {err:.3g})")
    return {"launches": {"segment_spmm": spmm_n, "gather_backward": gather_n,
                         "fused_adam": adam_n},
            "launches_by_kernel": counts,
            "steps_per_epoch": nb, "epoch_losses": losses,
            "epoch_seconds": [h.seconds for h in res.history],
            "train_rec_wall_s": wall, "best_val_recall": res.best_val_recall,
            "test_metrics": written}


def _params(ctx, dev):
    import torch
    return {k: torch.as_tensor(v, device=dev).clone()
            for k, v in ctx["params_np"].items()}


def phase_train_parity(dev, tmp: Path, ctx: dict):
    import torch
    from importlib import import_module
    trainer_mod = import_module(f"{PKG}.train.trainer")
    adam = import_module(f"{PKG}.ops.adam")
    graph = ctx["graph"]
    cfg = ctx["cfg"]
    tr_k = trainer_mod.RecTrainer(cfg, graph, device=dev, verbose=False)
    tr_p = trainer_mod.RecTrainer(cfg.replace(spmm_backend="torch"), graph,
                                  device=dev, verbose=False)
    gen = torch.Generator(device=dev).manual_seed(0)
    users, pos, neg, mask = tr_k.draw_epoch(gen)
    # the plans do not depend on the backend: both paths take the same
    plans = tr_k.step_plans(users, pos, neg)
    batches = [(users[s], pos[s], neg[s], mask[s], None, plans[s]) for s in
               (i % users.shape[0] for i in range(PARITY_STEPS))]

    def run(tr):
        params = _params(ctx, dev)
        opt = adam.adam_init(params)
        losses = torch.stack([tr.train_step(params, opt, *b)
                              for b in batches])
        torch.cuda.synchronize()
        return params, losses

    before = _counts_now()
    pk, lk = run(tr_k)
    _launched(before, {"segment_spmm": 4 * cfg.num_layers * PARITY_STEPS,
                       "gather_backward":
                           (2 * cfg.num_layers + 4) * PARITY_STEPS,
                       "fused_adam": PARITY_STEPS}, "the kernel path")
    before = _counts_now()
    pp, lp = run(tr_p)
    _launched(before, {}, "the plain path")
    pk2, lk2 = run(tr_k)
    loss_err, p_err, _ = _held(pk, lk, {"params": pp, "losses": lp},
                               "the kernel path against the plain path")
    moved = min(float((pk[k] - torch.as_tensor(ctx["params_np"][k],
                                               device=dev)).abs().max())
                for k in pk)
    bit = torch.equal(lk, lk2) and all(torch.equal(pk[k], pk2[k]) for k in pk)
    if not bit:
        raise AssertionError("two kernel-path runs are not bit-identical")
    log(f"[phase 7] {PARITY_STEPS} train steps, kernel path vs plain path on "
        f"the card: losses {[round(float(x), 7) for x in lk]} max diff "
        f"{loss_err:.3g} (tol {LOSS_ATOL:g}); params max abs diff "
        f"{p_err:.3g} (tol {TRAIN_ATOL:g} + {TRAIN_RTOL:g}*|ref|; the "
        f"smallest table moved by {moved:.3g}); two kernel-path runs "
        f"bit-identical: {bit}")
    return {"loss_max_diff": loss_err, "param_max_diff": p_err,
            "bit_identical": bit, "_trainer": tr_k,
            "_ref": {"params": pk, "losses": lk, "batches": batches}}


def step_split(loss_of, params, opt, lr: float, n: int) -> dict:
    """One train step split into forward+loss, backward and Adam (CUDA
    events), averaged over ``n`` steps; ``loss_of(leaves, j)`` is step
    ``j``'s loss of the parameter leaves."""
    import torch
    from importlib import import_module
    trainer_mod = import_module(f"{PKG}.train.trainer")
    adam = import_module(f"{PKG}.ops.adam")
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
          for _ in range(n)]
    adam_host = 0.0               # host seconds inside adam_step
    for j, e in enumerate(ev):
        with trainer_mod.deterministic_algorithms():
            e[0].record()
            leaves = {k: p.detach().requires_grad_() for k, p in
                      params.items()}
            loss = loss_of(leaves, j)
            e[1].record()
            grads = torch.autograd.grad(loss, list(leaves.values()))
            e[2].record()
            h0 = time.perf_counter()
            adam.adam_step(params, dict(zip(leaves, grads)), opt, lr)
            adam_host += time.perf_counter() - h0
            e[3].record()
    torch.cuda.synchronize()
    return {**{name: sum(e[i].elapsed_time(e[i + 1]) for e in ev) / n
               for i, name in enumerate(("forward_loss", "backward", "adam"))},
            "adam_host_ms": 1e3 * adam_host / n}


def profile_steps(step, n: int = 3) -> dict:
    """Where the device time of a step goes: device busy share and device
    time by kernel (profiler) over a window of ``n`` calls of ``step(j)``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        for j in range(n):
            step(j)
        torch.cuda.synchronize()
        window_ms = 1e3 * (time.perf_counter() - h0)
    by_kernel, host = {}, {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            by_kernel[e.key[:60]] = (by_kernel.get(e.key[:60], 0.0)
                                     + e.self_device_time_total / 1e3)
        else:
            host[e.key[:60]] = e.self_cpu_time_total / 1e3
    device_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    # the host's side: self CPU ms by operator (the profiler's own cost
    # included), what a host-bound step spends its time on
    top_host = sorted(host.items(), key=lambda kv: -kv[1])[:12]
    # ATen's sorted index_put_ backward of a stock row gather
    stock = sum(v for k, v in by_kernel.items() if "indexing_backward" in k)
    return {"window_steps": n, "window_ms": window_ms, "device_ms": device_ms,
            "busy_share": device_ms / window_ms, "top_kernels_ms": dict(top),
            "top_host_ops_ms": dict(top_host),
            "indexing_backward_ms": stock}


def time_direction(role: str, d, x) -> dict:
    """One SpMM direction at ``x``'s shape: the kernel (plain, kernel,
    kernel, plain, best of each), ``torch.sparse.mm`` and the bound."""
    import torch
    from importlib import import_module
    sc = import_module(f"{PKG}.ops.spmm_cuda")
    csr = torch.sparse_csr_tensor(d.indptr, d.src.long(), d.w,
                                  size=(d.num_dst, d.num_src))
    deg = d.indptr[1:] - d.indptr[:-1]
    p1 = cuda_time_ms(lambda: sc.segment_spmm_reference(
        d.indptr, d.src, d.w, x), 20)
    k1 = cuda_time_ms(lambda: sc.KERNEL(d.indptr, d.src, d.w, x,
                                        pieces=d.pieces), 30)
    k2 = cuda_time_ms(lambda: sc.KERNEL(d.indptr, d.src, d.w, x,
                                        pieces=d.pieces), 30)
    p2 = cuda_time_ms(lambda: sc.segment_spmm_reference(
        d.indptr, d.src, d.w, x), 20)
    return {"role": role, "num_dst": d.num_dst, "num_src": d.num_src,
            "edges": int(d.src.numel()), "max_dst_degree": int(deg.max()),
            "long_rows": d.pieces.num_long, "pieces": d.pieces.num_pieces,
            "ms": min(k1, k2), "plain_ms": min(p1, p2),
            "library_ms": cuda_time_ms(lambda: torch.sparse.mm(csr, x), 20),
            "bound_ms": bound_ms(d, x.shape[1], 4)}


def time_adam(params: dict, ab: tuple, lr: float, gen) -> dict:
    """The Adam kernel over ``params`` in one call, as a step runs it (one
    launch: plain, kernel, kernel, plain, CUDA events around a loop of
    calls, the host's issue included), its device time per call (the calls
    queued ahead of the card) and the host's microseconds a call of the
    wrapper and of ``ops/adam.adam_step``; ``torch.optim.Adam(fused=True)``
    over the same leaves (one call) as the yardstick, with its device time;
    the bound."""
    import torch
    from importlib import import_module
    tm = import_module(f"{PKG}.probes._timing")
    ac = import_module(f"{PKG}.ops.adam_cuda")
    a, b = ab
    state = []
    for p0 in params.values():
        p = p0.detach().clone()
        state.append((p, torch.randn(p.shape, device=p.device,
                                     generator=gen) * 1e-3,
                      torch.zeros_like(p), torch.zeros_like(p)))
    dev = state[0][0].device

    def run_k():
        ac.KERNEL(state, a, b)

    def run_p():
        ac.fused_adam_leaves_reference(state, a, b)

    before = ac.KERNEL.launches
    run_k()
    launches = ac.KERNEL.launches - before
    # the host's side: the kernel's wrapper alone, and ops/adam.adam_step
    # (the step's scalars, its leaf list, the wrapper) over the same leaves
    adam = import_module(f"{PKG}.ops.adam")
    names = [str(i) for i in range(len(state))]
    opt = adam.AdamState(m={k: t[2] for k, t in zip(names, state)},
                         v={k: t[3] for k, t in zip(names, state)})
    host_us = {"kernel_call": host_us_per_call(run_k),
               "adam_step": host_us_per_call(lambda: adam.adam_step(
                   {k: t[0] for k, t in zip(names, state)},
                   {k: t[1] for k, t in zip(names, state)}, opt, lr))}
    p1 = cuda_time_ms(run_p, 10)
    k1 = cuda_time_ms(run_k, 30)
    k2 = cuda_time_ms(run_k, 30)
    p2 = cuda_time_ms(run_p, 10)
    qs = []
    for p, g, _, _ in state:
        q = p.clone().requires_grad_()
        q.grad = g.clone()
        qs.append(q)
    lib = torch.optim.Adam(qs, lr=lr, fused=True)
    numel = sum(p.numel() for p, _, _, _ in state)
    return {"shape": [list(p.shape) for p, _, _, _ in state]
            if len(state) > 1 else list(state[0][0].shape),
            "launches_per_call": launches, "host_us": host_us,
            "ms": min(k1, k2), "plain_ms": min(p1, p2),
            "device_ms": tm.queued_device_ms(run_k, dev, 20),
            "library_ms": cuda_time_ms(lib.step, 30),
            "library_device_ms": tm.queued_device_ms(lib.step, dev, 20),
            "bound_ms": tm.bound_ms(ADAM_BYTES * numel, ADAM_FLOPS * numel)}


def _adam_line(tag: str, e: dict) -> str:
    host = e["host_us"]
    return (f"Adam {tag} kernel {e['ms']:.4f} ({e['launches_per_call']} "
            f"launch, device {e['device_ms']:.4f}; host us a call: wrapper "
            f"{host['kernel_call']:.1f}, adam_step {host['adam_step']:.1f}) "
            f"plain {e['plain_ms']:.4f} optim.Adam(fused) "
            f"{e['library_ms']:.4f} (device {e['library_device_ms']:.4f}) "
            f"bound {e['bound_ms']:.4f}")


def phase_train_times(dev, ctx: dict, tr) -> dict:
    import torch
    from importlib import import_module
    adam = import_module(f"{PKG}.ops.adam")
    cfg = tr.cfg
    params = _params(ctx, dev)
    opt = adam.adam_init(params)
    gen = torch.Generator(device=dev).manual_seed(1)
    users, pos, neg, mask = tr.draw_epoch(gen)
    nb = users.shape[0]
    plans = tr.step_plans(users, pos, neg)
    batches = [(users[s], pos[s], neg[s], mask[s], None, plans[s])
               for s in range(nb)]

    # one step split into forward+loss, backward, Adam (CUDA events), over
    # an epoch's batches after two warm-up steps
    for b in batches[:2]:
        tr.train_step(params, opt, *b)
    split = step_split(lambda leaves, j: tr._loss_fn(leaves, *batches[j]),
                       params, opt, cfg.lr, nb)
    step_ms = cuda_time_ms(lambda: tr.train_step(params, opt, *batches[0]), 10,
                           warmup=2)

    # each backward SpMM direction (the transposes), at the cotangent's shape
    bwd = [time_direction(role, d, torch.randn(d.num_src, cfg.emb_dim,
                                               device=dev, generator=gen))
           for role, d in (("bwd of item<-user (user-row shape)",
                            tr.model.item_from_user.bwd),
                           ("bwd of user<-item (item-row shape, hub)",
                            tr.model.user_from_item.bwd))]

    # a step's two gather plans (step 0: its users, its positives and
    # negatives)
    gathers = [time_gather(role, p, idx, cfg.emb_dim, gen)
               for role, p, idx in (
                   ("stage_b users", plans[0][0], users[0]),
                   ("stage_b items (hub)", plans[0][1],
                    torch.cat([pos[0], neg[0]])))]

    # the Adam kernel per table and on both tables in one launch (as a step
    # runs it) against its plain version, torch.optim.Adam(fused=True) and
    # its bound
    ab = adam.adam_scalars(10, cfg.lr)
    leaves = [dict(leaf=name, **time_adam({name: p0}, ab, cfg.lr, gen))
              for name, p0 in params.items()]
    adam_pair = dict(leaf="both tables", **time_adam(params, ab, cfg.lr, gen))

    # where the device time of a step goes: a profiled window of 3 steps
    profile_out = profile_steps(
        lambda j: tr.train_step(params, opt, *batches[2 + j]))
    if profile_out["indexing_backward_ms"]:
        raise AssertionError(f"the Stage-B step ran ATen's indexing "
                             f"backward: {profile_out['top_kernels_ms']}")

    # the cold start of a fresh process: the first call of
    # torch.use_deterministic_algorithms (which imports torch._inductor; the
    # trainer sets ATen's switch instead), then the first and second stock
    # deterministic row-gather backward (sorted index_put_, which the step
    # no longer runs) at a step's shapes
    code = ("import json, time, torch; d = torch.device('cuda', 0); "
            f"x = torch.randn({GRAPH['num_items']}, {cfg.emb_dim}, device=d, "
            "requires_grad=True); "
            f"i = torch.randint(0, {GRAPH['num_items']}, "
            f"(2 * {cfg.batch_size},), device=d); "
            "torch.cuda.synchronize(); t = time.perf_counter(); "
            "torch.use_deterministic_algorithms(True); "
            "out = [1e3 * (time.perf_counter() - t)]\n"
            "for _ in range(2):\n"
            "    torch.cuda.synchronize(); t = time.perf_counter(); "
            "torch.autograd.grad(x[i].sum(), [x]); torch.cuda.synchronize(); "
            "out.append(1e3 * (time.perf_counter() - t))\n"
            "print(json.dumps(out))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, check=True, timeout=300)
    cold = json.loads(proc.stdout.strip().splitlines()[-1])

    # one epoch, host clock: the draw (sampling) and the 15 steps
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    ep_batches = tr.draw_epoch(gen)
    torch.cuda.synchronize()
    h1 = time.perf_counter()
    loss = float(tr.run_epoch(params, opt, ep_batches).mean().item())
    h2 = time.perf_counter()
    if not np.isfinite(loss):
        raise AssertionError(f"epoch loss {loss}")
    out = {"step_ms": step_ms, "step_split_ms": split, "steps_per_epoch": nb,
           "gather_backward": gathers,
           "epoch_draw_ms": 1e3 * (h1 - h0), "epoch_steps_ms": 1e3 * (h2 - h1),
           "epoch_ms": 1e3 * (h2 - h0), "profile": profile_out,
           "cold_start_ms": dict(zip(("use_deterministic_algorithms",
                                      "gather_backward_first",
                                      "gather_backward_second"), cold)),
           "backward_directions": bwd,
           "adam_leaves": leaves, "adam_pair": adam_pair}
    log("[phase 8] times (ms): train step " + f"{step_ms:.3f} (forward+loss "
        f"{split['forward_loss']:.3f}, backward {split['backward']:.3f}, "
        f"Adam {split['adam']:.3f}, its host {split['adam_host_ms']:.3f}); "
        + "; ".join(
            f"{e['role']} kernel {e['ms']:.4f} plain {e['plain_ms']:.4f} "
            f"sparse.mm {e['library_ms']:.4f} bound {e['bound_ms']:.4f}"
            for e in bwd) + "; " + _gather_line(gathers) + "; " + "; ".join(
            _adam_line(f"{e['leaf']} {tuple(e['shape'])}", e)
            for e in leaves + [adam_pair])
        + f"; epoch {out['epoch_ms']:.1f} (draw {out['epoch_draw_ms']:.1f}, "
        f"{nb} steps {out['epoch_steps_ms']:.1f}); profiled 3 steps: device "
        f"busy {profile_out['device_ms']:.2f} of "
        f"{profile_out['window_ms']:.2f} ms "
        f"({100 * profile_out['busy_share']:.1f}%), by kernel "
        + ", ".join(f"{k} {v:.2f}"
                    for k, v in profile_out["top_kernels_ms"].items())
        + f"; no indexing_backward_kernel; fresh process: first "
        f"torch.use_deterministic_algorithms {cold[0]:.1f} ms, stock "
        f"deterministic gather backward first {cold[1]:.1f} ms, second "
        f"{cold[2]:.2f} ms")
    return out


# --------------------------------------------------------------------------
# phases 9-10: the chunked SpMM layouts and the slab gather (probe kernels)
# --------------------------------------------------------------------------

# (label, block rows R, chunk edges T, window W, local-id dtype name)
CHUNK_LAYOUTS = [("block", 512, 256, 0, "int32"), ("i16", 512, 256, 0, "int16"),
                 ("win64", 512, 256, 64, "int32"),
                 ("win128", 512, 256, 128, "int32"),
                 ("win256", 512, 256, 256, "int32"),
                 ("block_small", 64, 32, 0, "int32"),
                 ("win_small", 64, 32, 16, "int32"),
                 ("block_t1024", 512, 1024, 0, "int32"),
                 ("win_t1024", 512, 1024, 64, "int32"),
                 # T not a multiple of 4: the plan is loaded by the threads
                 ("block_t30", 64, 30, 0, "int32"),
                 ("win_t30", 64, 30, 16, "int32"),
                 # T = 36: a bulk plan load with int32 ids, the threads'
                 # with int16 ones (bulk needs T a multiple of 8 there)
                 ("block_t36", 64, 36, 0, "int32"),
                 ("i16_small", 64, 32, 0, "int16"),
                 ("i16_t1024", 512, 1024, 0, "int16"),
                 ("i16_t36", 64, 36, 0, "int16"),
                 ("i16_t30", 64, 30, 0, "int16")]
# the widths and tables beyond the D 8/64/128 sweep: D=63 and a table one
# float off 16-byte alignment take the staged kernel's 4-byte copies, D=256
# its four column tiles; on these graphs and layouts
CHUNK_WIDE_GRAPHS = ("zipf_hub", "inf_row0", "hub_block")
CHUNK_WIDE_LAYOUTS = ("block", "i16", "win64", "block_small", "win_small",
                      "block_t1024", "block_t36", "i16_small", "i16_t1024",
                      "i16_t36", "i16_t30")
CHUNK_HUB_CHUNKS = 80         # the hub block must span more chunks than this
CHUNK_KERNEL = {"int32": "chunk_spmm_block", "int16": "chunk_spmm_i16",
                "window": "chunk_spmm_window"}
GATHER_SIZES = (512, 2048, 8192, 16384)     # the JAX probe's slabs
GATHER_SMEM_MAX = 768         # the largest slab of the shared-memory route
GATHER_STEPS = 64


def _chunk_check(cs, plan, x, lid, tag, worst) -> None:
    """Kernel against the plain version on the card (fp32 bound: a bf16
    table's products are exact in fp32 and summed in fp32), two launches
    bit-identical, pad and empty rows zero, and bit-equal to the plain
    version's sequential CPU sum (runs in edge order, then chunk partials in
    chunk order: the order the kernel follows, with no atomics)."""
    import dataclasses
    import torch
    y1 = cs.chunk_spmm_blocks(plan, x, lid)
    y2 = cs.chunk_spmm_blocks(plan, x, lid)
    ref = cs.chunk_spmm_reference(plan, x)
    mag = cs.chunk_spmm_reference(
        dataclasses.replace(plan, w_padded=plan.w_padded.abs(), _cache={}),
        x.abs())
    torch.cuda.synchronize()
    if not torch.equal(y1, y2):
        raise AssertionError(f"{tag}: two launches differ")
    if y1.shape != (plan.num_blocks * plan.block_rows, x.shape[1]):
        raise AssertionError(f"{tag}: wrong output shape {tuple(y1.shape)}")
    if not torch.isfinite(y1).all():
        raise AssertionError(f"{tag}: non-finite output (a pad edge read?)")
    diff = (y1 - ref).abs()
    if bool((diff > FP32_ATOL + FP32_RTOL * mag).any()):
        raise AssertionError(f"{tag}: kernel disagrees with the plain "
                             f"version, max {float(diff.max())}")
    if bool((y1[mag.abs().sum(1) == 0] != 0).any()):
        raise AssertionError(f"{tag}: a row no edge reaches is not zero")
    name = CHUNK_KERNEL["window" if plan.window else
                        ("int16" if lid == torch.int16 else "int32")]
    name += " bf16" if x.dtype == torch.bfloat16 else ""
    worst[name] = max(worst.get(name, 0.0),
                      float(diff.max()) if diff.numel() else 0.0)
    cpu = dataclasses.replace(plan, _cache={}, **{
        f: (None if getattr(plan, f) is None else getattr(plan, f).cpu())
        for f in ("src_padded", "w_padded", "local_ids", "block_id",
                  "first_chunk", "win_start")})
    if not torch.equal(y1.cpu(), cs.chunk_spmm_reference(cpu, x.cpu())):
        raise AssertionError(f"{tag}: not bit-equal to the plain version's "
                             f"sequential CPU sum")


def phase_chunk_vs_plain(dev, dirs) -> dict:
    import torch
    from importlib import import_module
    cs = import_module(f"{PKG}.ops.chunk_spmm")
    sp = import_module(f"{PKG}.ops.segment_plan")
    rg = import_module(f"{PKG}.ops.row_gather")
    rgc = import_module(f"{PKG}.ops.row_gather_cuda")
    wk = import_module(f"{PKG}.probes.window_kernel")
    vg = import_module(f"{PKG}.probes.vmem_gather")
    rng = np.random.default_rng(0)
    worst = {k: 0.0 for k in CHUNK_KERNEL.values()}
    n = 0
    cases = _cases(rng)
    E = 30_000
    cases["inf_row0"] = (rng.integers(1, 5_000, E), rng.integers(0, 3_000, E),
                         rng.normal(size=E), 5_000, 3_000)
    # one row holding 3/4 of 40,000 edges: its block spans 117 chunks of 256
    # (938 of 32), so its carries are summed over many slot tiles
    E = 40_000
    cases["hub_block"] = (rng.integers(0, 5_000, E),
                          np.where(rng.random(E) < 0.75, 700,
                                   rng.integers(0, 2_000, E)),
                          rng.normal(size=E), 5_000, 2_000)
    hub_chunks = 0
    wide = bf16_cases = 0
    for name, (src, dst, w, ns, nd) in cases.items():
        o = np.argsort(dst, kind="stable")
        src, dst, w = (np.asarray(src, np.int32)[o], np.asarray(dst, np.int64)[o],
                       np.asarray(w, np.float32)[o])
        for label, R, T, W, lid in CHUNK_LAYOUTS:
            plan = sp.build_segment_plan(src, dst, w, nd, block_rows=R,
                                         chunk_edges=T, num_src=ns, window=W,
                                         device=dev)
            if name == "hub_block" and label == "block":
                hub_chunks = int(torch.bincount(plan.block_id).max())
                if hub_chunks <= CHUNK_HUB_CHUNKS:
                    raise AssertionError(f"hub block spans {hub_chunks} "
                                         f"chunks, not > {CHUNK_HUB_CHUNKS}")
            f32, b16 = torch.float32, torch.bfloat16
            widths = [(D, True, f32) for D in (8, 64, 128)]
            if name in CHUNK_WIDE_GRAPHS and label in CHUNK_WIDE_LAYOUTS:
                widths += [(63, True, f32), (256, True, f32), (64, False, f32)]
                if lid == "int32":    # bf16 tables: P1 and P3
                    widths += [(64, True, b16), (63, True, b16),
                               (256, True, b16), (64, False, b16)]
            for D, aligned, dt in widths:
                if aligned:
                    x = torch.randn(ns, D, device=dev).to(dt)
                else:   # one value off the 4-value alignment
                    x = torch.randn(ns * D + 1, device=dev).to(dt)[1:]
                    x = x.view(ns, D)
                if name == "inf_row0":
                    x[0] = float("inf")
                _chunk_check(cs, plan, x, getattr(torch, lid),
                             f"{name} {label} D={D} {dt}"
                             + ("" if aligned else " misaligned"), worst)
                n += 1
                wide += (D, aligned, dt) not in ((8, True, f32),
                                                 (64, True, f32),
                                                 (128, True, f32))
                bf16_cases += dt == b16
    # the reference graph, both directions, and a K=3 padded chain
    for name, d in dirs.items():
        for label, R, T, W, lid in CHUNK_LAYOUTS[:5]:
            plan = wk.plan_for(d, dev, chunk_edges=T, window=W)
            _chunk_check(cs, plan, d["x"], getattr(torch, lid),
                         f"{name} {label}", worst)
            n += 1
    iu, ui = dirs["items<-users"], dirs["users<-items"]
    p_iu, p_ui = wk.plan_for(iu, dev), wk.plan_for(ui, dev)
    lay_u = sp.PadLayout(ui["num_dst"], p_ui.num_blocks * p_ui.block_rows)
    lay_i = sp.PadLayout(iu["num_dst"], p_iu.num_blocks * p_iu.block_rows)
    u0 = torch.randn(lay_u.rows, 64, device=dev)
    i0 = torch.randn(lay_i.rows, 64, device=dev)
    u, i = lay_u.to_padded(u0), lay_i.to_padded(i0)
    cu, ci = u0, i0
    c_iu, c_ui = iu["csr"], ui["csr"]
    sc = import_module(f"{PKG}.ops.spmm_cuda")
    for layer in range(3):
        i = cs.apply_chunked_padded(p_iu, u)
        u = cs.apply_chunked_padded(p_ui, i)
        ci = sc.segment_spmm(c_iu.indptr, c_iu.src, c_iu.w, cu,
                             pieces=c_iu.pieces)
        cu = sc.segment_spmm(c_ui.indptr, c_ui.src, c_ui.w, ci,
                             pieces=c_ui.pieces)
        if bool((u[lay_u.rows:] != 0).any() or (i[lay_i.rows:] != 0).any()):
            raise AssertionError(f"padded chain layer {layer}: a pad row is "
                                 f"not zero")
        # each layer sums thousands of positive-weighted terms in another
        # order: the bound is relative to the layer's largest value
        for got, want in ((lay_u.from_padded(u), cu),
                          (lay_i.from_padded(i), ci)):
            if float((got - want).abs().max()) > \
                    FP32_ATOL + FP32_RTOL * float(want.abs().max()):
                raise AssertionError(
                    f"padded chain layer {layer} differs from the CSR chain "
                    f"by {float((got - want).abs().max())}")
    chain_err = max(float((lay_u.from_padded(u) - cu).abs().max()),
                    float((lay_i.from_padded(i) - ci).abs().max()))
    # a plan stage or row buffer reused before every warp is done with it
    # shows only when a warp lags: make warps lag and hold the sums
    t = time.perf_counter()
    race = import_module(f"{PKG}.probes.chunk_race").run(dev)
    for v, r in race["variants"].items():
        if r["differs"]:
            raise AssertionError(f"chunk kernel with lagging warps ({v}): "
                                 f"not bit-equal to the CPU sum on "
                                 f"{', '.join(r['differs'])}")
    race["seconds"] = time.perf_counter() - t
    log(f"[phase 9] chunked kernels vs plain: {n} cases ok "
        f"({len(cases)} graphs x {len(CHUNK_LAYOUTS)} layouts "
        f"(T 30/32/36/256/1024, int32 and int16 ids) "
        f"x D 8/64/128; {wide} cases at D 63/256 and a misaligned D=64 table "
        f"and {bf16_cases} with bf16 tables (D 64/63/256 and a misaligned "
        f"D=64, int32 layouts) on {'/'.join(CHUNK_WIDE_GRAPHS)} x "
        f"{'/'.join(CHUNK_WIDE_LAYOUTS)}; a hub block of {hub_chunks} "
        f"chunks; the reference graph x 5 "
        f"layouts x 2 directions), bit-identical reruns, inf in source row 0 "
        f"never read, untouched and pad rows zero; max abs err "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
        + f" (tol {FP32_ATOL:g} + {FP32_RTOL:g}*sum|w*x|), every case "
        f"bit-equal to the plain version's sequential CPU sum; K=3 padded "
        f"chain: pad rows zero, max diff from the CSR chain {chain_err:.3g}")
    log(f"[phase 9] chunk kernel with lagging warps ({race['lag_ns']} ns "
        f"sleeps): " + "; ".join(f"{v} {r['cases']} cases bit-equal"
                                 for v, r in race["variants"].items())
        + f" ({race['seconds']:.1f}s)")

    gather = {"max_abs_err": 0.0, "sizes": []}
    for S in (GATHER_SIZES[0], GATHER_SMEM_MAX) + GATHER_SIZES[1:]:
        idx = torch.randint(0, S, (GATHER_STEPS * S,), device=dev,
                            dtype=torch.int32)
        slabs = [torch.randn(S, 64, device=dev)]
        if rgc.smem_fits(S, 64):
            # one float off 16-byte alignment: no bulk copy, the threads load
            slabs.append(torch.randn(S * 64 + 1, device=dev)[1:].view(S, 64))
        for x in slabs:
            ref = rg.row_gather_reference(x, idx)
            for route, cluster in vg.variants(dev, S, 64):
                kw = {"cluster": cluster} if cluster else {}
                o1 = rgc.KERNEL(x, idx, route, **kw)
                o2 = rgc.KERNEL(x, idx, route, **kw)
                torch.cuda.synchronize()
                tag = (f"S={S} {route}" + (f" cluster {cluster}" if cluster
                                           else "")
                       + ("" if x.data_ptr() % 16 == 0 else " misaligned"))
                if not (torch.equal(o1, o2) and torch.equal(o1, ref)):
                    raise AssertionError(f"row_gather {tag}: not bit-exact")
                gather["sizes"].append({
                    "S": S, "route": route, "cluster": cluster,
                    "slab_load": rgc.smem_load(x) if route == "smem" else None,
                    "aligned": x.data_ptr() % 16 == 0})
    sizes = sorted({e["S"] for e in gather["sizes"]})
    log(f"[phase 9] row_gather kernel vs plain: S {sizes} x {GATHER_STEPS} "
        f"steps, D=64, {len(gather['sizes'])} cases: the L2 "
        f"route at every S, the shared-memory route in clusters of "
        f"{rgc.CLUSTERS} at S <= {GATHER_SMEM_MAX}, each on an aligned slab "
        f"(multicast bulk copies) and a misaligned one (the threads' load); "
        f"bit-exact, bit-identical reruns")
    return {"max_abs_err": worst, "cases": n, "wide_cases": wide,
            "bf16_cases": bf16_cases,
            "hub_block_chunks": hub_chunks, "padded_chain_max_diff": chain_err,
            "lagging_warps": race,
            "gather": gather}


def phase_probes(dev, dirs) -> dict:
    import torch
    from importlib import import_module
    wk = import_module(f"{PKG}.probes.window_kernel")
    kg = import_module(f"{PKG}.probes.kernel_grid")
    vg = import_module(f"{PKG}.probes.vmem_gather")
    size = dict(users=GRAPH["num_users"], items=GRAPH["num_items"],
                edges_per_user=GRAPH["edges_per_user"], dim=64)
    # ---- this slice's path, counted (every kernel's count) ----
    reset_counts()
    t0 = time.perf_counter()
    win = wk.run(dev, **size, iters=20, dirs=dirs)
    grid = kg.run(dev, **size, iters=10, dirs=dirs)
    gather = vg.run(dev, (GATHER_SIZES[0], GATHER_SMEM_MAX)
                    + GATHER_SIZES[1:], GATHER_STEPS, 64, 20)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernel_counters().items()}
    # every SpMM and slab-gather kernel runs here; the Adam kernel, the
    # training gathers' backward, the mesh's local sums and the top-k
    # select do not
    idle = [name for name, n in launches.items()
            if (n == 0) != (name in ("fused_adam", "gather_backward",
                                     "sharded_spmm", "topk_select"))]
    if idle:
        raise AssertionError(f"probe path launches {launches}: wrong for "
                             f"{idle}")
    bad = ([f"{r['direction']} {r['variant']}" for r in win["rows"]
            if not r["ok"]]
           + [f"{r['direction']} T={r['T']} W={r['W']}" for r in grid["grid"]
              if not r["ok"]]
           + [f"gather S={r['S']} {r['route']} c{r['cluster']}"
              for r in gather["rows"] if not r["exact"]])
    if bad or not grid["chain_ok"]:
        raise AssertionError(f"probe results out of bound: {bad}, chain "
                             f"{grid['chain']}")
    # CUDA launches per apply by CUDA kernel (a captured CUDA graph of one
    # apply): P1, P2 and P3 one chunk_staged_kernel and at most one memset
    # (the counters'); device ms per apply by CUDA kernel from the
    # profiler, whose windows may drop most records (once in four runs on
    # the H100, and all of three windows in a row twice): a window is taken
    # again, up to three, else the device ms are not measured
    cs = import_module(f"{PKG}.ops.chunk_spmm")
    kinds = {"staged": "chunk_staged_kernel"}
    by_kernel = {}
    for dname, d in dirs.items():
        base, win64 = wk.plan_for(d, dev), wk.plan_for(d, dev, window=64)
        for name, plan, lid in (("chunk_spmm_block", base, torch.int32),
                                ("chunk_spmm_window", win64, torch.int32),
                                ("chunk_spmm_i16", base, torch.int16)):
            def apply():
                return cs.chunk_spmm_blocks(plan, d["x"], lid)
            count = graph_launches(apply, kinds)
            if count.get("staged") != 1 or count.get("memset", 0) > 1 \
                    or set(count) - {"staged", "memset"}:
                raise AssertionError(f"{name} {dname}: CUDA launches per "
                                     f"apply {count}, expected one staged "
                                     f"kernel and at most one memset")
            # the profiler counts a memset as one "other" record
            want = {"staged": 1, **({"other": count["memset"]}
                                    if count.get("memset") else {})}
            by_kernel.setdefault(name, []).append(
                {"direction": dname,
                 "device_ms_by_kernel": profile_matching(apply, kinds, want),
                 "cuda_launches": count})
    rows = {(r["direction"], r["variant"]): r for r in win["rows"]}

    def line(variant):
        return "; ".join(
            f"{dn} {rows[(dn, variant)]['device_ms']:.4f} dev / "
            f"{rows[(dn, variant)]['ms']:.4f} loop (bound "
            f"{rows[(dn, variant)]['bound_ms']:.4f})" for dn in dirs)
    log(f"[phase 10] probes at reference scale in {wall:.1f}s: launches "
        + ", ".join(f"{k} {v}" for k, v in launches.items())
        + "; every variant within the fp32 bound of the CSR kernel, chain "
        "sums agree, gathers bit-exact")
    log("[phase 10] ms per apply, D=64: P3 base R=512 T=256: "
        + line("base R=512 T=256") + "; P2 i16 on the same plan: "
        + line("i16 R=512 T=256") + "; P1 win W=64: " + line("win W=64")
        + "; K1/K2 csr: " + line("csr") + "; torch.sparse.mm: "
        + ", ".join(f"{dn} {rows[(dn, 'csr')]['library_ms']:.4f}"
                    for dn in dirs))
    log("[phase 10] CUDA launches per apply (captured graph), device ms "
        "(profiler): " + "; ".join(
            f"{name} {e['direction']} " + ", ".join(
                f"{k} {v}" for k, v in e["cuda_launches"].items())
            + " (" + ("not measured" if e["device_ms_by_kernel"] is None
                      else ", ".join(f"{k} {v:.4f}" for k, v in
                                     e["device_ms_by_kernel"].items()))
            + ")"
            for name, es in by_kernel.items() for e in es))
    return {"window_kernel": win, "kernel_grid": grid, "vmem_gather": gather,
            "launches": launches, "wall_s": wall,
            "cuda_launches_by_kernel": by_kernel}


# --------------------------------------------------------------------------
# phases 11-14: Stage A (train-cred) in SLAS and full-graph mode
# --------------------------------------------------------------------------

# the review stream of scripts/two_stage_demo.py at its defaults (the repo's
# two-stage scale)
CRED_REVIEWS = dict(lines=600_000, users=60_000, items=250_000)
CRED_EPOCHS = 2               # of 100 (CredConfig.epochs)
# the SLAS candidate cap of the JAX package's 10M run: uncapped, the zipf
# head item's degree would size each (I, P) table beyond the card
CRED_PAD_DEG = 128
CRED_ADAM = 1                 # Adam launches a step: one over the ten leaves
CRED_GATHERS = 5              # full-graph gather backwards a step
CRED_ARTEFACTS = ("user_labels.csv", "user_features.csv", "graph_hetero.npz",
                  "credibility_scores_minmax.npy",
                  "credibility_scores_minmax_with_user_id.csv",
                  "cred_model.npz")


def write_reviews(path: Path, lines: int, users: int, items: int,
                  seed: int = 0) -> None:
    """The port's ``scripts/two_stage_demo.make_synthetic_reviews``, the
    JAX script's stream byte for byte (lognormal user activity, zipf-1.05
    item popularity, ratings skewed to 4-5)."""
    from importlib import import_module
    import_module(f"{PKG}.scripts.two_stage_demo").make_synthetic_reviews(
        path, lines, users, items, seed)


def cred_steps_per_epoch(hg, batch_size: int) -> int:
    """Steps of one Stage-A epoch: the 80% train split of the labelled
    users in batches (``train/cred_trainer.py``)."""
    n = int(0.8 * int((hg.user_y >= 0).sum()))
    return -(-n // min(batch_size, n))


def _check_scores(res, num_users: int, tag: str,
                  epochs: int = CRED_EPOCHS) -> None:
    losses = [h["loss"] for h in res.history]
    if len(losses) != epochs or not np.isfinite(losses).all():
        raise AssertionError(f"{tag}: epoch losses {losses}")
    s = res.cred_minmax
    if s.shape != (num_users,) or not np.isfinite(s).all() \
            or s.min() < 0.0 or s.max() != 1.0:
        raise AssertionError(f"{tag}: min-max scores {s.shape} in "
                             f"[{s.min()}, {s.max()}]")


def phase_cred_slas(dev, tmp: Path, jsonl: Path) -> dict:
    """Phase 11: the CLI's train-cred in its default (SLAS) mode, counted."""
    import torch
    from importlib import import_module
    cli = import_module(f"{PKG}.cli.main")
    hetero = import_module(f"{PKG}.graph.hetero")
    config = import_module(f"{PKG}.utils.config")
    ingest = import_module(f"{PKG}.data.ingest")
    native = import_module(f"{PKG}.data.native.ingest_native")
    out = tmp / "cred"
    # the native reader's g++ build (once a checkout), then the native
    # reader asked for by name (a failed build raises) and the Python
    # reader on the same JSONL: equal tables
    t0 = time.perf_counter()
    native.load_library()
    build_s = time.perf_counter() - t0
    reads = {}
    for backend in ("native", "python"):
        t0 = time.perf_counter()
        table = ingest.ingest_jsonl(jsonl, config.IngestConfig(
            jsonl_path=str(jsonl), backend=backend))
        reads[backend] = (time.perf_counter() - t0, table)
    nat, py = reads["native"][1], reads["python"][1]
    if nat.extra.get("backend") != "native" or nat.user_ids != py.user_ids \
            or nat.item_ids != py.item_ids or not all(
                np.array_equal(getattr(nat, c), getattr(py, c))
                for c in ("uidx", "iidx", "rating", "split", "tok_count")):
        raise AssertionError("the native and Python readers disagree")
    ingest_s = {"native_build": build_s, **{k: v[0] for k, v in reads.items()}}
    del reads, nat, py
    # ---- this path, counted (every kernel's count) ----
    reset_counts()
    t0 = time.perf_counter()
    res = cli.run(["train-cred", "--jsonl", str(jsonl), "--out", str(out),
                   "--device", str(dev), f"epochs={CRED_EPOCHS}",
                   f"slas_pad_deg={CRED_PAD_DEG}"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    hg = hetero.HeteroGraph.load_npz(out / "graph_hetero.npz")
    cfg = config.CredConfig()
    nb = cred_steps_per_epoch(hg, cfg.batch_size)
    # no SpMM: SLAS builds no operator; one Adam launch a step
    counts = read_counts({"fused_adam": CRED_ADAM * nb * CRED_EPOCHS},
                         "cred_slas path")
    missing = [a for a in CRED_ARTEFACTS if not (out / a).is_file()]
    if missing:
        raise AssertionError(f"train-cred wrote no {missing}")
    _check_scores(res, hg.num_users, "train-cred (slas)")
    labels = hg.user_y
    log(f"[phase 11] train-cred (slas, hidden {cfg.hidden_dim}, k "
        f"{cfg.k_item_neigh}x{cfg.k_user_neigh}, batch {cfg.batch_size}, "
        f"slas_pad_deg {CRED_PAD_DEG}; reduced: {CRED_EPOCHS} of "
        f"{cfg.epochs} epochs, the candidate cap) on {CRED_REVIEWS['lines']:,}"
        f" review lines: {hg.num_users:,} users, {hg.num_items:,} items, "
        f"{hg.num_edges:,} edges, labelled {int((labels == 1).sum()):,} "
        f"genuine / {int((labels == 0).sum()):,} fake; native reader built "
        f"in {build_s:.2f}s; ingest native {ingest_s['native']:.2f}s, python "
        f"{ingest_s['python']:.2f}s (equal tables; train-cred's backend=auto "
        f"takes native); {nb} steps an "
        f"epoch; wall {wall:.1f}s, epoch seconds "
        f"{[round(h['seconds'], 2) for h in res.history]}, losses "
        f"{[round(h['loss'], 6) for h in res.history]}, holdout AUC "
        f"{res.history[-1]['holdout_auc']:.4f}; launches segment_spmm "
        f"{counts['segment_spmm']}, gather_backward "
        f"{counts['gather_backward']}, fused_adam {counts['fused_adam']} = "
        f"{CRED_ADAM} x {nb} x {CRED_EPOCHS}; six artefacts written, "
        f"scores in [0, 1] with max 1")
    return {"launches_by_kernel": counts, "wall_s": wall, "ingest_s": ingest_s,
            "steps_per_epoch": nb, "history": res.history,
            "num_users": hg.num_users, "num_items": hg.num_items,
            "num_edges": hg.num_edges, "_hg": hg, "_out": out}


def _cred_held_against_plain(tr_k, tr_p, tag: str) -> dict:
    """PARITY_STEPS full-graph Stage-A steps of ``tr_k`` (the kernels)
    against ``tr_p`` (the same configuration with ``backend="torch"``)
    from one state, at phase 7's tolerances (``_held``); the kernel path
    launches what a step's code gives, the plain path nothing.  Returns
    the differences, the steps' inputs and the kernel path's results
    (``ref``), and ``run``, which repeats the steps on a trainer."""
    import torch
    from importlib import import_module
    adam = import_module(f"{PKG}.ops.adam")
    params0, _, _ = tr_k.init_state(seed=0)
    order = np.random.default_rng(0).permutation(tr_k.train_users)
    users, mask = tr_k.epoch_batches(None, order)
    plans = tr_k.seed_plans(users)
    steps = [s % users.shape[0] for s in range(PARITY_STEPS)]

    def run(t):
        params = {k: v.clone() for k, v in params0.items()}
        opt = adam.adam_init(params)
        losses = torch.stack([t.train_step(params, opt, users[s], mask[s],
                                           seed_plan=plans[s])
                              for s in steps])
        torch.cuda.synchronize()
        return params, losses

    before = _counts_now()
    pk, lk = run(tr_k)
    _launched(before, {"segment_spmm": 8 * PARITY_STEPS,
                       "gather_backward": CRED_GATHERS * PARITY_STEPS,
                       "fused_adam": CRED_ADAM * PARITY_STEPS},
              f"{tag}: the kernel path")
    before = _counts_now()
    pp, lp = run(tr_p)
    _launched(before, {}, f"{tag}: the plain path")
    loss_err, p_err, bit = _held(pk, lk, {"params": pp, "losses": lp},
                                 f"{tag}: the kernel path against the "
                                 f"plain path")
    return {"loss_max_diff": loss_err, "param_max_diff": p_err,
            "bit_identical": bit, "run": run,
            "ref": {"params0": params0, "users": users, "mask": mask,
                    "plans": plans, "steps": steps, "params": pk,
                    "losses": lk}}


def phase_cred_full_graph(dev, hg) -> dict:
    """Phase 12: full-graph mode at the same scale, counted, and 3 steps
    held against the plain path."""
    import torch
    from importlib import import_module
    ct = import_module(f"{PKG}.train.cred_trainer")
    config = import_module(f"{PKG}.utils.config")
    cfg = config.CredConfig(trainer_mode="full_graph", epochs=CRED_EPOCHS)
    # ---- this path, counted (every kernel's count) ----
    reset_counts()
    t0 = time.perf_counter()
    tr = ct.CredTrainer(hg, cfg, device=dev)
    t1 = time.perf_counter()
    res = tr.fit()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    nb = tr.steps_per_epoch
    # 4 SpMM a step forward (2 views x 2 operators) and 4 backward; 2 per
    # holdout evaluation (the early view) and 2 for the final inference;
    # 5 gather backwards a step (3 seed-row gathers, 2 edge gathers)
    want_spmm = 8 * nb * CRED_EPOCHS + 2 * CRED_EPOCHS + 2
    counts = read_counts({"segment_spmm": want_spmm,
                          "gather_backward": CRED_GATHERS * nb * CRED_EPOCHS,
                          "fused_adam": CRED_ADAM * nb * CRED_EPOCHS},
                         "cred_full_graph path")
    _check_scores(res, hg.num_users, "full-graph fit")

    # ---- 3 steps, kernel path vs plain path, from one state ----
    tr_p = ct.CredTrainer(hg, cfg, device=dev, backend="torch",
                          verbose=False)
    held = _cred_held_against_plain(tr, tr_p, "Stage A")
    ref = held["ref"]
    pk, lk = ref["params"], ref["losses"]
    loss_err, p_err = held["loss_max_diff"], held["param_max_diff"]
    pk2, lk2 = held["run"](tr)
    bit = torch.equal(lk, lk2) and all(torch.equal(pk[k], pk2[k]) for k in pk)
    if not bit:
        raise AssertionError("two Stage-A kernel-path runs are not "
                             "bit-identical")
    log(f"[phase 12] full-graph fit (hidden {cfg.hidden_dim}, batch "
        f"{cfg.batch_size}, {nb} steps an epoch, {CRED_EPOCHS} epochs): "
        f"set-up {t1 - t0:.1f}s, fit {t2 - t1:.1f}s, epoch seconds "
        f"{[round(h['seconds'], 2) for h in res.history]}, losses "
        f"{[round(h['loss'], 6) for h in res.history]}, holdout AUC "
        f"{res.history[-1]['holdout_auc']:.4f}; launches segment_spmm "
        f"{counts['segment_spmm']} = 8 x {nb} x {CRED_EPOCHS} + 2 x "
        f"{CRED_EPOCHS} + 2, gather_backward {counts['gather_backward']} = "
        f"{CRED_GATHERS} x {nb} x {CRED_EPOCHS}, fused_adam "
        f"{counts['fused_adam']} = "
        f"{CRED_ADAM} x {nb} x {CRED_EPOCHS}; {PARITY_STEPS} steps vs the "
        f"plain path: losses {[round(float(x), 7) for x in lk]} max diff "
        f"{loss_err:.3g} (tol {LOSS_ATOL:g}), params max abs diff "
        f"{p_err:.3g} (tol {TRAIN_ATOL:g} + {TRAIN_RTOL:g}*|ref|); two "
        f"kernel-path runs bit-identical: {bit}")
    return {"launches_by_kernel": counts, "setup_s": t1 - t0,
            "fit_s": t2 - t1, "steps_per_epoch": nb, "history": res.history,
            "loss_max_diff": loss_err, "param_max_diff": p_err,
            "bit_identical": bit, "_trainer": tr, "_ref": ref}


def phase_two_stage(dev, tmp: Path, jsonl: Path, cred_dir: Path) -> dict:
    """Phase 13: build-graph on the same JSONL, then train-rec --cred on
    the CSV that train-cred wrote."""
    import torch
    from importlib import import_module
    cli = import_module(f"{PKG}.cli.main")
    build = import_module(f"{PKG}.graph.build")
    presets = import_module(f"{PKG}.configs.presets")
    trainer_mod = import_module(f"{PKG}.train.trainer")
    csv = cred_dir / "credibility_scores_minmax_with_user_id.csv"
    t0 = time.perf_counter()
    cli.run(["build-graph", "--jsonl", str(jsonl), "--out", str(tmp / "g"),
             "--device", str(dev), "backend=native"])
    t1 = time.perf_counter()
    graph = build.BipartiteGraph.load_npz(tmp / "g" / "graph.npz")
    # the vector train-rec loads: its trainer reads the CSV by user id
    cred = trainer_mod.RecTrainer(
        presets.get_preset("cu_message").replace(cred_csv_path=str(csv)),
        graph, device=dev, verbose=False).cred
    if cred.shape != (graph.num_users,) or not np.isfinite(cred).all():
        raise AssertionError(f"credibility vector {cred.shape}")
    changed = int((cred != 1.0).sum())
    if changed == 0:
        raise AssertionError("no graph user took a score from the CSV")
    t2 = time.perf_counter()
    res = cli.run(["train-rec", "--graph", str(tmp / "g" / "graph.npz"),
                   "--preset", "cu_message", "--cred", str(csv),
                   "--device", str(dev), "epochs=1"])
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    metrics = [res.test_metrics[K][m] for K in res.test_metrics
               for m in ("precision", "recall", "ndcg")]
    if not (np.isfinite(metrics).all() and np.isfinite(res.history[0].loss)):
        raise AssertionError(f"train-rec metrics {res.test_metrics}")
    log(f"[phase 13] two-stage contract: build-graph on the same JSONL "
        f"(native reader) in {t1 - t0:.1f}s ({graph.summary()}); train-rec --preset cu_message "
        f"--cred <train-cred CSV> epochs=1 in {t3 - t2:.1f}s: {changed:,} of "
        f"{graph.num_users:,} graph users took a score from the CSV (min "
        f"{cred.min():.4f}, mean {cred.mean():.4f}), loss "
        f"{res.history[0].loss:.6f}, test R@20 "
        f"{res.test_metrics[20]['recall']:.6f}")
    return {"build_graph_s": t1 - t0, "train_rec_s": t3 - t2,
            "users_scored": changed, "graph_users": graph.num_users,
            "test_metrics": res.test_metrics}


def _mode_times(tr) -> dict:
    """A step's split, the back-to-back step, one epoch (host clock) and a
    profiled 3-step window, from a fresh state of ``tr``."""
    import torch
    params, opt, gen = tr.init_state(seed=1)
    users, mask = tr.epoch_batches(gen)
    nb = users.shape[0]
    plans = tr.seed_plans(users) or [None] * nb

    def step(j):
        tr.train_step(params, opt, users[j % nb], mask[j % nb], gen,
                      seed_plan=plans[j % nb])

    step(0)
    step(1)
    split = step_split(
        lambda leaves, j: tr._loss(leaves, users[j % nb], mask[j % nb], gen,
                                   seed_plan=plans[j % nb]),
        params, opt, tr.cfg.lr, min(10, nb))
    step_ms = cuda_time_ms(lambda: step(0), 10, warmup=2)
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    loss = float(tr.run_epoch(params, opt, gen).mean().item())
    epoch_ms = 1e3 * (time.perf_counter() - h0)
    if not np.isfinite(loss):
        raise AssertionError(f"epoch loss {loss}")
    return {"step_ms": step_ms, "step_split_ms": split, "epoch_ms": epoch_ms,
            "steps_per_epoch": tr.steps_per_epoch,
            "profile": profile_steps(step)}


def phase_cred_times(dev, tmp: Path, jsonl: Path, hg, tr_full) -> dict:
    """Phase 14: Stage-A times on the card."""
    import torch
    from importlib import import_module
    ct = import_module(f"{PKG}.train.cred_trainer")
    config = import_module(f"{PKG}.utils.config")
    cli = import_module(f"{PKG}.cli.main")
    sampling = import_module(f"{PKG}.ops.sampling")
    adam = import_module(f"{PKG}.ops.adam")
    tr_slas = ct.CredTrainer(hg, config.CredConfig(slas_pad_deg=CRED_PAD_DEG),
                             device=dev, verbose=False)
    modes = {"slas": _mode_times(tr_slas), "full_graph": _mode_times(tr_full)}
    if modes["full_graph"]["profile"]["indexing_backward_ms"]:
        raise AssertionError(
            f"the full-graph step ran ATen's indexing backward: "
            f"{modes['full_graph']['profile']['top_kernels_ms']}")

    # train-cred through the CLI in full-graph mode (the SLAS wall is
    # phase 11's)
    t0 = time.perf_counter()
    cli.run(["train-cred", "--jsonl", str(jsonl), "--out",
             str(tmp / "cred_fg"), "--device", str(dev),
             f"epochs={CRED_EPOCHS}", "trainer_mode=full_graph"])
    torch.cuda.synchronize()
    modes["full_graph"]["train_cred_wall_s"] = time.perf_counter() - t0

    # the SpMM in Stage A's directions (the early view), D = hidden
    D = tr_full.cfg.hidden_dim
    view = tr_full.model.views["early"]
    gen = torch.Generator(device=dev).manual_seed(2)
    dirs = [time_direction(role, d, torch.randn(d.num_src, D, device=dev,
                                                generator=gen))
            for role, d in (
                ("item<-user (hub)", view.item_from_user.fwd),
                ("user<-item", view.user_from_item.fwd),
                ("bwd of item<-user (user rows)", view.item_from_user.bwd),
                ("bwd of user<-item (item rows, hub)",
                 view.user_from_item.bwd))]
    # the smoothness term's two gathers (the early view's plans)
    p_src, p_dst = view.smooth_plans
    gathers = [time_gather("stage_a h_u2[src]", p_src, view.src, D, gen),
               time_gather("stage_a h_i1[dst] (hub)", p_dst, view.dst, D,
                           gen)]
    # the Adam kernel on the ten Stage-A leaves in one launch, as a step
    # runs it
    params, _, _ = tr_full.init_state(seed=3)
    adam_leaves = time_adam(params, adam.adam_scalars(10, tr_full.cfg.lr),
                            tr_full.cfg.lr, gen)

    # gumbel_topk at the user draw's shape: (B * k_item, P)
    cfg = tr_slas.cfg
    shape = (cfg.batch_size * cfg.k_item_neigh, CRED_PAD_DEG)
    logits = torch.randn(shape, device=dev, generator=gen)
    gmask = torch.rand(shape, device=dev, generator=gen) < 0.5
    topk = {"shape": list(shape), "k": cfg.k_user_neigh,
            "ms": cuda_time_ms(lambda: sampling.gumbel_topk(
                gen, logits, cfg.k_user_neigh, gmask), 20),
            # torch.topk on the same scores: the yardstick of the stable sort
            "torch_topk_ms": cuda_time_ms(lambda: torch.topk(
                logits, cfg.k_user_neigh, dim=-1), 20)}

    log("[phase 14] Stage-A times (ms): " + "; ".join(
        f"{m} step {t['step_ms']:.3f} (forward+loss "
        f"{t['step_split_ms']['forward_loss']:.3f}, backward "
        f"{t['step_split_ms']['backward']:.3f}, Adam "
        f"{t['step_split_ms']['adam']:.3f}, its host "
        f"{t['step_split_ms']['adam_host_ms']:.3f}), epoch "
        f"{t['epoch_ms']:.1f} "
        f"({t['steps_per_epoch']} steps), profiled 3 steps: device busy "
        f"{t['profile']['device_ms']:.2f} of {t['profile']['window_ms']:.2f} "
        f"ms ({100 * t['profile']['busy_share']:.1f}%), by kernel "
        + ", ".join(f"{k} {v:.2f}" for k, v in
                    list(t["profile"]["top_kernels_ms"].items())[:6])
        for m, t in modes.items())
        + f"; train-cred full_graph wall "
        f"{modes['full_graph']['train_cred_wall_s']:.1f}s; SpMM (early view, "
        f"D={D}) " + "; ".join(
            f"{e['role']} ({e['edges']:,} edges, max degree "
            f"{e['max_dst_degree']:,}, {e['long_rows']} long rows) kernel "
            f"{e['ms']:.4f} plain {e['plain_ms']:.4f} sparse.mm "
            f"{e['library_ms']:.4f} bound {e['bound_ms']:.4f}" for e in dirs)
        + "; " + _gather_line(gathers)
        + "; " + _adam_line(f"on the {len(params)} Stage-A leaves",
                            adam_leaves)
        + f"; gumbel_topk {tuple(shape)} k={cfg.k_user_neigh} "
        f"{topk['ms']:.4f} (torch.topk {topk['torch_topk_ms']:.4f})")
    return {"modes": modes, "spmm_directions": dirs, "gumbel_topk": topk,
            "gather_backward": gathers, "adam_leaves": adam_leaves}


# --------------------------------------------------------------------------
# phase 15: serving on a mesh
# --------------------------------------------------------------------------

MESH_MODES = ("halo", "allgather", "auto")
MESH_WORKERS = 2              # part (b): ranks on the one card, over gloo
MESH_TIMEOUT = 300            # seconds for each mesh subprocess
REPLACES_SHARDED = (REPLACES + "; the local sums of the JAX package's "
                    "sharded SpMM (parallel/sharded_spmm.py:372 and :392, "
                    "XLA segment_sum)")


def _evaluate_args(tmp: Path, dev, mode: str) -> list:
    return ["evaluate", "--graph", str(tmp / "graph.npz"),
            "--params", str(tmp / "best_model.npz"), "--preset", "cu_message",
            "--cred", str(tmp / "cred.csv"), "--split", "test",
            "--device", str(dev), f"eval_mode={mode}"]


def _cli_subprocess(args: list) -> tuple:
    """The port's CLI in a subprocess: (metrics of its JSON line, wall
    seconds, stdout)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"{PKG}.cli", *args],
                          cwd=Path(__file__).resolve().parent,
                          capture_output=True, text=True,
                          timeout=MESH_TIMEOUT)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(args[:1] + args[-3:])} failed "
                             f"({proc.returncode}):\n{proc.stderr[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    return {int(k): v for k, v in res.items()}, wall, proc.stdout


def profiled_op_names(fn) -> set:
    """Every operator and kernel name the profiler records over one call of
    ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()}


def _jaccard(a, b) -> np.ndarray:
    return np.array([len(set(x) & set(y)) / len(set(x) | set(y))
                     for x, y in zip(a, b)])


def time_sharded_direction(role: str, op, d, xp) -> dict:
    """The sharded operator's local sum on one direction at P=1: the kernel
    (``SHARDED_KERNEL``) on the exchanged buffer, held bit for bit against
    its plain version's ordered CPU sums, timed beside the plain version
    and ``torch.sparse.mm`` on the same local CSR."""
    import torch
    from importlib import import_module
    sc = import_module(f"{PKG}.ops.spmm_cuda")
    c = d.csr
    src = op._exchange(d, xp.contiguous())
    y = sc.SHARDED_KERNEL(c.indptr, c.src, c.w, src, pieces=c.pieces)
    plain = sc.segment_spmm_reference(
        c.indptr.cpu(), c.src.cpu(), c.w.cpu(), src.cpu(),
        long_row_edges=c.pieces.edges_per_piece)
    if not torch.equal(y.cpu(), plain):
        raise AssertionError(f"{role}: sharded local sum not bit-equal to "
                             f"the plain version's ordered CPU sums")
    err = float((y.cpu() - plain).abs().max())
    csr = torch.sparse_csr_tensor(c.indptr, c.src.long(), c.w,
                                  size=(c.num_dst, c.num_src))
    ms = [cuda_time_ms(lambda: sc.SHARDED_KERNEL(
        c.indptr, c.src, c.w, src, pieces=c.pieces), 50) for _ in range(2)]
    pl = [cuda_time_ms(lambda: sc.segment_spmm_reference(
        c.indptr, c.src, c.w, src), 20) for _ in range(2)]
    return {"role": role, "mode": d.mode, "num_dst": c.num_dst,
            "num_src": c.num_src, "edges": int(c.src.numel()),
            "long_rows": c.pieces.num_long, "pieces": c.pieces.num_pieces,
            "ms": min(ms), "plain_ms": min(pl),
            "library_ms": cuda_time_ms(lambda: torch.sparse.mm(csr, src), 20),
            "bound_ms": bound_ms(c, src.shape[1], 4), "max_abs_err": err}


def phase_serving_mesh(dev, tmp: Path, ctx: dict, res: dict) -> dict:
    """Phase 15: serving on a mesh at reference scale, with phase 3's
    saved graph, credibility CSV and parameters in ``tmp``."""
    import functools
    import torch
    import torch.distributed as dist
    from importlib import import_module
    mesh_mod = import_module(f"{PKG}.parallel.mesh")
    ssp = import_module(f"{PKG}.parallel.sharded_spmm")
    trainer_mod = import_module(f"{PKG}.train.trainer")
    lg = import_module(f"{PKG}.models.lightgcn")
    ckpt = import_module(f"{PKG}.train.checkpoint")
    retrieval = import_module(f"{PKG}.eval.retrieval")
    graph, cfg = ctx["graph"], ctx["cfg"]
    K = cfg.num_layers

    # ---- (a) the CLI's evaluate --mesh 1: a world of one over NCCL ----
    cli_res, cli_wall = {}, {}
    for mode in ("sampled", "full"):
        cli_res[mode], cli_wall[mode], out = _cli_subprocess(
            _evaluate_args(tmp, dev, mode) + ["--mesh", "1"])
        if "mesh: {'data': 1, 'model': 1}" not in out:
            raise AssertionError(f"evaluate --mesh 1 printed no mesh line:\n"
                                 f"{out[-2000:]}")
    cli_err = max(_metrics_equal(cli_res["sampled"], res["metrics_sampled"]),
                  _metrics_equal(cli_res["full"], res["metrics_full"]))

    params = ckpt.load_params_npz(tmp / "best_model.npz", device=dev)
    single = trainer_mod.RecTrainer(cfg, graph, device=dev, verbose=False)
    with torch.no_grad():
        ref_u, ref_i = single.model.propagate(params)
    users = torch.as_tensor(single.ctx.eval_users["test"][:512], device=dev)
    excl = torch.as_tensor(
        retrieval.exclusion_rows_for_users(graph, users.cpu().numpy()),
        device=dev)
    _, ref_top = retrieval.topk_for_users(ref_u, ref_i, users, 20,
                                          exclude_batch_rows=excl)
    mesh = mesh_mod.make_mesh(1, device_type=dev.type)
    try:
        # ---- the mesh serving path, counted (every kernel's count) ----
        reset_counts()
        t0 = time.perf_counter()
        tr_s = trainer_mod.RecTrainer(cfg, graph, device=dev, mesh=mesh,
                                      verbose=False)
        res_s = tr_s.evaluate(params, "test")
        tr_f = trainer_mod.RecTrainer(cfg.replace(eval_mode="full"), graph,
                                      device=dev, mesh=mesh, verbose=False)
        res_f = tr_f.evaluate(params, "test")
        models, tables = {}, {}
        for mode in MESH_MODES:
            models[mode] = lg.LightGCN(
                cfg, graph, tr_s.cred, device=dev,
                operator_factory=functools.partial(
                    ssp.ShardedSpmmOperator, mesh=mesh, mode=mode))
            with torch.no_grad():
                tables[mode] = models[mode].propagate(params)
        _, top = retrieval.topk_for_users(*tables["auto"], users, 20,
                                          exclude_batch_rows=excl, mesh=mesh)
        torch.cuda.synchronize()
        path_s = time.perf_counter() - t0
        n_prop = 2 + len(MESH_MODES)
        # 2K local sums per propagate (the exchange is a collective, not a
        # kernel of the package); the mesh ranks with its own top-k, not
        # topk_select; no other kernel is on this path
        counts = read_counts({"sharded_spmm": 2 * K * n_prop},
                             "serving mesh path")
        for mode, (u, i) in tables.items():
            if not (torch.equal(u, ref_u) and torch.equal(i, ref_i)):
                raise AssertionError(f"{mode}: sharded tables not bit-equal "
                                     f"to the single-device kernel path")
        err = max(_metrics_equal(res_s, res["metrics_sampled"]),
                  _metrics_equal(res_f, res["metrics_full"]))
        jac = _jaccard(top.cpu().numpy(), ref_top.cpu().numpy())
        if jac.mean() < 0.99:
            raise AssertionError(f"mesh top-20 Jaccard {jac.mean()} < 0.99")
        # the exchange each mode chose for item<-user and its transpose
        fwd_modes = {m: (models[m].item_from_user.stats["fwd_mode"],
                         models[m].item_from_user.stats["bwd_mode"])
                     for m in MESH_MODES}

        # ---- no scatter on the path; CUDA launches per propagate ----
        auto = models["auto"]
        # a window with the row kernel's records, taken again, up to five,
        # where the profiler dropped them
        for _ in range(5):
            names = profiled_op_names(lambda: auto.propagate(params))
            if any("rows_kernel" in n for n in names):
                break
        else:
            raise AssertionError("no profiled window of a sharded propagate "
                                 "holds the row kernel's records")
        bad = sorted(n for n in names
                     if "indexing_backward" in n or "index_put" in n)
        if bad:
            raise AssertionError(f"sharded propagate ran {bad}")
        with torch.no_grad():
            split, launches_by_cuda = profile_split(
                lambda: auto.propagate(params),
                {"long_rows": "long_rows_kernel", "rows": "rows_kernel",
                 "nccl": "nccl", "memcpy": "Memcpy",
                 "index_select": "index", "elementwise": "elementwise"})

        # ---- times: single-device and sharded propagate, in turns ----
        with torch.no_grad():
            prop = {"single": [], **{m: [] for m in MESH_MODES}}
            for order in (("single",) + MESH_MODES,
                          MESH_MODES[::-1] + ("single",)):
                for m in order:
                    model = single.model if m == "single" else models[m]
                    prop[m].append(cuda_time_ms(
                        lambda: model.propagate(params), 10))
        prop_ms = {m: min(v) for m, v in prop.items()}
        evals = {}
        for name, t in (("sampled", tr_s), ("full", tr_f)):
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            t.evaluate(params, "test")
            torch.cuda.synchronize()
            evals[name] = 1e3 * (time.perf_counter() - h0)
        ifu, ufi = auto.item_from_user, auto.user_from_item
        xu = ifu.src_layout.to_padded(params["user_emb"])
        xi = ufi.src_layout.to_padded(params["item_emb"])
        dirs = [time_sharded_direction("item<-user", ifu, ifu.fwd, xu),
                time_sharded_direction("user<-item", ufi, ufi.fwd, xi)]
        # host microseconds a call, by piece of the item<-user apply (the
        # launches queued, not waited for)
        c = ifu.fwd.csr
        full = ifu._exchange(ifu.fwd, xu)
        sc = import_module(f"{PKG}.ops.spmm_cuda")
        with torch.no_grad():
            host_us = {
                "propagate": host_us_per_call(
                    lambda: auto.propagate(params), 20),
                "single_propagate": host_us_per_call(
                    lambda: single.model.propagate(params), 20),
                "apply_padded": host_us_per_call(
                    lambda: ifu.apply_padded(xu), 100),
                "exchange": host_us_per_call(
                    lambda: ifu._exchange(ifu.fwd, xu), 100),
                "local_sum": host_us_per_call(
                    lambda: sc.SHARDED_KERNEL(c.indptr, c.src, c.w, full,
                                              pieces=c.pieces), 100),
                "to_padded": host_us_per_call(
                    lambda: ifu.src_layout.to_padded(params["user_emb"]),
                    100),
                "from_padded": host_us_per_call(
                    lambda: ufi.src_layout.from_padded(xi), 100)}
    finally:
        dist.destroy_process_group()

    two = phase_mesh_two_ranks(tmp, ref_u, ref_i, res_f)
    log(f"[phase 15] serving on a mesh (cu_message D={cfg.emb_dim} K={K}): "
        f"(a) evaluate --mesh 1 (a world of one, subprocess) metrics diff vs "
        f"phase 3 "
        f"{cli_err:.3g}, wall sampled {cli_wall['sampled']:.1f}s full "
        f"{cli_wall['full']:.1f}s; in process: tables bit-equal to the "
        f"single-device kernel path in modes "
        + ", ".join(f"{m} (fwd/bwd {fwd_modes[m][0]}/{fwd_modes[m][1]})"
                    for m in MESH_MODES)
        + f", metrics diff {err:.3g}, top-20 Jaccard {jac.mean():.6f}; "
        f"launches sharded_spmm {counts['sharded_spmm']} = {2 * K} x "
        f"{n_prop} propagates in {path_s:.1f}s; CUDA launches a propagate "
        f"{launches_by_cuda}; no indexing_backward/index_put; propagate ms "
        + ", ".join(f"{m} {v:.3f}" for m, v in prop_ms.items())
        + f"; host us a call " + ", ".join(
            f"{k} {v:.1f}" for k, v in host_us.items())
        + f"; evaluate ms sampled {evals['sampled']:.1f} full "
        f"{evals['full']:.1f}; local sums "
        + "; ".join(f"{d['role']} ({d['mode']}) kernel {d['ms']:.4f} plain "
                    f"{d['plain_ms']:.4f} sparse.mm {d['library_ms']:.4f} "
                    f"bound {d['bound_ms']:.4f}" for d in dirs)
        + f"; (b) {MESH_WORKERS} ranks on one card over gloo: tables "
        f"bit-equal in both exchanges, metrics diff {two['metrics_err']:.3g}, "
        f"{two['seconds']:.1f}s")
    return {"launches_by_kernel": counts, "cli_metrics_err": cli_err,
            "cli_wall_s": cli_wall, "metrics_err": err,
            "jaccard_mean": float(jac.mean()), "path_s": path_s,
            "modes": fwd_modes, "cuda_launches_per_propagate": launches_by_cuda,
            "device_split_ms": split, "propagate_ms": prop_ms,
            "host_us_per_call": host_us,
            "evaluate_ms": evals, "directions": dirs, "two_ranks": two}


def run_two_ranks(tmp: Path, mode: str) -> float:
    """MESH_WORKERS ranks of this script on the one card, joined over gloo
    (NCCL takes one rank a device), in ``mode`` ("serve" or "train"; files
    in ``tmp/mesh_two``); returns their wall seconds, or raises with the
    output of a rank that failed."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(mesh_worker_command(r, MESH_WORKERS, tmp, mode),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(MESH_WORKERS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MESH_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        outs.append("timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    seconds = time.perf_counter() - t0
    failed = [o for p, o in zip(procs, outs) if p.returncode != 0
              or "[mesh worker OK]" not in o]
    if failed or len(outs) < len(procs):
        raise AssertionError(f"two ranks on one card over gloo ({mode}) "
                             f"failed:\n{(failed or outs)[-1][-3000:]}")
    return seconds


def phase_mesh_two_ranks(tmp: Path, ref_u, ref_i, ref_metrics) -> dict:
    """Part (b): two ranks (:func:`run_two_ranks`), each propagates in both
    exchanges and evaluates the full catalogue on the (1, MESH_WORKERS)
    mesh; both ranks' tables must be bit-equal to the one-card path and
    their metrics identical, within 1e-6 of ``ref_metrics``."""
    import torch
    out = tmp / "mesh_two"
    out.mkdir(exist_ok=True)
    seconds = run_two_ranks(tmp, "serve")
    for mode in ("halo", "allgather"):
        for r in range(MESH_WORKERS):
            u, i = (torch.as_tensor(np.load(out / f"{mode}_{t}_r{r}.npy"))
                    for t in "ui")
            if not (torch.equal(u, ref_u.cpu()) and torch.equal(i, ref_i.cpu())):
                raise AssertionError(f"two ranks, {mode}, rank {r}: tables "
                                     f"not bit-equal to the one-card path")
    metrics = [{int(k): v for k, v in json.loads(
        (out / f"metrics_r{r}.json").read_text()).items()}
        for r in range(MESH_WORKERS)]
    if any(m != metrics[0] for m in metrics):
        raise AssertionError("two ranks report different metrics")
    return {"seconds": seconds,
            "metrics_err": _metrics_equal(metrics[0], ref_metrics)}


def mesh_worker_command(rank: int, world: int, tmp: Path,
                        mode: str = "serve") -> list:
    return [sys.executable, str(Path(__file__).resolve()), "--mesh-worker",
            str(rank), str(world), str(tmp), mode]


def mesh_worker(rank: int, world: int, tmp: Path, dev=None,
                mode: str = "serve") -> int:
    """One rank of phase 15's part (b) (``mode`` "serve": the (1, world)
    mesh) or of phase 16's part (d) ("train": the (1, world) mesh, then
    the (world, 1) mesh in the same process): gloo on ``dev`` (the
    card)."""
    import torch
    import torch.distributed as dist
    from datetime import timedelta
    from importlib import import_module
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    distributed = import_module(f"{PKG}.parallel.distributed")
    mesh_mod = import_module(f"{PKG}.parallel.mesh")
    build = import_module(f"{PKG}.graph.build")
    presets = import_module(f"{PKG}.configs.presets")
    trainer_mod = import_module(f"{PKG}.train.trainer")
    ckpt = import_module(f"{PKG}.train.checkpoint")
    dev = dev or torch.device("cuda", 0)
    out = tmp / "mesh_two"
    distributed.initialize(init_method=f"file://{out}/store_{mode}",
                           world_size=world, rank=rank, device=dev,
                           backend="gloo", timeout=timedelta(seconds=120))
    graph = build.BipartiteGraph.load_npz(tmp / "graph.npz")
    cfg = presets.get_preset("cu_message").replace(
        cred_csv_path=str(tmp / "cred.csv"), eval_mode="full")
    if mode == "train":
        adam = import_module(f"{PKG}.ops.adam")
        inp = np.load(out / "train_inputs.npz")
        batches = tuple(torch.as_tensor(inp[k], device=dev)
                        for k in ("users", "pos", "neg", "mask"))
        for shape in ((1, world), (world, 1)):
            mesh = mesh_mod.make_mesh(world, shape=shape,
                                      device_type=dev.type)
            tr = trainer_mod.RecTrainer(cfg, graph, device=dev, mesh=mesh,
                                        verbose=False)
            blocks = tr._pad_params({k: torch.as_tensor(inp[k], device=dev)
                                     for k in ("user_emb", "item_emb")})
            opt = adam.adam_init(blocks)
            losses = tr.run_epoch(blocks, opt, batches)
            tag = f"{shape[0]}x{shape[1]}"
            np.save(out / f"train_{tag}_losses_r{rank}.npy",
                    losses.cpu().numpy())
            for k, v in tr._trim(blocks).items():
                np.save(out / f"train_{tag}_{k}_r{rank}.npy", v.cpu().numpy())
                np.save(out / f"train_{tag}_{k}_rows_r{rank}.npy",
                        np.array(blocks[k].shape))
    else:
        mesh = mesh_mod.make_mesh(world, shape=(1, world),
                                  device_type=dev.type)
        params = ckpt.load_params_npz(tmp / "best_model.npz", device=dev)
        for ex in ("halo", "allgather"):
            tr = trainer_mod.RecTrainer(cfg.replace(sharded_spmm_mode=ex),
                                        graph, device=dev, mesh=mesh,
                                        verbose=False)
            with torch.no_grad():
                u, i = tr.model.propagate(params)
            np.save(out / f"{ex}_u_r{rank}.npy", u.cpu().numpy())
            np.save(out / f"{ex}_i_r{rank}.npy", i.cpu().numpy())
        res = tr.evaluate(params, "test")
        (out / f"metrics_r{rank}.json").write_text(json.dumps(
            {str(k): v for k, v in res.items()}, default=float))
    dist.destroy_process_group()
    print("[mesh worker OK]", flush=True)
    return 0


# --------------------------------------------------------------------------
# phase 16: training on a mesh
# --------------------------------------------------------------------------

MESH_STEP_ITERS = 5           # CUDA-event loop of a train step, each turn


def _no_scatter(step, tag: str) -> None:
    """A profiled ``step()`` (a window holding the row kernel's records,
    retaken up to five times) runs no stock scatter: no ``index_put_``,
    ``index_add_`` or ``indexing_backward_kernel``."""
    for _ in range(5):
        names = profiled_op_names(step)
        if any("rows_kernel" in n for n in names):
            break
    else:
        raise AssertionError(f"{tag}: no profiled window holds the row "
                             f"kernel's records")
    bad = sorted(n for n in names if "indexing_backward" in n
                 or "index_put" in n or "index_add" in n)
    if bad:
        raise AssertionError(f"{tag} ran {bad}")


def _in_turns(fns: dict, iters: int) -> dict:
    """Each of ``fns``' CUDA-event ms a call (best of two turns: in order,
    then in reverse)."""
    ms = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            ms[name].append(cuda_time_ms(fns[name], iters))
    return {name: min(v) for name, v in ms.items()}


def phase_mesh_train_steps(dev, ctx: dict, parity: dict) -> dict:
    """Phase 16 (a): sharded train steps on a world of one over NCCL, in
    process, from phase 7's parameters and batches, against phase 7's
    one-card kernel path; a profiled step; the step's times beside one
    card's, and the host cost of its two collectives."""
    import torch
    import torch.distributed as dist
    from importlib import import_module
    mesh_mod = import_module(f"{PKG}.parallel.mesh")
    sharding = import_module(f"{PKG}.parallel.sharding")
    trainer_mod = import_module(f"{PKG}.train.trainer")
    adam = import_module(f"{PKG}.ops.adam")
    graph, cfg = ctx["graph"], ctx["cfg"]
    K = cfg.num_layers
    ref, single = parity["_ref"], parity["_trainer"]
    batches = ref["batches"]
    S = len(batches)
    mesh = mesh_mod.make_mesh(1, device_type=dev.type)
    try:
        tr = trainer_mod.RecTrainer(cfg, graph, device=dev, mesh=mesh,
                                    verbose=False)

        def run():
            blocks = tr._pad_params(_params(ctx, dev))
            opt = adam.adam_init(blocks)
            losses = torch.stack([tr.train_step(blocks, opt, *b)
                                  for b in batches])
            torch.cuda.synchronize()
            return tr._trim(blocks), losses

        before = _counts_now()
        pm, lm = run()
        # K forward and K backward local sums on each operator, the
        # propagated and ego tables' batch-row gathers, one Adam launch
        per_step = {"sharded_spmm": 4 * K, "gather_backward": 4,
                    "fused_adam": 1}
        _launched(before, {k: v * S for k, v in per_step.items()},
                  "mesh train steps")
        loss_err, p_err, bit = _held(pm, lm, ref, "mesh train steps")

        blocks = tr._pad_params(_params(ctx, dev))
        opt = adam.adam_init(blocks)
        p1 = _params(ctx, dev)
        o1 = adam.adam_init(p1)

        def mesh_step(j=0):
            tr.train_step(blocks, opt, *batches[j % S])

        def one_step(j=0):
            single.train_step(p1, o1, *batches[j % S])

        _no_scatter(mesh_step, "a mesh train step")
        step_ms = _in_turns({"one_card": one_step, "mesh": mesh_step},
                            MESH_STEP_ITERS)
        prof = {"mesh": profile_steps(mesh_step),
                "one_card": profile_steps(one_step)}
        flat = torch.zeros(sum(v.numel() for v in blocks.values()) + 1,
                           device=dev)
        host_us = {"mesh_step": host_us_per_call(mesh_step, 5),
                   "one_card_step": host_us_per_call(one_step, 5)}
        with torch.no_grad():
            host_us["param_all_gather"] = host_us_per_call(
                lambda: sharding.gather_params(blocks, tr._model_axis,
                                               tr._rows), 50)
            host_us["grad_all_reduce"] = host_us_per_call(
                lambda: dist.all_reduce(flat, group=tr._data_axis.group), 50)
    finally:
        dist.destroy_process_group()
    log(f"[phase 16a] {S} sharded train steps on a world of one (NCCL) vs "
        f"phase 7's one-card kernel path: losses "
        f"{[round(float(x), 7) for x in lm]} max diff {loss_err:.3g} (tol "
        f"{LOSS_ATOL:g}), params max abs diff {p_err:.3g} (tol "
        f"{TRAIN_ATOL:g} + {TRAIN_RTOL:g}*|ref|), bit-equal: {bit}; "
        f"launches a step {per_step}; no index_put/index_add/"
        f"indexing_backward in a profiled step; step ms (CUDA events) mesh "
        f"{step_ms['mesh']:.3f} one card {step_ms['one_card']:.3f}; device "
        f"ms a step mesh {prof['mesh']['device_ms'] / 3:.3f} one card "
        f"{prof['one_card']['device_ms'] / 3:.3f}, host window ms a step "
        f"mesh {prof['mesh']['window_ms'] / 3:.3f} one card "
        f"{prof['one_card']['window_ms'] / 3:.3f}; host us a call "
        + ", ".join(f"{k} {v:.1f}" for k, v in host_us.items()))
    return {"loss_max_diff": loss_err, "param_max_diff": p_err,
            "bit_equal": bit, "launches_per_step": per_step,
            "step_ms": step_ms, "profile": prof, "host_us_per_call": host_us,
            "_ref": {"params": pm, "losses": lm}}


def phase_train_rec_mesh(dev, tmp: Path, ctx: dict, train: dict) -> dict:
    """Phase 16 (b): the CLI's train-rec --mesh 1 (a world of one over
    NCCL, in this process so that its launches are counted) for
    TRAIN_EPOCHS epochs with checkpoints, beside phase 6's one-card run."""
    import torch
    from importlib import import_module
    cli = import_module(f"{PKG}.cli.main")
    graph, cfg = ctx["graph"], ctx["cfg"]
    K = cfg.num_layers
    nb = train["steps_per_epoch"]
    n_evals = TRAIN_EPOCHS // cfg.eval_every + 1      # val per epoch + test
    out = tmp / "rec_mesh"
    # ---- the main path, counted (every kernel's count) ----
    reset_counts()
    t0 = time.perf_counter()
    res = cli.run(["train-rec", "--graph", str(tmp / "graph.npz"),
                   "--preset", "cu_message", "--cred", str(tmp / "cred.csv"),
                   "--out", str(out), "--checkpoint", "--device", str(dev),
                   f"epochs={TRAIN_EPOCHS}", "--mesh", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # a step: 4K local sums, 4 gather backwards, 1 Adam; 2K local sums per
    # evaluation
    counts = read_counts(
        {"sharded_spmm": 4 * K * nb * TRAIN_EPOCHS + 2 * K * n_evals,
         "gather_backward": 4 * nb * TRAIN_EPOCHS,
         "fused_adam": nb * TRAIN_EPOCHS}, "training mesh path")
    losses = [h.loss for h in res.history]
    if len(losses) != TRAIN_EPOCHS or not all(np.isfinite(losses)):
        raise AssertionError(f"mesh epoch losses {losses}")
    for name in ("best_model.npz", "test_metrics.json", "metrics.jsonl"):
        if not (out / name).is_file():
            raise AssertionError(f"train-rec --mesh 1 wrote no {name}")
    if not any((out / "ckpt").glob("*.pt")):
        raise AssertionError("train-rec --mesh 1 wrote no checkpoint")
    with np.load(out / "best_model.npz") as z:
        shapes = {k: z[k].shape for k in z.files}
    if shapes != {"user_emb": (graph.num_users, cfg.emb_dim),
                  "item_emb": (graph.num_items, cfg.emb_dim)}:
        raise AssertionError(f"best_model.npz holds {shapes}")
    written = {int(k): v for k, v in json.loads(
        (out / "test_metrics.json").read_text()).items()}
    ev = cli.run(["evaluate", "--graph", str(tmp / "graph.npz"),
                  "--params", str(out / "best_model.npz"),
                  "--preset", "cu_message", "--cred", str(tmp / "cred.csv"),
                  "--split", "test", "--device", str(dev)])
    err = _metrics_equal(written, ev)
    one = {int(k): v for k, v in train["test_metrics"].items()}
    vs_one = {"epoch_loss": max(abs(a - b) for a, b in
                                zip(losses, train["epoch_losses"])),
              "test_metrics": max(abs(written[k][m] - one[k][m])
                                  for k in one
                                  for m in ("precision", "recall", "ndcg"))}
    log(f"[phase 16b] train-rec --mesh 1 (a world of one, in process): "
        f"{TRAIN_EPOCHS} epochs in {wall:.1f}s (phase 6 on one card "
        f"{train['train_rec_wall_s']:.1f}s), epoch losses "
        f"{[round(x, 6) for x in losses]}, epoch seconds "
        f"{[round(h.seconds, 3) for h in res.history]}; launches "
        f"sharded_spmm {counts['sharded_spmm']} = {4 * K} x {nb} x "
        f"{TRAIN_EPOCHS} + {2 * K} x {n_evals}, gather_backward "
        f"{counts['gather_backward']} = 4 x {nb} x {TRAIN_EPOCHS}, "
        f"fused_adam {counts['fused_adam']}; best_model.npz exact rows; "
        f"evaluate on it reproduces test_metrics.json (diff {err:.3g}); vs "
        f"phase 6: epoch loss diff {vs_one['epoch_loss']:.3g}, test "
        f"metrics diff {vs_one['test_metrics']:.3g}")
    return {"launches_by_kernel": counts, "train_rec_wall_s": wall,
            "epoch_losses": losses,
            "epoch_seconds": [h.seconds for h in res.history],
            "evaluate_err": err, "vs_one_card": vs_one}


def phase_cred_mesh(dev, tmp: Path, jsonl: Path, hg, cred_full: dict
                    ) -> dict:
    """Phase 16 (c): Stage A on a world of one over NCCL: full-graph steps
    in process against phase 12's kernel path, then the CLI's train-cred
    --mesh 1 in full-graph mode for one epoch, counted."""
    import torch
    import torch.distributed as dist
    from importlib import import_module
    mesh_mod = import_module(f"{PKG}.parallel.mesh")
    ct = import_module(f"{PKG}.train.cred_trainer")
    config = import_module(f"{PKG}.utils.config")
    adam = import_module(f"{PKG}.ops.adam")
    cli = import_module(f"{PKG}.cli.main")
    ref = cred_full["_ref"]
    steps = ref["steps"]
    cfg = config.CredConfig(trainer_mode="full_graph", epochs=CRED_EPOCHS)
    mesh = mesh_mod.make_mesh(1, device_type=dev.type)
    try:
        t0 = time.perf_counter()
        tr = ct.CredTrainer(hg, cfg, device=dev, mesh=mesh, verbose=False)
        setup = time.perf_counter() - t0

        def run():
            params = {k: v.clone() for k, v in ref["params0"].items()}
            opt = adam.adam_init(params)
            losses = torch.stack([
                tr.train_step(params, opt, ref["users"][s], ref["mask"][s],
                              seed_plan=ref["plans"][s]) for s in steps])
            torch.cuda.synchronize()
            return params, losses

        before = _counts_now()
        pm, lm = run()
        # 4 local sums a step forward (2 views x 2 operators), 4 backward
        per_step = {"sharded_spmm": 8, "gather_backward": CRED_GATHERS,
                    "fused_adam": CRED_ADAM}
        _launched(before, {k: v * len(steps) for k, v in per_step.items()},
                  "Stage-A mesh steps")
        loss_err, p_err, bit = _held(pm, lm, ref, "Stage-A mesh steps")
        params = {k: v.clone() for k, v in ref["params0"].items()}
        opt = adam.adam_init(params)
        p1 = {k: v.clone() for k, v in ref["params0"].items()}
        o1 = adam.adam_init(p1)
        single = cred_full["_trainer"]

        def mesh_step(j=0):
            s = steps[j % len(steps)]
            tr.train_step(params, opt, ref["users"][s], ref["mask"][s],
                          seed_plan=ref["plans"][s])

        def one_step(j=0):
            s = steps[j % len(steps)]
            single.train_step(p1, o1, ref["users"][s], ref["mask"][s],
                              seed_plan=ref["plans"][s])

        _no_scatter(mesh_step, "a Stage-A mesh step")
        step_ms = _in_turns({"one_card": one_step, "mesh": mesh_step},
                            MESH_STEP_ITERS)
    finally:
        dist.destroy_process_group()

    # ---- the CLI's train-cred --mesh 1, full graph, counted ----
    out = tmp / "cred_mesh"
    nb = cred_steps_per_epoch(hg, cfg.batch_size)
    reset_counts()
    t0 = time.perf_counter()
    res = cli.run(["train-cred", "--jsonl", str(jsonl), "--out", str(out),
                   "--device", str(dev), "--mesh", "1", "epochs=1",
                   "trainer_mode=full_graph"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # 8 local sums a step, 2 for the holdout evaluation, 2 for the
    # inference; 5 gather backwards and 1 Adam a step
    counts = read_counts({"sharded_spmm": 8 * nb + 2 + 2,
                          "gather_backward": CRED_GATHERS * nb,
                          "fused_adam": CRED_ADAM * nb},
                         "cred_full_graph_mesh path")
    _check_scores(res, hg.num_users, "train-cred --mesh 1", epochs=1)
    missing = [n for n in CRED_ARTEFACTS if not (out / n).is_file()]
    if missing:
        raise AssertionError(f"train-cred --mesh 1 wrote no {missing}")
    log(f"[phase 16c] Stage A on a world of one (NCCL): {len(steps)} "
        f"full-graph steps vs phase 12's one-card kernel path: losses "
        f"{[round(float(x), 7) for x in lm]} max diff {loss_err:.3g} (tol "
        f"{LOSS_ATOL:g}), params max abs diff {p_err:.3g}, bit-equal: "
        f"{bit}; launches a step {per_step}; no index_put/index_add/"
        f"indexing_backward in a profiled step; set-up {setup:.1f}s; step "
        f"ms mesh {step_ms['mesh']:.3f} one card {step_ms['one_card']:.3f}; "
        f"train-cred --mesh 1 trainer_mode=full_graph, 1 epoch ({nb} "
        f"steps): {wall:.1f}s, loss {res.history[0]['loss']:.6f}, holdout "
        f"AUC {res.history[0]['holdout_auc']:.4f}, scores in [0, 1]; "
        f"launches sharded_spmm {counts['sharded_spmm']} = 8 x {nb} + 2 + "
        f"2, gather_backward {counts['gather_backward']}, fused_adam "
        f"{counts['fused_adam']}")
    return {"launches_by_kernel": counts, "loss_max_diff": loss_err,
            "param_max_diff": p_err, "bit_equal": bit,
            "launches_per_step": per_step, "setup_s": setup,
            "step_ms": step_ms, "train_cred_wall_s": wall,
            "history": res.history}


def phase_train_two_ranks(tmp: Path, ctx: dict, parity: dict) -> dict:
    """Phase 16 (d): two ranks of this script on the one card over gloo,
    each training phase 7's steps on the (1, 2) mesh and then on the
    (2, 1) mesh in the same process: losses identical on both ranks, and
    within phase 7's tolerances of its one-card kernel path."""
    import torch
    ref = parity["_ref"]
    out = tmp / "mesh_two"
    out.mkdir(exist_ok=True)
    cols = list(zip(*[b[:4] for b in ref["batches"]]))
    np.savez(out / "train_inputs.npz", **ctx["params_np"],
             **{k: torch.stack(v).cpu().numpy()
                for k, v in zip(("users", "pos", "neg", "mask"), cols)})
    seconds = run_two_ranks(tmp, "train")
    dev = ref["losses"].device
    res = {}
    for tag in (f"1x{MESH_WORKERS}", f"{MESH_WORKERS}x1"):
        def ld(name, r):
            return torch.as_tensor(np.load(out / f"train_{tag}_{name}_r{r}.npy"),
                                   device=dev)
        losses = [ld("losses", r) for r in range(MESH_WORKERS)]
        if any(not torch.equal(x, losses[0]) for x in losses):
            raise AssertionError(f"{tag}: the ranks report different losses")
        errs = [_held({k: ld(k, r) for k in ref["params"]}, losses[r], ref,
                      f"two ranks {tag} rank {r}")
                for r in range(MESH_WORKERS)]
        rows = {k: int(ld(f"{k}_rows", 0)[0]) for k in ref["params"]}
        res[tag] = {"loss_max_diff": max(e[0] for e in errs),
                    "param_max_diff": max(e[1] for e in errs),
                    "bit_equal": all(e[2] for e in errs),
                    "block_rows": rows}
    log(f"[phase 16d] {MESH_WORKERS} ranks on one card over gloo, "
        f"{len(ref['batches'])} steps on the (1, {MESH_WORKERS}) mesh then on "
        f"the ({MESH_WORKERS}, 1) mesh in each process: losses identical on "
        f"both ranks; vs phase 7's one-card kernel path "
        + "; ".join(f"{tag}: losses max diff {r['loss_max_diff']:.3g}, "
                    f"params max abs diff {r['param_max_diff']:.3g}, "
                    f"bit-equal {r['bit_equal']}, block rows "
                    f"{r['block_rows']}" for tag, r in res.items())
        + f"; {seconds:.1f}s")
    return {"seconds": seconds, **res}


# --------------------------------------------------------------------------
# phase 17: the chunked backend on the main path
# --------------------------------------------------------------------------

CHUNKED_ITERS = 10            # CUDA-event loop of a propagate or a step
CHUNK_NAMES = ("chunk_spmm_block", "chunk_spmm_window")


def _chunk_launches(*directions) -> dict:
    """Launches by kernel of one application of each chunked direction
    (``ops/spmm.ChunkDirection``): one a slice, by its plan's kind."""
    out = {}
    for d in directions:
        for p in d.plans:
            name = CHUNK_NAMES[bool(p.window)]
            out[name] = out.get(name, 0) + 1
    return out


def _times(counts: dict, n: int) -> dict:
    return {k: v * n for k, v in counts.items()}


def _plus(*counts) -> dict:
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def _chunked_op(dev, slices="auto", precision="fp32"):
    """An operator factory of chunked ``SpmmOperator``s."""
    from importlib import import_module
    spmm = import_module(f"{PKG}.ops.spmm")
    return lambda em: spmm.SpmmOperator(em, dev, backend="chunked",
                                        precision=precision, slices=slices)


class _plain_chunks:
    """Within: chunked operators run the plain version of the chunk kernel
    (``chunk_spmm_blocks(backend="torch")``) on the card, to hold the
    kernel path against."""

    def __enter__(self):
        import functools
        from importlib import import_module
        self.mod = import_module(f"{PKG}.ops.spmm")
        self.real = self.mod.chunk_spmm_blocks
        self.mod.chunk_spmm_blocks = functools.partial(self.real,
                                                       backend="torch")

    def __exit__(self, *exc):
        self.mod.chunk_spmm_blocks = self.real


def _plan_stats(op) -> dict:
    return {side: [{"rows": p.num_dst, "blocks": p.num_blocks,
                    "chunks": p.num_chunks, "window": p.window,
                    "pad_pct": 100.0 * (p.padded_edges - int(
                        (p.local_ids < (p.window or p.block_rows)).sum()))
                    / max(p.padded_edges, 1)}
                   for p in getattr(op, side).plans]
            for side in ("fwd", "bwd")}


def phase_chunked_serving(dev, tmp: Path, ctx: dict, res: dict) -> dict:
    """Phase 17 (a)-(c): serving on the chunked backend, counted; bf16
    against the plain chunked version; sliced against unsliced."""
    import torch
    from importlib import import_module
    cli = import_module(f"{PKG}.cli.main")
    trainer_mod = import_module(f"{PKG}.train.trainer")
    retrieval = import_module(f"{PKG}.eval.retrieval")
    lightgcn = import_module(f"{PKG}.models.lightgcn")
    cs = import_module(f"{PKG}.ops.chunk_spmm")
    graph, cfg = ctx["graph"], ctx["cfg"]
    K = cfg.num_layers
    cfg_c = cfg.replace(spmm_backend="chunked")
    params = _params(ctx, dev)
    tr_csr = trainer_mod.RecTrainer(cfg, graph, device=dev, verbose=False)
    users = torch.as_tensor(tr_csr.ctx.eval_users["test"][:512], device=dev)
    excl = torch.as_tensor(
        retrieval.exclusion_rows_for_users(graph, users.cpu().numpy()),
        device=dev)
    with torch.no_grad():
        u_csr, i_csr = tr_csr.model.propagate(params)
    _, top_csr = retrieval.topk_for_users(u_csr, i_csr, users, 20,
                                          exclude_batch_rows=excl)

    # ---- (a) the serving path on chunk plans, counted ----
    reset_counts()
    t0 = time.perf_counter()
    res_s = cli.run(_evaluate_args(tmp, dev, "sampled")
                    + ["spmm_backend=chunked"])
    res_f = cli.run(_evaluate_args(tmp, dev, "full")
                    + ["spmm_backend=chunked"])
    tr = trainer_mod.RecTrainer(cfg_c, graph, device=dev, verbose=False)
    with torch.no_grad():
        u_c, i_c = tr.model.propagate(params)
    top_s, top_c = retrieval.topk_for_users(u_c, i_c, users, 20,
                                            exclude_batch_rows=excl)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = tr.model
    ifu, ufi = m.item_from_user, m.user_from_item
    if m._padded_chain() is None:
        raise AssertionError("the chunked operators' padded chain is off")
    per_prop = _times(_chunk_launches(ifu.fwd, ufi.fwd), K)
    # and one top-k select a batch of the full evaluation, one for
    # topk_for_users
    counts = read_counts({**_times(per_prop, 3), "topk_select":
                          full_eval_calls(graph, "test") + 1},
                         "serving_chunked path")
    if not (_close(u_c, u_csr) and _close(i_c, i_csr)):
        raise AssertionError("chunked tables differ from the CSR kernel's")
    tab_err = max(float((u_c - u_csr).abs().max()),
                  float((i_c - i_csr).abs().max()))
    err_s = _metrics_equal(res_s, res["metrics_sampled"])
    err_f = _metrics_equal(res_f, res["metrics_full"])
    jac = _jaccard(top_c.cpu().numpy(), top_csr.cpu().numpy())
    if jac.mean() < 0.99 or not torch.isfinite(top_s).all():
        raise AssertionError(f"chunked top-20 Jaccard {jac.mean()} < 0.99")

    # the path's plans at reference scale, each held against the plain
    # version (fp32 bound) and bit for bit against its ordered CPU sums, in
    # fp32 and bf16, with two launches bit-identical
    worst = {}
    x_of = {"fwd": {id(ifu): params["user_emb"], id(ufi): params["item_emb"]},
            "bwd": {id(ifu): i_c, id(ufi): u_c}}
    n_checked = 0
    for op in (ifu, ufi):
        for side in ("fwd", "bwd"):
            x32 = x_of[side][id(op)].contiguous()
            for p in getattr(op, side).plans:
                for x in (x32, x32.to(torch.bfloat16)):
                    _chunk_check(cs, p, x, torch.int32, f"{side} {p.num_dst} "
                                 f"rows W={p.window} {x.dtype}", worst)
                    n_checked += 1

    # ---- (b) bf16: the kernel path against the plain chunked version ----
    tr_b = trainer_mod.RecTrainer(cfg_c.replace(spmm_precision="bf16"),
                                  graph, device=dev, verbose=False)
    with torch.no_grad():
        u_b, i_b = tr_b.model.propagate(params)
        with _plain_chunks():
            u_bp, i_bp = tr_b.model.propagate(params)
    bf16_rel = 0.0
    for got, want in ((u_b, u_bp), (i_b, i_bp)):
        row = want.abs().amax(dim=1, keepdim=True)
        diff = (got - want).abs()
        if bool((diff > BF16_ROW_TOL * row + FP32_ATOL).any()):
            raise AssertionError(f"bf16 chunked tables differ from the plain "
                                 f"chunked version by {float(diff.max())}")
        bf16_rel = max(bf16_rel, float((diff / (row + 1e-30)).max()))

    # ---- (c) sliced and unsliced, and two runs: bit-equal ----
    m1 = lightgcn.LightGCN(cfg_c, graph, tr.cred, device=dev,
                           operator_factory=_chunked_op(dev, slices=1))
    with torch.no_grad():
        u_1, i_1 = m1.propagate(params)
        u_2, i_2 = m.propagate(params)
    if len(m1.item_from_user.fwd.plans) != 1:
        raise AssertionError("slices=1 built more than one slice")
    if not (torch.equal(u_1, u_c) and torch.equal(i_1, i_c)):
        raise AssertionError("sliced and unsliced propagates differ")
    if not (torch.equal(u_2, u_c) and torch.equal(i_2, i_c)):
        raise AssertionError("two chunked propagates differ")
    stats = {"item<-user": _plan_stats(ifu), "user<-item": _plan_stats(ufi)}
    log(f"[phase 17a] serving on chunk plans (spmm_backend=chunked, "
        f"cu_message D={cfg.emb_dim} K={K}): item<-user "
        + ", ".join(f"{s['rows']} rows W={s['window']} {s['chunks']} chunks "
                    f"pad {s['pad_pct']:.1f}%" for s in stats["item<-user"]
                    ["fwd"])
        + "; user<-item " + ", ".join(
            f"{s['rows']} rows W={s['window']} {s['chunks']} chunks pad "
            f"{s['pad_pct']:.1f}%" for s in stats["user<-item"]["fwd"])
        + f"; launches {counts} = 3 propagates x {per_prop}; tables vs the "
        f"CSR kernel's max abs diff {tab_err:.3g} (tol {FP32_ATOL:g} + "
        f"{FP32_RTOL:g}*|ref|), sampled metrics diff {err_s:.3g}, full "
        f"{err_f:.3g} (tol 1e-6), top-20 Jaccard mean {jac.mean():.6f}; "
        f"{n_checked} plans of the path (fp32 and bf16) bit-equal to the "
        f"plain version's CPU sums, max abs err vs the card's plain version "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
        + f"; path {wall:.1f}s")
    log(f"[phase 17b-c] bf16 chunked propagate vs the plain chunked version "
        f"on the card: max row-relative diff {bf16_rel:.3g} (tol "
        f"{BF16_ROW_TOL:g}); slices=1 and slices=auto propagates bit-equal, "
        f"two runs bit-equal")
    return {"launches_by_kernel": counts, "launches_per_propagate": per_prop,
            "table_max_diff": tab_err, "metrics_diff": [err_s, err_f],
            "jaccard_mean": float(jac.mean()), "plans": stats,
            "max_abs_err": worst, "plans_checked": n_checked,
            "bf16_row_rel_diff": bf16_rel, "path_s": wall,
            "_models": {"chunked": tr, "bf16": tr_b, "s1": m1,
                        "csr": tr_csr}}


def phase_chunked_training(dev, tmp: Path, ctx: dict, train: dict,
                           p7: dict, serving: dict) -> dict:
    """Phase 17 (d): train-rec on the chunked backend, counted; 3 steps
    against phase 7's CSR kernel path; reruns; a profiled step."""
    import torch
    from importlib import import_module
    cli = import_module(f"{PKG}.cli.main")
    trainer_mod = import_module(f"{PKG}.train.trainer")
    adam = import_module(f"{PKG}.ops.adam")
    graph, cfg = ctx["graph"], ctx["cfg"]
    K = cfg.num_layers
    m = serving["_models"]["chunked"].model
    ifu, ufi = m.item_from_user, m.user_from_item
    per_eval = _times(_chunk_launches(ifu.fwd, ufi.fwd), K)
    per_step = _times(_chunk_launches(ifu.fwd, ufi.fwd, ifu.bwd, ufi.bwd), K)
    nb = train["steps_per_epoch"]
    n_evals = TRAIN_EPOCHS // cfg.eval_every + 1
    out = tmp / "rec_chunked"

    reset_counts()
    t0 = time.perf_counter()
    res = cli.run(["train-rec", "--graph", str(tmp / "graph.npz"),
                   "--preset", "cu_message", "--cred", str(tmp / "cred.csv"),
                   "--out", str(out), "--checkpoint", "--device", str(dev),
                   f"epochs={TRAIN_EPOCHS}", "spmm_backend=chunked"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(
        {**_plus(_times(per_step, nb * TRAIN_EPOCHS),
                 _times(per_eval, n_evals)),
         "gather_backward": (2 * K + 4) * nb * TRAIN_EPOCHS,
         "fused_adam": nb * TRAIN_EPOCHS}, "training_chunked path")
    losses = [h.loss for h in res.history]
    if len(losses) != TRAIN_EPOCHS or not all(np.isfinite(losses)):
        raise AssertionError(f"chunked epoch losses {losses}")
    if not any((out / "ckpt").glob("*.pt")):
        raise AssertionError("chunked train-rec wrote no checkpoint")
    written = json.loads((out / "test_metrics.json").read_text())
    ev = cli.run(["evaluate", "--graph", str(tmp / "graph.npz"),
                  "--params", str(out / "best_model.npz"),
                  "--preset", "cu_message", "--cred", str(tmp / "cred.csv"),
                  "--split", "test", "--device", str(dev),
                  "spmm_backend=chunked"])
    ev_err = _metrics_equal({int(k): v for k, v in written.items()}, ev)

    # ---- 3 steps from phase 7's parameters and batches ----
    ref = p7["_ref"]
    tr = trainer_mod.RecTrainer(ctx["cfg"].replace(spmm_backend="chunked"),
                                graph, device=dev, verbose=False)
    batches = [b[:5] + (tr.step_plans(b[0][None], b[1][None],
                                      b[2][None])[0],)
               for b in ref["batches"]]
    if batches[0][5][1].num_dst != ufi.src_layout.padded_rows:
        raise AssertionError("the chunked step's item plan is not over the "
                             "padded item table")

    def run():
        params = _params(ctx, dev)
        opt = adam.adam_init(params)
        losses = torch.stack([tr.train_step(params, opt, *b)
                              for b in batches])
        torch.cuda.synchronize()
        return params, losses

    S = len(batches)
    before = _counts_now()
    pc, lc = run()
    _launched(before, {**_times(per_step, S),
                       "gather_backward": (2 * K + 4) * S,
                       "fused_adam": S}, "chunked train steps")
    loss_err, p_err, bit_csr = _held(pc, lc, ref, "chunked train steps "
                                     "against phase 7's CSR kernel path")
    pc2, lc2 = run()
    bit = torch.equal(lc, lc2) and all(torch.equal(pc[k], pc2[k]) for k in pc)
    if not bit:
        raise AssertionError("two chunked train-step runs differ")
    p1 = _params(ctx, dev)
    o1 = adam.adam_init(p1)
    _no_scatter(lambda: tr.train_step(p1, o1, *batches[0]),
                "a chunked train step")
    log(f"[phase 17d] train-rec spmm_backend=chunked, {TRAIN_EPOCHS} epochs "
        f"with checkpoints in {wall:.1f}s (phase 6, CSR: "
        f"{train['train_rec_wall_s']:.1f}s): epoch losses "
        f"{[round(x, 6) for x in losses]} (CSR {[round(x, 6) for x in train['epoch_losses']]}); "
        f"launches {counts} = {per_step} x {nb} x {TRAIN_EPOCHS} + "
        f"{per_eval} x {n_evals}, gather_backward {2 * K + 4} and fused_adam "
        f"1 a step; evaluate reproduces test_metrics.json (diff "
        f"{ev_err:.3g}); {S} steps vs phase 7's CSR kernel path: losses "
        f"max diff {loss_err:.3g} (tol {LOSS_ATOL:g}), params "
        f"{p_err:.3g} (tol {TRAIN_ATOL:g} + {TRAIN_RTOL:g}*|ref|), bit-equal "
        f"{bit_csr}; two chunked runs bit-identical; no index_put/index_add/"
        f"indexing_backward in a profiled step")
    return {"launches_by_kernel": counts, "launches_per_step": per_step,
            "train_rec_wall_s": wall, "epoch_losses": losses,
            "epoch_seconds": [h.seconds for h in res.history],
            "evaluate_diff": ev_err, "loss_max_diff": loss_err,
            "param_max_diff": p_err, "bit_equal_to_csr": bit_csr,
            "_trainer": tr, "_batches": batches}


def phase_chunked_cred(dev, hg, c12: dict) -> dict:
    """Phase 17 (e): 3 Stage-A full-graph steps on chunk plans, counted,
    against phase 12's CSR kernel path."""
    import torch
    from importlib import import_module
    ct = import_module(f"{PKG}.train.cred_trainer")
    adam = import_module(f"{PKG}.ops.adam")
    ref = c12["_ref"]
    cfg = c12["_trainer"].cfg
    reset_counts()
    tr = ct.CredTrainer(hg, cfg, device=dev, backend="chunked", verbose=False)

    def run():
        params = {k: v.clone() for k, v in ref["params0"].items()}
        opt = adam.adam_init(params)
        losses = torch.stack([tr.train_step(params, opt, ref["users"][s],
                                            ref["mask"][s],
                                            seed_plan=ref["plans"][s])
                              for s in ref["steps"]])
        torch.cuda.synchronize()
        return params, losses

    pc, lc = run()
    S = len(ref["steps"])
    views = [tr.model.views[v] for v in ("early", "late")]
    per_step = _plus(*(_chunk_launches(v.item_from_user.fwd,
                                       v.user_from_item.fwd,
                                       v.item_from_user.bwd,
                                       v.user_from_item.bwd) for v in views))
    counts = read_counts({**_times(per_step, S),
                          "gather_backward": CRED_GATHERS * S,
                          "fused_adam": CRED_ADAM * S},
                         "cred_full_graph_chunked path")
    # Stage A's losses are O(1e4) (phase 12): summed in another order than
    # the CSR kernel's, they differ in their last bits, so the losses are
    # held to a few ulps
    loss_err, p_err, bit_csr = _held(pc, lc, ref, "Stage-A chunked steps "
                                     "against phase 12's CSR kernel path",
                                     loss_rtol=STAGE_A_LOSS_RTOL)
    ulps = (lc - ref["losses"]).abs() / torch.finfo(torch.float32).eps / \
        torch.exp2(torch.floor(torch.log2(ref["losses"].abs())))
    pc2, lc2 = run()
    bit = torch.equal(lc, lc2) and all(torch.equal(pc[k], pc2[k]) for k in pc)
    if not bit:
        raise AssertionError("two Stage-A chunked runs differ")
    plans = {v: {"item<-user": _plan_stats(tr.model.views[v].item_from_user),
                 "user<-item": _plan_stats(tr.model.views[v].user_from_item)}
             for v in ("early", "late")}
    log(f"[phase 17e] Stage A full-graph on chunk plans: {S} steps vs "
        f"phase 12's CSR kernel path: losses "
        f"{[round(float(x), 7) for x in lc]} max diff {loss_err:.3g}, in "
        f"ulps {[float(u) for u in ulps]} (tol {LOSS_ATOL:g} + "
        f"{STAGE_A_LOSS_RTOL:.3g}*|ref|), params {p_err:.3g} (tol "
        f"{TRAIN_ATOL:g} + {TRAIN_RTOL:g}*|ref|), bit-equal {bit_csr}; two "
        f"runs "
        f"bit-identical; launches {counts} ({per_step} a step)")
    return {"launches_by_kernel": counts, "launches_per_step": per_step,
            "loss_max_diff": loss_err, "loss_ulps": [float(u) for u in ulps],
            "param_max_diff": p_err, "bit_equal_to_csr": bit_csr,
            "plans": plans}


SPMM_KINDS = {"staged": "chunk_staged_kernel", "long_rows": "long_rows_kernel",
              "rows": "rows_kernel"}


def _device_host(fn, dev, queue: int = 0) -> dict:
    """Device ms a call: ``queue`` calls queued ahead of the card
    (``queued_device_ms``; calls whose host time fits the spin), else the
    busy time of a profiled window of 3 calls; the SpMM kernels' own device
    ms (the staged chunk kernel, the CSR row kernels) from a profiled window
    of 5 calls that holds every one of their launches (the profiler can drop
    records: a window is taken again, up to three, else "not measured",
    None); host us a call."""
    import torch
    from importlib import import_module
    timing = import_module(f"{PKG}.probes._timing")
    before = _counts_now()
    fn()
    torch.cuda.synchronize()
    n = {k: v - before[k] for k, v in _counts_now().items()}
    want = {"staged": n["chunk_spmm_block"] + n["chunk_spmm_window"],
            "rows": n["segment_spmm"] + n["gather_backward"]}
    spmm = None
    for _ in range(3 if sum(want.values()) else 0):
        split, count = profile_split(fn, SPMM_KINDS, calls=5)
        if all(count.get(k, 0) == v for k, v in want.items()):
            spmm = sum(split.get(k, 0.0) for k in SPMM_KINDS)
            break
    out = {"spmm_device_ms": spmm, "host_us": host_us_per_call(fn, 20)}
    if queue:
        out["device_ms"] = timing.queued_device_ms(fn, dev, queue)
    else:
        prof = profile_steps(lambda j: fn(), 3)
        out["device_ms"] = prof["device_ms"] / 3
        out["busy_share"] = prof["busy_share"]
    return out


def _ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f}"


def phase_chunked_times(dev, ctx: dict, serving: dict, training: dict,
                        p7: dict) -> dict:
    """Phase 17 (f): times in turns with the CSR path: each direction's
    apply at S = auto and S = 1, fp32 and bf16 (beside its bound and
    torch.sparse.mm), the propagate and the train step."""
    import torch
    from importlib import import_module
    timing = import_module(f"{PKG}.probes._timing")
    sc = import_module(f"{PKG}.ops.spmm_cuda")
    adam = import_module(f"{PKG}.ops.adam")
    trainer_mod = import_module(f"{PKG}.train.trainer")
    mods = serving["_models"]
    params = _params(ctx, dev)
    graph = ctx["graph"]
    m, m1, mb = mods["chunked"].model, mods["s1"], mods["bf16"].model
    csr = mods["csr"].model
    mb1 = import_module(f"{PKG}.models.lightgcn").LightGCN(
        ctx["cfg"].replace(spmm_backend="chunked", spmm_precision="bf16"),
        graph, mods["chunked"].cred, device=dev,
        operator_factory=_chunked_op(dev, slices=1, precision="bf16"))
    dirs = []
    for role, attr, x32 in (("item<-user", "item_from_user",
                             params["user_emb"]),
                            ("user<-item", "user_from_item",
                             params["item_emb"])):
        ops = {"S=auto": getattr(m, attr), "S=1": getattr(m1, attr),
               "bf16 S=auto": getattr(mb, attr), "bf16 S=1": getattr(mb1, attr)}
        c = getattr(csr, attr).fwd
        xb = x32.to(torch.bfloat16)
        xp = {k: o.src_layout.to_padded(xb if k.startswith("bf16") else x32)
              for k, o in ops.items()}
        fns = {k: (lambda o=o, x=xp[k]: o.apply_padded(x))
               for k, o in ops.items()}

        def plain(k):
            def run():
                with _plain_chunks():
                    return fns[k]()
            return run
        # the plain version of the chunk kernel on the card, same plans
        fns["plain S=auto"], fns["plain bf16 S=auto"] = (
            plain("S=auto"), plain("bf16 S=auto"))
        fns["csr"] = lambda: getattr(csr, attr).apply(x32)
        fns["csr bf16"] = lambda: sc.KERNEL(c.indptr, c.src, c.w, xb,
                                            pieces=c.pieces)
        sp = torch.sparse_csr_tensor(c.indptr, c.src.long(), c.w,
                                     size=(c.num_dst, c.num_src))
        fns["torch.sparse.mm"] = lambda: torch.sparse.mm(sp, x32)
        with torch.no_grad():
            ms = _in_turns(fns, 20)
            entry = {"direction": role, "ms": ms,
                     "bound_ms": {k: sum(timing.plan_bound_ms(
                         p, 64, x_bytes=2 if k.startswith("bf16") else 4)
                         for p in o.fwd.plans) for k, o in ops.items()},
                     "slices": {k: len(o.fwd.plans) for k, o in ops.items()},
                     "window": ops["S=auto"].fwd.plans[0].window,
                     **{k: _device_host(fns[k], dev, 20) for k in fns}}
        entry["bound_ms"]["csr"] = bound_ms(c, 64, 4)
        entry["bound_ms"]["csr bf16"] = bound_ms(c, 64, 2)
        try:
            spb = torch.sparse_csr_tensor(c.indptr, c.src.long(),
                                          c.w.to(torch.bfloat16),
                                          size=(c.num_dst, c.num_src))
            with torch.no_grad():
                entry["ms"]["torch.sparse.mm bf16"] = cuda_time_ms(
                    lambda: torch.sparse.mm(spb, xb), 20)
        except RuntimeError as e:       # the library may lack this dtype
            entry["ms"]["torch.sparse.mm bf16"] = None
            entry["sparse_mm_bf16_error"] = str(e)[:200]
        dirs.append(entry)

    # the propagate, in turns
    models = {"csr": csr, "S=auto": m, "S=1": m1, "bf16 S=auto": mb,
              "bf16 S=1": mb1}
    props = {k: (lambda mm=mm: mm.propagate(params)) for k, mm in
             models.items()}
    with torch.no_grad():
        prop_ms = _in_turns(props, CHUNKED_ITERS)
        prop_dev = {k: _device_host(f, dev, 5) for k, f in props.items()}

    # the train step, in turns: phase 7's CSR trainer, the chunked one
    # (S = auto), S = 1 and bf16
    ref = p7["_ref"]
    single = p7["_trainer"]
    cfg_c = ctx["cfg"].replace(spmm_backend="chunked")
    trainers = {"csr": (single, [b for b in ref["batches"]]),
                "S=auto": (training["_trainer"], training["_batches"])}
    for key, kw in (("S=1", dict(operator_factory=_chunked_op(dev, 1))),
                    ("bf16 S=auto", dict(cfg=cfg_c.replace(
                        spmm_precision="bf16")))):
        t = trainer_mod.RecTrainer(kw.get("cfg", cfg_c), graph, device=dev,
                                   verbose=False,
                                   operator_factory=kw.get("operator_factory"))
        trainers[key] = (t, [b[:5] + (t.step_plans(b[0][None], b[1][None],
                                                   b[2][None])[0],)
                             for b in ref["batches"]])
    state = {k: _params(ctx, dev) for k in trainers}
    opts = {k: adam.adam_init(p) for k, p in state.items()}
    steps = {k: (lambda k=k, t=t, bs=bs: t.train_step(state[k], opts[k],
                                                      *bs[0]))
             for k, (t, bs) in trainers.items()}
    step_ms = _in_turns(steps, CHUNKED_ITERS)
    step_dev = {k: _device_host(f, dev) for k, f in steps.items()}
    log("[phase 17f] times (ms; CUDA events in turns, best of two; device "
        "ms of calls queued ahead of the card (a step's: the profiler's busy "
        "time), the SpMM kernels' own from the profiler; host us a call): "
        + "; ".join(
            f"{d['direction']} (W={d['window']}, slices "
            f"{d['slices']['S=auto']}) " + ", ".join(
                f"{k} {v:.4f}" if v is not None else f"{k} not measured"
                for k, v in d["ms"].items())
            + " | device (SpMM kernels alone) " + ", ".join(
                f"{k} {_ms(d[k]['device_ms'])} "
                f"({_ms(d[k]['spmm_device_ms'])})" for k in d["ms"] if k in d)
            + " | bound " + ", ".join(f"{k} {v:.4f}" for k, v in
                                      d["bound_ms"].items())
            for d in dirs)
        + "; propagate " + ", ".join(
            f"{k} {v:.3f} (device {_ms(prop_dev[k]['device_ms'])}, SpMM "
            f"{_ms(prop_dev[k]['spmm_device_ms'])}, host "
            f"{prop_dev[k]['host_us']:.0f} us)" for k, v in prop_ms.items())
        + "; train step " + ", ".join(
            f"{k} {v:.3f} (device {_ms(step_dev[k]['device_ms'])}, SpMM "
            f"{_ms(step_dev[k]['spmm_device_ms'])}, host "
            f"{step_dev[k]['host_us']:.0f} us)" for k, v in step_ms.items()))
    return {"directions": dirs, "propagate_ms": prop_ms,
            "propagate_device": prop_dev, "step_ms": step_ms,
            "step_device": step_dev}


# --------------------------------------------------------------------------
# phase 18: the north star (bench.py, scripts/two_stage_10m.py)
# --------------------------------------------------------------------------

# the bench's headline at reference scale (phase 3's graph), in both modes
BENCH_ARGS = ["--scale", "ref", "--iters", "4", "--no-northstar"]
BENCH_REF_EDGES = 360_207     # the reference graph's train edges
BENCH_LAYERS = 3              # the bench's default --layers
JAX_HEADLINE_KEYS = ("metric", "value", "unit", "vs_baseline",
                     "vs_baseline_same_precision")
JAX_NORTHSTAR_KEYS = ("metric", "value", "unit", "definition", "propagate_s",
                      "epoch_s")
# the planted graph's train / val / test edges in the JAX package's 10M run
# (runs/two_stage_10m/pipeline.log)
NORTHSTAR_SPLIT = (6_899_612, 864_551, 861_347)
NORTHSTAR_ITERS = 3           # bench_northstar's timed loops (the JAX bench's)
NORTHSTAR_SAMPLE = 4096       # val users of the top-20 check
TOPK_BATCH = 512              # users a ranking call (the preset's eval_batch)
NORTHSTAR_GATHERS = 4         # gather backwards a per_epoch step
# epochs of the two-stage run: Stage A (SLAS) and Stage B, of the JAX
# script's 6 and 12
TWO_STAGE_EPOCHS = (1, 1)


def _tee(out) -> tuple:
    """A stdout that writes to ``out`` and keeps what was written:
    (the stream, its buffer)."""
    import io
    from importlib import import_module
    buf = io.StringIO()
    return import_module(f"{PKG}.scripts.reference_regression").Tee(
        out, buf), buf


@contextlib.contextmanager
def _peak_gb(peaks: dict, name: str):
    """Records in ``peaks[name]`` the card's peak allocated GB inside."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    yield
    torch.cuda.synchronize()
    peaks[name] = torch.cuda.max_memory_allocated() / 1e9


def _finite_metrics(res: dict, tag: str) -> None:
    for K, r in res.items():
        if not all(np.isfinite(r[m]) and 0.0 <= r[m] <= 1.0
                   for m in ("precision", "recall", "ndcg")):
            raise AssertionError(f"{tag}: metric out of range at K={K}: {r}")


def phase_bench_headline(dev) -> dict:
    """Phase 18 (a): the port's ``bench.main`` in process at reference
    scale, ``--mode epoch`` (the headline) and ``--mode step``: one JSON
    line each with the JAX bench's keys, a finite positive value and
    ``edges_per_step`` = E*K*2*2 (E = 360,207, K = 3); the kernel path
    launched the SpMM, the gathers' backward and Adam."""
    import io
    from importlib import import_module
    bench = import_module(f"{PKG}.bench")
    out = {}
    for mode in ("epoch", "step"):
        buf = io.StringIO()
        before = _counts_now()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            ret = bench.main(BENCH_ARGS + ["--mode", mode,
                                           "--device", str(dev)])
        wall = time.perf_counter() - t0
        lines = [json.loads(ln) for ln in buf.getvalue().splitlines()
                 if ln.startswith("{")]
        if lines != [json.loads(json.dumps(ret))]:
            raise AssertionError(f"bench --mode {mode} printed {lines}")
        line = lines[0]
        missing = [k for k in JAX_HEADLINE_KEYS if k not in line]
        if missing or line["metric"] != "train_edges_per_sec_per_chip":
            raise AssertionError(f"bench --mode {mode}: {line} lacks "
                                 f"{missing}")
        if not (np.isfinite(line["value"]) and line["value"] > 0
                and line["vs_baseline"] > 0):
            raise AssertionError(f"bench --mode {mode}: {line}")
        if line["edges_per_step"] != BENCH_REF_EDGES * BENCH_LAYERS * 4:
            raise AssertionError(f"bench --mode {mode}: edges_per_step "
                                 f"{line['edges_per_step']}")
        launched = {n: k.launches - before[n]
                    for n, k in kernel_counters().items()}
        if not all(launched[n] for n in ("segment_spmm", "gather_backward",
                                         "fused_adam")):
            raise AssertionError(f"bench --mode {mode} launched {launched}")
        out[mode] = {"line": line, "wall_s": wall,
                     "launches_by_kernel": launched}
        log(f"[phase 18a] bench --mode {mode} ({wall:.1f}s, launches "
            f"{launched}): {json.dumps(line)}")
    return out


def phase_northstar(dev, graph) -> dict:
    """Phase 18 (b): the ``scaled_10m`` preset at full width on the planted
    10M-edge graph.  Counted as the ``northstar`` path: ``bench_northstar``
    (its propagations and epochs), then one full evaluate on val.  Held on
    the card against the plain path (``spmm_backend="torch"``): the
    propagated tables, 3 steps, the top-20 of NORTHSTAR_SAMPLE val users;
    a profiled step runs no stock scatter.  Times: the host's set-up by
    part, the propagate, the epoch by part, the step split, the kernels at
    these shapes; the card's peak memory by part."""
    import torch
    from importlib import import_module
    bench = import_module(f"{PKG}.bench")
    operators = import_module(f"{PKG}.graph.operators")
    spmm = import_module(f"{PKG}.ops.spmm")
    sampling = import_module(f"{PKG}.ops.sampling")
    ranking = import_module(f"{PKG}.eval.ranking")
    retrieval = import_module(f"{PKG}.eval.retrieval")
    adam = import_module(f"{PKG}.ops.adam")
    sc = import_module(f"{PKG}.ops.spmm_cuda")
    tm = import_module(f"{PKG}.probes._timing")
    peaks = {}

    # ---- the host's set-up: the trainer, then each part alone ----
    host = {}
    t = time.perf_counter()
    with _peak_gb(peaks, "trainer"):
        tr = bench.northstar_trainer(graph, dev)
    host["trainer_s"] = time.perf_counter() - t
    cfg = tr.cfg
    K = cfg.num_layers
    t = time.perf_counter()
    em = operators.build_edge_maps(graph, cfg.weight_mode, tr.cred)[0]
    host["edge_maps_s"] = time.perf_counter() - t
    t = time.perf_counter()
    d = spmm.CsrDirection.from_edges(em.src, em.dst, em.w, em.num_src,
                                     em.num_dst, dev)
    torch.cuda.synchronize()
    host["csr_direction_s"] = time.perf_counter() - t
    t = time.perf_counter()
    sc.long_row_pieces(d.indptr)
    host["long_row_pieces_s"] = time.perf_counter() - t
    del em, d
    deg_i = graph.train_item_degrees()
    t = time.perf_counter()
    sampling.build_alias_table((deg_i + 1.0) ** cfg.neg_pop_gamma)
    host["alias_table_s"] = time.perf_counter() - t
    t = time.perf_counter()
    sampling.PopMixSampler.build(deg_i, dev, mix_pop=cfg.neg_mix_pop,
                                 gamma=cfg.neg_pop_gamma)
    host["popmix_sampler_s"] = time.perf_counter() - t
    t = time.perf_counter()
    ranking.EvalContext.build(graph, dev, membership=cfg.membership)
    torch.cuda.synchronize()
    host["eval_context_s"] = time.perf_counter() - t
    nb = -(-tr.train_users.size // cfg.batch_size)
    it = NORTHSTAR_ITERS

    # ---- the northstar path, counted ----
    reset_counts()
    t = time.perf_counter()
    with _peak_gb(peaks, "bench_northstar"):
        line = bench.bench_northstar(trainer=tr, iters=it)
    bench_s = time.perf_counter() - t
    params, _, gen = tr.init_state()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with _peak_gb(peaks, "evaluate_full_val"):
        val = tr.evaluate(params, "val")
    eval_s = time.perf_counter() - t
    # a propagation: 2K SpMM; an epoch: its cache's propagation, then nb
    # steps of 4 gather backwards and one Adam launch; each loop runs
    # one call untimed first; the evaluate: one propagation and a top-k
    # select a batch
    counts = read_counts(
        {"segment_spmm": 2 * K * (1 + it) * 2 + 2 * K,
         "gather_backward": NORTHSTAR_GATHERS * nb * (1 + it),
         "fused_adam": nb * (1 + it),
         "topk_select": full_eval_calls(graph, "val", cfg.eval_batch)},
        "northstar path")
    missing = [k for k in JAX_NORTHSTAR_KEYS if k not in line]
    E = graph.train_edges.shape[1]
    if missing or line["metric"] != \
            "northstar_propagation_edges_per_sec_per_chip" \
            or line["value"] != E * 2 * K / line["propagate_s"] \
            or not (line["value"] > 0 and line["epoch_s"] > 0):
        raise AssertionError(f"bench_northstar returned {line}")
    _finite_metrics(val, "northstar full evaluate")
    log(f"[phase 18b] northstar (scaled_10m D={cfg.emb_dim} K={K} batch "
        f"{cfg.batch_size}, {nb} steps an epoch): host set-up "
        + ", ".join(f"{k} {v:.2f}" for k, v in host.items())
        + f"; bench_northstar ({it} timed + 1) {bench_s:.1f}s: "
        f"{json.dumps(line)}; full evaluate on val {eval_s:.2f}s (R@20 "
        f"{val[20]['recall']:.6f}, {val[20]['users_eval']} users); "
        f"launches {counts}")

    # ---- held on the card against the plain path ----
    with _peak_gb(peaks, "plain_trainer"):
        tr_p = bench.northstar_trainer(graph, dev, spmm_backend="torch")
    with torch.no_grad(), _peak_gb(peaks, "propagate_pair"):
        u_k, i_k = tr.model.propagate(params)
        before = _counts_now()
        u_p, i_p = tr_p.model.propagate(params)
        _launched(before, {}, "the plain propagate")
    if not (_close(u_k, u_p) and _close(i_k, i_p)):
        raise AssertionError("northstar: propagated tables differ from the "
                             "plain path's")
    tab_err = max(float((u_k - u_p).abs().max()),
                  float((i_k - i_p).abs().max()))
    users, pos, neg, mask = tr.draw_epoch(gen)
    plans = tr.step_plans(users[:PARITY_STEPS], pos[:PARITY_STEPS],
                          neg[:PARITY_STEPS])

    def run_steps(t_):
        p = {k: v.clone() for k, v in params.items()}
        o = adam.adam_init(p)
        cached = t_._epoch_cache(p)
        losses = torch.stack([
            t_.train_step(p, o, users[s], pos[s], neg[s], mask[s], cached,
                          plans[s]) for s in range(PARITY_STEPS)])
        torch.cuda.synchronize()
        return p, losses

    before = _counts_now()
    with _peak_gb(peaks, "three_steps"):
        pk, lk = run_steps(tr)
    _launched(before, {"segment_spmm": 2 * K,
                       "gather_backward": NORTHSTAR_GATHERS * PARITY_STEPS,
                       "fused_adam": PARITY_STEPS}, "northstar kernel steps")
    before = _counts_now()
    pp, lp = run_steps(tr_p)
    _launched(before, {}, "northstar plain steps")
    loss_err, p_err, bit = _held(pk, lk, {"params": pp, "losses": lp},
                                 "northstar: the kernel path against the "
                                 "plain path")
    del pk, pp
    sample = tr.ctx.eval_users["val"][:NORTHSTAR_SAMPLE]
    tops = ([], [])
    for s in range(0, sample.size, TOPK_BATCH):
        us = sample[s:s + TOPK_BATCH]
        ut = torch.as_tensor(us, device=dev)
        excl = torch.as_tensor(retrieval.exclusion_rows_for_users(graph, us),
                               device=dev)
        for top, (ue, ie) in zip(tops, ((u_k, i_k), (u_p, i_p))):
            top.append(retrieval.topk_for_users(
                ue, ie, ut, 20, exclude_batch_rows=excl)[1].cpu().numpy())
    jac = _jaccard(np.concatenate(tops[0]), np.concatenate(tops[1]))
    if jac.mean() < 0.99:
        raise AssertionError(f"northstar top-20 Jaccard {jac.mean()} < 0.99")
    del u_p, i_p, tr_p
    p3 = {k: v.clone() for k, v in params.items()}
    o3 = adam.adam_init(p3)
    cached = tr._epoch_cache(p3)

    def step(j=0):
        tr.train_step(p3, o3, users[j], pos[j], neg[j], mask[j], cached,
                      plans[j])

    _no_scatter(step, "northstar step")
    log(f"[phase 18b] vs the plain path on the card: tables max abs diff "
        f"{tab_err:.3g} (tol {FP32_ATOL:g} + {FP32_RTOL:g}*|ref|); "
        f"{PARITY_STEPS} steps: losses {[round(float(x), 7) for x in lk]} "
        f"max diff {loss_err:.3g}, params max diff {p_err:.3g}, bit-equal "
        f"{bit}; top-20 Jaccard over {sample.size} val users mean "
        f"{jac.mean():.6f} min {jac.min():.4f}; no stock scatter in a "
        f"profiled step")

    # ---- times ----
    iu, ui = tr.model.item_from_user.fwd, tr.model.user_from_item.fwd
    with torch.no_grad():
        prop_ms = cuda_time_ms(lambda: tr.model.propagate(params), 5,
                               warmup=1)
        # the profiler can drop records: a window is taken again, up to
        # three, until it holds a propagate's 2K row kernels
        for _ in range(3):
            prop_split, prop_launches = profile_split(
                lambda: tr.model.propagate(params),
                {"long_rows": "long_rows_kernel", "rows": "rows_kernel"},
                calls=3)
            if prop_launches.get("rows") == 2 * K:
                break
    prop_device = sum(prop_split.values())
    deg = iu.indptr[1:] - iu.indptr[:-1]
    hub = int(deg.max())
    epoch = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    batches = tr.draw_epoch(gen)
    torch.cuda.synchronize()
    epoch["draw_s"] = time.perf_counter() - t
    t = time.perf_counter()
    all_plans = tr.step_plans(*batches[:3])
    torch.cuda.synchronize()
    epoch["plans_s"] = time.perf_counter() - t
    t = time.perf_counter()
    cached_e = tr._epoch_cache(p3)
    torch.cuda.synchronize()
    epoch["cache_s"] = time.perf_counter() - t
    t = time.perf_counter()
    for s in range(nb):
        tr.train_step(p3, o3, *(x[s] for x in batches), cached_e,
                      all_plans[s])
    torch.cuda.synchronize()
    epoch["steps_s"] = time.perf_counter() - t
    del all_plans, cached_e, batches
    split = step_split(
        lambda leaves, j: tr._loss_fn(leaves, users[j], pos[j], neg[j],
                                      mask[j], cached, plans[j]),
        p3, o3, cfg.lr, PARITY_STEPS)
    prof = profile_steps(step)
    rows = []
    for role, dd, x in (("K1 item<-user", iu, params["user_emb"]),
                        ("K2 user<-item", ui, params["item_emb"])):
        x = x.contiguous()
        r = time_direction(role, dd, x)
        # device time alone: the calls queued ahead of the card
        r["device_ms"] = tm.queued_device_ms(
            lambda: sc.KERNEL(dd.indptr, dd.src, dd.w, x, pieces=dd.pieces),
            dev)
        rows.append(r)
    g = torch.Generator(device=dev).manual_seed(0)
    gathers = [time_gather(f"north star step's users into "
                           f"{graph.num_users:,} rows", plans[0][0],
                           users[0], cfg.emb_dim, g),
               time_gather(f"north star step's items into "
                           f"{graph.num_items:,} rows", plans[0][1],
                           torch.cat([pos[0], neg[0]]), cfg.emb_dim, g)]
    del cached, p3, o3
    adam_pair = time_adam(params, adam.adam_scalars(1, cfg.lr), cfg.lr, g)
    log(f"[phase 18b] times: propagate {prop_ms:.3f} ms (CUDA events; "
        f"device by kernel {', '.join(f'{k} {v:.3f}' for k, v in prop_split.items())}"
        f", long_rows_kernel {100 * prop_split.get('long_rows', 0.0) / prop_device:.1f}%"
        f" of {prop_device:.3f} device ms; CUDA launches {prop_launches}); "
        f"item<-user hub {hub:,} edges ({-(-hub // iu.pieces.edges_per_piece)}"
        f" pieces; {iu.pieces.num_long} long rows, {iu.pieces.num_pieces} "
        f"pieces); epoch by part (s) {', '.join(f'{k} {v:.3f}' for k, v in epoch.items())}"
        f"; step split (ms) {', '.join(f'{k} {v:.3f}' for k, v in split.items())}"
        f"; profiled step window {prof['window_ms']:.2f} ms, device "
        f"{prof['device_ms']:.3f} ms ({100 * prof['busy_share']:.1f}% busy)"
        f"; peak GB {', '.join(f'{k} {v:.2f}' for k, v in peaks.items())}")
    log("[phase 18b] kernels at the north star's shapes (ms): " + "; ".join(
        f"{r['role']} ({r['edges']:,} edges, D={cfg.emb_dim}) kernel "
        f"{r['ms']:.4f} device {r['device_ms']:.4f} plain {r['plain_ms']:.4f} "
        f"sparse.mm {r['library_ms']:.4f} bound {r['bound_ms']:.4f}"
        for r in rows) + "; " + _gather_line(gathers) + "; "
        + _adam_line("both tables", adam_pair))
    del u_k, i_k, params
    # the trainer serves phase 21's scaling terms (no second set-up)
    return {"_trainer": tr, "launches_by_kernel": counts,
            "split": NORTHSTAR_SPLIT,
            "steps_per_epoch": nb, "host_setup_s": host, "line": line,
            "bench_northstar_s": bench_s, "evaluate_full_val_s": eval_s,
            "val_metrics": val, "table_max_abs_diff": tab_err,
            "steps_loss_max_diff": loss_err, "steps_param_max_diff": p_err,
            "steps_bit_equal": bit, "jaccard_mean": float(jac.mean()),
            "jaccard_min": float(jac.min()), "propagate_ms": prop_ms,
            "propagate_device_split_ms": prop_split,
            "propagate_cuda_launches": prop_launches,
            "propagate_profile_complete": prop_launches.get("rows") == 2 * K,
            "long_rows_share": prop_split.get("long_rows", 0.0) / prop_device,
            "hub_degree": hub, "hub_pieces":
                -(-hub // iu.pieces.edges_per_piece),
            "long_rows": iu.pieces.num_long, "pieces": iu.pieces.num_pieces,
            "epoch_split_s": epoch, "step_split_ms": split,
            "profiled_step": prof, "peak_gb": peaks, "directions": rows,
            "gather_backward": gathers, "adam_pair": adam_pair}


def phase_northstar_two_stage(dev, graph, tmp: Path) -> dict:
    """Phase 18 (c): the port's ``scripts/two_stage_10m.run`` on the
    planted graph, counted as the ``northstar_two_stage`` path: Stage A in
    SLAS mode (``slas_pad_deg=128``; no SpMM, no gather backward, one Adam
    launch a step), the CSV, then Stage B under ``scaled_10m`` reading it
    for every user; valid scores, finite metrics."""
    import re
    import torch
    from importlib import import_module
    ts = import_module(f"{PKG}.scripts.two_stage_10m")
    config = import_module(f"{PKG}.utils.config")
    presets = import_module(f"{PKG}.configs.presets")
    cfg_b = presets.get_preset("scaled_10m")
    ep_a, ep_b = TWO_STAGE_EPOCHS
    out = tmp / "two_stage_10m"
    reset_counts()
    tee, buf = _tee(sys.stdout)
    t = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        summary = ts.run(graph, out, cred_epochs=ep_a, rec_epochs=ep_b,
                         pad_deg=CRED_PAD_DEG, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    sa, sb = summary["stage_a"], summary["stage_b"]
    n_a = int(0.8 * sa["labeled_users"])
    steps_a = -(-n_a // min(config.CredConfig().batch_size, n_a))
    n_b = int((graph.user_csr("train").degrees() > 0).sum())
    nb = -(-n_b // cfg_b.batch_size)
    K = cfg_b.num_layers
    # Stage A: one Adam launch a step and nothing else; Stage B: an epoch's
    # cache (2K SpMM), 4 gathers and 1 Adam a step, 2K SpMM and a top-k
    # select a batch an evaluation (val each epoch, test once)
    counts = read_counts(
        {"segment_spmm": 2 * K * (2 * ep_b + 1),
         "gather_backward": NORTHSTAR_GATHERS * nb * ep_b,
         "fused_adam": steps_a * ep_a + nb * ep_b,
         "topk_select": ep_b * full_eval_calls(graph, "val", cfg_b.eval_batch)
         + full_eval_calls(graph, "test", cfg_b.eval_batch)},
        "northstar two-stage path")
    scores = np.load(out / "credibility_scores_minmax.npy")
    if scores.shape != (graph.num_users,) or not np.isfinite(scores).all() \
            or scores.min() < 0.0 or scores.max() > 1.0:
        raise AssertionError(f"two-stage scores {scores.shape} in "
                             f"[{scores.min()}, {scores.max()}]")
    used = re.findall(r"used=([\d,]+)", buf.getvalue())
    if [int(u.replace(",", "")) for u in used] != [graph.num_users]:
        raise AssertionError(f"Stage B read {used} users from the CSV, "
                             f"not {graph.num_users:,}")
    if not all(np.isfinite(sa[k]) for k in ("holdout_auc_final",
                                           "holdout_bce_final")):
        raise AssertionError(f"Stage A holdout {sa}")
    _finite_metrics({int(k): v for k, v in sb["test"].items()},
                    "two-stage Stage B test")
    log(f"[phase 18c] two_stage_10m on the planted graph ({wall:.1f}s): "
        f"Stage A SLAS pad {CRED_PAD_DEG}, {steps_a} steps an epoch: setup "
        f"{sa['setup_seconds']:.1f}s, {ep_a} epoch in "
        f"{sa['wall_seconds']:.1f}s ({sa['seconds_per_epoch']}), holdout "
        f"AUC {sa['holdout_auc_final']:.4f}, peak {sa['peak_hbm_gb']} "
        f"GB; Stage B read {used[0]} users from the CSV, {ep_b} epoch "
        f"({nb} steps) in {sb['wall_seconds']:.1f}s, best val R@20 "
        f"{sb['best_val_recall']:.6f}, test R@20 "
        f"{sb['test']['20']['recall']:.6f}, peak {sb['peak_hbm_gb']} "
        f"GB; launches {counts} (Stage A: fused_adam {steps_a * ep_a}, "
        f"segment_spmm 0, gather_backward 0)")
    return {"launches_by_kernel": counts, "summary": summary,
            "wall_s": wall, "stage_a_steps_per_epoch": steps_a,
            "stage_b_steps_per_epoch": nb}


# --------------------------------------------------------------------------
# phase 19: the reference protocol's entry points (scripts/, examples/)
# --------------------------------------------------------------------------

# the six reference runs of the JAX package's runs/SUMMARY.md
PROTOCOL_PRESETS = ("vanilla", "cu_message", "pop_neg", "degree_aware",
                    "pop_extended", "cred_eq322")
PROTOCOL_EPOCHS = 1           # of 400
# the presets whose operator or weights no earlier phase holds against the
# plain path: vanilla's joint table, degree_aware's and cred_eq322's weights
HELD_PRESETS = ("vanilla", "degree_aware", "cred_eq322")
PARITY_EPOCHS = 4             # of 200, validated every PARITY_EVAL_EVERY
PARITY_EVAL_EVERY = 2
DEMO_EPOCHS = (1, 2)          # the two-stage demo's Stage A and B, of 60, 400
STEP_GATHERS = 10             # gather backwards a per_batch step at K=3
# one line of a reference-format log, written from the JAX package's
# runs/cu_message_ref_scale.out (the K= lines also take the extended fields
# of format_metrics_block; the device line names the card here)
_MET = r"=\d+\.\d{4} "
LOG_LINE = (
    r"(Loaded edges\. Users=[\d,]+ Items=[\d,]+ Train=[\d,]+ Val=[\d,]+ "
    r"Test=[\d,]+"
    r"|Using device: .+"
    r"|Epoch \d{2,} \| loss=\d+\.\d{6}"
    r"|(VAL|TEST) metrics:"
    r"|  K=\d+: P=\d\.\d{4} R=\d\.\d{4} NDCG=\d\.\d{4} "
    rf"(COV{_MET}LogPop{_MET}SI{_MET}(CredU{_MET}HighR{_MET}LowR{_MET})?)?"
    r"\((sampled\(1pos\+neg\)|full)\)"
    r"|  saved best \(val Recall@20=\d\.\d{4}\)"
    r"|\[REGRESSION\] preset=\w+ epochs=\d+ wall=\d+\.\ds "
    r"epochs/hour=\d+\.\d propagation_edges_per_sec=[\d,]+"
    r"|)")


def _applies(cfg) -> int:
    """SpMM applications of one propagate: one a layer on the joint
    table, two (item<-user, user<-item) on split tables."""
    return cfg.num_layers * (1 if cfg.propagation == "symmetric" else 2)


def _per_batch_counts(cfg, steps: int, epochs: int, evals: int) -> dict:
    """A per_batch fit's launches (``train/trainer.py``): a step runs
    its propagate forward and backward, the K+1 user and K+1 item gathers
    of ``propagate_rows`` and the two ego gathers, one Adam launch; each
    evaluation one propagate."""
    P = _applies(cfg)
    return {"segment_spmm": 2 * P * steps * epochs + P * evals,
            "gather_backward": (2 * (cfg.num_layers + 1) + 2)
            * steps * epochs,
            "fused_adam": steps * epochs}


def _keys(rec) -> dict:
    """A metrics record's keys, nested one level into the metric dicts."""
    out = {}
    for k, v in rec.items():
        if isinstance(v, dict):
            out[k] = {K: sorted(m) if isinstance(m, dict) else None
                      for K, m in v.items()}
        else:
            out[k] = None
    return out


def _held_against_plain(tr_k, tr_p, tag: str) -> dict:
    """Phase 7's check on another graph or configuration: the trainer
    ``tr_k`` (the kernels) against ``tr_p`` (the same configuration with
    ``spmm_backend="torch"``), from ``tr_k``'s seed: one propagate's
    tables (``_close``) and PARITY_STEPS train steps (``_held``).  The
    kernel path launches what the step's code gives, the plain path
    nothing; none of it counts on a path."""
    import torch
    from importlib import import_module
    adam = import_module(f"{PKG}.ops.adam")
    cfg = tr_k.cfg
    P, K = _applies(cfg), cfg.num_layers
    params, _, gen = tr_k.init_state()
    with torch.no_grad():
        before = _counts_now()
        u_k, i_k = tr_k.model.propagate(params)
        _launched(before, {"segment_spmm": P}, f"{tag}: kernel propagate")
        before = _counts_now()
        u_p, i_p = tr_p.model.propagate(params)
        _launched(before, {}, f"{tag}: plain propagate")
    if not (_close(u_k, u_p) and _close(i_k, i_p)):
        raise AssertionError(f"{tag}: propagated tables differ from the "
                             f"plain path's")
    tab_err = max(float((u_k - u_p).abs().max()),
                  float((i_k - i_p).abs().max()))
    users, pos, neg, mask = tr_k.draw_epoch(gen)
    plans = tr_k.step_plans(users, pos, neg)
    steps = [i % users.shape[0] for i in range(PARITY_STEPS)]

    def run(tr):
        p = {k: v.clone() for k, v in params.items()}
        o = adam.adam_init(p)
        losses = torch.stack([tr.train_step(p, o, users[s], pos[s], neg[s],
                                            mask[s], None, plans[s])
                              for s in steps])
        torch.cuda.synchronize()
        return p, losses

    before = _counts_now()
    pk, lk = run(tr_k)
    _launched(before, {"segment_spmm": 2 * P * PARITY_STEPS,
                       "gather_backward": (2 * (K + 1) + 2) * PARITY_STEPS,
                       "fused_adam": PARITY_STEPS}, f"{tag}: kernel steps")
    before = _counts_now()
    pp, lp = run(tr_p)
    _launched(before, {}, f"{tag}: plain steps")
    loss_err, p_err, bit = _held(pk, lk, {"params": pp, "losses": lp},
                                 f"{tag}: the kernel path against the "
                                 f"plain path")
    return {"table_max_diff": tab_err, "loss_max_diff": loss_err,
            "param_max_diff": p_err, "bit_identical": bit,
            "table_rows": (int(u_k.shape[0]), int(i_k.shape[0]))}


def _held_line(held: dict) -> str:
    return "; ".join(
        f"{k} tables {h['table_rows']} max diff {h['table_max_diff']:.3g}, "
        f"{PARITY_STEPS} steps: losses {h['loss_max_diff']:.3g}, params "
        f"{h['param_max_diff']:.3g}" for k, h in held.items())


def phase_reference_regression(dev, tmp: Path) -> dict:
    """Phase 19 (a): ``scripts/reference_regression.main`` at ``--scale
    ref`` for each preset of PROTOCOL_PRESETS, counted together as the
    ``reference_regression`` path; every printed line in the reference's
    log format, the metrics JSONL with the keys of the JAX package's
    record of the same preset (plus ``card`` on the final line), finite
    test metrics, each preset's launches as the trainer's code gives
    them."""
    import re
    from importlib import import_module
    rr = import_module(f"{PKG}.scripts.reference_regression")
    presets = import_module(f"{PKG}.configs.presets")
    root = Path(__file__).resolve().parent
    graph = rr.scale_graph("ref")
    n_train = int((graph.user_csr("train").degrees() > 0).sum())
    line_re = re.compile(LOG_LINE)
    reset_counts()
    total, runs = {}, {}
    for p in PROTOCOL_PRESETS:
        cfg = presets.get_preset(p)
        steps = -(-n_train // cfg.batch_size)
        before = _counts_now()
        metrics = tmp / f"{p}_metrics.jsonl"
        tee, buf = _tee(sys.stdout)
        t = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            final = rr.main(["--preset", p, "--epochs", str(PROTOCOL_EPOCHS),
                             "--scale", "ref", "--metrics-jsonl", str(metrics),
                             "--device", str(dev)])
        wall = time.perf_counter() - t
        want = _per_batch_counts(cfg, steps, PROTOCOL_EPOCHS,
                                 PROTOCOL_EPOCHS + 1)
        got = _launched(before, want, f"reference_regression {p}")
        total = _plus(total, want)
        bad = [ln for ln in buf.getvalue().splitlines()
               if not line_re.fullmatch(ln)]
        if bad:
            raise AssertionError(f"reference_regression {p}: lines not in "
                                 f"the reference's format: {bad[:3]}")
        ours = [json.loads(ln) for ln in metrics.read_text().splitlines()]
        jax = [json.loads(ln) for ln in
               (root / "runs" / f"{p}_ref_scale_metrics.jsonl")
               .read_text().splitlines()]
        want_final = {**_keys(jax[-1]), "card": None}
        if len(ours) != PROTOCOL_EPOCHS + 1 \
                or any(_keys(r) != _keys(jax[0]) for r in ours[:-1]) \
                or _keys(ours[-1]) != want_final:
            raise AssertionError(f"reference_regression {p}: metrics keys "
                                 f"{[_keys(r) for r in ours]}, JAX's "
                                 f"{_keys(jax[0])} / {want_final}")
        _finite_metrics({int(k): v for k, v in final["test"].items()},
                        f"reference_regression {p} test")
        runs[p] = {"wall_s": wall, "steps_per_epoch": steps,
                   "launches_by_kernel": got,
                   "test_recall_20": final["test"]["20"]["recall"],
                   "card": final["card"]}
    counts = read_counts(total, "reference_regression path")
    trainer_mod = import_module(f"{PKG}.train.trainer")
    held = {}
    for p in HELD_PRESETS:
        cfg = presets.get_preset(p)
        held[p] = _held_against_plain(
            trainer_mod.RecTrainer(cfg, graph, device=dev, verbose=False),
            trainer_mod.RecTrainer(cfg.replace(spmm_backend="torch"), graph,
                                   device=dev, verbose=False),
            f"reference_regression {p}")
    log(f"[phase 19a] reference_regression --scale ref --epochs "
        f"{PROTOCOL_EPOCHS}, {len(PROTOCOL_PRESETS)} presets: " + "; ".join(
            f"{p} {r['wall_s']:.1f}s, {r['steps_per_epoch']} steps, test "
            f"R@20 {r['test_recall_20']:.4f}, {r['launches_by_kernel']}"
            for p, r in runs.items())
        + "; every line in the reference's format, the metrics keys JAX's; "
        "held against the plain path: " + _held_line(held))
    return {"launches_by_kernel": counts, "runs": runs,
            "held_against_plain": held}


def phase_parity(dev, tmp: Path) -> dict:
    """Phase 19 (b): ``scripts/parity_run`` counted as the
    ``parity_framework`` path: ``build`` at its defaults, ``framework`` on
    every configuration (seed 0, PARITY_EPOCHS epochs) and ``--fast`` on
    cu_message, then ``report`` against the committed oracle records:
    one row a configuration and metric, each with a verdict."""
    import io
    from importlib import import_module
    pr = import_module(f"{PKG}.scripts.parity_run")
    config = import_module(f"{PKG}.utils.config")
    root = Path(__file__).resolve().parent
    d = tmp / "parity"
    graph_path = d / "graph.npz"
    reset_counts()
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        pr.main(["build", "--out", str(graph_path)])
    z = np.load(graph_path)
    n_train = int(np.unique(z["train_edges"][0]).size)
    evals = PARITY_EPOCHS // PARITY_EVAL_EVERY + 1
    g = pr.load_graph(graph_path)
    want, recs = {}, []
    for name, fast in [(c, False) for c in pr.CONFIG_MAP] \
            + [("cu_message", True)]:
        argv = ["framework", "--graph", str(graph_path), "--config", name,
                "--seed", "0", "--epochs", str(PARITY_EPOCHS),
                "--eval-every", str(PARITY_EVAL_EVERY), "--device", str(dev),
                "--out", str(d / ("framework_fast.jsonl" if fast
                                  else "framework.jsonl"))]
        cfg = config.RecConfig(**pr.CONFIG_MAP[name],
                               **(pr.FAST_FLAGS if fast else {}))
        steps = -(-n_train // cfg.batch_size)
        if fast:
            # per_epoch: a cache propagate an epoch, no SpMM in a step,
            # the two batch-row and two ego gathers
            P = _applies(cfg)
            # and the full evaluation's top-k select a batch
            c = {"segment_spmm": P * (PARITY_EPOCHS + evals),
                 "gather_backward": NORTHSTAR_GATHERS * steps * PARITY_EPOCHS,
                 "fused_adam": steps * PARITY_EPOCHS,
                 "topk_select": (evals - 1) * full_eval_calls(
                     g, "val", cfg.eval_batch)
                 + full_eval_calls(g, "test", cfg.eval_batch)}
        else:
            c = _per_batch_counts(cfg, steps, PARITY_EPOCHS, evals)
        before = _counts_now()
        with contextlib.redirect_stdout(io.StringIO()):
            rec = pr.main(argv + (["--fast"] if fast else []))
        _launched(before, c, f"parity_run framework {name} fast={fast}")
        want = _plus(want, c)
        if set(rec) != {"config", "seed", "best_val", "test", "fast",
                        "eval_mode", "seconds", "card"}:
            raise AssertionError(f"parity framework record {sorted(rec)}")
        _finite_metrics({int(k): v for k, v in rec["test"].items()},
                        f"parity {name} fast={fast}")
        recs.append(rec)
    counts = read_counts(want, "parity_framework path")
    wall = time.perf_counter() - t
    trainer_mod = import_module(f"{PKG}.train.trainer")
    build = import_module(f"{PKG}.graph.build")
    graph = build.BipartiteGraph(
        num_users=int(z["num_users"]), num_items=int(z["num_items"]),
        train_edges=z["train_edges"], val_edges=z["val_edges"],
        test_edges=z["test_edges"])
    cred = np.load(d / "cred.npy").astype(np.float32)
    held = {}
    for name in pr.CONFIG_MAP:
        cfg = config.RecConfig(name=f"parity_{name}", seed=0,
                               **pr.CONFIG_MAP[name])
        c_ = cred if name in pr.REAL_CRED else None
        held[name] = _held_against_plain(
            trainer_mod.RecTrainer(cfg, graph, cred=c_, device=dev,
                                   verbose=False),
            trainer_mod.RecTrainer(cfg.replace(spmm_backend="torch"), graph,
                                   cred=c_, device=dev, verbose=False),
            f"parity_run {name}")
    report = tmp / "QUALITY_PARITY.md"
    with contextlib.redirect_stdout(io.StringIO()):
        text = pr.main(["report", "--dir", str(d), "--jax-dir",
                        str(root / "runs" / "parity"),
                        "--report-out", str(report)])
    # the quality tables: the report ends with the committed Stage-A section
    quality = text.split("\n## Stage-A parity")[0]
    rows = [[c.strip() for c in ln.strip().strip("|").split("|")]
            for ln in quality.splitlines() if ln.startswith("| ")
            and not ln.startswith("| Config")]
    want_rows = [(c, m + "@20") for c in pr.REPORT_CONFIGS
                 for m in ["recall", "ndcg"]
                 + (list(pr.EXT_METRICS) if c == "pop_extended" else [])] \
        + [(c, m + "@20") for c in pr.FAST_CONFIGS for m in ("recall", "ndcg")]
    if [tuple(r[:2]) for r in rows] != want_rows \
            or any(len(r) != 8 for r in rows) \
            or sum(r[-1] in ("PASS", "FAIL") for r in rows) != 2 * 7 + 6 + 2:
        raise AssertionError(f"parity report rows {rows}")
    log(f"[phase 19b] parity_run: build ({int(z['num_users']):,} users, "
        f"{z['train_edges'].shape[1]:,} train edges), framework on "
        f"{len(pr.CONFIG_MAP)} configurations + --fast cu_message (seed 0, "
        f"{PARITY_EPOCHS} epochs, {-(-n_train // 4096)} steps an epoch) in "
        f"{wall:.1f}s, test R@20 "
        + ", ".join(f"{r['config']}{'(fast)' if r['fast'] else ''} "
                    f"{r['test'][20]['recall']:.4f}" for r in recs)
        + f"; launches {counts}; report: {len(rows)} rows, "
        f"{sum(r[-1] in ('PASS', 'FAIL') for r in rows)} with a verdict; "
        "held against the plain path: " + _held_line(held))
    return {"launches_by_kernel": counts, "wall_s": wall, "records": recs,
            "held_against_plain": held}


def phase_two_stage_demo(dev, tmp: Path, jsonl: Path) -> dict:
    """Phase 19 (c): ``scripts/two_stage_demo.run`` on phase 11's JSONL,
    counted as the ``two_stage_demo`` path: Stage A in SLAS mode
    (``--pad-deg 128``; one Adam launch a step, no SpMM, no gather
    backward) for DEMO_EPOCHS[0] epoch, the CSV, then Stage B under
    ``cred_eq322`` for DEMO_EPOCHS[1] epochs reading a score for every
    graph user; scores finite in [0, 1], ``summary.json`` with the JAX
    script's keys."""
    import re
    import torch
    from importlib import import_module
    ts = import_module(f"{PKG}.scripts.two_stage_demo")
    presets = import_module(f"{PKG}.configs.presets")
    ingest = import_module(f"{PKG}.data.ingest")
    build = import_module(f"{PKG}.graph.build")
    root = Path(__file__).resolve().parent
    ep_a, ep_b = DEMO_EPOCHS
    out = tmp / "two_stage_demo"
    reset_counts()
    tee, buf = _tee(sys.stdout)
    t = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        summary = ts.run(jsonl, out, cred_epochs=ep_a, rec_epochs=ep_b,
                         pad_deg=CRED_PAD_DEG, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    text = buf.getvalue()
    n_a = int(re.search(r"train=([\d,]+)", text).group(1).replace(",", ""))
    steps_a = -(-n_a // min(import_module(f"{PKG}.utils.config")
                             .CredConfig().batch_size, n_a))
    # Stage B's graph, as the demo builds it
    graph = build.build_bipartite_graph(ingest.ingest_jsonl(jsonl))
    cfg_b = presets.get_preset("cred_eq322")
    n_b = int((graph.user_csr("train").degrees() > 0).sum())
    nb = -(-n_b // cfg_b.batch_size)
    want = _plus({"fused_adam": steps_a * ep_a},
                        _per_batch_counts(cfg_b, nb, ep_b, ep_b + 1))
    counts = read_counts(want, "two_stage_demo path")
    trainer_mod = import_module(f"{PKG}.train.trainer")
    cfg_c = cfg_b.replace(cred_csv_path=str(
        out / "credibility_scores_minmax_with_user_id.csv"))
    held = {"cred_eq322 (Stage B)": _held_against_plain(
        trainer_mod.RecTrainer(cfg_c, graph, device=dev, verbose=False),
        trainer_mod.RecTrainer(cfg_c.replace(spmm_backend="torch"), graph,
                               device=dev, verbose=False),
        "two_stage_demo Stage B")}
    scores = np.load(out / "credibility_scores_minmax.npy")
    if not np.isfinite(scores).all() or scores.min() < 0.0 \
            or scores.max() > 1.0:
        raise AssertionError(f"two-stage demo scores in "
                             f"[{scores.min()}, {scores.max()}]")
    used = re.findall(r"used=([\d,]+)", text)
    if [int(u.replace(",", "")) for u in used] != [graph.num_users]:
        raise AssertionError(f"Stage B read {used} users from the CSV, "
                             f"not {graph.num_users:,}")
    jax_keys = set(json.loads((root / "runs" / "two_stage" / "summary.json")
                              .read_text()))
    written = json.loads((out / "summary.json").read_text())
    if set(written) != jax_keys | {"card", "stage_a"} \
            or len(written["stage_a"]["history"]) != ep_a:
        raise AssertionError(f"two-stage summary keys {sorted(written)}")
    _finite_metrics({int(k): v for k, v in summary["test"].items()},
                    "two-stage demo Stage B test")
    h = summary["stage_a"]["history"][-1]
    log(f"[phase 19c] two_stage_demo on phase 11's JSONL ({wall:.1f}s): "
        f"Stage A SLAS pad {CRED_PAD_DEG}, {steps_a} steps, {ep_a} epoch in "
        f"{summary['stage_a']['wall_seconds']:.1f}s, holdout AUC "
        f"{h['holdout_auc']:.4f}; Stage B ({graph.summary()}, {nb} steps) "
        f"read {used[0]} users from the CSV, {ep_b} epochs in "
        f"{summary['stage_b_wall_seconds']:.1f}s, test R@20 "
        f"{summary['test']['20']['recall']:.4f}; launches {counts}; held "
        "against the plain path: " + _held_line(held))
    return {"launches_by_kernel": counts, "wall_s": wall,
            "held_against_plain": held,
            "stage_a_steps_per_epoch": steps_a, "stage_b_steps_per_epoch": nb,
            "summary": summary}


def phase_end_to_end(dev, tmp: Path) -> dict:
    """Phase 19 (d): ``examples/end_to_end.main`` at its own size, counted
    as the ``end_to_end`` path (Stage A in SLAS mode, one Adam launch a
    step; Stage B under ``pop_extended``, batch 128); finite metrics."""
    import io
    from importlib import import_module
    e2e = import_module(f"{PKG}.examples.end_to_end")
    ingest = import_module(f"{PKG}.data.ingest")
    build = import_module(f"{PKG}.graph.build")
    presets = import_module(f"{PKG}.configs.presets")
    features = import_module(f"{PKG}.data.features")
    hetero = import_module(f"{PKG}.graph.hetero")
    out = tmp / "end_to_end"
    reset_counts()
    tee, buf = _tee(io.StringIO())
    t = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        res = e2e.main(["--out", str(out), "--device", str(dev)])
    wall = time.perf_counter() - t
    # the example's graph and heterograph, rebuilt from its stream
    table = ingest.ingest_jsonl(out / "reviews.jsonl")
    graph = build.build_bipartite_graph(table)
    hg = hetero.build_heterograph(table, features.compute_user_features(table))
    ep_a, batch_a = 10, 64
    ep_b, batch_b = 8, 128
    steps_a = cred_steps_per_epoch(hg, batch_a)
    cfg_b = presets.get_preset("pop_extended")
    nb = -(-int((graph.user_csr("train").degrees() > 0).sum()) // batch_b)
    want = _plus({"fused_adam": steps_a * ep_a},
                        _per_batch_counts(cfg_b, nb, ep_b, ep_b + 1))
    counts = read_counts(want, "end_to_end path")
    if len(res.history) != ep_b or not all(np.isfinite(h.loss)
                                           for h in res.history):
        raise AssertionError(f"end_to_end losses {res.history}")
    _finite_metrics(res.test_metrics, "end_to_end test")
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("[e2e]")]
    log(f"[phase 19d] end_to_end ({wall:.1f}s; Stage A {steps_a} step an "
        f"epoch, Stage B {nb} steps): {' | '.join(lines[-2:])}; launches "
        f"{counts}")
    return {"launches_by_kernel": counts, "wall_s": wall, "lines": lines}


# --------------------------------------------------------------------------
# phase 20: the remaining protocol drivers
# --------------------------------------------------------------------------

DRIVER_EPOCHS = 2             # cred_parity's framework and downstream runs
EQUIV_USERS = 4096            # val users of the overlap (of 100,000)
# bf16's mean Jaccard@20 after one epoch: a bound on gross errors.  The
# one-epoch model's near-tied scores reorder under the bf16 tables' rounding
# alone (0.9613 on an H100 with fp32 sums); the full-length record is held
# to the protocol's 0.99
EQUIV_BF16_MIN = 0.9
SCHEDULE_EPOCHS = 1           # schedule_compare's per_batch, of 12
INGEST_PYTHON_LINES = 100_000  # the Python reader's prefix
BREAKDOWN_BATCHES = 2         # eval_breakdown's batches of 512 (of 6)
EVAL_BATCH = 512              # the full evaluation's users a batch


def _cred_full_graph_counts(nb: int, epochs: int) -> dict:
    """A full-graph Stage-A fit's launches (phase 12's count)."""
    return {"segment_spmm": 8 * nb * epochs + 2 * epochs + 2,
            "gather_backward": CRED_GATHERS * nb * epochs,
            "fused_adam": CRED_ADAM * nb * epochs}


def phase_cred_parity(dev, tmp: Path) -> dict:
    """Phase 20 (a): ``scripts/cred_parity_run`` counted as the
    ``cred_parity`` path: ``build`` at its size (3,000 users), ``framework``
    in both modes for DRIVER_EPOCHS epochs, a ``downstream`` pair
    (cu_message and cred_eq322 on the oracle's scores) for DRIVER_EPOCHS
    epochs, then ``report`` against the committed oracle vector: a row for
    the oracle and each mode, a row for each downstream run, a verdict.
    After the path is read, the shapes it gives the kernels are held
    against the plain path: the full-graph ``CredTrainer`` on the planted
    heterograph (``_cred_held_against_plain``) and both Stage-B
    configurations on the md5-split graph with the oracle's scores as
    credibility (``_held_against_plain``)."""
    import io
    from importlib import import_module
    cp = import_module(f"{PKG}.scripts.cred_parity_run")
    config = import_module(f"{PKG}.utils.config")
    root = Path(__file__).resolve().parent
    oracle = root / "runs" / "torch_h100" / "cred_parity" / "cred_oracle.npy"
    d = tmp / "cred_parity"
    reset_counts()
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        built = cp.main(["build", "--dir", str(d)])
        runs = {m: cp.main(["framework", "--mode", m, "--dir", str(d),
                            "--epochs", str(DRIVER_EPOCHS), "--device",
                            str(dev)]) for m in cp.MODES}
        ds = cp.main(["downstream", "--dir", str(d), "--oracle", str(oracle),
                      "--sources", "oracle", "--epochs", str(DRIVER_EPOCHS),
                      "--device", str(dev)])
        report = cp.main(["report", "--dir", str(d), "--oracle",
                          str(oracle), "--jax-cpu", str(
                              root / cp.DIR / "jax_cpu")])
    wall = time.perf_counter() - t
    labeled = int((np.load(d / "hg.npz", allow_pickle=True)["user_y"] >= 0)
                  .sum())
    nb_a = -(-int(0.8 * labeled) // cp.BATCH_A)
    z = np.load(d / "graph.npz")
    n_b = int(np.unique(z["train_edges"][0]).size)
    want = _plus(_cred_full_graph_counts(nb_a, DRIVER_EPOCHS),
                 {"fused_adam": nb_a * DRIVER_EPOCHS})
    for cname in cp.STAGE_B:
        cfg = config.RecConfig(table_layout="split", **cp.STAGE_B[cname])
        want = _plus(want, _per_batch_counts(
            cfg, -(-n_b // cfg.batch_size), DRIVER_EPOCHS, 1))
    counts = read_counts(want, "cred_parity path")
    rows = [ln.split("|")[1].strip() for ln in report.splitlines()
            if ln.startswith("| ")]
    want_rows = ["oracle", *cp.MODES] + [f"{c}/oracle" for c in cp.STAGE_B]
    if built["users"] != 3000 or sorted(ds) != sorted(want_rows[3:]) \
            or [r for r in rows if r in want_rows] != want_rows \
            or "**Verdict: " not in report:
        raise AssertionError(f"cred_parity report rows {rows}, downstream "
                             f"{sorted(ds)}")
    for m, r in runs.items():
        if not np.isfinite(r["loss"]).all() or len(r["loss"]) != \
                DRIVER_EPOCHS:
            raise AssertionError(f"cred_parity {m}: losses {r['loss']}")
    # the full-graph trainer on the planted heterograph: one inference
    # (2 SpMM), then the steps
    hg = import_module(f"{PKG}.graph.hetero").HeteroGraph.load_npz(
        d / "hg.npz")
    cfg_a = config.CredConfig(trainer_mode="full_graph", batch_size=cp.BATCH_A)
    ct = import_module(f"{PKG}.train.cred_trainer")
    tr_k = ct.CredTrainer(hg, cfg_a, device=dev, verbose=False)
    tr_p = ct.CredTrainer(hg, cfg_a, device=dev, backend="torch",
                          verbose=False)
    params0, _, _ = tr_k.init_state(seed=0)
    before = _counts_now()
    s_k = tr_k.infer(params0)
    _launched(before, {"segment_spmm": 2}, "cred_parity full_graph: kernel "
              "inference")
    before = _counts_now()
    s_p = tr_p.infer(params0)
    _launched(before, {}, "cred_parity full_graph: plain inference")
    if not _close(s_k, s_p):
        raise AssertionError("cred_parity full_graph: inferred scores differ "
                             "from the plain path's")
    fg = _cred_held_against_plain(tr_k, tr_p, "cred_parity full_graph")
    held = {"full_graph": {
        "table_max_diff": float((s_k - s_p).abs().max()),
        "table_rows": (int(s_k.shape[0]),),
        **{k: fg[k] for k in ("loss_max_diff", "param_max_diff",
                              "bit_identical")}}}
    trainer_mod = import_module(f"{PKG}.train.trainer")
    graph = cp._graph(d / "graph.npz")
    cred = np.load(oracle).astype(np.float32)
    for cname, cdict in cp.STAGE_B.items():
        cfg = config.RecConfig(name=f"ds_{cname}_oracle",
                               table_layout="split", **cdict)
        held[cname] = _held_against_plain(
            trainer_mod.RecTrainer(cfg, graph, cred=cred, device=dev,
                                   verbose=False),
            trainer_mod.RecTrainer(cfg.replace(spmm_backend="torch"), graph,
                                   cred=cred, device=dev, verbose=False),
            f"cred_parity {cname}")
    log(f"[phase 20a] cred_parity_run on the planted heterograph "
        f"({built['users']:,} users, {built['edges']:,} edges; {wall:.1f}s): "
        + "; ".join(f"{m} {DRIVER_EPOCHS} epochs ({nb_a} steps), holdout AUC "
                    f"{r['final_holdout_auc']:.4f}, {r['wall_seconds']:.1f}s"
                    for m, r in runs.items())
        + "; downstream " + ", ".join(f"{k} R@20 {v['recall']:.4f}"
                                      for k, v in ds.items())
        + f"; report: {report.strip().splitlines()[-1][:120]}; launches "
        f"{counts}; held against the plain path: " + _held_line(held))
    return {"launches_by_kernel": counts, "wall_s": wall, "framework": runs,
            "downstream": ds, "held_against_plain": held}


def bf16_product_check(dev, num_items: int, dim: int) -> dict:
    """The bf16 evaluation's product on the card (``score_product``: one
    bf16 GEMM with an fp32 output) against the fp32 product of the same
    tables rounded to bf16 and upcast, at one evaluation batch against
    ``num_items`` items: each bf16 product is exact in fp32, so the two may
    differ by summation order only, at most 2 (D - 1) 2^-24 sum_k |p_k| a
    score.  Launches no hand kernel."""
    from importlib import import_module

    import torch
    rt = import_module(f"{PKG}.eval.retrieval")
    rt.exact_fp32_matmul()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    u = 0.1 * torch.randn(EVAL_BATCH, dim, generator=gen, device=dev)
    items = 0.1 * torch.randn(num_items, dim, generator=gen, device=dev)
    got = rt.score_product(u, items, "bf16")
    ub, ib = u.bfloat16().float(), items.bfloat16().float()
    gap = (got - ub @ ib.T).abs_()
    ratio = gap.div_(2 * (dim - 1) * 2.0 ** -24 * (ub.abs() @ ib.abs().T))
    worst = float(ratio.nan_to_num_(0.0).max())
    if got.dtype != torch.float32 or got.shape != (EVAL_BATCH, num_items) \
            or not worst <= 1.0:
        raise AssertionError(f"bf16 product with fp32 output: {got.dtype} "
                             f"{tuple(got.shape)}, gap {worst} of its bound")
    return {"shape": [EVAL_BATCH, num_items, dim],
            "max_gap_over_bound": worst}


def phase_eval_equiv(dev, graph, tmp: Path, params: dict) -> dict:
    """Phase 20 (c): ``scripts/eval_equiv_r4 overlap`` on phase 18's planted
    graph, counted as the ``eval_equiv`` path (one propagate), in all three
    modes on EQUIV_USERS val users, on ``params``: phase 20 (b)'s kernel
    trainer after one epoch (``train`` runs at full length in
    ``scripts/protocol.py``; here its 10M trainer would be one more
    set-up).  Approx equal to exact (the port ranks it exactly), bf16 mean
    Jaccard@20 >= EQUIV_BF16_MIN (a bound on gross errors: after one epoch
    near-tied scores reorder more than on the full-length record, which is
    held to 0.99).  Then ``bf16_product_check`` at the graph's catalogue,
    outside the count."""
    import io
    from importlib import import_module
    ee = import_module(f"{PKG}.scripts.eval_equiv_r4")
    checkpoint = import_module(f"{PKG}.train.checkpoint")
    d = tmp / "eval_equiv_r4"
    checkpoint.save_params_npz(d / "params_exact.npz", params)
    reset_counts()
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        ov = ee.main(["overlap", "--max-users", str(EQUIV_USERS), "--dir",
                      str(d), "--device", str(dev)], graph=graph)
    t_overlap = time.perf_counter() - t
    (d / "params_exact.npz").unlink()
    # a propagation, then each mode's _full_batch: a top-k select a batch
    counts = read_counts({"segment_spmm": _applies(ee.make_cfg("exact")),
                          "topk_select": len(ee.MODES)
                          * -(-EQUIV_USERS // TOPK_BATCH)},
                         "eval_equiv path")
    a, b = ov["jaccard_approx_vs_exact"], ov["jaccard_bf16_vs_exact"]
    if ov["n_users"] != EQUIV_USERS or a["frac_identical"] != 1.0 \
            or not EQUIV_BF16_MIN <= b["mean"] <= 1.0:
        raise AssertionError(f"eval_equiv overlap {ov}")
    product = bf16_product_check(dev, graph.num_items,
                                 ee.make_cfg("exact").emb_dim)
    log(f"[phase 20c] eval_equiv_r4 overlap on {ov['n_users']:,} val users "
        f"of the planted graph ({t_overlap:.1f}s): approx identical on "
        f"{a['frac_identical']:.1%}, bf16 mean Jaccard@20 {b['mean']:.4f} "
        f"(min {b['min']:.4f}); launches {counts}; the bf16 GEMM with fp32 "
        f"output at {product['shape']} within "
        f"{product['max_gap_over_bound']:.3f} of its summation-order bound "
        f"of the upcast product")
    return {"launches_by_kernel": counts, "overlap_s": t_overlap,
            "overlap": ov, "bf16_product": product}


def phase_schedule_compare(dev, graph, tmp: Path) -> dict:
    """Phase 20 (b): ``scripts/schedule_compare`` with ``per_batch`` for
    SCHEDULE_EPOCHS epoch on phase 18's planted graph, counted as the
    ``schedule_compare`` path (a step: the K=4 propagate forward and
    backward, 2(K+1)+2 gathers, 1 Adam; a propagate each evaluation), the
    JAX record's keys; then one propagate and PARITY_STEPS ``per_batch``
    steps held against ``spmm_backend="torch"`` on the card; returns the
    kernel trainer's parameters after one epoch as ``_params``."""
    import io
    from importlib import import_module
    sc = import_module(f"{PKG}.scripts.schedule_compare")
    presets = import_module(f"{PKG}.configs.presets")
    trainer_mod = import_module(f"{PKG}.train.trainer")
    root = Path(__file__).resolve().parent
    cfg = presets.get_preset("scaled_10m", propagation_schedule="per_batch",
                             epochs=SCHEDULE_EPOCHS, seed=0)
    n_train = int((graph.user_csr("train").degrees() > 0).sum())
    nb = -(-n_train // cfg.batch_size)
    reset_counts()
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out = sc.main([str(SCHEDULE_EPOCHS), "--schedules", "per_batch",
                       "--out", str(tmp / "schedule_compare.json"),
                       "--device", str(dev)], graph=graph)
    wall = time.perf_counter() - t
    # and the full evaluation's top-k select a batch (val every epoch, test)
    counts = read_counts({**_per_batch_counts(cfg, nb, SCHEDULE_EPOCHS,
                                              SCHEDULE_EPOCHS + 1),
                          "topk_select": SCHEDULE_EPOCHS * full_eval_calls(
                              graph, "val", cfg.eval_batch)
                          + full_eval_calls(graph, "test", cfg.eval_batch)},
                         "schedule_compare path")
    jax = json.loads((root / "runs" / "schedule_compare.json").read_text())
    written = json.loads((tmp / "schedule_compare.json").read_text())
    if set(written) != set(jax) - {"per_epoch"} | {"card"} \
            or _keys(written["per_batch"]) != _keys(jax["per_batch"]):
        raise AssertionError(f"schedule_compare keys {_keys(written)}")
    _finite_metrics(out["per_batch"]["test"], "schedule_compare per_batch")
    tr_k = trainer_mod.RecTrainer(cfg, graph, device=dev, verbose=False)
    held = _held_against_plain(
        tr_k, trainer_mod.RecTrainer(cfg.replace(spmm_backend="torch"),
                                     graph, device=dev, verbose=False),
        "schedule_compare per_batch")
    # phase 20 (c)'s parameters: one per_batch epoch of the kernel trainer
    params, opt, gen = tr_k.init_state()
    tr_k.run_epoch(params, opt, tr_k.draw_epoch(gen))
    r = out["per_batch"]
    log(f"[phase 20b] schedule_compare per_batch {SCHEDULE_EPOCHS} epoch on "
        f"the planted graph ({nb} steps): {wall:.1f}s (fit "
        f"{r['seconds']:.1f}s, epoch {r['epoch_seconds_median']:.2f}s), test "
        f"R@20 {r['test'][20]['recall']:.6f}; launches {counts}; held "
        f"against the plain path: " + _held_line({"per_batch": held}))
    return {"launches_by_kernel": counts, "wall_s": wall, "record": out,
            "held_against_plain": held, "_params": params}


def phase_ingest_bench(dev, tmp: Path, jsonl: Path) -> dict:
    """Phase 20 (d): ``scripts/ingest_bench`` on phase 11's JSONL (its
    Python reader on an INGEST_PYTHON_LINES prefix): every line kept, the
    JAX record's keys with the host's CPU and the card, no kernel
    launched."""
    import io
    from importlib import import_module
    ib = import_module(f"{PKG}.scripts.ingest_bench")
    root = Path(__file__).resolve().parent
    lines = CRED_REVIEWS["lines"]
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        rec = ib.main(["--path", str(jsonl), "--lines", str(lines),
                       "--python-lines", str(INGEST_PYTHON_LINES), "--out",
                       str(tmp / "ingest_bench.json"), "--device", str(dev)])
    read_counts({}, "ingest_bench")
    jax = json.loads((root / "runs" / "ingest_bench.json").read_text())
    if rec["rows_kept"] != lines or not jsonl.exists() \
            or set(rec) != set(jax) | {"host_cpu", "card"}:
        raise AssertionError(f"ingest_bench record {rec}")
    log(f"[phase 20d] ingest_bench on phase 11's {lines:,} lines: native "
        f"{rec['native_s']:.2f}s ({rec['native_mlines_per_s']:.3f} M "
        f"lines/s), Python {rec['python_prefix_s']:.2f}s on "
        f"{rec['python_prefix_lines']:,} lines (projected "
        f"{rec['python_projected_s']:.1f}s); host {rec['host_cpu']}")
    return rec


def phase_eval_breakdown(dev, graph, tmp: Path) -> dict:
    """Phase 20 (e): ``probes/eval_breakdown`` for BREAKDOWN_BATCHES
    batches on phase 18's planted graph: every part timed, the chunked
    top-k sets equal to the full-width ones, no kernel launched but the
    top-k select of its two ``_full_batch`` calls a batch."""
    import io
    from importlib import import_module
    eb = import_module(f"{PKG}.probes.eval_breakdown")
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        rec = eb.main(["--batches", str(BREAKDOWN_BATCHES), "--out",
                       str(tmp / "eval_breakdown.json"), "--device",
                       str(dev)], graph=graph)
    read_counts({"topk_select": 2 * BREAKDOWN_BATCHES}, "eval_breakdown")
    ms = rec["ms_per_batch"]
    if set(ms) != set(eb.PARTS) or min(rec["sets_agree_min"].values()) < 1.0 \
            or not all(np.isfinite(v) and v >= 0 for v in ms.values()):
        raise AssertionError(f"eval_breakdown {rec['ms_per_batch']} "
                             f"{rec['sets_agree_min']}")
    log(f"[phase 20e] eval_breakdown, {BREAKDOWN_BATCHES} batches of "
        f"{rec['batch']} over {graph.num_items:,} items (ms a batch, "
        f"{rec['clock']}): " + ", ".join(f"{k} {v:.3f}" for k, v in
                                         ms.items())
        + f"; sets agree {rec['sets_agree_min']}; bf16 Jaccard vs fp32 "
        f"{rec['bf16_jaccard_vs_fp32_mean']:.4f}")
    return rec


# phase 21: the last three modules (probes/scaling_terms.py,
# probes/sampling_costs.py, scripts/scaling_projection.py)
# --------------------------------------------------------------------------

TERMS_ITERS = 1               # scaling_terms' timed calls a loop (of 3)
SAMPLING_ITERS = 3            # sampling_costs' timed calls (of 20)


def phase_scaling_terms(dev, tr, tmp: Path) -> dict:
    """Phase 21 (a): ``probes/scaling_terms`` on phase 18's north-star
    trainer at TERMS_ITERS iteration, counted as the ``scaling_terms``
    path: each loop runs one untimed call first; a propagate 2K
    ``segment_spmm``, an epoch 2K for its cache then 4 ``gather_backward``
    and 1 ``fused_adam`` a step, the evaluation's two calls a propagate
    and a top-k select a batch each.  The JAX record's keys plus ``card``, ``iters`` and ``clock``;
    finite positive terms, scan_steps_s = epoch_s - propagate_s, and a
    ``config`` the projection accepts."""
    import io
    from importlib import import_module
    st = import_module(f"{PKG}.probes.scaling_terms")
    sp = import_module(f"{PKG}.scripts.scaling_projection")
    root = Path(__file__).resolve().parent
    K, nb = tr.cfg.num_layers, -(-tr.train_users.size // tr.cfg.batch_size)
    path = tmp / "scaling_terms.json"
    reset_counts()
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        rec = st.main(["--iters", str(TERMS_ITERS), "--out", str(path),
                       "--device", str(dev)], trainer=tr)
    wall = time.perf_counter() - t
    n = TERMS_ITERS + 1
    counts = read_counts({"segment_spmm": 2 * K * (2 * n + 2),
                          "gather_backward": NORTHSTAR_GATHERS * nb * n,
                          "fused_adam": nb * n,
                          "topk_select": 2 * full_eval_calls(
                              tr.ctx.graph, "val", tr.cfg.eval_batch)},
                         "scaling_terms path")
    jax = json.loads((root / "runs" / "scaling_terms.json").read_text())
    terms = [rec[k] for k in ("propagate_s", "epoch_s", "eval_epoch_s")]
    if set(rec) != set(jax) | {"card", "iters", "clock"} \
            or not all(np.isfinite(v) and v > 0 for v in terms) \
            or rec["scan_steps_s"] != max(rec["epoch_s"] - rec["propagate_s"],
                                          0.0) \
            or rec["config"] != jax["config"] or rec["fixed_s"] != 0.0:
        raise AssertionError(f"scaling_terms record {rec}")
    sp.check_terms(rec)
    log(f"[phase 21a] scaling_terms on phase 18's trainer ({TERMS_ITERS} "
        f"timed call a loop, {wall:.1f}s): propagate "
        f"{1e3 * rec['propagate_s']:.3f} ms, epoch {rec['epoch_s']:.4f} s "
        f"({nb} steps), scan steps {rec['scan_steps_s']:.4f} s, full "
        f"evaluation {rec['eval_epoch_s']:.3f} s; {rec['config']}; card "
        f"{rec['card']}; launches {counts}")
    return {"launches_by_kernel": counts, "wall_s": wall, "terms": rec,
            "_path": path}


def phase_sampling_costs(dev, tmp: Path) -> dict:
    """Phase 21 (b): ``probes/sampling_costs`` at SAMPLING_ITERS timed
    calls (the catalogues and graph of the JAX probes): every draw in range,
    every timing positive, hash table and binary search agreeing, every
    member found, no kernel launched."""
    import io
    from importlib import import_module
    sc = import_module(f"{PKG}.probes.sampling_costs")
    reset_counts()
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rec = sc.main(["--iters", str(SAMPLING_ITERS), "--out",
                       str(tmp / "sampling_costs.json"), "--device",
                       str(dev)])
    wall = time.perf_counter() - t
    counts = read_counts({}, "sampling_costs path")
    m, alias = rec["membership"], rec["alias"]
    ms = [r["us_per_draw_batch"] for r in alias] + list(
        rec["sampling"]["ms"].values()) + list(m["ms"].values())
    if not (m["agree"] and m["members_found"]) \
            or not all(r["in_range"] for r in alias) \
            or sorted({r["catalogue"] for r in alias}) != sorted(sc.CATALOGUES) \
            or not all(np.isfinite(v) and v > 0 for v in ms):
        raise AssertionError(f"sampling_costs record {rec}")
    log(f"[phase 21b] sampling_costs ({SAMPLING_ITERS} timed calls, "
        f"{wall:.1f}s, {rec['clock']}): draws (us a batch of "
        f"{alias[0]['draws_per_call']:,}) " + ", ".join(
            f"{r['draw']} I={r['catalogue']:,} {r['us_per_draw_batch']:.1f}"
            for r in alias) + "; sampling (ms) " + ", ".join(
            f"{k} {v:.4f}" for k, v in rec["sampling"]["ms"].items())
        + "; membership (ms) " + ", ".join(
            f"{k} {v:.4f}" for k, v in m["ms"].items())
        + f"; hash table {m['hash_table']['size']:,} slots, load "
        f"{m['hash_table']['load']:.3f}; agree {m['agree']}, members found "
        f"{m['members_found']}")
    return {"launches_by_kernel": counts, "wall_s": wall, "record": rec}


def phase_scaling_projection(dev, graph, terms_path: Path, tmp: Path) -> dict:
    """Phase 21 (c): ``scripts/scaling_projection`` on (a)'s terms and
    phase 18's planted graph: rows for P = 2, 4, 8 with finite times and
    efficiencies, the bandwidths marked as not measured, and the P=4 halo
    rows equal to a ``sharding_report`` record of the same graph; no kernel
    launched.  A TPU-labelled terms file (the JAX record) is refused.  The
    halo check here is a consistency check within the port: the record and
    the projection come from one planner (``_plan_dir``), so it catches a
    wiring slip (P h_max against P^2 h_max), not a planner fault.  The
    independent check is ``scripts/protocol.py summary``'s, against the
    committed, JAX-equal ``runs/torch_h100/sharding_report.json``."""
    import io
    from importlib import import_module
    sr = import_module(f"{PKG}.scripts.sharding_report")
    sp = import_module(f"{PKG}.scripts.scaling_projection")
    root = Path(__file__).resolve().parent
    reset_counts()
    t = time.perf_counter()
    stats = sr.operator_stats(graph, sp.CHECK_P)
    record = tmp / "sharding_report.json"
    record.write_text(json.dumps({
        "graph": sr.graph_key(graph),
        "operators": {k: sr.record_stats(v) for k, v in stats.items()}}))
    t_report = time.perf_counter() - t
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        rep = sp.main(["--terms", str(terms_path), "--sharding-report",
                       str(record), "--out",
                       str(tmp / "scaling_projection.json"), "--device",
                       str(dev)], graph=graph, report_graph=graph)
        try:
            sp.main(["--terms", str(root / "runs" / "scaling_terms.json"),
                     "--sharding-report", "", "--out",
                     str(tmp / "tpu.json"), "--device", str(dev)],
                    graph=graph)
            refused = None
        except ValueError as e:
            refused = str(e)
    wall = time.perf_counter() - t
    counts = read_counts({}, "scaling_projection path")
    rows = rep["projections"]
    a = rep["assumptions"]
    if set(rows) != {"2", "4", "8"} or not rep["sharding_report_check"][
            "equal"] or refused is None or "TPU" not in refused \
            or any(a[k]["measured"] for k in sp.ASSUMPTIONS) \
            or not all(np.isfinite(r["scaling_efficiency"])
                       and 0 < r["scaling_efficiency"] <= 1
                       and r["t_epoch_projected_s"] > 0
                       for r in rows.values()):
        raise AssertionError(f"scaling_projection {rows} "
                             f"{rep.get('sharding_report_check')} "
                             f"refused {refused}")
    log(f"[phase 21c] scaling_projection (a projection; {wall:.1f}s, the "
        f"halo record {t_report:.1f}s): " + "; ".join(
            f"P={P} t_epoch {r['t_epoch_projected_s']:.4f} s (collectives "
            f"{1e3 * r['t_collective_s']:.2f} ms) efficiency "
            f"{r['scaling_efficiency']:.3f}" for P, r in rows.items())
        + "; P=4 halo rows equal to the sharding record of the same graph "
        "(a consistency check within the port); TPU terms refused")
    return {"launches_by_kernel": counts, "wall_s": wall, "projections": rows,
            "check": rep["sharding_report_check"], "refused": refused}


# --------------------------------------------------------------------------
# phase 22: the JAX trainer's own random streams
# --------------------------------------------------------------------------

# the JAX package's side, written on a CPU by tests/test_torch_jax_streams.py
JAX_STREAMS_FIXTURE = "runs/torch_h100/f10/jax_small.json"


def _sha256(arrays) -> str:
    import hashlib
    h = hashlib.sha256()
    for x in arrays:
        h.update(np.ascontiguousarray(x).tobytes())
    return h.hexdigest()


def phase_jax_streams(dev) -> dict:
    """Phase 22: ``scripts/jax_streams.py`` (the JAX trainer's threefry
    streams in numpy) driving the port on the card, counted as the
    ``jax_streams_replay`` path: degree_aware on the fixture's small graph
    from the replica's initial parameters, each epoch on the replica's
    draws through ``RecTrainer.run_epoch``.  The parameters' and every
    epoch's draws' sha256 equal to the JAX package's (the fixture), every
    epoch's mean loss within the fixture's rtol of JAX's jitted epoch on a
    CPU; 12 ``segment_spmm``, 10 ``gather_backward`` and 1 ``fused_adam``
    a step.  Then the graph's shapes held against the plain path."""
    import torch
    from importlib import import_module
    js = import_module(f"{PKG}.scripts.jax_streams")
    build = import_module(f"{PKG}.graph.build")
    presets = import_module(f"{PKG}.configs.presets")
    lightgcn = import_module(f"{PKG}.models.lightgcn")
    adam = import_module(f"{PKG}.ops.adam")
    trainer = import_module(f"{PKG}.train.trainer")
    root = Path(__file__).resolve().parent
    fx = json.loads((root / JAX_STREAMS_FIXTURE).read_text())
    graph = build.synthetic_bipartite_graph(**fx["graph"])
    fit = {k: tuple(v) if isinstance(v, list) else v
           for k, v in fx["fit"].items()}
    cfg = presets.get_preset(fx["preset"]).replace(**fit)
    cred = np.random.default_rng(0).uniform(
        0.2, 1.0, graph.num_users).astype(np.float32)
    t = time.perf_counter()
    tr = trainer.RecTrainer(cfg, graph, cred=cred, device=dev, verbose=False)
    init, key = js.init_state(fx["seed"], cfg, graph.num_users,
                              graph.num_items)
    if _sha256(init[k] for k in sorted(init)) != fx["init_sha256"]:
        raise AssertionError("phase 22: the replica's initial parameters "
                             "differ from the JAX trainer's")
    params = lightgcn.params_from_jax(init, dev)
    opt = adam.adam_init(params)
    csr = graph.user_csr("train")
    losses = []
    reset_counts()
    for epoch, sha in enumerate(fx["draws_sha256"], 1):
        batches, key = js.epoch_draws(key, tr.train_users, csr, cfg,
                                      graph.num_items)
        if _sha256(batches) != sha:
            raise AssertionError(f"phase 22: epoch {epoch}'s draws differ "
                                 f"from the JAX epoch's")
        losses.append(float(tr.run_epoch(params, opt, tuple(
            torch.as_tensor(b, device=dev) for b in batches)).mean()))
    nb = batches[0].shape[0]
    counts = read_counts(_per_batch_counts(cfg, nb, len(losses), 0),
                         "jax_streams_replay path")
    wall = time.perf_counter() - t
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, fx["losses"])]
    if len(losses) != fx["epochs"] or not np.isfinite(losses).all() \
            or max(rel) > fx["loss_rtol"]:
        raise AssertionError(f"phase 22: epoch losses {losses} against "
                             f"JAX's {fx['losses']} (rtol "
                             f"{fx['loss_rtol']:g}): {max(rel):.3g}")
    plain = trainer.RecTrainer(cfg.replace(spmm_backend="torch"), graph,
                               cred=cred, device=dev, verbose=False)
    held = _held_against_plain(tr, plain, "phase 22")
    twogen = _twogen_replay(dev, graph, fx["seed"], fx["epochs"])
    log(f"[phase 22] jax_streams: {fx['preset']} on the JAX trainer's "
        f"streams, {graph.num_users} users x {graph.num_items} items, seed "
        f"{fx['seed']}, {len(losses)} epochs of {nb} steps ({wall:.1f}s): "
        f"init and every epoch's draws equal to JAX's (sha256), losses "
        f"within {max(rel):.3g} of JAX's jitted epochs on a CPU (rtol "
        f"{fx['loss_rtol']:g}); last {losses[-1]:.7f} (JAX "
        f"{fx['losses'][-1]:.7f}); launches {counts}; held against the "
        f"plain path: {_held_line({'small graph': held})}")
    return {"launches_by_kernel": counts, "wall_s": wall, "losses": losses,
            "max_rel_loss_diff": max(rel), "held": held, "twogen": twogen}


def _twogen_replay(dev, graph, seed: int, epochs: int) -> dict:
    """Phase 22 (b): ``protocol f10_fresh``'s twogen arm, counted as the
    ``twogen_replay`` path: ``protocol.replay`` of degree_aware's parity
    configuration on ``graph`` for ``epochs`` epochs on the port's own
    streams, the initial tables from a generator seeded ``seed`` and the
    epochs from a second one seeded ``seed + F10_EPOCH_SEED_OFFSET``.
    Its streams' initial tables bit-equal to ``RecTrainer.init_state``'s,
    every epoch's draws bit-equal to ``draw_epoch`` on a second generator,
    and the replay's logged losses finite and equal, digit for digit, to
    ``run_epoch`` on those tables and draws."""
    import torch
    from importlib import import_module
    protocol = import_module(f"{PKG}.scripts.protocol")
    parity_run = import_module(f"{PKG}.scripts.parity_run")
    adam = import_module(f"{PKG}.ops.adam")
    trainer = import_module(f"{PKG}.train.trainer")
    epoch_seed = seed + protocol.F10_EPOCH_SEED_OFFSET
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "graph.npz"
        np.savez_compressed(path, train_edges=graph.train_edges,
                            val_edges=graph.val_edges,
                            test_edges=graph.test_edges,
                            num_users=graph.num_users,
                            num_items=graph.num_items)
        t = time.perf_counter()
        reset_counts()
        protocol.replay(path, "degree_aware", seed, epochs, dev,
                        Path(tmp) / "twogen.out",
                        port_streams=protocol.PORT_STREAMS,
                        epoch_seed=epoch_seed)
        wall = time.perf_counter() - t
        cfg = parity_run.framework_config("degree_aware", epochs, 2, seed)
        tr = trainer.RecTrainer(cfg, parity_run.load_graph(path), device=dev,
                                verbose=False)
        nb = -(-tr.train_users.size // cfg.batch_size)
        counts = read_counts(_per_batch_counts(cfg, nb, epochs, 0),
                             "twogen_replay path")
        logged = [float(x) for x in protocol._EPOCH_LOSS.findall(
            (Path(tmp) / "twogen.out").read_text())]
    params, key, draw = protocol.replay_streams(
        tr, seed, protocol.PORT_STREAMS, epoch_seed=epoch_seed)
    fit_params = tr.init_state(seed)[0]
    if params.keys() != fit_params.keys() or not all(
            torch.equal(params[k], v) for k, v in fit_params.items()):
        raise AssertionError("phase 22: the twogen replay's initial tables "
                             "differ from RecTrainer.init_state's")
    gen = torch.Generator(device=dev)
    gen.manual_seed(epoch_seed)
    opt = adam.adam_init(fit_params)
    mine = []
    for epoch in range(1, epochs + 1):
        batches, key = draw(key)
        want = tr.draw_epoch(gen)
        if not all(np.array_equal(a, w.cpu().numpy())
                   for a, w in zip(batches, want)):
            raise AssertionError(f"phase 22: the twogen replay's epoch "
                                 f"{epoch} draws differ from draw_epoch on "
                                 f"a generator seeded {epoch_seed}")
        mine.append(float(tr.run_epoch(fit_params, opt, want).mean()))
    if len(logged) != epochs or not np.isfinite(logged).all() or \
            [f"{x:.6f}" for x in mine] != [f"{x:.6f}" for x in logged]:
        raise AssertionError(f"phase 22: the twogen replay's losses "
                             f"{logged} against run_epoch's {mine}")
    log(f"[phase 22] twogen replay: degree_aware's parity configuration on "
        f"{graph.num_users} x {graph.num_items}, seed {seed}, epochs from a "
        f"generator seeded {epoch_seed}, {epochs} epochs of {nb} steps "
        f"({wall:.1f}s): initial tables bit-equal to init_state's, every "
        f"epoch's draws bit-equal to draw_epoch's on the second generator, "
        f"losses equal to run_epoch's on them; last {logged[-1]:.6f}; "
        f"launches {counts}")
    return {"launches_by_kernel": counts, "wall_s": wall, "losses": logged,
            "epoch_seed": epoch_seed}


# --------------------------------------------------------------------------
# phase 23: the top-k select kernel (csrc/topk_select.cu)
# --------------------------------------------------------------------------

REPLACES_TOPK = ("no Pallas kernel: torch.topk on the single-device ranking "
                 "path (eval/ranking.py _full_batch, eval/retrieval.py "
                 "topk_for_users); the JAX package ranks with XLA's lax.top_k "
                 "(eval/ranking.py:203)")
TOPK_KINDS = {"chunks": "topk_select_chunks_kernel",
              "merge": "topk_select_merge_kernel"}
TOPK_K = 20
TOPK_EVAL_USERS = 512             # scaled_10m's evaluation batch
TOPK_SERVE_USERS = (256, 1024)    # the serve cell's smallest and largest


def _topk_row(tag: str, scores, ts, tc, timing) -> dict:
    """The kernel on one score matrix: ids and value bits equal to the
    plain version's, one counted call and two CUDA launches a call (a
    captured graph); its ms (CUDA events), device ms by kernel (profiler;
    None where every window lost records), the plain version's and
    torch.topk's ms, the bound (every score read once at 3.35 TB/s), the
    share of scores that entered a thread queue, and the measured max
    |values - plain values| and whether the ids equal the plain ones."""
    import torch
    rows, cols = scores.shape
    before = tc.KERNEL.launches
    values, ids, inserted = ts.topk_select(scores, TOPK_K, count=True)
    rv, ri = ts.topk_select_reference(scores, TOPK_K)
    ids_equal = bool(torch.equal(ids, ri))
    bits_equal = bool(torch.equal(values.view(torch.int32),
                                  rv.view(torch.int32)))
    max_abs_err = float(torch.where(values == rv, 0.0,
                                    (values - rv).abs()).max())
    if not (ids_equal and bits_equal):
        raise AssertionError(f"{tag}: topk_select differs from its plain "
                             f"version (ids equal {ids_equal}, max abs err "
                             f"{max_abs_err:.3g})")
    if tc.KERNEL.launches != before + 1:
        raise AssertionError(f"{tag}: {tc.KERNEL.launches - before} counted "
                             f"calls for one")
    del values, ids, rv, ri

    def call():
        return ts.topk_select(scores, TOPK_K)
    launches = graph_launches(call, TOPK_KINDS)
    if launches != {"chunks": 1, "merge": 1}:
        raise AssertionError(f"{tag}: CUDA launches a call {launches}")
    split = profile_matching(call, TOPK_KINDS, launches)
    return {"shape": tag, "rows": rows, "cols": cols, "k": TOPK_K,
            "chunks": tc.chunks_for(rows, cols,
                                    tc.sm_count(scores.device.index)),
            "ms": cuda_time_ms(call, 20),
            "device_ms": None if split is None else sum(split.values()),
            "device_ms_by_kernel": split,
            "plain_ms": cuda_time_ms(
                lambda: ts.topk_select_reference(scores, TOPK_K), 3),
            "library_ms": cuda_time_ms(
                lambda: torch.topk(scores, TOPK_K, dim=1), 20),
            "bound_ms": timing.bound_ms(rows * cols * 4, 0),
            "engaged_share": inserted / (rows * cols),
            "max_abs_err": max_abs_err, "ids_equal": ids_equal,
            "cuda_launches_per_call": launches}


def phase_topk_select(dev, ns_graph) -> dict:
    """Phase 23: the top-k select on the two cells' own masked score
    matrices: (a) ``scaled_10m``'s evaluation batch, 512 test users' bf16
    scores over the planted graph's 1,000,000 items, train items at -1e9;
    (b) the serve cell's requests, 256 and 1,024 users' fp32 scores over
    the reference-scale graph's 261,728 items, train items at -inf; both on
    tables propagated from ``init_state(0)``.  Each through ``_topk_row``."""
    import torch
    from importlib import import_module
    bench = import_module(f"{PKG}.bench")
    build = import_module(f"{PKG}.graph.build")
    presets = import_module(f"{PKG}.configs.presets")
    trainer_mod = import_module(f"{PKG}.train.trainer")
    retrieval = import_module(f"{PKG}.eval.retrieval")
    ts = import_module(f"{PKG}.ops.topk_select")
    tc = import_module(f"{PKG}.ops.topk_select_cuda")
    timing = import_module(f"{PKG}.probes._timing")
    rows = []
    graph = build.synthetic_bipartite_graph(**GRAPH)
    cases = [("eval", lambda: bench.northstar_trainer(ns_graph, dev), ns_graph,
              (TOPK_EVAL_USERS,), -1e9),
             ("serve", lambda: trainer_mod.RecTrainer(
                 presets.get_preset("cu_message"), graph, device=dev,
                 verbose=False), graph, TOPK_SERVE_USERS, float("-inf"))]
    for cell, make_trainer, g, sizes, masked in cases:
        tr = make_trainer()
        with torch.no_grad():
            user_emb, item_emb = tr.model.propagate(tr.init_state(0)[0])
        test = tr.ctx.users_of("test")
        for n in sizes:
            users = test[:n]
            scores = retrieval.score_product(
                user_emb[torch.as_tensor(users, device=dev)], item_emb,
                tr.cfg.eval_score_dtype if cell == "eval" else "fp32")
            excl = torch.as_tensor(retrieval.exclusion_rows_for_users(
                g, users), device=dev)
            retrieval.mask_excluded(scores, excl, masked)
            rows.append({"cell": cell, **_topk_row(
                f"{cell} {n} x {g.num_items:,}", scores, ts, tc, timing)})
            del scores, excl
        del tr, user_emb, item_emb
        torch.cuda.empty_cache()
    for r in rows:
        log(f"[phase 23] topk_select {r['shape']} k={r['k']} chunks "
            f"{r['chunks']}: {r['ms']:.4f} ms, device "
            f"{_ms(r['device_ms'])} ({r['device_ms_by_kernel']}), bound "
            f"{r['bound_ms']:.4f}, plain {r['plain_ms']:.3f}, torch.topk "
            f"{r['library_ms']:.4f}; engaged {100 * r['engaged_share']:.3f}%;"
            f" max abs err {r['max_abs_err']:g}, ids equal {r['ids_equal']}")
    return {"rows": rows}


def _rounded(obj):
    """``obj`` with every float to 6 significant digits, for the kernels'
    line (the ``--out`` file keeps every digit)."""
    if isinstance(obj, float):
        return float(f"{obj:.6g}")
    if isinstance(obj, dict):
        return {k: _rounded(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_rounded(v) for v in obj]
    return obj


def launches_by_path(paths: dict, name: str) -> dict:
    """One kernel's launches on each counted path (``paths``: path name to
    the counts read after it)."""
    return {path: counts[name] for path, counts in paths.items()}


def _probe_entry(rows, name, source, replaces, paths, main_paths, err,
                 extra):
    """One kernel's entry from its probe rows (summed over the rows: one
    application per direction, or one call per slab size).  ``launches``
    is the sum over the main paths for a kernel that runs there (P1 and P3,
    on the chunked paths), else the probes' count (P2 and P4); every
    path's count is in ``launches_by_path``."""
    on_main = sum(paths[p][name] for p in main_paths)
    return {"name": name, "route": "cuda", "source": f"{PKG}/csrc/{source}",
            "replaces": replaces,
            "launches": on_main or paths["probes"][name],
            "launches_by_path": launches_by_path(paths, name),
            "max_abs_err": err,
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "bytes",
            "library_ms": sum(r["library_ms"] for r in rows), **extra}


def probe_kernel_entries(chunk: dict, probes: dict, paths: dict,
                         main_paths: tuple, chunked: dict) -> list:
    """The kernels' entries of the probe kernels P1-P4, from phases 9-10
    (``paths``: each counted path's launches by kernel), with P1's and P3's
    times on the chunked main path (phase 17 (f): each direction's apply
    at S = auto and S = 1, fp32 and bf16)."""
    kernels = []
    win_rows = probes["window_kernel"]["rows"]
    err = chunk["max_abs_err"]
    for name, variant, replaces in (
            ("chunk_spmm_block", "base R=512 T=256", REPLACES_P3),
            ("chunk_spmm_window", "win W=64", REPLACES_P1),
            ("chunk_spmm_i16", "i16 R=512 T=256", REPLACES_P2)):
        rows = [r for r in win_rows if r["variant"] == variant]
        # each direction's apply on the chunked main path: ms, device ms
        # and bound at S = auto and S = 1, fp32 and bf16
        on_path = [{"direction": d["direction"], "slices": d["slices"],
                    "ms": d["ms"], "bound_ms": d["bound_ms"],
                    "device_ms": {k: d[k]["device_ms"] for k in d["ms"]
                                  if k in d}}
                   for d in chunked["directions"]
                   if CHUNK_NAMES[bool(d["window"])] == name]
        kernels.append(_probe_entry(
            rows, name, "chunk_spmm.cu", replaces, paths, main_paths,
            err[name],
            {"shape": f"{variant}, one application per direction, D=64",
             "max_abs_err_bf16": err.get(f"{name} bf16"),
             "chunked_path_directions": on_path,
             "device_ms": sum(r["device_ms"] for r in rows),
             "cuda_launches_per_apply": probes["cuda_launches_by_kernel"][name],
             "directions": [{k: r[k] for k in ("direction", "ms", "device_ms",
                                               "plain_ms", "bound_ms",
                                               "library_ms", "pad_pct",
                                               "chunks")}
                            for r in rows]}))
    # the wrapper's route (L2) at the JAX probe's slabs; the shared-memory
    # route in each cluster size, and S = 768, stay in "sizes"
    g_all = probes["vmem_gather"]["rows"]
    g_rows = [r for r in g_all if r["route"] == "l2" and r["S"] in GATHER_SIZES]
    kernels.append(_probe_entry(
        g_rows, "row_gather", "row_gather.cu", REPLACES_P4, paths,
        main_paths, chunk["gather"]["max_abs_err"],
        {"shape": f"one call per slab size S in {list(GATHER_SIZES)}, "
                  f"{GATHER_STEPS} * S rows, D=64, L2 route",
         "device_ms": sum(r["device_ms"] for r in g_rows),
         "library_device_ms": sum(r["library_device_ms"] for r in g_rows),
         "sizes": [{k: r[k] for k in ("S", "route", "cluster", "ms",
                                      "device_ms", "ns_per_row", "plain_ms",
                                      "bound_ms", "library_ms",
                                      "library_device_ms")}
                   for r in g_all]}))
    return kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every number to this JSON file")
    ap.add_argument("--mesh-worker", nargs=4, default=None,
                    metavar=("RANK", "WORLD", "DIR", "MODE"),
                    help="internal: one rank of phase 15's part (b) (MODE "
                         "serve) or of phase 16's part (d) (MODE train)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if args.mesh_worker:
        rank, world, tmp, mode = args.mesh_worker
        return mesh_worker(int(rank), int(world), Path(tmp), mode=mode)
    return run(torch.device("cuda", 0), args.out)


def build_kernels() -> tuple:
    """Build every kernel source of the package (one nvcc each, started
    together); returns the phase-1 summary and each source's ptxas lines."""
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from importlib import import_module
    root = Path(__file__).resolve().parent
    mods = [import_module(f"{PKG}.ops.{m}") for m in
            ("spmm_cuda", "adam_cuda", "chunk_spmm_cuda", "row_gather_cuda",
             "topk_select_cuda")]
    for m in mods:
        if not m.SOURCE.resolve().is_relative_to(root):
            raise RuntimeError(f"{PKG} was imported from "
                               f"{m.SOURCE.parents[2]}, not from this "
                               f"checkout ({root})")
    # one kernel object per source: the chunked kernels share theirs
    by_source = {}
    for m in mods:
        for k in getattr(m, "KERNELS", None) or (m.KERNEL,):
            by_source.setdefault(k.source, k)
    # phase 9's copies of the chunk kernel with lagging warps, built alongside
    cr = import_module(f"{PKG}.probes.chunk_race")
    lagged = [cr.lagged_kernel(v) for v in cr.VARIANTS]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(by_source) + len(lagged)) as pool:
        libs = list(pool.map(lambda k: k.build(),
                              [*by_source.values(), *lagged]))[:len(by_source)]
    built, ptxas = [], {}
    for k, lib in zip(by_source.values(), libs):
        lines = [ln.strip() for ln in k.build_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        ptxas[k.source.name] = lines
        regs = [ln for ln in lines if "registers" in ln]
        built.append(f"{lib.name} ({len(regs)} kernels, "
                     f"{regs[0] if regs else 'no ptxas report'})")
    return (f"torch {torch.__version__} cuda {torch.version.cuda}; "
            f"{len(libs)} sources built in {time.perf_counter() - t0:.1f}s: "
            + "; ".join(built)), ptxas


def run(dev, out_path=None) -> int:
    """Every phase on ``dev``; prints the kernels' line and the last line."""
    import torch
    t_start = time.perf_counter()
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from importlib import import_module
    smi = nvidia_smi()
    summary, ptxas = build_kernels()
    log(f"[phase 1] {smi}; {summary}")
    wk = import_module(f"{PKG}.probes.window_kernel")
    # the probe graph: both reference-scale directions with random weights
    probe_dirs = wk.directions(GRAPH["num_users"], GRAPH["num_items"],
                               GRAPH["edges_per_user"], 64, dev)

    worst = phase_kernel_vs_plain(dev, probe_dirs)
    worst_adam = phase_adam_vs_plain(dev)
    gather_check = phase_gather_vs_plain(dev)
    # phase 11's review JSONL lives until phase 19 (c) reads it again
    reviews_tmp = tempfile.TemporaryDirectory()
    reviews_dir = Path(reviews_tmp.name)
    # phase 3's directory (graph, credibility CSV, parameters) lives until
    # phase 15 serves from it
    with tempfile.TemporaryDirectory() as tmp_slice:
        tmp_slice = Path(tmp_slice)
        res = phase_slice(dev, tmp_slice)
        ctx = res.pop("_ctx")
        train = phase_train(dev, tmp_slice, ctx)
        parity = phase_train_parity(dev, tmp_slice, ctx)
        # phase 7's trainer, parameters and batches serve phases 8 and 16
        p7 = {k: parity.pop(k) for k in ("_trainer", "_ref")}
        times = phase_train_times(dev, ctx, p7["_trainer"])
        t9 = time.perf_counter()
        chunk = phase_chunk_vs_plain(dev, probe_dirs)
        probes = phase_probes(dev, probe_dirs)
        log(f"[phases 9-10] {time.perf_counter() - t9:.1f}s")
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            jsonl = reviews_dir / "reviews.jsonl"
            t = time.perf_counter()
            write_reviews(jsonl, **CRED_REVIEWS)
            log(f"[phase 11] wrote {CRED_REVIEWS['lines']:,} review lines "
                f"({CRED_REVIEWS['users']:,} users, "
                f"{CRED_REVIEWS['items']:,} items) in "
                f"{time.perf_counter() - t:.1f}s")
            seconds = {}
            t = time.perf_counter()
            cred_slas = phase_cred_slas(dev, tmp, jsonl)
            hg, cred_dir = cred_slas.pop("_hg"), cred_slas.pop("_out")
            seconds[11] = time.perf_counter() - t
            t = time.perf_counter()
            cred_full = phase_cred_full_graph(dev, hg)
            c12 = {k: cred_full.pop(k) for k in ("_trainer", "_ref")}
            tr_full = c12["_trainer"]
            seconds[12] = time.perf_counter() - t
            t = time.perf_counter()
            two_stage = phase_two_stage(dev, tmp, jsonl, cred_dir)
            seconds[13] = time.perf_counter() - t
            t = time.perf_counter()
            cred_times = phase_cred_times(dev, tmp, jsonl, hg, tr_full)
            seconds[14] = time.perf_counter() - t
            log("[phases 11-14] seconds " + ", ".join(
                f"{k}: {v:.1f}" for k, v in seconds.items()))
            t = time.perf_counter()
            mesh = phase_serving_mesh(dev, tmp_slice, ctx, res)
            log(f"[phase 15] done in {time.perf_counter() - t:.1f}s")
            # ---- phase 16: training on a mesh ----
            t = time.perf_counter()
            mesh_steps = phase_mesh_train_steps(dev, ctx, p7)
            mesh_steps.pop("_ref")
            rec_mesh = phase_train_rec_mesh(dev, tmp_slice, ctx, train)
            cred_mesh = phase_cred_mesh(dev, tmp, jsonl, hg, c12)
            two_train = phase_train_two_ranks(tmp_slice, ctx, p7)
            log(f"[phase 16] done in {time.perf_counter() - t:.1f}s")
            # ---- phase 17: the chunked backend on the main path ----
            t = time.perf_counter()
            ch_serve = phase_chunked_serving(dev, tmp_slice, ctx, res)
            ch_train = phase_chunked_training(dev, tmp_slice, ctx, train, p7,
                                              ch_serve)
            ch_cred = phase_chunked_cred(dev, hg, c12)
            ch_times = phase_chunked_times(dev, ctx, ch_serve, ch_train, p7)
            for r in (ch_serve, ch_train):
                for k in [k for k in r if k.startswith("_")]:
                    r.pop(k)
            log(f"[phase 17] done in {time.perf_counter() - t:.1f}s")

    # ---- phase 18: the north star ----
    t18 = time.perf_counter()
    torch.cuda.empty_cache()
    bench_line = phase_bench_headline(dev)
    t = time.perf_counter()
    ns_graph = import_module(f"{PKG}.bench").northstar_graph()
    split = tuple(ns_graph.edges(s).shape[1] for s in ("train", "val", "test"))
    log(f"[phase 18] planted graph {ns_graph.summary()} built in "
        f"{time.perf_counter() - t:.1f}s (host)")
    if split != NORTHSTAR_SPLIT:
        raise AssertionError(f"planted graph split {split}, not "
                             f"{NORTHSTAR_SPLIT}")
    northstar = phase_northstar(dev, ns_graph)
    ns_trainer = northstar.pop("_trainer")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ns_two = phase_northstar_two_stage(dev, ns_graph, Path(tmp))
    log(f"[phase 18] done in {time.perf_counter() - t18:.1f}s")

    # ---- phase 19: the reference protocol's entry points ----
    t19 = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        protocol = {"reference_regression":
                    phase_reference_regression(dev, tmp),
                    "parity_framework": phase_parity(dev, tmp),
                    "two_stage_demo": phase_two_stage_demo(
                        dev, tmp, reviews_dir / "reviews.jsonl"),
                    "end_to_end": phase_end_to_end(dev, tmp)}
    log(f"[phase 19] done in {time.perf_counter() - t19:.1f}s")

    # ---- phase 20: the remaining protocol drivers, on phase 18's graph ----
    t20 = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        drivers = {"cred_parity": phase_cred_parity(dev, tmp),
                   "schedule_compare": phase_schedule_compare(dev, ns_graph,
                                                              tmp)}
        drivers["eval_equiv"] = phase_eval_equiv(
            dev, ns_graph, tmp, drivers["schedule_compare"].pop("_params"))
        ingest_rec = phase_ingest_bench(dev, tmp,
                                        reviews_dir / "reviews.jsonl")
        breakdown = phase_eval_breakdown(dev, ns_graph, tmp)
    reviews_tmp.cleanup()
    log(f"[phase 20] done in {time.perf_counter() - t20:.1f}s")

    # ---- phase 21: the last three modules, on phase 18's graph ----
    t21 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        terms = phase_scaling_terms(dev, ns_trainer, tmp)
        del ns_trainer
        torch.cuda.empty_cache()
        last = {"scaling_terms": terms,
                "sampling_costs": phase_sampling_costs(dev, tmp),
                "scaling_projection": phase_scaling_projection(
                    dev, ns_graph, terms.pop("_path"), tmp)}
    log(f"[phase 21] done in {time.perf_counter() - t21:.1f}s")

    # ---- phase 22: the JAX trainer's own random streams on the card ----
    t22 = time.perf_counter()
    torch.cuda.empty_cache()
    streams = phase_jax_streams(dev)
    log(f"[phase 22] done in {time.perf_counter() - t22:.1f}s")

    # ---- phase 23: the top-k select on the cells' score matrices ----
    t23 = time.perf_counter()
    torch.cuda.empty_cache()
    topk = phase_topk_select(dev, ns_graph)
    del ns_graph
    log(f"[phase 23] done in {time.perf_counter() - t23:.1f}s")

    dirs = res["directions"]
    pair = times["adam_pair"]
    cred_gathers = cred_times["gather_backward"]
    # every kernel's count, read after each counted path: serving (phase
    # 3), training (phase 6), the probes (phase 10), Stage A in SLAS mode
    # (phase 11) and in full-graph mode (phase 12), serving on a mesh
    # (phase 15), training on a mesh (phase 16 (b)), Stage A's full graph
    # on a mesh (phase 16 (c)), the chunked backend (phase 17), the north
    # star (phase 18) and the protocol's entry points (phase 19)
    paths = {"serving": res["launches_by_kernel"],
             "training": train["launches_by_kernel"],
             "probes": probes["launches"],
             "cred_slas": cred_slas["launches_by_kernel"],
             "cred_full_graph": cred_full["launches_by_kernel"],
             "serving_mesh": mesh["launches_by_kernel"],
             "training_mesh": rec_mesh["launches_by_kernel"],
             "cred_full_graph_mesh": cred_mesh["launches_by_kernel"],
             "serving_chunked": ch_serve["launches_by_kernel"],
             "training_chunked": ch_train["launches_by_kernel"],
             "cred_full_graph_chunked": ch_cred["launches_by_kernel"],
             "northstar": northstar["launches_by_kernel"],
             "northstar_two_stage": ns_two["launches_by_kernel"],
             **{k: v["launches_by_kernel"] for k, v in protocol.items()},
             **{k: v["launches_by_kernel"] for k, v in drivers.items()},
             **{k: v["launches_by_kernel"] for k, v in last.items()},
             "jax_streams_replay": streams["launches_by_kernel"],
             "twogen_replay": streams["twogen"]["launches_by_kernel"]}
    main_paths = ("serving", "training", "cred_slas", "cred_full_graph",
                  "serving_mesh", "training_mesh", "cred_full_graph_mesh",
                  "serving_chunked", "training_chunked",
                  "cred_full_graph_chunked", "northstar",
                  "northstar_two_stage", *protocol, *drivers, *last,
                  "jax_streams_replay", "twogen_replay")
    mesh_dirs = mesh["directions"]
    kernels = [{
        "name": "segment_spmm",
        "route": "cuda",
        "source": f"{PKG}/csrc/segment_spmm.cu",
        "replaces": REPLACES,
        # the main path's runs: serving (phase 3), training (phase 6) and
        # Stage A (phases 11 and 12)
        "launches": sum(paths[k]["segment_spmm"] for k in main_paths),
        "launches_by_path": launches_by_path(paths, "segment_spmm"),
        "max_abs_err": worst["fp32"],
        # one Gauss-Seidel layer: one K1-role plus one K2-role application
        "ms": sum(e["ms"] for e in dirs),
        "plain_ms": sum(e["plain_ms"] for e in dirs),
        "bound_ms": sum(e["bound_ms"] for e in dirs),
        "bound_by": "bytes",
        "library_ms": sum(e["library_ms"] for e in dirs),
        "long_row_edges": dirs[0]["long_row_edges"],
        "directions": dirs,
        "backward_directions": times["backward_directions"],
        "item_from_user_split_ms": res["item_from_user_split_ms"],
        "cred_directions": cred_times["spmm_directions"],
        "northstar_directions": northstar["directions"],
    }, {
        "name": "fused_adam",
        "route": "cuda",
        "source": f"{PKG}/csrc/fused_adam.cu",
        "replaces": REPLACES_ADAM,
        "launches": sum(paths[k]["fused_adam"] for k in main_paths),
        "launches_by_path": launches_by_path(paths, "fused_adam"),
        "max_abs_err": worst_adam["max_abs_err"],
        # one Stage-B train step: both tables in one launch
        **{k: pair[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                                "device_ms", "library_device_ms")},
        "bound_by": "bytes",
        "leaves": times["adam_leaves"],
        "cred_leaves": cred_times["adam_leaves"],
        "northstar_tables": northstar["adam_pair"],
    }, {
        "name": "gather_backward",
        "route": "cuda",
        "source": f"{PKG}/csrc/segment_spmm.cu",
        "replaces": REPLACES_GATHER,
        "launches": sum(paths[k]["gather_backward"] for k in main_paths),
        "launches_by_path": launches_by_path(paths, "gather_backward"),
        "max_abs_err": gather_check["max_abs_err"],
        # one Stage-A full-graph step's smoothness pair, h_u2[src] and
        # h_i1[dst]; the library call is index_add_ (atomic)
        "ms": sum(e["ms"] for e in cred_gathers),
        "plain_ms": sum(e["plain_ms"] for e in cred_gathers),
        "bound_ms": sum(e["bound_ms"] for e in cred_gathers),
        "bound_by": "bytes",
        "library_ms": sum(e["library_ms"] for e in cred_gathers),
        "index_put_ms": sum(e["index_put_ms"] for e in cred_gathers),
        "cases": cred_gathers + times["gather_backward"]
        + northstar["gather_backward"],
        "checked": gather_check["cases"],
    }, {
        "name": "sharded_spmm",
        "route": "cuda",
        "source": f"{PKG}/csrc/segment_spmm.cu",
        "replaces": REPLACES_SHARDED,
        "launches": sum(paths[k]["sharded_spmm"] for k in main_paths),
        "launches_by_path": launches_by_path(paths, "sharded_spmm"),
        "max_abs_err": max(d["max_abs_err"] for d in mesh_dirs),
        # one Gauss-Seidel layer's two local sums on a world of one (mode
        # "auto"), each on the buffer its exchange gave
        "ms": sum(d["ms"] for d in mesh_dirs),
        "plain_ms": sum(d["plain_ms"] for d in mesh_dirs),
        "bound_ms": sum(d["bound_ms"] for d in mesh_dirs),
        "bound_by": "bytes",
        "library_ms": sum(d["library_ms"] for d in mesh_dirs),
        "directions": mesh_dirs,
    }]
    kernels += probe_kernel_entries(chunk, probes, paths, main_paths,
                                    ch_times)
    t_rows = topk["rows"]
    kernels.append({
        "name": "topk_select",
        "route": "cuda",
        "source": f"{PKG}/csrc/topk_select.cu",
        "replaces": REPLACES_TOPK,
        # one call a batch of a full evaluation or a request, on the main
        # paths that rank on one device
        "launches": sum(paths[k]["topk_select"] for k in main_paths),
        "launches_by_path": launches_by_path(paths, "topk_select"),
        "max_abs_err": max(r["max_abs_err"] for r in t_rows),
        "ids_equal": all(r["ids_equal"] for r in t_rows),
        # the evaluation's batch (phase 23 (a))
        **{k: t_rows[0][k] for k in ("shape", "ms", "device_ms", "plain_ms",
                                     "bound_ms", "library_ms",
                                     "engaged_share")},
        "bound_by": "bytes",
        "cases": t_rows,
    })
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(
            {"nvidia_smi": smi, "torch": torch.__version__, "kernels": kernels,
             "phase2_worst": worst, "phase2b_worst": worst_adam,
             "phase2c": gather_check,
             "ptxas": ptxas, "phase9": chunk, "probes": probes,
             "train": train, "train_parity": parity,
             "cred_slas": cred_slas, "cred_full_graph": cred_full,
             "two_stage": two_stage, "cred_times": cred_times,
             "cred_phase_seconds": seconds, "serving_mesh": mesh,
             "training_mesh": {"steps": mesh_steps, "train_rec": rec_mesh,
                               "cred": cred_mesh, "two_ranks": two_train},
             "chunked": {"serving": ch_serve, "training": ch_train,
                         "cred_full_graph": ch_cred, "times": ch_times},
             "northstar": {"bench": bench_line, "scaled_10m": northstar,
                           "two_stage": ns_two},
             "protocol": protocol,
             "drivers": {**drivers, "ingest_bench": ingest_rec,
                         "eval_breakdown": breakdown},
             "last_modules": last, "jax_streams": streams,
             "topk_select": topk,
             "train_times": {k: v for k, v in times.items()
                             if k not in ("backward_directions",
                                          "adam_leaves", "adam_pair")},
             **{k: v for k, v in res.items() if k != "directions"}},
            indent=1, default=float))
    log(f"[total] {time.perf_counter() - t_start:.1f}s")
    print(smi)
    print(json.dumps({"kernels": _rounded(kernels)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
