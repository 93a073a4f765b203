"""Benchmark harness of the port: the counterpart of ``bench.py`` at the
repository root, which measures the JAX package.

Measures Stage-B training throughput (the propagation-dominated BPR train
step) on a synthetic bipartite graph and prints JSON lines on stdout, the
headline last:

    {"metric": "northstar_propagation_edges_per_sec_per_chip", ...}
    {"metric": "train_edges_per_sec_per_chip", "value": ..., "unit":
     "edges/s", "vs_baseline": ..., ...}

"value" counts propagation edge traversals (E * K * 2 directions * fwd+bwd
a step) per second of the trainer's steps on one card.  ``--mode epoch``
(the headline) times what ``RecTrainer.fit`` runs for an epoch:
``draw_epoch`` (the epoch's samples), then ``run_epoch`` (its step plans,
then every step), fenced on the card; ``--mode step`` one isolated step of
a fixed pool of users with its own positive and uniform negative draws
(``RecTrainer.train_step``, which builds the step's plans).

``--backend``: "auto" (the CSR SpMM kernel K1/K2, the port's default),
"chunked" (the chunk layout on P1/P3, the JAX package's "pallas") or
"torch" (the plain versions: gather + ``index_add_``, the JAX package's
"xla").  "vs_baseline" is the same measurement on ``--baseline-backend``
(default "torch") in fp32 over this one: the speed-up over stock PyTorch
with the reference's arithmetic, as the JAX bench's is over stock XLA in
fp32; ``vs_baseline_same_precision`` re-runs the baseline at
``--precision`` (default bf16: bf16 messages, fp32 sums).  Neither is a
kernel's yardstick: a kernel is held to its bound and its library call
(``chip_smoke.py``).

The bound is the least time an H100 SXM could take for a step's SpMM
applications (``probes/_timing.bound_ms``: each application's referenced
source rows, edge arrays and row pointers read once and its output written
once at 3.35 TB/s, or its fp32 operations at 67 TFLOP/s, whichever is
larger), summed over the step; the line gives the step's share of it.

The north star (``bench_northstar``, on the card with ``--scale ref --mode
epoch``, unless ``--no-northstar``) is the ``scaled_10m`` preset on the
planted 10M-edge graph (500,000 users, 1,000,000 items, 20 edges a user):
one K-layer propagation and one "per_epoch" epoch, with the peak memory.

Every line names its device; on the card also the card and its power limit
(``nvidia-smi``).  The entry point runs on the card and raises without one
unless ``--device cpu`` is passed; its times are then the host's.

    python -m <package>.bench [--scale small|ref|large]
        [--backend auto|chunked|torch] [--precision bf16|fp32]
        [--mode epoch|step] [--iters N] [--no-northstar] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import numpy as np
import torch

from .configs.presets import get_preset
from .graph.build import (synthetic_bipartite_graph,
                          synthetic_bipartite_graph_planted)
from .ops.sampling import sample_negatives_uniform, sample_positives
from .probes._timing import bound_ms
from .train.trainer import RecTrainer
from .utils.config import SPMM_BACKENDS, RecConfig
from .utils.device import card_name, resolve_device
from .utils.profiling import Throughput, time_fn

WEIGHT_MODES = {"gauss_seidel": "cu_message", "symmetric": "symmetric",
                "bipartite_sync": "cred_eq322"}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_graph(scale: str):
    if scale == "small":
        return synthetic_bipartite_graph(2_000, 3_000, 16.0, seed=0, power=0.9)
    if scale == "ref":
        # reference dataset scale: 58.9K users / 262K items / ~464K edges
        return synthetic_bipartite_graph(58_867, 261_728, 7.9, seed=0,
                                         power=1.0)
    if scale == "large":
        # north-star class: multi-million-edge graph
        return synthetic_bipartite_graph(500_000, 1_000_000, 20.0, seed=0,
                                         power=1.0)
    raise ValueError(scale)


def northstar_graph(users: int = 500_000, items: int = 1_000_000,
                    edges_per_user: float = 20.0):
    """The planted graph of the north star (``bench.py:214-217``); at its
    defaults the 10M-edge one: 6,899,612 train, 864,551 val and 861,347
    test edges."""
    return synthetic_bipartite_graph_planted(
        users, items, edges_per_user, seed=0, power=1.0,
        coarse_clusters=16, fine_per_coarse=16, mix=(0.55, 0.25, 0.20))


def _config(backend: str, emb_dim: int, num_layers: int, batch_size: int,
            precision: str, propagation: str) -> RecConfig:
    return RecConfig(name="bench", propagation=propagation,
                     weight_mode=WEIGHT_MODES[propagation],
                     table_layout="split" if propagation != "symmetric"
                     else "joint",
                     emb_dim=emb_dim, num_layers=num_layers,
                     batch_size=batch_size, spmm_backend=backend,
                     spmm_precision=precision)


def _trainer(graph, cfg: RecConfig, seed: int, device) -> RecTrainer:
    cred = np.random.default_rng(seed).uniform(
        0.2, 1.0, graph.num_users).astype(np.float32)
    return RecTrainer(cfg, graph, cred=cred, device=device, verbose=False)


def make_epoch(graph, backend: str, emb_dim: int, num_layers: int,
               batch_size: int, seed: int = 0, precision: str = "fp32",
               propagation: str = "gauss_seidel", device="cuda"):
    """The trainer's epoch as ``fit`` runs it: ``draw_epoch`` (the epoch's
    samples), then ``run_epoch`` (the step plans, then every step).
    Returns ``(run_epoch, state, n_batches)``; ``run_epoch(state)`` returns
    ``(state, mean loss)`` and updates the state's parameters and moments in
    place."""
    cfg = _config(backend, emb_dim, num_layers, batch_size, precision,
                  propagation)
    tr = _trainer(graph, cfg, seed, device)
    state = tr.init_state(seed)
    nb = -(-tr.train_users.size // batch_size)

    def run_epoch(state):
        params, opt_state, gen = state
        losses = tr.run_epoch(params, opt_state, tr.draw_epoch(gen))
        return state, losses.mean()

    return run_epoch, state, nb


def time_epoch(run_epoch, state, iters: int, warmup: int = 2):
    """Seconds an epoch (fenced on the card) and the last epoch's loss."""
    last = []

    def one():
        _, loss = run_epoch(state)
        last[:] = [loss]
        return loss

    dt = time_fn(one, iters=iters, warmup=warmup)
    return dt, float(last[0])


def make_step(graph, backend: str, emb_dim: int, num_layers: int,
              batch_size: int, seed: int = 0, precision: str = "fp32",
              propagation: str = "gauss_seidel", device="cuda"):
    """One isolated train step: a fixed pool of ``batch_size`` train users,
    a uniform positive and a uniform negative each drawn in the step,
    ``RecTrainer.train_step`` (the step's plans, ``propagate_rows``, BPR +
    ego L2, the backward, Adam).  Returns ``(step, params, opt_state,
    cfg)``; ``step(params, opt_state, gen)`` returns them with the loss."""
    cfg = _config(backend, emb_dim, num_layers, batch_size, precision,
                  propagation)
    tr = _trainer(graph, cfg, seed, device)
    params, opt_state, _ = tr.init_state(seed)
    dev = tr.device
    users = torch.as_tensor(np.resize(tr.train_users, batch_size),
                            dtype=torch.int64, device=dev)
    mask = torch.ones(batch_size, dtype=torch.bool, device=dev)
    csr = tr.ctx.train_csr

    def step(params, opt_state, gen):
        pos = sample_positives(gen, csr, users)
        neg = sample_negatives_uniform(gen, csr, users, graph.num_items,
                                       rounds=cfg.neg_rounds)
        loss = tr.train_step(params, opt_state, users, pos, neg, mask)
        return params, opt_state, gen, loss

    return step, params, opt_state, cfg


def time_step(step, params, opt_state, iters: int, warmup: int = 3):
    """Seconds a step (fenced on the card) and the last step's loss."""
    gen = torch.Generator(device=next(iter(params.values())).device)
    gen.manual_seed(1)
    last = []

    def one():
        loss = step(params, opt_state, gen)[3]
        last[:] = [loss]
        return loss

    dt = time_fn(one, iters=iters, warmup=warmup)
    return dt, float(last[0])


def step_bound_s(graph, emb_dim: int, num_layers: int, itemsize: int,
                 propagation: str) -> float:
    """The least seconds a step's SpMM applications could take on the card:
    K layers of each direction forward and of its transpose backward, each
    application its referenced source rows, edge arrays (int32 id and fp32
    weight a nonzero), int64 row pointers and its output
    (``probes/_timing.csr_bound_ms``), at ``itemsize`` bytes a table
    element."""
    u, i = (np.asarray(a, np.int64) for a in graph.train_edges)
    U, I, D = graph.num_users, graph.num_items, emb_dim

    def one(src: np.ndarray, num_dst: int) -> float:
        rows = np.unique(src).size
        E = src.size
        return bound_ms(rows * D * itemsize + E * 8 + (num_dst + 1) * 8
                        + num_dst * D * itemsize, 2.0 * E * D)

    if propagation == "symmetric":
        joint = one(np.concatenate([u, i + U]), U + I)
        layer = 2 * joint
    else:
        # item<-user and user<-item forward; each is the other's transpose
        layer = 2 * (one(u, I) + one(i, U))
    return num_layers * layer / 1e3


def northstar_trainer(graph, device="cuda", **overrides) -> RecTrainer:
    """``RecTrainer`` of the ``scaled_10m`` preset as the JAX bench builds
    it (``epochs=2, seed=0``), with ``overrides``."""
    cfg = get_preset("scaled_10m", epochs=2, seed=0, **overrides)
    return RecTrainer(cfg, graph, device=device, verbose=False)


def bench_northstar(graph=None, iters: int = 3, device="cuda",
                    trainer=None) -> dict:
    """The 10M-edge north-star operating point: the ``scaled_10m`` preset
    (fp32 messages, "per_epoch" cached propagation, D=128, K=4, batch
    8,192) on the planted 10M-edge graph (``graph``, by default built here
    by :func:`northstar_graph`), or ``trainer``, a :func:`northstar_trainer`
    already built.  Returns the north-star line.

    Definitions (they differ from the headline's):
      * value = E * 2K / propagate_s: edge traversals a second of ONE
        K-layer bipartite propagation (forward only, as the per_epoch cache
        runs it under ``no_grad``: no backward SpMM at this point);
      * epoch_s: one training epoch as ``fit`` runs it (``draw_epoch``,
        then ``run_epoch``: the step plans, the cache's propagation, and
        ceil(train users / 8,192) steps), fenced on the card;
      * peak_memory_gb: ``torch.cuda.max_memory_allocated`` over the whole
        call (trainer, propagations and epochs), None on the CPU.
    Each loop runs one call first, untimed."""
    dev = trainer.device if trainer is not None else resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = None
    if trainer is None:
        if graph is None:
            t0 = time.perf_counter()
            graph = northstar_graph()
            log(f"[bench] northstar graph: {graph.summary()} "
                f"({time.perf_counter() - t0:.1f}s to build)")
        t0 = time.perf_counter()
        trainer = northstar_trainer(graph, dev)
        setup_s = time.perf_counter() - t0
    tr, cfg = trainer, trainer.cfg
    params, opt_state, gen = tr.init_state()

    with torch.no_grad():
        t_prop = time_fn(tr.model.propagate, params, iters=iters, warmup=1)
    t_epoch = time_fn(lambda: tr.run_epoch(params, opt_state,
                                           tr.draw_epoch(gen)),
                      iters=iters, warmup=1)
    peak = (torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else None)

    E = tr.graph.train_edges.shape[1]
    K = cfg.num_layers
    value = E * 2 * K / t_prop
    nb = -(-tr.train_users.size // cfg.batch_size)
    log(f"[bench] northstar scaled_10m ({cfg.spmm_precision} messages, "
        f"per_epoch) on {dev}: propagate {t_prop * 1e3:.3f} ms "
        f"({value / 1e6:.1f}M edges/s), epoch {t_epoch:.4f} s ({nb} steps)"
        f", peak memory {peak} GB")
    return {
        "metric": "northstar_propagation_edges_per_sec_per_chip",
        "value": value,
        "unit": "edges/s",
        "definition": "E*2K/propagate_s, one cached K-layer bipartite "
                      "propagation, scaled_10m preset as shipped "
                      f"(spmm_precision={cfg.spmm_precision}, D="
                      f"{cfg.emb_dim}, K={K}, E={E}); epoch_s: draw_epoch + "
                      f"run_epoch ({nb} steps and the per_epoch cache)",
        "propagate_s": t_prop,
        "epoch_s": t_epoch,
        "steps_per_epoch": nb,
        "iters": iters,
        "trainer_setup_s": setup_s,
        "peak_memory_gb": peak,
        "device": dev.type,
        "card": card_name(dev),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", default="ref", choices=["small", "ref", "large"])
    ap.add_argument("--backend", default="auto", choices=SPMM_BACKENDS)
    ap.add_argument("--baseline-backend", default="torch",
                    choices=SPMM_BACKENDS)
    ap.add_argument("--emb-dim", type=int, default=64)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--precision", default="bf16", choices=["fp32", "bf16"])
    ap.add_argument("--propagation", default="gauss_seidel",
                    choices=list(WEIGHT_MODES))
    ap.add_argument("--mode", default="epoch", choices=["epoch", "step"],
                    help="epoch: time the trainer's epoch as fit runs it "
                    "(amortized per step; the headline). step: one isolated "
                    "train step (its samples and plans included).")
    ap.add_argument("--no-northstar", action="store_true",
                    help="skip the 10M-edge scaled_10m operating-point "
                    "measurement (first JSON line; on the card with --scale "
                    "ref --mode epoch only)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                    "versions and times the host)")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))          # no fallback to the CPU
    on_card = dev.type == "cuda"
    card = card_name(dev)
    clock = "fenced on the card" if on_card else "host clock, cpu"
    log(f"[bench] device={dev} card={card}")

    graph = build_graph(args.scale)
    E = graph.train_edges.shape[1]
    log(f"[bench] graph: {graph.summary()}")
    # edge traversals per step: K layers x 2 directions x (fwd + bwd)
    edges_per_step = E * args.layers * 2 * 2
    kw = dict(propagation=args.propagation, device=dev)

    if args.mode == "epoch":
        run_epoch, state, nb = make_epoch(graph, args.backend, args.emb_dim,
                                          args.layers, args.batch,
                                          precision=args.precision, **kw)
        iters = max(1, args.iters // 4)
        edt, loss = time_epoch(run_epoch, state, iters)
        dt = edt / nb
        thr = Throughput(edges_per_step, steps=nb * iters, seconds=edt * iters)
        log(f"[bench] {args.backend}/{args.precision}: {edt * 1e3:.1f} ms/epoch "
            f"({nb} batches, {dt * 1e3:.3f} ms/step, {clock}) loss={loss:.4f}")
    else:
        step, params, opt_state, _ = make_step(graph, args.backend,
                                               args.emb_dim, args.layers,
                                               args.batch,
                                               precision=args.precision, **kw)
        dt, loss = time_step(step, params, opt_state, args.iters)
        thr = Throughput(edges_per_step, steps=args.iters,
                         seconds=dt * args.iters)
        log(f"[bench] {args.backend}/{args.precision}: {dt * 1e3:.3f} ms/step "
            f"({clock}) loss={loss:.4f}")
    log(f"[bench] {thr.summary()}")
    value = thr.edges_per_sec

    itemsize = 2 if args.precision == "bf16" else 4
    sol = step_bound_s(graph, args.emb_dim, args.layers, itemsize,
                       args.propagation)
    share = sol / dt if on_card else None
    n_apps = (2 if args.propagation == "symmetric" else 4) * args.layers
    log(f"[bench] bound: {sol * 1e3:.4f} ms a step ({n_apps} SpMM "
        f"applications at 3.35 TB/s or 67 TFLOP/s fp32, H100 SXM) -> "
        + (f"{100 * share:.1f}% of it on {card}" if on_card
           else "no share: not a device time (cpu)"))

    def bench_baseline(precision):
        if args.mode == "epoch":
            brun, bstate, bnb = make_epoch(graph, args.baseline_backend,
                                           args.emb_dim, args.layers,
                                           args.batch, precision=precision,
                                           **kw)
            bedt, bloss = time_epoch(brun, bstate, max(args.iters // 8, 2))
            return bedt / bnb, bloss
        bstep, bparams, bopt, _ = make_step(
            graph, args.baseline_backend, args.emb_dim, args.layers,
            args.batch, precision=precision, **kw)
        return time_step(bstep, bparams, bopt, max(args.iters // 2, 5))

    # vs_baseline against the baseline in fp32 (the reference's arithmetic;
    # the headline), vs_baseline_same_precision at --precision, so the
    # kernels' gain and bf16's are never conflated
    vs_baseline = 1.0
    vs_same = None
    if args.backend != args.baseline_backend:
        bdt, bloss = bench_baseline("fp32")
        log(f"[bench] {args.baseline_backend}/fp32: {bdt * 1e3:.3f} ms/step "
            f"loss={bloss:.4f}")
        vs_baseline = bdt / dt
        if args.precision != "fp32":
            sdt, sloss = bench_baseline(args.precision)
            log(f"[bench] {args.baseline_backend}/{args.precision}: "
                f"{sdt * 1e3:.3f} ms/step loss={sloss:.4f}")
            vs_same = sdt / dt

    out = {
        "metric": "train_edges_per_sec_per_chip",
        "value": value,
        "unit": "edges/s",
        "vs_baseline": vs_baseline,
    }
    if vs_same is not None:
        out["vs_baseline_same_precision"] = vs_same
    out.update({
        "definition": f"E*K*2*2/step_s, {args.mode} mode, "
                      f"{args.backend}/{args.precision}, D={args.emb_dim}, "
                      f"K={args.layers}, batch {args.batch}, E={E}; "
                      f"vs_baseline: {args.baseline_backend}/fp32 step_s "
                      "over this one",
        "edges_per_step": edges_per_step,
        "step_s": dt,
        "bound_step_s": sol,
        "share_of_bound": share,
        "device": dev.type,
        "card": card,
    })

    # the north star as a line BEFORE the headline (the last line); on the
    # card at the default scale only: the 10M planted graph is no CPU run
    if (not args.no_northstar and on_card and args.scale == "ref"
            and args.mode == "epoch"):
        try:
            print(json.dumps(bench_northstar(device=dev)), flush=True)
        except Exception:          # never sink the headline metric
            log("[bench] northstar measurement failed:\n"
                + traceback.format_exc())

    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
