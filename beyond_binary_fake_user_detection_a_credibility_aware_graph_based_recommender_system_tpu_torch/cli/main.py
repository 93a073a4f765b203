"""Command-line interface of the PyTorch package.

    python -m beyond_binary_..._tpu_torch.cli build-graph --jsonl R.jsonl --out D/
    python -m ..._tpu_torch.cli train-cred --jsonl R.jsonl --out D/
                                           [--plots] [--checkpoint [--resume]]
                                           [--mesh N] [k=v ...]
    python -m ..._tpu_torch.cli merge-user-ids --npy cred.npy --graph D/graph.npz
                                               --out D/cred.csv
    python -m ..._tpu_torch.cli train-rec --graph D/graph.npz --preset cu_message
                                          [--cred D/cred.csv] [--out D/rec]
                                          [--checkpoint [--resume]]
                                          [--mesh N] [k=v ...]
    python -m ..._tpu_torch.cli evaluate --graph D/graph.npz --params best.npz
                                         --preset cu_message [--mesh N] [k=v ...]

Every command takes ``--device`` (default ``cuda``; ``cpu`` runs on the
CPU).  ``train-rec``, ``train-cred`` and ``evaluate`` take ``--mesh N``: they
then run on a (data, model) mesh of N processes, one a card (NCCL; gloo with
``--device cpu``): ``--mesh 1`` (or ``all`` without a launcher) in one
process, N > 1 under
``torchrun --nproc-per-node N -m ..._tpu_torch.cli train-rec --mesh N ...``.
Training shards the tables, Adam moments and batches (``train-rec``) or runs
Stage A's forward on the edge-sharded operators (``train-cred``); rank 0
alone prints and writes the outputs.
"""

from __future__ import annotations

import argparse
import contextlib
import json
from pathlib import Path


def _add_overrides(p):
    p.add_argument("overrides", nargs="*",
                   help="config overrides as key=value")


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")


@contextlib.contextmanager
def _meshed(args):
    """``(mesh, device, rank0)`` for the command's ``--mesh`` ('all' or a
    process count; no mesh without it): the (data, model) ``DeviceMesh``,
    this rank's device, and whether this is rank 0.  A process group this
    creates (a world of one) is destroyed on the way out."""
    import torch
    import torch.distributed as dist
    from ..parallel import distributed
    from ..parallel.mesh import make_mesh
    from ..utils.device import resolve_device

    if not args.mesh:
        yield None, args.device, True
        return
    world = distributed.launched_world_size()
    n = world if args.mesh == "all" else int(args.mesh)
    if n != world:
        if distributed.launched():
            raise ValueError(f"--mesh {n}, but the launcher started {world} "
                             "processes")
        raise RuntimeError(
            f"--mesh {n} needs {n} processes, one a device: launch with "
            f"torchrun --nproc-per-node {n} -m {__package__} {args.cmd} "
            f"--mesh {n} ...")
    dev = resolve_device(distributed.rank_device(args.device))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    owned = not dist.is_initialized()
    distributed.initialize(device=dev)
    try:
        mesh = make_mesh(n, device_type=dev.type)
        rank0 = dist.get_rank() == 0
        if rank0:
            print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
        yield mesh, dev, rank0
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def cmd_build_graph(args):
    from ..data.ingest import ingest_jsonl
    from ..graph.build import build_bipartite_graph
    from ..utils.config import IngestConfig
    from ..utils.device import resolve_device

    resolve_device(args.device)
    cfg = IngestConfig(jsonl_path=args.jsonl).with_overrides(args.overrides)
    table = ingest_jsonl(args.jsonl, cfg)
    graph = build_bipartite_graph(table)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    graph.save_npz(out / "graph.npz")
    print(f"Saved graph to {out/'graph.npz'}")
    print(graph.summary())


def cmd_train_cred(args):
    """Stage A: ingest, labels, features and the heterograph (written as
    OUT/user_labels.csv, user_features.csv, graph_hetero.npz), then train
    the credibility model and export its scores and parameters; returns
    the ``CredFitResult``."""
    from ..data.features import (compute_user_features, save_features_csv,
                                 save_labels_csv)
    from ..data.ingest import ingest_jsonl
    from ..graph.hetero import build_heterograph
    from ..train.checkpoint import TrainCheckpointer
    from ..train.cred_trainer import CredTrainer
    from ..utils.config import CredConfig, IngestConfig
    from ..utils.device import resolve_device

    ccfg = CredConfig().with_overrides(args.overrides)
    with _meshed(args) as (mesh, device, rank0):
        device = resolve_device(device)
        table = ingest_jsonl(args.jsonl, IngestConfig(jsonl_path=args.jsonl),
                             collect_token_hashes=(ccfg.feature_set == "v1"))
        feats = compute_user_features(table, ccfg)
        hg = build_heterograph(table, feats,
                               graph_feature_set=ccfg.graph_feature_set)
        out = Path(args.out)
        if rank0:
            out.mkdir(parents=True, exist_ok=True)
            # reference intermediate artifacts (main.py steps 1/3)
            save_labels_csv(out / "user_labels.csv", table, feats.labels)
            save_features_csv(out / "user_features.csv", table, feats)
            hg.save_npz(out / "graph_hetero.npz")
            if args.plots:
                from ..eval.report import plot_feature_distributions
                plot_feature_distributions(feats, out / "plots")
        trainer = CredTrainer(hg, ccfg, device=device, mesh=mesh)
        ck = TrainCheckpointer(out / "cred_ckpt", keep=args.ckpt_keep,
                               every=args.ckpt_every) if args.checkpoint \
            else None
        result = trainer.fit(checkpointer=ck, resume=args.resume)
        if rank0:
            trainer.export(result, out)
    return result


def cmd_merge_user_ids(args):
    import numpy as np
    from ..data.cred_io import save_credibility_csv
    from ..graph.build import BipartiteGraph
    from ..utils.device import resolve_device

    resolve_device(args.device)
    graph = BipartiteGraph.load_npz(args.graph)
    cred = np.load(args.npy)
    save_credibility_csv(args.out, cred, graph.user_ids)
    print(f"Saved {args.out} ({len(cred)} users)")


def cmd_train_rec(args):
    """Trains, writes OUT/best_model.npz, OUT/test_metrics.json and (from
    ``fit``) OUT/metrics.jsonl; returns the ``FitResult``."""
    from ..configs.presets import get_preset
    from ..graph.build import BipartiteGraph
    from ..train.checkpoint import TrainCheckpointer, save_params_npz
    from ..train.trainer import RecTrainer

    cfg = get_preset(args.preset).with_overrides(args.overrides)
    if args.cred:
        cfg = cfg.replace(cred_csv_path=args.cred)
    if args.out:
        cfg = cfg.replace(out_dir=args.out)
    with _meshed(args) as (mesh, device, rank0):
        graph = BipartiteGraph.load_npz(args.graph)
        if rank0:
            print(f"Loaded edges. {graph.summary()}")
        trainer = RecTrainer(cfg, graph, device=device, mesh=mesh)
        ck = TrainCheckpointer(Path(args.out) / "ckpt",
                               keep=args.ckpt_keep, every=args.ckpt_every) if (
            args.out and args.checkpoint) else None
        result = trainer.fit(checkpointer=ck, resume=args.resume)
    if args.out and rank0:
        save_params_npz(Path(args.out) / "best_model.npz", result.best_params)
        with open(Path(args.out) / "test_metrics.json", "w") as f:
            json.dump({str(k): v for k, v in result.test_metrics.items()}, f,
                      indent=2, default=float)
    return result


def cmd_evaluate(args):
    """Prints the metric block and a JSON line (under a mesh: rank 0 only);
    returns the metrics (every rank the same)."""
    from ..configs.presets import get_preset
    from ..graph.build import BipartiteGraph
    from ..train.checkpoint import load_params_npz
    from ..train.trainer import RecTrainer, format_metrics_block

    cfg = get_preset(args.preset).with_overrides(args.overrides)
    if args.cred:
        cfg = cfg.replace(cred_csv_path=args.cred)
    with _meshed(args) as (mesh, device, rank0):
        graph = BipartiteGraph.load_npz(args.graph)
        trainer = RecTrainer(cfg, graph, device=device, mesh=mesh)
        params = load_params_npz(args.params, device=trainer.device)
        res = trainer.evaluate(params, args.split)
    if rank0:
        print(format_metrics_block(args.split.upper(), res))
        print(json.dumps({str(k): v for k, v in res.items()}, default=float))
    return res


def build_parser():
    ap = argparse.ArgumentParser(prog="bb-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("build-graph", help="JSONL -> bipartite graph npz")
    p.add_argument("--jsonl", required=True)
    p.add_argument("--out", required=True)
    _add_device(p)
    _add_overrides(p)
    p.set_defaults(fn=cmd_build_graph)

    p = sub.add_parser("train-cred", help="Stage A: train credibility model")
    p.add_argument("--jsonl", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--plots", action="store_true",
                   help="write fake-vs-genuine feature distribution PNGs "
                        "(needs matplotlib)")
    p.add_argument("--checkpoint", action="store_true",
                   help="full-state checkpoints under OUT/cred_ckpt")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest OUT/cred_ckpt state")
    p.add_argument("--mesh", default=None,
                   help="train on a (data, model) mesh of N processes "
                        "('all': the launcher's world); N > 1 under "
                        "torchrun --nproc-per-node N")
    p.add_argument("--ckpt-keep", type=int, default=3)
    p.add_argument("--ckpt-every", type=int, default=1)
    _add_device(p)
    _add_overrides(p)
    p.set_defaults(fn=cmd_train_cred)

    p = sub.add_parser("merge-user-ids",
                       help="join a credibility .npy with a graph's id map "
                            "into the CSV contract (merge_user_id.py)")
    p.add_argument("--npy", required=True)
    p.add_argument("--graph", required=True)
    p.add_argument("--out", required=True)
    _add_device(p)
    p.set_defaults(fn=cmd_merge_user_ids)

    p = sub.add_parser("train-rec", help="Stage B: train a LightGCN variant")
    p.add_argument("--graph", required=True)
    p.add_argument("--preset", default="vanilla")
    p.add_argument("--cred", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--checkpoint", action="store_true",
                   help="full-state checkpoints under OUT/ckpt")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest OUT/ckpt state")
    p.add_argument("--mesh", default=None,
                   help="train on a (data, model) mesh of N processes "
                        "('all': the launcher's world); N > 1 under "
                        "torchrun --nproc-per-node N")
    p.add_argument("--ckpt-keep", type=int, default=3)
    p.add_argument("--ckpt-every", type=int, default=1)
    _add_device(p)
    _add_overrides(p)
    p.set_defaults(fn=cmd_train_rec)

    p = sub.add_parser("evaluate", help="evaluate saved params")
    p.add_argument("--graph", required=True)
    p.add_argument("--params", required=True)
    p.add_argument("--preset", default="vanilla")
    p.add_argument("--cred", default=None)
    p.add_argument("--split", default="test")
    p.add_argument("--mesh", default=None,
                   help="serve on a (data, model) mesh of N processes "
                        "('all': the launcher's world); N > 1 under "
                        "torchrun --nproc-per-node N")
    _add_device(p)
    _add_overrides(p)
    p.set_defaults(fn=cmd_evaluate)
    return ap


def run(argv=None):
    """Run one command; returns what the command returns (``evaluate``:
    its metrics dict; ``train-rec``: its ``FitResult``; ``train-cred``:
    its ``CredFitResult``)."""
    args = build_parser().parse_args(argv)
    return args.fn(args)


def main(argv=None) -> None:
    """Console entry point: returns None, so ``sys.exit(main())`` exits 0."""
    run(argv)


if __name__ == "__main__":
    main()
