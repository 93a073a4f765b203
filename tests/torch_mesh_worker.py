"""One gloo rank of the port's mesh tests (never imports jax).

    python tests/torch_mesh_worker.py SUITE RANK WORLD DIR

Joins a gloo process group of WORLD CPU processes through the file store
``DIR/store_<SUITE>_<WORLD>``, builds the (WORLD // 2, 2) mesh (model size
2; world 4 puts two model groups in two data replicas), reads
``DIR/inputs_<SUITE>.npz`` and ``DIR/graph.npz``, runs the SUITE's checks
("spmm", "topk", "train" or "cred") and writes each result as
``DIR/w<WORLD>_<name>_r<RANK>.npy`` (metrics as ``.json``) for the test to
compare.  Prints ``[mesh OK]`` last.  The tests start the ranks with
:func:`spawn_ranks`.
"""

import functools
import json
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
PKG = ("beyond_binary_fake_user_detection_a_credibility_aware_graph_based_"
       "recommender_system_tpu_torch")
MODES = ("halo", "allgather")


def _imp(name):
    import importlib
    return importlib.import_module(f"{PKG}.{name}")


def edge_maps(inp):
    """The random map with a hub row and small_graph's item<-user
    cu_message map, by name."""
    EdgeMap = _imp("graph.operators").EdgeMap
    return {name: EdgeMap(src=inp[f"{name}_src"], dst=inp[f"{name}_dst"],
                          w=inp[f"{name}_w"],
                          num_src=int(inp[f"{name}_num_src"]),
                          num_dst=int(inp[f"{name}_num_dst"]))
            for name in ("hub", "ifu")}


def suite_spmm(mesh, inp, save):
    ssp = _imp("parallel.sharded_spmm")
    lg = _imp("models.lightgcn")
    presets = _imp("configs.presets")
    build = _imp("graph.build")
    for name, em in edge_maps(inp).items():
        x = torch.as_tensor(inp[f"{name}_x"])
        g = torch.as_tensor(inp[f"{name}_g"])
        for mode in MODES:
            op = ssp.ShardedSpmmOperator(em, mesh, mode=mode)
            save(f"apply_{name}_{mode}", op(x))
            xr = x.clone().requires_grad_()
            (op(xr) * g).sum().backward()
            save(f"grad_{name}_{mode}", xr.grad)
            # bf16 messages (weights rounded to bf16, fp32 sums)
            op = ssp.ShardedSpmmOperator(em, mesh, mode=mode,
                                         precision="bf16")
            save(f"apply_{name}_{mode}_bf16",
                 op(x.to(torch.bfloat16)).float())

    # the span layout's round trip and its dual gathers' gradients
    x = torch.as_tensor(inp["span_x"])
    layout = ssp.SpanLayout(ssp.balanced_spans(inp["span_w"], 2), mesh)
    p = layout.to_padded(x)
    save("span_back", layout.from_padded(p))
    xr = x.clone().requires_grad_()
    (layout.to_padded(xr) ** 2).sum().backward()       # sharded output
    save("span_grad_x", xr.grad)
    pr = p.detach().clone().requires_grad_()
    (layout.from_padded(pr) ** 2).sum().backward()     # replicated output
    save("span_grad_p", pr.grad)
    save("span_p", p)

    # LightGCN.propagate on the padded chain, conversions counted
    graph = build.BipartiteGraph.load_npz(Path(sys.argv[4]) / "graph.npz")
    calls = {"to": 0, "from": 0}
    to_p, from_p = ssp.SpanLayout.to_padded, ssp.SpanLayout.from_padded

    def count(kind, fn):
        def wrapped(self, t):
            calls[kind] += 1
            return fn(self, t)
        return wrapped
    ssp.SpanLayout.to_padded = count("to", to_p)
    ssp.SpanLayout.from_padded = count("from", from_p)
    for preset in ("cu_message", "vanilla"):
        params = {k.removeprefix(f"{preset}_"): torch.as_tensor(v)
                  for k, v in inp.items() if k.startswith(f"{preset}_")}
        for mode in MODES:
            for prec in ("fp32", "bf16"):
                cfg = presets.get_preset(preset).replace(
                    emb_dim=32, num_layers=3, spmm_precision=prec)
                model = lg.LightGCN(cfg, graph, inp["cred"], device="cpu",
                                    operator_factory=functools.partial(
                                        ssp.ShardedSpmmOperator, mesh=mesh,
                                        mode=mode, precision=prec))
                calls.update({"to": 0, "from": 0})
                u, i = model.propagate(params)
                tag = f"{preset}_{mode}" + ("_bf16" if prec == "bf16" else "")
                save(f"prop_{tag}_u", u)
                save(f"prop_{tag}_i", i)
                save(f"prop_{tag}_calls",
                     torch.tensor([calls["to"], calls["from"]]))


def suite_topk(mesh, inp, save):
    stk = _imp("parallel.sharded_topk")
    ranking = _imp("eval.ranking")
    build = _imp("graph.build")
    u, items = torch.as_tensor(inp["u"]), torch.as_tensor(inp["items"])
    excl = torch.as_tensor(inp["excl"])
    st = stk.ShardedTopK(mesh, items.shape[0])
    ip = st.pad_items(items)
    k = int(inp["k"])
    for tag, kw in (("exact", {}), ("excl", {"exclude": excl}),
                    ("approx", {"exclude": excl, "method": "approx"}),
                    ("bf16", {"exclude": excl, "score_dtype": "bf16"})):
        v, ids = st.topk(u, ip, k, **kw)
        save(f"topk_{tag}_v", v)
        save(f"topk_{tag}_ids", ids)
    small = torch.as_tensor(inp["pad_items"])
    st9 = stk.ShardedTopK(mesh, small.shape[0])
    _, ids = st9.topk(u[:, :small.shape[1]], st9.pad_items(small), 5)
    save("topk_pad_ids", ids)

    graph = build.BipartiteGraph.load_npz(Path(sys.argv[4]) / "graph.npz")
    ctx = ranking.EvalContext.build(graph, "cpu")
    ue, ie = torch.as_tensor(inp["ue"]), torch.as_tensor(inp["ie"])
    for tag, kw in (("exact", {}),
                    ("fast", {"topk": "approx", "score_dtype": "bf16"})):
        res = ranking.evaluate_full(ue, ie, ctx, "test", mesh=mesh,
                                    extended=True, **kw)
        save(f"eval_{tag}", res)


def _fit_out(res) -> dict:
    """A fit's losses, test metrics and best tables, for :func:`save`."""
    return {"losses": torch.tensor([h.loss for h in res.history],
                                   dtype=torch.float64),
            "metrics": res.test_metrics, **res.best_params}


def _data_columns(x, mesh):
    """This data replica's columns of a (..., B) batch."""
    mesh_mod = _imp("parallel.mesh")
    d = mesh_mod.data_axis(mesh)
    n = x.shape[-1] // d.size
    return x[..., d.coord * n:(d.coord + 1) * n]


def suite_train(mesh, inp, save):
    """The sharded train step against its oracle, padded tables, fits
    (popmix + fairness; per_epoch; resumed from a checkpoint; under
    ``spmm_backend="chunked"``), ``propagate_rows`` on span layouts, and at world 2 a fit on the (2, 1)
    mesh after the (1, 2) one (two meshes in one process)."""
    import torch.distributed as dist
    build = _imp("graph.build")
    config = _imp("utils.config")
    lg = _imp("models.lightgcn")
    ssp = _imp("parallel.sharded_spmm")
    sharding = _imp("parallel.sharding")
    mesh_mod = _imp("parallel.mesh")
    trainer = _imp("train.trainer")
    ckpt = _imp("train.checkpoint")
    adam = _imp("ops.adam")
    graph = build.BipartiteGraph.load_npz(Path(sys.argv[4]) / "graph.npz")
    world = dist.get_world_size()
    cred = inp["cred"]

    # one step of make_sharded_train_step against its unsharded oracle
    cfg = config.RecConfig(propagation="gauss_seidel",
                           weight_mode="cu_message", table_layout="split",
                           emb_dim=16, num_layers=2)
    model = lg.LightGCN(cfg, graph, device="cpu",
                        operator_factory=functools.partial(
                            ssp.ShardedSpmmOperator, mesh=mesh))
    step, shard_state, oracle = sharding.make_sharded_train_step(
        model, mesh, 1e-3)
    params = {k: torch.as_tensor(inp[f"step_{k}"])
              for k in ("user_emb", "item_emb")}
    batch = [torch.as_tensor(inp[f"step_{k}"]) for k in ("users", "pos",
                                                         "neg")]
    blocks, opt, p_shard, o_shard = shard_state(params)
    assert p_shard == {"user_emb": "model", "item_emb": "model"}, p_shard
    save("step_loss", step(blocks, opt, *(_data_columns(b, mesh)
                                          for b in batch)))
    for k, v in sharding.gather_params(
            blocks, mesh_mod.model_axis(mesh),
            sharding.table_rows(model)).items():
        save(f"step_{k}", v)
    full = {k: v.clone() for k, v in params.items()}
    save("oracle_loss", oracle(full, adam.adam_init(full), *batch))
    for k, v in full.items():
        save(f"oracle_{k}", v)

    # tables whose rows do not split: padded, row-sharded, pad moments 0
    odd = build.synthetic_bipartite_graph(467, 1003, 8.0, seed=11)
    tr = trainer.RecTrainer(
        cfg.replace(batch_size=64, eval_mode="full", seed=5), odd,
        device="cpu", mesh=mesh, verbose=False)
    blocks, opt, gen = tr.init_state()
    for k, v in blocks.items():
        save(f"pad_block_{k}", torch.tensor(v.shape))
    tr.run_epoch(blocks, opt, tr.draw_epoch(gen))
    for name, tree in (("p", blocks), ("m", opt.m), ("v", opt.v)):
        for k, v in tr._trim(tree, keep_pad=True).items():
            save(f"pad_{name}_{k}", v)
    for k, v in tr._trim(blocks).items():
        save(f"pad_trim_{k}", torch.tensor(v.shape))

    # fits; the same samples as the one-device fit
    e2e = config.RecConfig(
        name="mesh_e2e", propagation="gauss_seidel", weight_mode="cu_message",
        table_layout="split", negative_sampler="popmix", lambda_fair=0.1,
        emb_dim=16, num_layers=2, batch_size=64, epochs=4, eval_every=2,
        eval_mode="full", seed=3)
    per_epoch = e2e.replace(name="mesh_per_epoch", lambda_fair=0.0,
                            propagation_schedule="per_epoch", seed=4)
    for tag, c in (("e2e", e2e), ("per_epoch", per_epoch)):
        res = trainer.RecTrainer(c, graph, cred=cred, device="cpu", mesh=mesh,
                                 verbose=False).fit()
        for k, v in _fit_out(res).items():
            save(f"fit_{tag}_{k}", v)
    # resumed from a checkpoint written by rank 0
    ck_dir = Path(sys.argv[4]) / f"ck_w{world}"
    trainer.RecTrainer(e2e, graph, cred=cred, device="cpu", mesh=mesh,
                       verbose=False).fit(
        epochs=2, checkpointer=ckpt.TrainCheckpointer(ck_dir))
    res = trainer.RecTrainer(e2e, graph, cred=cred, device="cpu", mesh=mesh,
                             verbose=False).fit(
        checkpointer=ckpt.TrainCheckpointer(ck_dir), resume=True)
    for k, v in _fit_out(res).items():
        save(f"fit_resumed_{k}", v)

    # "chunked" on a mesh: the sharded operators keep the CSR kernel, their
    # local sums through segment_spmm as SHARDED_KERNEL (the JAX package's
    # sharded operator ignores the backend); no chunk plan runs
    spmm_cuda, op_mod = _imp("ops.spmm_cuda"), _imp("ops.spmm")
    tr = trainer.RecTrainer(e2e.replace(spmm_backend="chunked"), graph,
                            cred=cred, device="cpu", mesh=mesh, verbose=False)
    ops = (tr.model.item_from_user, tr.model.user_from_item)
    save("chunked_csr", torch.tensor([all(
        isinstance(o, ssp.ShardedSpmmOperator) and o.backend == "auto"
        for o in ops)]))
    calls, chunked = [], []
    real_csr, real_chunk = ssp.segment_spmm, op_mod.chunk_spmm_blocks
    ssp.segment_spmm = lambda *a, **k: (calls.append(k.get("kernel")),
                                        real_csr(*a, **k))[1]
    op_mod.chunk_spmm_blocks = lambda *a, **k: (chunked.append(1),
                                                real_chunk(*a, **k))[1]
    try:
        res = tr.fit(epochs=2)
    finally:
        ssp.segment_spmm, op_mod.chunk_spmm_blocks = real_csr, real_chunk
    save("chunked_calls", torch.tensor([
        len(calls), all(c is spmm_cuda.SHARDED_KERNEL for c in calls),
        len(chunked)]))
    for k, v in _fit_out(res).items():
        save(f"fit_chunked_{k}", v)

    # propagate_rows on span layouts against rows of the full propagate
    users = torch.as_tensor(inp["rows_users"])
    items = torch.as_tensor(inp["rows_items"])
    for preset in ("cu_message", "vanilla"):
        c = _imp("configs.presets").get_preset(preset).replace(
            emb_dim=16, num_layers=2)
        m = lg.LightGCN(c, graph, cred, device="cpu",
                        operator_factory=functools.partial(
                            ssp.ShardedSpmmOperator, mesh=mesh))
        assert m._padded_chain() is not None
        p = lg.init_params(torch.Generator().manual_seed(1), c,
                           graph.num_users, graph.num_items)
        u, i = m.propagate(p)
        ru, ri = m.propagate_rows(p, users, items)
        save(f"rows_{preset}", torch.cat([ru, ri]))
        save(f"rows_{preset}_full", torch.cat([u[users], i[items]]))

    if world == 2:
        # a second mesh over the same ranks: two data replicas of one rank
        # each; its evaluations rank through its own model groups
        mesh21 = mesh_mod.make_mesh(2, shape=(2, 1), device_type="cpu")
        res = trainer.RecTrainer(e2e, graph, cred=cred, device="cpu",
                                 mesh=mesh21, verbose=False).fit()
        for k, v in _fit_out(res).items():
            save(f"fit_mesh21_{k}", v)
        tr = trainer.RecTrainer(e2e, graph, cred=cred, device="cpu",
                                mesh=mesh, verbose=False)
        save("eval_mesh12_again", tr.evaluate(res.best_params, "test"))


def suite_cred(mesh, inp, save):
    """Stage A on the mesh's edge-sharded operators: the full-graph forward
    in every view, and one injected full-graph epoch."""
    hetero = _imp("graph.hetero")
    config = _imp("utils.config")
    cm = _imp("models.cred_model")
    ssp = _imp("parallel.sharded_spmm")
    cred_trainer = _imp("train.cred_trainer")
    adam = _imp("ops.adam")
    hg = hetero.synthetic_heterograph(num_users=96, num_items=64,
                                      num_edges=800, seed=1)
    cfg = config.CredConfig(hidden_dim=16, trainer_mode="full_graph",
                            batch_size=32)
    params = {k.removeprefix("cred_"): torch.as_tensor(v)
              for k, v in inp.items() if k.startswith("cred_")}
    model = cm.CredModel(hg, cfg, "cpu", operator_factory=functools.partial(
        ssp.ShardedSpmmOperator, mesh=mesh))
    with torch.no_grad():
        for view in (None, "early", "late"):
            for name, t in zip(("cred", "h_u2", "h_i1"),
                               model.forward(params, view)):
                save(f"fwd_{view}_{name}", t)
    tr = cred_trainer.CredTrainer(hg, cfg, device="cpu", mesh=mesh,
                                  verbose=False)
    leaves = {k: v.clone() for k, v in params.items()}
    losses = tr.run_epoch(leaves, adam.adam_init(leaves), None,
                          order=inp["order"])
    save("epoch_losses", losses)
    for k, v in leaves.items():
        save(f"epoch_{k}", v)


def spawn_ranks(suite: str, world: int, out: Path,
                timeout: float = 120.0) -> list:
    """Run WORLD ranks of SUITE at once and return their outputs; a rank
    that fails or outlives ``timeout`` seconds (a collective that hangs)
    fails the caller, and every rank is killed on the way out."""
    import os
    import subprocess
    import time
    # one thread a rank: the ranks share the test worker's cores
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, suite, str(r), str(world), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=env) for r in range(world)]
    outs = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            left = max(deadline - time.monotonic(), 1.0)
            outs.append(p.communicate(timeout=left)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or "[mesh OK]" not in o:
            raise AssertionError(f"{suite} rank {r} of {world} failed "
                                 f"(rc {p.returncode}):\n{o[-4000:]}")
    return outs


def main():
    sys.path.insert(0, str(REPO))
    sys.modules["jax"] = None          # the port must not need it
    suite, rank, world, out = (sys.argv[1], int(sys.argv[2]),
                               int(sys.argv[3]), Path(sys.argv[4]))
    distributed = _imp("parallel.distributed")
    mesh_mod = _imp("parallel.mesh")
    distributed.initialize(init_method=f"file://{out}/store_{suite}_{world}",
                           world_size=world, rank=rank, device="cpu",
                           timeout=timedelta(seconds=60))
    mesh = mesh_mod.make_mesh(world, shape=(world // 2, 2), device_type="cpu")
    inp = dict(np.load(out / f"inputs_{suite}.npz"))

    def save(name, value):
        path = out / f"w{world}_{name}_r{rank}"
        if isinstance(value, dict):
            path.with_suffix(".json").write_text(json.dumps(
                {str(k): v for k, v in value.items()}, default=float))
        else:
            np.save(path.with_suffix(".npy"), value.detach().numpy())

    {"spmm": suite_spmm, "topk": suite_topk, "train": suite_train,
     "cred": suite_cred}[suite](mesh, inp, save)
    torch.distributed.destroy_process_group()
    print("[mesh OK]", flush=True)


if __name__ == "__main__":
    main()
