"""One gloo rank of the port's mesh tests (never imports jax).

    python tests/torch_mesh_worker.py SUITE RANK WORLD DIR

Joins a gloo process group of WORLD CPU processes through the file store
``DIR/store_<SUITE>_<WORLD>``, builds the (WORLD // 2, 2) mesh (model size
2; world 4 puts two model groups in two data replicas), reads
``DIR/inputs_<SUITE>.npz`` and ``DIR/graph.npz``, runs the SUITE's checks
("spmm" or "topk") and writes each result as
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
        cfg = presets.get_preset(preset).replace(emb_dim=32, num_layers=3)
        params = {k.removeprefix(f"{preset}_"): torch.as_tensor(v)
                  for k, v in inp.items() if k.startswith(f"{preset}_")}
        for mode in MODES:
            model = lg.LightGCN(cfg, graph, inp["cred"], device="cpu",
                                operator_factory=functools.partial(
                                    ssp.ShardedSpmmOperator, mesh=mesh,
                                    mode=mode))
            calls.update({"to": 0, "from": 0})
            u, i = model.propagate(params)
            save(f"prop_{preset}_{mode}_u", u)
            save(f"prop_{preset}_{mode}_i", i)
            save(f"prop_{preset}_{mode}_calls",
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

    {"spmm": suite_spmm, "topk": suite_topk}[suite](mesh, inp, save)
    torch.distributed.destroy_process_group()
    print("[mesh OK]", flush=True)


if __name__ == "__main__":
    main()
