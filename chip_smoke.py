#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py [--out results.json]

Phases (each prints one line; any failure exits non-zero):
  1. the card's name and power limit (nvidia-smi), and the kernel's build
     from ``csrc/segment_spmm.cu`` with nvcc for sm_90a;
  2. the kernel against its plain PyTorch version on the card: random
     edges, empty rows, duplicate edges, a zero-edge operator and a Zipf hub
     graph, at D in {8, 64, 128}, fp32 and bf16; two launches must be
     bit-identical;
  3. the serving slice at full width: the reference-scale graph
     (58,867 users, 261,728 items), the cu_message preset (D=64, K=3), the
     CLI's merge-user-ids, then evaluate --split test in sampled and full
     mode, then topk_for_users for 512 users at k=20; the kernel's launch
     counter must show 6 launches per propagate;
  4. the same parameters through the plain path (spmm_backend=torch) on the
     card: propagated tables, metrics and top-20 sets must agree;
  5. times (CUDA events) of each operator direction through the kernel, the
     plain version and torch.sparse.mm, one propagate, and one sampled and
     one full evaluate.

It imports nothing of the JAX package.  It needs one CUDA card and exits
non-zero without one.  The line before the last holds the kernels' JSON; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
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
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, published
FP32_FLOPS = 67e12            # H100 SXM fp32 outside the tensor cores
# fp32: |kernel - plain| <= FP32_ATOL + FP32_RTOL * sum_e |w_e * x_src(e)|,
# the summation error bound (the plain version on the card sums with atomics
# in another order, so a cancelling sum of O(1) terms can end near 0 with an
# absolute error of a few 1e-6)
FP32_RTOL, FP32_ATOL = 1e-5, 1e-6
BF16_ROW_TOL = 2e-2           # |kernel - plain| <= 2e-2 * max|plain row|


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
    """Least time for one application: each input read once (the source
    rows this operator references, src, w, indptr), y written once, over
    the HBM rate; 2*E*D flops over the fp32 rate; the larger of the two."""
    import torch
    rows = int(torch.unique(op.src).numel()) if op.src.numel() else 0
    nbytes = (rows * D * itemsize + op.src.numel() * 8
              + op.indptr.numel() * 8 + op.num_dst * D * itemsize)
    flops = 2.0 * op.src.numel() * D
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)


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


def phase_kernel_vs_plain(dev) -> dict:
    import torch
    from importlib import import_module
    spmm = import_module(f"{PKG}.ops.spmm")
    sc = import_module(f"{PKG}.ops.spmm_cuda")
    rng = np.random.default_rng(0)
    worst = {"fp32": 0.0, "bf16_rel": 0.0}
    hub = 0
    n = 0
    seq_equal = True
    for name, (src, dst, w, ns, nd) in _cases(rng).items():
        d = spmm.CsrDirection.from_edges(src, dst, w, ns, nd, dev)
        hub = max(hub, int((d.indptr[1:] - d.indptr[:-1]).max()))
        empty = (d.indptr[1:] == d.indptr[:-1])
        for D in (8, 64, 128):
            x32 = torch.randn(ns, D, device=dev, dtype=torch.float32)
            for dt in (torch.float32, torch.bfloat16):
                x = x32.to(dt)
                y1 = sc.KERNEL(d.indptr, d.src, d.w, x)
                y2 = sc.KERNEL(d.indptr, d.src, d.w, x)
                ref = sc.segment_spmm_reference(d.indptr, d.src, d.w, x)
                torch.cuda.synchronize()
                tag = f"{name} D={D} {dt}"
                if not torch.equal(y1, y2):
                    raise AssertionError(f"{tag}: two launches differ")
                if y1.dtype != dt or y1.shape != (nd, D):
                    raise AssertionError(f"{tag}: wrong output {y1.dtype} "
                                         f"{tuple(y1.shape)}")
                if bool((y1[empty] != 0).any()):
                    raise AssertionError(f"{tag}: empty row not zero")
                diff = (y1.float() - ref.float()).abs()
                if dt == torch.float32:
                    mag = sc.segment_spmm_reference(d.indptr, d.src,
                                                    d.w.abs(), x.abs())
                    bad = diff > FP32_ATOL + FP32_RTOL * mag
                    worst["fp32"] = max(worst["fp32"], float(diff.max())
                                        if diff.numel() else 0.0)
                    # the kernel sums each row in edge order, like the
                    # plain version's sequential CPU index_add_
                    seq = sc.segment_spmm_reference(
                        d.indptr.cpu(), d.src.cpu(), d.w.cpu(), x.cpu())
                    seq_equal &= torch.equal(y1.cpu(), seq)
                else:
                    row = ref.float().abs().amax(dim=1, keepdim=True)
                    bad = diff > BF16_ROW_TOL * row + FP32_ATOL
                    rel = diff / (row + 1e-30)
                    worst["bf16_rel"] = max(worst["bf16_rel"], float(
                        rel.max()) if rel.numel() else 0.0)
                if bool(bad.any()):
                    raise AssertionError(f"{tag}: kernel disagrees with the "
                                         f"plain version, max "
                                         f"{float(diff.max())}")
                n += 1
    log(f"[phase 2] kernel vs plain: {n} cases ok (5 graphs x D 8/64/128 x "
        f"fp32/bf16), bit-identical reruns, empty rows zero, hub row "
        f"{hub} edges; max fp32 abs err {worst['fp32']:.3g} (tol "
        f"{FP32_ATOL:g} + {FP32_RTOL:g}*sum|w*x|), max bf16 err/row-max "
        f"{worst['bf16_rel']:.3g} (tol {BF16_ROW_TOL:g}); fp32 bit-equal to "
        f"the sequential CPU sum: {seq_equal}")
    worst["bit_equal_sequential_cpu"] = seq_equal
    return worst


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
    graph = build.synthetic_bipartite_graph(58_867, 261_728, 7.9, seed=0,
                                            power=1.0)
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
              "--out", str(tmp / "cred.csv")])
    # every trainer below reads the same CSV as the CLI's evaluate
    cfg = cfg.replace(cred_csv_path=str(tmp / "cred.csv"))
    base = ["evaluate", "--graph", str(tmp / "graph.npz"),
            "--params", str(tmp / "best_model.npz"), "--preset", "cu_message",
            "--cred", str(tmp / "cred.csv"), "--split", "test"]

    # ---- phase 3: the main path, counted ----
    sc.KERNEL.launches = 0
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
    launches = sc.KERNEL.launches
    n_prop = 3
    if launches != 6 * n_prop:
        raise AssertionError(f"kernel launched {launches} times, expected "
                             f"6 per propagate x {n_prop}")
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
        f"launches {launches} = 6 x {n_prop} propagates; setup "
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
        csr = torch.sparse_csr_tensor(d.indptr, d.src.long(), d.w,
                                      size=(d.num_dst, d.num_src))
        deg = d.indptr[1:] - d.indptr[:-1]
        entry = {"role": role, "num_dst": d.num_dst, "num_src": d.num_src,
                 "edges": int(d.src.numel()), "max_dst_degree": int(deg.max()),
                 "empty_dst_rows": int((deg == 0).sum())}
        # plain, kernel, kernel, plain: compare within one call
        p1 = cuda_time_ms(lambda: sc.segment_spmm_reference(
            d.indptr, d.src, d.w, x32), 20)
        k1 = cuda_time_ms(lambda: sc.KERNEL(d.indptr, d.src, d.w, x32), 50)
        k2 = cuda_time_ms(lambda: sc.KERNEL(d.indptr, d.src, d.w, x32), 50)
        p2 = cuda_time_ms(lambda: sc.segment_spmm_reference(
            d.indptr, d.src, d.w, x32), 20)
        entry["ms"] = min(k1, k2)
        entry["plain_ms"] = min(p1, p2)
        entry["library_ms"] = cuda_time_ms(lambda: torch.sparse.mm(csr, x32),
                                           20)
        entry["bound_ms"] = bound_ms(d, x32.shape[1], 4)
        entry["bf16_ms"] = cuda_time_ms(
            lambda: sc.KERNEL(d.indptr, d.src, d.w, xb), 50)
        entry["bf16_plain_ms"] = cuda_time_ms(
            lambda: sc.segment_spmm_reference(d.indptr, d.src, d.w, xb), 20)
        entry["bf16_bound_ms"] = bound_ms(d, xb.shape[1], 2)
        per_dir.append(entry)
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
        f"{e['role']} kernel {e['ms']:.4f} plain {e['plain_ms']:.4f} "
        f"sparse.mm {e['library_ms']:.4f} bound {e['bound_ms']:.4f} | bf16 "
        f"kernel {e['bf16_ms']:.4f} plain {e['bf16_plain_ms']:.4f} bound "
        f"{e['bf16_bound_ms']:.4f}" for e in per_dir)
        + f"; propagate kernel {prop_ms:.3f} plain {prop_plain_ms:.3f}; "
        f"evaluate sampled {evals['sampled']:.1f} full {evals['full']:.1f}")
    return {"launches": launches, "directions": per_dir,
            "propagate_ms": prop_ms, "propagate_plain_ms": prop_plain_ms,
            "evaluate_ms": evals, "metrics_sampled": res_s,
            "metrics_full": res_f, "jaccard_mean": float(jac.mean())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every number to this JSON file")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from importlib import import_module
    sc = import_module(f"{PKG}.ops.spmm_cuda")
    if not sc.SOURCE.resolve().is_relative_to(root):
        raise RuntimeError(f"{PKG} was imported from {sc.SOURCE.parents[2]}, "
                           f"not from this checkout ({root})")
    dev = torch.device("cuda", 0)

    smi = nvidia_smi()
    t0 = time.perf_counter()
    lib = sc.KERNEL.build()
    regs = [ln.strip() for ln in sc.KERNEL.build_log.splitlines()
            if "registers" in ln]
    log(f"[phase 1] {smi}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; built {lib.name} in "
        f"{time.perf_counter() - t0:.1f}s ({len(regs)} instantiations, "
        f"{regs[0] if regs else 'no ptxas report'})")

    worst = phase_kernel_vs_plain(dev)
    with tempfile.TemporaryDirectory() as tmp:
        res = phase_slice(dev, Path(tmp))

    dirs = res["directions"]
    kernels = [{
        "name": "segment_spmm",
        "route": "cuda",
        "source": f"{PKG}/csrc/segment_spmm.cu",
        "replaces": REPLACES,
        "launches": res["launches"],
        "max_abs_err": worst["fp32"],
        # one Gauss-Seidel layer: one K1-role plus one K2-role application
        "ms": sum(e["ms"] for e in dirs),
        "plain_ms": sum(e["plain_ms"] for e in dirs),
        "bound_ms": sum(e["bound_ms"] for e in dirs),
        "bound_by": "bytes",
        "library_ms": sum(e["library_ms"] for e in dirs),
        "directions": dirs,
    }]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"nvidia_smi": smi, "torch": torch.__version__, "kernels": kernels,
             "phase2_worst": worst, **{k: v for k, v in res.items()
                                       if k != "directions"}},
            indent=1, default=float))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
