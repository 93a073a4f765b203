"""A timed evaluation's least time on an H100 SXM over its measured time,
in %: its propagation (``roofline.propagate_bound_ms``, bytes bind) and
each of its batches (the bf16 GEMM at 989 TFLOP/s, which binds, or the
bf16 tables' bytes at 3.35 TB/s: ``roofline.eval_batch_bound_ms``)."""

from benchmark import roofline


def read(run):
    cfg = run.cfg
    eval_s, batches = run.timed.get("eval_s"), run.counts.get("batches")
    if not eval_s or not batches:
        return None
    bound = (roofline.propagate_bound_ms(run.stats, cfg.emb_dim,
                                         cfg.num_layers)
             + batches * roofline.eval_batch_bound_ms(
                 cfg.eval_batch, run.items, cfg.emb_dim, max(cfg.Ks),
                 run.timed["exclusions_per_batch"]))
    return 100.0 * bound / 1e3 / eval_s
