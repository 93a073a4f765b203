"""The fused Adam kernel's least time (28 bytes an element of both tables
at 3.35 TB/s, H100 SXM) over its device time in the traced epoch, in %."""

from benchmark import roofline


def read(run):
    tr, cfg = run.trace, run.cfg
    if tr is None or not run.counts.get("steps"):
        return None
    steps = run.counts["steps"]
    if tr.counters.get("fused_adam") != steps:
        return None
    dev = tr.kernel_s(("fused_adam_multi_kernel",))
    bound = roofline.adam_bound_ms((run.users + run.items) * cfg.emb_dim)
    return 100.0 * steps * bound / 1e3 / dev if dev > 0 else None
