"""The traced epoch's segment-sum applications (the propagation, its
transposes backward, the gathers' backward) at their least time on an H100
SXM (``roofline.train_epoch_spmm_ms``), over their device time, in %.
Nothing is read when the port's counters do not match the applications the
arithmetic counts."""

from benchmark import roofline

KERNELS = ("rows_kernel", "long_rows_kernel")


def read(run):
    tr, cfg = run.trace, run.cfg
    if tr is None or not run.counts.get("steps"):
        return None
    want = roofline.train_epoch_spmm_ms(
        run.stats, cfg.emb_dim, cfg.num_layers, cfg.batch_size,
        run.counts["steps"], cfg.propagation_schedule)
    if (tr.counters.get("spmm"), tr.counters.get("gather_backward")) \
            != (want["spmm"], want["gather_backward"]):
        return None
    dev = tr.kernel_s(KERNELS)
    return 100.0 * want["ms"] / 1e3 / dev if dev > 0 else None
