"""The whole step's share of the H100's peaks: the least time of a step's
work (its segment-sum applications, the per_epoch propagation's share and
Adam; bytes bind every one of them) over the measured time a step of the
traced run's timed epochs, in %."""

from benchmark import roofline


def read(run):
    cfg = run.cfg
    step_s = run.timed.get("step_s")
    steps = run.counts.get("steps")
    if not step_s or not steps:
        return None
    spmm = roofline.train_epoch_spmm_ms(
        run.stats, cfg.emb_dim, cfg.num_layers, cfg.batch_size, steps,
        cfg.propagation_schedule)["ms"]
    adam = roofline.adam_bound_ms((run.users + run.items) * cfg.emb_dim)
    return 100.0 * (spmm / steps + adam) / 1e3 / step_s
