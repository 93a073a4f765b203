"""Device milliseconds a step of the model and its loss: every device
record of the traced epoch's steps (``run_epoch``, after its draws are
fenced) but the segment-sum and fused Adam kernels, which have metrics of
their own.  That is the model's combine passes and gathers, the BPR and L2
terms and their backward, whichever kernels run them."""

from benchmark.tracing import RUN_EPOCH

OTHER_LAYERS = ("rows_kernel", "long_rows_kernel", "fused_adam_multi_kernel")


def read(run):
    if run.trace is None or not run.counts.get("steps"):
        return None
    s = run.trace.device_s_since(RUN_EPOCH, OTHER_LAYERS)
    return 1e3 * s / run.counts["steps"] if s > 0 else None
