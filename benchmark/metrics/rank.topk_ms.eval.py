"""Device milliseconds of the top-k kernels (``torch.topk``'s selection
and sort) a batch of the traced evaluation."""

FRAGMENTS = ("topk", "TopK", "KthValues", "KthCounts", "WithinKCounts",
             "bitonicSort", "sortKeyValue")


def read(run):
    if run.trace is None or not run.counts.get("batches"):
        return None
    s = run.trace.device_s(FRAGMENTS)
    return 1e3 * s / run.counts["batches"] if s > 0 else None
