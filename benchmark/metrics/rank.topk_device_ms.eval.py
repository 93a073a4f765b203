"""Device milliseconds of the top-k a batch: the kernels launched inside
the port's ``rec.rank.topk`` spans of the traced window, whatever their
names, over the spans (a batch of an evaluation, a request served)."""

from benchmark import spans

TOPK = "rec.rank.topk"


def read(run):
    if run.trace is None:
        return None
    iv = spans.intervals(run.trace, TOPK)
    return spans.per_span(spans.device_us_launched_in(run.trace, iv), iv,
                          1e-3)
