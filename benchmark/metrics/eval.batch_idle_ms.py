"""Milliseconds a batch with nothing running on the card: the part of each
of the port's ``rec.eval.batch`` spans (a batch's ids, exclusion rows,
score, mask, top-k, metrics and accumulation) in the traced evaluation that
no device record covers, summed, over the batches."""

from benchmark import spans

BATCH = "rec.eval.batch"


def read(run):
    if run.trace is None:
        return None
    iv = spans.intervals(run.trace, BATCH)
    return spans.per_span(spans.idle_us(run.trace, iv), iv, 1e-3)
