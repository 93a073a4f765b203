"""Host waits for the card a batch: stream, device and event synchronise
calls that start inside the port's ``rec.eval.batch`` spans of the traced
evaluation, over the batches."""

from benchmark import spans

BATCH = "rec.eval.batch"


def read(run):
    if run.trace is None:
        return None
    iv = spans.intervals(run.trace, BATCH)
    return spans.per_span(spans.calls_in(run.trace, iv, spans.SYNC_CALLS),
                          iv)
