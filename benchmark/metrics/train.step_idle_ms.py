"""Milliseconds a step with nothing running on the card: the part of each
of the port's ``rec.train.step`` spans (one train step, forward, backward
and Adam) in the traced epoch that no device record covers, summed, over
the steps."""

from benchmark import spans

STEP = "rec.train.step"


def read(run):
    if run.trace is None:
        return None
    iv = spans.intervals(run.trace, STEP)
    return spans.per_span(spans.idle_us(run.trace, iv), iv, 1e-3)
