"""Kernel launch calls a step: the runtime's launch calls that start
inside the port's ``rec.train.step`` spans of the traced epoch (the
autograd engine's thread's included), over the steps."""

from benchmark import spans
from benchmark.tracing import LAUNCH_CALLS

STEP = "rec.train.step"


def read(run):
    if run.trace is None:
        return None
    iv = spans.intervals(run.trace, STEP)
    return spans.per_span(spans.calls_in(run.trace, iv, LAUNCH_CALLS), iv)
