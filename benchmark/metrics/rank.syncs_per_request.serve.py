"""Host waits for the card a request while the port ranks it: synchronise
calls that start inside its ``rec.rank.exclusions`` and
``rec.rank.topk_for_users`` spans, over the traced requests."""

from benchmark import spans

REQUEST = "rec.rank.topk_for_users"
PARTS = ("rec.rank.exclusions", REQUEST)


def read(run):
    if run.trace is None:
        return None
    iv = [i for name in PARTS for i in spans.intervals(run.trace, name)]
    return spans.per_span(spans.calls_in(run.trace, iv, spans.SYNC_CALLS),
                          spans.intervals(run.trace, REQUEST))
