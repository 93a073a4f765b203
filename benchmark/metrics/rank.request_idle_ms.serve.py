"""Milliseconds a request with nothing running on the card while the port
ranks it: the part of its ``rec.rank.exclusions`` and
``rec.rank.topk_for_users`` spans that no device record covers, summed
over the traced requests, over the requests."""

from benchmark import spans

REQUEST = "rec.rank.topk_for_users"
PARTS = ("rec.rank.exclusions", REQUEST)


def read(run):
    if run.trace is None:
        return None
    iv = [i for name in PARTS for i in spans.intervals(run.trace, name)]
    return spans.per_span(spans.idle_us(run.trace, iv),
                          spans.intervals(run.trace, REQUEST), 1e-3)
