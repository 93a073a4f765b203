"""Seconds to make or load the cell's graph (the benchmark's span)."""


def read(run):
    s = run.spans.seconds.get("setup.graph_s")
    return sum(s) if s else None
