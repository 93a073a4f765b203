"""The traced window's share with nothing running on the card, in %."""


def read(run):
    return None if run.trace is None else run.trace.idle_pct()
