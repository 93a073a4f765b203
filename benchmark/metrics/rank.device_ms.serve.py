"""Device milliseconds a request: every device record of the traced
requests over their count."""


def read(run):
    if run.trace is None or not run.counts.get("requests"):
        return None
    s = run.trace.device_s()
    return 1e3 * s / run.counts["requests"] if s > 0 else None
