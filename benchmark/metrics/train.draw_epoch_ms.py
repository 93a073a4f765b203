"""Milliseconds of an epoch's draws (``RecTrainer.draw_epoch``), fenced on
the card, the mean over the traced run's timed epochs."""


def read(run):
    s = run.spans.seconds.get("train.draw_epoch")
    return 1e3 * sum(s) / len(s) if s else None
