"""Seconds of ``RecTrainer(...)``: the model's operators on the card, the
evaluation context, the samplers (the benchmark's span)."""


def read(run):
    s = run.spans.seconds.get("setup.trainer_s")
    return sum(s) if s else None
