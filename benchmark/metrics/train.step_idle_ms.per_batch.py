"""``train.step_idle_ms``'s reading, in the per_batch training cell (it
moves ``train_samples_per_s.per_batch``)."""

from benchmark.registry import metric_reader

read = metric_reader("train.step_idle_ms")
