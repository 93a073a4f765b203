"""``train.launches_per_step``'s reading, in the per_batch training cell
(it moves ``train_samples_per_s.per_batch``)."""

from benchmark.registry import metric_reader

read = metric_reader("train.launches_per_step")
