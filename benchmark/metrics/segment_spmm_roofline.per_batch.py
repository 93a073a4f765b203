"""``segment_spmm_roofline``'s reading, in the per_batch training cell
(it moves ``train_samples_per_s.per_batch``)."""

from benchmark.registry import metric_reader

read = metric_reader("segment_spmm_roofline")
