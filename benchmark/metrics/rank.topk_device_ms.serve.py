"""``rank.topk_device_ms.eval``'s reading, in the serving cell: device
milliseconds of the top-k a request (it moves ``serve_p95_ms``)."""

from benchmark.registry import metric_reader

read = metric_reader("rank.topk_device_ms.eval")
