"""The benchmark of the PyTorch and CUDA port.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) and prints one JSON line: ``python -m benchmark.run
--workload <cell> --seed <n> --seconds <s> --trace <0|1>``.  Everything
that decides a number lives here: the frozen graph generators, the drivers
of each kind of traffic, the plain references, the roofline arithmetic,
the window and the readers of the per-layer metrics, each found by name
(``registry.py``).  From the port the benchmark takes only the system under
test, its launch counters and its kernel names.
"""
