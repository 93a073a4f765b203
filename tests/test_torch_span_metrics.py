"""The benchmark's readers of the port's spans, on synthetic traces.

Each reader (``benchmark/metrics/<name>.py``) takes the spans from a traced
window's host records by name and attributes the window's other records to
them by time alone: idle time inside spans that overlap busy intervals,
launch and synchronise calls (a trace's records carry no thread, so a call
from the autograd engine's thread counts by when it starts), and device
time paired with launch calls in order.  A window without the spans (a
program that has none), a lost kernel record or no complete window reads
nothing.
"""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import registry, spans
from benchmark.tracing import Trace

REPO = Path(__file__).resolve().parents[1]
NEW = ("train.step_idle_ms", "train.launches_per_step",
       "train.step_idle_ms.per_batch", "train.launches_per_step.per_batch",
       "rank.topk_device_ms.eval", "eval.batch_idle_ms",
       "eval.syncs_per_batch", "rank.topk_device_ms.serve",
       "rank.request_idle_ms.serve", "rank.syncs_per_request.serve")
KERNEL = "void at::native::some_kernel<float>(int)"


def read(name, trace):
    return registry.metric_reader(name)(SimpleNamespace(trace=trace))


def _trace(host, device, launches=0):
    return Trace(device=device, host=host, window=(0.0, 1000.0),
                 launches=launches)


def test_step_idle_is_the_uncovered_part_of_each_step():
    host = [("rec.train.step", 0.0, 100.0), ("rec.train.step", 200.0, 300.0),
            ("rec.train.forward", 0.0, 50.0), ("bench.run_epoch", 0.0, 900.0)]
    device = [(KERNEL, 10.0, 40.0), (KERNEL, 30.0, 60.0),
              ("Memcpy DtoD (Device -> Device)", 90.0, 210.0),
              (KERNEL, 400.0, 500.0)]
    tr = _trace(host, device)
    # step 1: 100 - [10, 60] - [90, 100] = 40; step 2: 100 - [200, 210] = 90
    for name in ("train.step_idle_ms", "train.step_idle_ms.per_batch"):
        assert read(name, tr) == pytest.approx(1e-3 * (40 + 90) / 2)


def test_launches_and_syncs_count_by_when_they_start():
    host = [("rec.train.step", 0.0, 100.0), ("rec.train.step", 200.0, 300.0),
            ("cudaLaunchKernel", 5.0, 7.0),           # main thread
            ("cudaLaunchKernel", 60.0, 62.0),         # the engine's thread
            ("cuLaunchKernelEx", 99.0, 103.0),        # ends after the step
            ("cudaLaunchKernel", 150.0, 152.0),       # between steps
            ("cudaLaunchKernel", 195.0, 205.0),       # starts before step 2
            ("cudaLaunchKernelExC", 250.0, 251.0),
            ("cudaMemcpyAsync", 20.0, 30.0)]
    tr = _trace(host, [], launches=6)
    for name in ("train.launches_per_step",
                 "train.launches_per_step.per_batch"):
        assert read(name, tr) == pytest.approx(4 / 2)


def test_eval_batch_idle_and_syncs():
    host = [("rec.eval.batch", 0.0, 100.0), ("rec.eval.batch", 100.0, 180.0),
            ("rec.rank.exclusions", 2.0, 30.0),
            ("cudaStreamSynchronize", 40.0, 45.0),
            ("cudaEventSynchronize", 120.0, 121.0),
            ("cudaDeviceSynchronize", 130.0, 131.0),
            ("cudaStreamSynchronize", 190.0, 191.0)]
    device = [(KERNEL, 30.0, 110.0), (KERNEL, 150.0, 400.0)]
    tr = _trace(host, device)
    # [0, 30] and [110, 150] idle
    assert read("eval.batch_idle_ms", tr) == pytest.approx(1e-3 * 70 / 2)
    assert read("eval.syncs_per_batch", tr) == pytest.approx(3 / 2)


def test_topk_device_time_pairs_launches_with_kernels_in_order():
    host = [("rec.eval.batch", 0.0, 100.0), ("rec.rank.topk", 10.0, 20.0),
            ("rec.eval.batch", 100.0, 200.0), ("rec.rank.topk", 110.0, 120.0),
            ("cudaLaunchKernel", 5.0, 6.0),
            ("cudaLaunchKernel", 12.0, 13.0),
            ("cudaLaunchKernel", 14.0, 15.0),
            ("cudaLaunchKernel", 30.0, 31.0),
            ("cuLaunchKernel", 115.0, 116.0)]
    # in start order: the launch at 5 runs 6-8, those at 12 and 14 run 21-31
    # and 31-36 (named otherwise than torch.topk's), the one at 30 runs 40-60
    device = [("gemm", 6.0, 8.0), ("Memset (Device)", 9.0, 10.0),
              ("my_topk_pass_one", 21.0, 31.0),
              ("my_topk_pass_two", 31.0, 36.0), ("other", 40.0, 60.0),
              ("my_topk_pass_one", 130.0, 134.0)]
    tr = _trace(host, device, launches=5)
    for name in ("rank.topk_device_ms.eval", "rank.topk_device_ms.serve"):
        assert read(name, tr) == pytest.approx(1e-3 * (10 + 5 + 4) / 2)
    lost = _trace(host, device[:-1], launches=5)
    assert read("rank.topk_device_ms.eval", lost) is None


def test_serve_request_idle_and_syncs():
    host = [("bench.request", 0.0, 60.0),
            ("rec.rank.exclusions", 0.0, 10.0),
            ("rec.rank.topk_for_users", 12.0, 40.0),
            ("rec.rank.score", 12.0, 15.0), ("rec.rank.topk", 30.0, 40.0),
            ("cudaStreamSynchronize", 5.0, 6.0),    # no card work in it
            ("cudaStreamSynchronize", 11.0, 12.0),  # between the two spans
            ("cudaStreamSynchronize", 25.0, 29.0),
            ("bench.request", 100.0, 160.0),
            ("rec.rank.exclusions", 100.0, 104.0),
            ("rec.rank.topk_for_users", 104.0, 150.0)]
    device = [(KERNEL, 20.0, 30.0), (KERNEL, 38.0, 50.0),
              (KERNEL, 100.0, 150.0)]
    tr = _trace(host, device)
    # request 1: [0, 10] + [12, 20] + [30, 38] = 26; request 2: 0
    assert read("rank.request_idle_ms.serve", tr) == pytest.approx(
        1e-3 * 26 / 2)
    assert read("rank.syncs_per_request.serve", tr) == pytest.approx(2 / 2)


@pytest.mark.parametrize("name", NEW)
def test_a_window_without_the_spans_reads_nothing(name):
    host = [("bench.run_epoch", 0.0, 100.0), ("cudaLaunchKernel", 1.0, 2.0),
            ("cudaStreamSynchronize", 3.0, 4.0)]
    assert read(name, _trace(host, [(KERNEL, 5.0, 9.0)], launches=1)) \
        is None
    assert read(name, None) is None


@pytest.mark.parametrize("seed", range(4))
def test_idle_matches_a_count_on_a_grid(seed):
    rng = np.random.default_rng(seed)

    def ivs(n, width):
        s = rng.integers(0, 400, n)
        return [(float(a), float(a + b))
                for a, b in zip(s, rng.integers(1, width, n))]

    steps, busy = ivs(6, 60), ivs(12, 40)
    tr = _trace([], [(KERNEL, s, e) for s, e in busy])
    grid = np.arange(0, 500) + 0.5
    inside = np.zeros(grid.size, bool)
    covered = np.zeros(grid.size, bool)
    for s, e in steps:
        inside |= (grid > s) & (grid < e)
    for s, e in busy:
        covered |= (grid > s) & (grid < e)
    assert spans.idle_us(tr, steps) == pytest.approx(
        float((inside & ~covered).sum()))


def test_the_new_metrics_are_in_the_spec():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    by = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW:
        m = by[name]
        assert m["source"] == "device_trace" and m["better"] == "lower"
        assert (REPO / "benchmark" / "metrics" / f"{name}.py").exists()
        for w in m["workloads"]:
            cell = registry.find_cell(w, REPO)
            assert m["moves"] in {e["name"] for e in cell.end_to_end}
    assert {m["name"] for m in spec["per_layer"][-len(NEW):]} == set(NEW)
