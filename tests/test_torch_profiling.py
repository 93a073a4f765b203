"""``utils/profiling.py`` against ``JAX: utils/profiling.py``.

``Throughput`` with set ``steps`` and ``seconds`` gives JAX's
``steps_per_sec``, ``edges_per_sec`` and ``summary()``; ``time_fn`` returns
a positive mean on the CPU (no device fence there); ``trace`` writes a
Chrome trace into its directory.
"""

import json

import pytest
import torch

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.utils.profiling import Throughput as JThroughput
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.utils import profiling


@pytest.mark.parametrize("steps,seconds,edges", [(0, 0.0, 10), (7, 2.5, 360_207),
                                                 (400, 12.375, 1)])
def test_throughput_matches_jax(steps, seconds, edges):
    got = profiling.Throughput(edges, steps=steps, seconds=seconds)
    want = JThroughput(edges, steps=steps, seconds=seconds)
    assert got.steps_per_sec == want.steps_per_sec
    assert got.edges_per_sec == want.edges_per_sec
    assert got.summary() == want.summary()


def test_throughput_start_stop_counts():
    t = profiling.Throughput(100)
    with pytest.raises(AssertionError, match="start"):
        t.stop()
    t.start()
    t.stop(steps=3)
    assert t.steps == 3 and t.seconds > 0.0
    assert t.edges_per_sec == pytest.approx(100 * t.steps_per_sec)


def test_time_fn_positive_on_cpu():
    x = torch.randn(64, 64)
    calls = []

    def fn(a):
        calls.append(1)
        return {"y": a @ a, "n": len(calls)}
    s = profiling.time_fn(fn, x, iters=4, warmup=2)
    assert s > 0.0 and len(calls) == 6


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tb")):
        torch.randn(32, 32) @ torch.randn(32, 32)
    files = list((tmp_path / "tb").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
