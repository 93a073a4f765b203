"""The port's spans (``utils/profiling.span``) on the CPU, and on the card.

With no profiler running a span is one shared no-op object.  Under
``torch.profiler`` every span is a host record that is not a user
annotation (the profiler mirrors user annotations onto the card's
timeline), and the spans nest as the layers do: a train step holds one
forward, one backward and one Adam; an evaluation batch its exclusion rows,
score, mask, top-k and metrics; a request its score, mask and top-k.
Losses, parameters, metrics and top-k lists are bit-identical with and
without a profiler running.  The ``cuda`` test holds a traced window on the
card to no device record named like a span.
"""

import contextlib
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.configs.presets import get_preset
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.eval import retrieval
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.graph.build import synthetic_bipartite_graph
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.train.trainer import RecTrainer
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.utils import profiling

SCHEDULES = ("per_epoch", "per_batch")
STEP_PARTS = ("rec.train.forward", "rec.train.backward", "rec.train.adam")
BATCH_PARTS = ("rec.rank.exclusions", "rec.rank.score", "rec.rank.mask",
               "rec.rank.topk", "rec.eval.metrics")
REQUEST_PARTS = ("rec.rank.score", "rec.rank.mask", "rec.rank.topk")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graph():
    return synthetic_bipartite_graph(num_users=120, num_items=90,
                                     edges_per_user=12.0, seed=7, power=0.8)


def _trainer(graph, schedule="per_epoch", device="cpu"):
    cfg = get_preset("cu_message").replace(
        batch_size=32, eval_batch=32, Ks=(5, 10), eval_mode="full",
        propagation_schedule=schedule)
    return RecTrainer(cfg, graph, device=device, verbose=False)


def _spans(prof):
    """``(name, start, end)`` of the window's span records, by start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith("rec.")),
                  key=lambda r: (r[1], -r[2]))


def _holder(rec, recs):
    """The innermost other span that holds ``rec``, or None."""
    holders = [r for r in recs if r is not rec and r[1] <= rec[1]
               and rec[2] <= r[2]]
    return min(holders, key=lambda r: r[2] - r[1]) if holders else None


def _parent(rec, recs):
    p = _holder(rec, recs)
    return p[0] if p else None


def _children(recs, name):
    """For each span ``name``, the names of the spans directly inside it."""
    kids = {id(r): Counter() for r in recs if r[0] == name}
    for r in recs:
        p = _holder(r, recs)
        if p is not None and id(p) in kids:
            kids[id(p)][r[0]] += 1
    return list(kids.values())


def _request(tr, graph, users, k=5):
    user_emb, item_emb = tr.model.propagate(tr.init_state(0)[0])
    excl = torch.as_tensor(retrieval.exclusion_rows_for_users(graph, users),
                           device=tr.device)
    return retrieval.topk_for_users(user_emb, item_emb,
                                    torch.as_tensor(users, device=tr.device),
                                    k, exclude_batch_rows=excl)


def test_span_without_a_profiler_is_one_shared_no_op():
    a, b = profiling.span("rec.train.step"), profiling.span("any.name")
    assert a is b
    with a:
        with b:
            pass
    assert profiling.span("rec.rank.topk") is a


def test_spans_are_host_records_apart_from_user_annotations():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.span("rec.train.step") is not \
            profiling.span("rec.train.step")
        with profiling.span("rec.train.step"):
            with profiling.span("rec.train.forward"):
                torch.ones(4).sum()
        with torch.profiler.record_function("rec.user"):
            pass
    by = {e.name: e for e in prof.events()}
    assert not by["rec.train.step"].is_user_annotation
    assert not by["rec.train.forward"].is_user_annotation
    assert by["rec.user"].is_user_annotation
    recs = _spans(prof)
    assert _parent(next(r for r in recs if r[0] == "rec.train.forward"),
                   recs) == "rec.train.step"
    assert profiling.span("rec.train.step") is profiling.span("x")


def test_every_span_name_is_listed():
    assert len(set(profiling.SPANS)) == len(profiling.SPANS)
    assert all(n.startswith(profiling.SPAN_PREFIX) for n in profiling.SPANS)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_run_epoch_has_one_step_span_a_step(graph, schedule):
    tr = _trainer(graph, schedule)
    params, opt, gen = tr.init_state(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        batches = tr.draw_epoch(gen)
        tr.run_epoch(params, opt, batches)
    recs = _spans(prof)
    names = Counter(r[0] for r in recs)
    steps = batches[0].shape[0]
    assert steps >= 3
    assert names["rec.train.step"] == steps
    assert names["rec.train.plans"] == 1
    assert names["rec.train.epoch_cache"] == (schedule == "per_epoch")
    assert set(names) <= set(profiling.SPANS)
    for kids in _children(recs, "rec.train.step"):
        assert kids == Counter(STEP_PARTS)
    assert _children(recs, "rec.train.draw") == [
        Counter(("rec.train.sample_positives", "rec.train.sample_negatives"))]
    for r in recs:
        if r[0] in ("rec.train.draw", "rec.train.plans",
                    "rec.train.epoch_cache", "rec.train.step"):
            assert _parent(r, recs) is None


def test_evaluate_has_one_batch_span_a_batch(graph):
    tr = _trainer(graph)
    params = tr.init_state(0)[0]
    users = tr.ctx.users_of("test").size
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = tr.evaluate(params, "test")
    recs = _spans(prof)
    names = Counter(r[0] for r in recs)
    assert res[10]["users_eval"] == users
    assert names["rec.eval.batch"] == -(-users // 32) >= 3
    assert names["rec.eval.propagate"] == names["rec.eval.finalize"] == 1
    for kids in _children(recs, "rec.eval.batch"):
        assert kids == Counter(BATCH_PARTS)
    for r in recs:
        if r[0] in ("rec.eval.propagate", "rec.eval.batch",
                    "rec.eval.finalize"):
            assert _parent(r, recs) is None


def test_topk_for_users_has_one_request_span(graph):
    tr = _trainer(graph)
    users = np.arange(7)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _request(tr, graph, users)
    recs = _spans(prof)
    names = Counter(r[0] for r in recs)
    assert names["rec.rank.topk_for_users"] == 1
    assert names["rec.rank.exclusions"] == 1
    assert _children(recs, "rec.rank.topk_for_users") == [
        Counter(REQUEST_PARTS)]


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_results_are_bit_identical_under_a_profiler(graph, schedule):
    def run(profiled):
        tr = _trainer(graph, schedule)
        params, opt, gen = tr.init_state(3)
        ctx = (profile(activities=[ProfilerActivity.CPU]) if profiled
               else contextlib.nullcontext())
        with ctx:
            losses = tr.run_epoch(params, opt, tr.draw_epoch(gen))
            res = tr.evaluate(params, "test")
            top = _request(tr, graph, np.arange(9))
        return losses, params, res, top

    plain, traced = run(False), run(True)
    assert torch.equal(plain[0], traced[0])
    for k in plain[1]:
        assert torch.equal(plain[1][k], traced[1][k])
    assert plain[2] == traced[2]
    assert torch.equal(plain[3][0], traced[3][0])
    assert torch.equal(plain[3][1], traced[3][1])


@pytest.mark.cuda
def test_no_device_record_carries_a_span_name(graph):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    tr = _trainer(graph, device="cuda")
    params, opt, gen = tr.init_state(0)
    batches = tr.draw_epoch(gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.run_epoch(params, opt, tr.draw_epoch(gen))
        tr.evaluate(params, "test")
        _request(tr, graph, np.arange(9))
        torch.cuda.synchronize()
    device = [e.name for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    host = Counter(e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CPU)
    assert device, "the profiler kept no device record"
    assert not [n for n in device if n.startswith(profiling.SPAN_PREFIX)]
    assert host["rec.train.step"] == batches[0].shape[0]
    assert host["rec.rank.topk"] >= 2
