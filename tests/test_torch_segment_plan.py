"""The PyTorch package's chunk planner against the JAX package's.

``ops/segment_plan.build_segment_plan`` must give arrays equal to JAX
``build_pallas_segment_plan`` (plain, forced windows, "auto", several chunk
sizes, the empty plan, the invalid-window error) and, for windows, to the
probe's loop planner ``build_window_plan`` (``scripts/probe_window_kernel.py``,
imported by path).  ``auto_window``, ``PadLayout`` and the bridge from a JAX
plan agree too.  Exact equality throughout: the planners are the same numpy.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.graph.build import synthetic_bipartite_graph_planted
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.ops import spmm as j_spmm
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.ops import spmm_pallas as j_pallas
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops import segment_plan as sp

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("src_padded", "w_padded", "local_ids", "block_id", "first_chunk",
          "win_start")


def _probe_window_module():
    spec = importlib.util.spec_from_file_location(
        "probe_window_kernel", ROOT / "scripts" / "probe_window_kernel.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def probe_window():
    return _probe_window_module()


@pytest.fixture(scope="module")
def graphs(small_graph):
    # a planted power-law graph: a few hub items own most edges, many blocks
    planted = synthetic_bipartite_graph_planted(
        num_users=1500, num_items=2600, edges_per_user=9.0, seed=3,
        power=1.1)
    return {"small": small_graph, "planted": planted}


def _direction(graph, name):
    """dst-sorted (src, dst, w, num_src, num_dst) of one direction."""
    u, i = np.asarray(graph.train_edges[0]), np.asarray(graph.train_edges[1])
    w = np.random.default_rng(0).random(u.size).astype(np.float32)
    src, dst, ns, nd = ((u, i, graph.num_users, graph.num_items)
                        if name == "items<-users" else
                        (i, u, graph.num_items, graph.num_users))
    order = np.argsort(dst, kind="stable")
    return (src[order].astype(np.int32), dst[order].astype(np.int64),
            w[order], ns, nd)


def _assert_same(port, jplan):
    got = port.arrays()
    for f in FIELDS:
        want = getattr(jplan, f)
        if want is None:
            assert got[f] is None, f
            continue
        want = np.asarray(want).reshape(-1)
        assert got[f].dtype == want.dtype, f
        assert np.array_equal(got[f], want), f
    for f in ("num_dst", "num_src", "num_blocks", "block_rows",
              "chunk_edges", "window"):
        assert getattr(port, f) == getattr(jplan, f), f


DIRS = ["items<-users", "users<-items"]


@pytest.mark.parametrize("graph", ["small", "planted"])
@pytest.mark.parametrize("direction", DIRS)
@pytest.mark.parametrize("T", [128, 256, 512])
@pytest.mark.parametrize("window", [0, 64, 128, 256, "auto"])
def test_plan_arrays_equal_jax(graphs, graph, direction, T, window):
    src, dst, w, ns, nd = _direction(graphs[graph], direction)
    kw = dict(num_src=ns, chunk_edges=T, window=window)
    port = sp.build_segment_plan(src, dst, w, nd, **kw)
    _assert_same(port, j_pallas.build_pallas_segment_plan(src, dst, w, nd,
                                                          **kw))
    assert port.src_padded.dtype == torch.int32
    assert port.padded_edges == port.num_chunks * T


@pytest.mark.parametrize("graph", ["small", "planted"])
@pytest.mark.parametrize("direction", DIRS)
@pytest.mark.parametrize("T", [128, 256, 512])
@pytest.mark.parametrize("W", [64, 128, 256])
def test_window_plan_equals_probe_loop_planner(graphs, probe_window, graph,
                                              direction, T, W):
    src, dst, w, ns, nd = _direction(graphs[graph], direction)
    port = sp.build_segment_plan(src, dst, w, nd, num_src=ns, chunk_edges=T,
                                 window=W).arrays()
    want = probe_window.build_window_plan(src, dst, w, nd, R=512, T=T, W=W)
    for f, k in (("src_padded", "src"), ("w_padded", "w"),
                 ("local_ids", "lid"), ("block_id", "block"),
                 ("first_chunk", "first"), ("win_start", "wstart")):
        assert np.array_equal(port[f], np.asarray(want[k]).reshape(-1)), f
    assert port["block_id"].size == want["G"]


@pytest.mark.parametrize("num_dst", [1, 7, 600])
def test_empty_plan_equals_jax(num_dst):
    z = np.zeros(0, np.int32)
    kw = dict(num_src=5, block_rows=32, chunk_edges=16)
    port = sp.build_segment_plan(z, z, np.zeros(0, np.float32), num_dst, **kw)
    _assert_same(port, j_pallas.build_pallas_segment_plan(
        z, z, np.zeros(0, np.float32), num_dst, **kw))
    assert port.window == 0 and bool((port.local_ids == 32).all())


@pytest.mark.parametrize("window", [4, 12, 32, 40, -8])
def test_invalid_window_raises_like_jax(window):
    src = np.array([0, 1, 2], np.int32)
    dst = np.array([0, 3, 9], np.int64)
    w = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="invalid"):
        j_pallas.build_pallas_segment_plan(src, dst, w, 10, block_rows=32,
                                           chunk_edges=8, window=window)
    with pytest.raises(ValueError, match="invalid"):
        sp.build_segment_plan(src, dst, w, 10, block_rows=32, chunk_edges=8,
                              window=window)


def test_unsorted_edges_raise():
    with pytest.raises(ValueError, match="sorted"):
        sp.build_segment_plan(np.array([0, 1], np.int32),
                              np.array([3, 1], np.int64),
                              np.ones(2, np.float32), 4)


@pytest.mark.parametrize("graph", ["small", "planted"])
@pytest.mark.parametrize("direction", DIRS)
@pytest.mark.parametrize("T", [128, 256, 512])
def test_auto_window_equals_jax(graphs, graph, direction, T):
    _, dst, _, _, nd = _direction(graphs[graph], direction)
    for R in (256, 512):
        assert sp.auto_window(dst, nd, dst.size, R, T) == \
            j_pallas.auto_window(dst, nd, dst.size, R, T)
    assert sp._plain_padded_edges(dst, -(-nd // 512), 512, T) == \
        j_pallas._plain_padded_edges(dst, -(-nd // 512), 512, T)


def test_auto_window_picks_a_window_for_dense_rows():
    """Dense destination rows (many edges each) take a window under "auto";
    the same decision as JAX, and not the trivial one."""
    rng = np.random.default_rng(5)
    dst = np.sort(rng.integers(0, 300, 12_000)).astype(np.int64)
    src = rng.integers(0, 50, dst.size).astype(np.int32)
    w = rng.random(dst.size).astype(np.float32)
    port = sp.build_segment_plan(src, dst, w, 300, window="auto")
    assert port.window == j_pallas.auto_window(dst, 300, dst.size) > 0
    _assert_same(port, j_pallas.build_pallas_segment_plan(src, dst, w, 300))


@pytest.mark.parametrize("rows,padded", [(5, 8), (8, 8), (0, 4)])
def test_pad_layout_matches_jax(rows, padded):
    x = np.random.default_rng(rows).normal(size=(rows, 3)).astype(np.float32)
    jl, tl = j_spmm.PadLayout(rows, padded), sp.PadLayout(rows, padded)
    p = tl.to_padded(torch.as_tensor(x))
    assert np.array_equal(p.numpy(), np.asarray(jl.to_padded(jnp.asarray(x))))
    assert np.array_equal(tl.from_padded(p).numpy(), x)
    assert tl.equals(sp.PadLayout(rows, padded))
    assert not tl.equals(sp.PadLayout(rows, padded + 8))
    assert not tl.equals(jl)


@pytest.mark.parametrize("window", [0, 64])
def test_plan_from_jax_equals_built_plan(graphs, window):
    src, dst, w, ns, nd = _direction(graphs["planted"], "users<-items")
    jplan = j_pallas.build_pallas_segment_plan(src, dst, w, nd, num_src=ns,
                                               window=window)
    port = sp.segment_plan_from_jax(jplan, "cpu")
    _assert_same(port, jplan)
    built = sp.build_segment_plan(src, dst, w, nd, num_src=ns, window=window)
    for f in FIELDS[:-1]:
        assert torch.equal(getattr(port, f), getattr(built, f)), f


def test_plan_from_jax_rejects_a_pad_before_a_real_edge(graphs):
    src, dst, w, ns, nd = _direction(graphs["small"], "items<-users")
    jplan = j_pallas.build_pallas_segment_plan(src, dst, w, nd, num_src=ns,
                                               block_rows=32, chunk_edges=16,
                                               window=0)
    lid = np.asarray(jplan.local_ids).reshape(-1).copy()
    lid[0] = 32                        # a pad at the head of chunk 0

    class Bad:
        pass
    bad = Bad()
    bad.__dict__.update({f: getattr(jplan, f) for f in FIELDS})
    bad.__dict__.update({f: getattr(jplan, f) for f in (
        "num_dst", "num_src", "num_blocks", "block_rows", "chunk_edges",
        "window")})
    bad.local_ids = lid
    with pytest.raises(ValueError, match="pad edge"):
        sp.segment_plan_from_jax(bad)


def test_int16_local_ids_are_converted_once_and_checked():
    src = np.array([0, 1, 2], np.int32)
    dst = np.array([0, 3, 9], np.int64)
    plan = sp.build_segment_plan(src, dst, np.ones(3, np.float32), 10,
                                 block_rows=32, chunk_edges=8, window=0)
    a = plan.local_ids_as(torch.int16)
    assert a.dtype == torch.int16 and a is plan.local_ids_as(torch.int16)
    assert torch.equal(a.int(), plan.local_ids)
    big = sp.build_segment_plan(src, dst, np.ones(3, np.float32), 10,
                                block_rows=40_000, chunk_edges=8, window=0)
    with pytest.raises(ValueError, match="32767"):
        big.local_ids_as(torch.int16)
