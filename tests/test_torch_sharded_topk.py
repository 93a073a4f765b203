"""The port's sharded top-k and ``evaluate_full(mesh=)`` on gloo ranks.

Worlds 2 (mesh (1, 2)) and 4 (mesh (2, 2)) run once each as spawned CPU
processes (``tests/torch_mesh_worker.py``, suite "topk", 120 s limit).
Mirrors ``tests/test_sharded_topk.py``: the top-k against a dense top-k
(ids as sets: ties may order differently), exclusion, pad rows never
returned, ``method="approx"`` ranking exactly (the port's recorded
divergence), ``score_dtype="bf16"`` against the JAX product the TPU
kept (bf16 tables, fp32 accumulation: the port's deliberate divergence
from JAX's mesh path on a CPU, which rounds each score to bf16) and
against JAX's ``ShardedTopK`` within that rounding; and ``evaluate_full(mesh=)`` within 1e-6 of the port on one
device and of JAX (on one device and on a (1, 2) mesh).  Every rank
returns the same.
"""

import json
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_mesh_worker import spawn_ranks

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.eval.ranking import EvalContext as JEvalContext
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.eval.ranking import evaluate_full as j_evaluate_full
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.parallel.mesh import make_mesh as j_make_mesh
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.parallel.sharded_topk import ShardedTopK as JShardedTopK
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.eval.ranking import EvalContext, evaluate_full

WORLDS = (2, 4)
METRICS = ("precision", "recall", "ndcg", "item_coverage",
           "avg_log_popularity", "avg_self_information")


@pytest.fixture(scope="module")
def case(small_graph, tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_topk")
    rng = np.random.default_rng(11)
    B, I, D = 16, 103, 8
    inp = {"u": rng.normal(size=(B, D)).astype(np.float32),
           "items": rng.normal(size=(I, D)).astype(np.float32),
           "excl": rng.integers(0, I, (B, 6)).astype(np.int32),
           "k": np.int64(7),
           "pad_items": rng.normal(size=(9, 4)).astype(np.float32),
           "ue": rng.normal(size=(small_graph.num_users, 16))
           .astype(np.float32),
           "ie": rng.normal(size=(small_graph.num_items, 16))
           .astype(np.float32)}
    small_graph.save_npz(out / "graph.npz")
    np.savez(out / "inputs_topk.npz", **inp)
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        list(pool.map(lambda w: spawn_ranks("topk", w, out), WORLDS))

    def load(world, name, rank=0):
        path = out / f"w{world}_{name}_r{rank}"
        if name.startswith("eval_"):
            res = json.loads(path.with_suffix(".json").read_text())
            return {int(k): v for k, v in res.items()}
        return np.load(path.with_suffix(".npy"))
    return {"inp": inp, "load": load}


def _dense(inp, exclude):
    s = inp["u"] @ inp["items"].T
    if exclude:
        for b, row in enumerate(inp["excl"]):
            s[b, row] = -np.inf
    return s


@pytest.mark.parametrize("exclude", (False, True), ids=("all", "excl"))
@pytest.mark.parametrize("world", WORLDS)
def test_topk_matches_dense(case, world, exclude):
    inp, k = case["inp"], int(case["inp"]["k"])
    tag = "excl" if exclude else "exact"
    v, ids = (case["load"](world, f"topk_{tag}_{t}") for t in ("v", "ids"))
    dense = _dense(inp, exclude)
    for b in range(dense.shape[0]):
        order = np.argsort(-dense[b], kind="stable")[:k]
        np.testing.assert_allclose(v[b], dense[b][order], rtol=1e-5,
                                   atol=1e-6)
        assert set(ids[b].tolist()) == set(order.tolist())
        if exclude:
            assert not set(ids[b].tolist()) & set(inp["excl"][b].tolist())


@pytest.mark.parametrize("world", WORLDS)
def test_approx_ranks_exactly(case, world):
    """``method="approx"`` is the exact top-k on the mesh too."""
    ld = case["load"]
    assert np.array_equal(ld(world, "topk_approx_v"), ld(world, "topk_excl_v"))
    for a, b in zip(ld(world, "topk_approx_ids"), ld(world, "topk_excl_ids")):
        assert set(a.tolist()) == set(b.tolist())


@pytest.mark.parametrize("world", WORLDS)
def test_pad_rows_never_returned(case, world):
    ids = case["load"](world, "topk_pad_ids")
    assert ids.shape == (16, 5) and ids.max() < 9 and ids.min() >= 0


@pytest.mark.parametrize("world", WORLDS)
def test_bf16_scores_match_jax(case, world):
    """The bf16 top-k against the top-k of JAX's bf16 product with fp32
    accumulation (``preferred_element_type=jnp.float32``: the TPU's
    scores), values within rtol / atol 1e-6 (summation order only), ids as
    sets; JAX's sharded bf16 values are those rounded to bf16."""
    inp, k = case["inp"], int(case["inp"]["k"])
    s = np.array(jnp.dot(jnp.asarray(inp["u"]).astype(jnp.bfloat16),
                         jnp.asarray(inp["items"]).astype(jnp.bfloat16).T,
                         preferred_element_type=jnp.float32))
    for b, row in enumerate(inp["excl"]):
        s[b, row] = -np.inf
    want = np.argsort(-s, axis=1, kind="stable")[:, :k]
    st = JShardedTopK(j_make_mesh(2, shape=(1, 2)), inp["items"].shape[0])
    jv, _ = st.topk(jnp.asarray(inp["u"]),
                    st.pad_items(jnp.asarray(inp["items"])), k,
                    exclude=jnp.asarray(inp["excl"]), score_dtype="bf16")
    v, ids = (case["load"](world, f"topk_bf16_{t}") for t in ("v", "ids"))
    assert v.dtype == np.float32
    np.testing.assert_allclose(v, np.take_along_axis(s, want, 1), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(jv, np.float32), v, rtol=2.0 ** -8)
    exact = case["load"](world, "topk_excl_ids")
    jac = []
    for b in range(v.shape[0]):
        assert set(ids[b].tolist()) == set(want[b].tolist())
        assert not set(ids[b].tolist()) & set(inp["excl"][b].tolist())
        s, e = set(ids[b].tolist()), set(exact[b].tolist())
        jac.append(len(s & e) / len(s | e))
    assert np.mean(jac) >= 0.9


@pytest.fixture(scope="module")
def references(case, small_graph):
    inp = case["inp"]
    ue, ie = inp["ue"], inp["ie"]
    t_ctx = EvalContext.build(small_graph, "cpu")
    j_ctx = JEvalContext.build(small_graph)
    jmesh = j_make_mesh(2, shape=(1, 2))
    return {
        "port": evaluate_full(torch.as_tensor(ue), torch.as_tensor(ie), t_ctx,
                              "test", extended=True),
        "jax": j_evaluate_full(jnp.asarray(ue), jnp.asarray(ie), j_ctx,
                               "test", extended=True),
        "jax_mesh": j_evaluate_full(jnp.asarray(ue), jnp.asarray(ie), j_ctx,
                                    "test", extended=True, mesh=jmesh),
        "jax_mesh_fast": j_evaluate_full(jnp.asarray(ue), jnp.asarray(ie),
                                         j_ctx, "test", extended=True,
                                         mesh=jmesh, topk="approx",
                                         score_dtype="bf16")}


@pytest.mark.parametrize("ref", ("port", "jax", "jax_mesh"))
@pytest.mark.parametrize("world", WORLDS)
def test_evaluate_full_on_the_mesh(case, references, world, ref):
    res = case["load"](world, "eval_exact")
    want = references[ref]
    for K in want:
        assert res[K]["users_eval"] == want[K]["users_eval"]
        for m in METRICS:
            assert res[K][m] == pytest.approx(want[K][m], abs=1e-6), (K, m)


@pytest.mark.parametrize("world", WORLDS)
def test_evaluate_full_fast_flags_on_the_mesh(case, references, world):
    """approx + bf16 on the mesh: the bf16 block scores may reorder
    near-ties only (``tests/test_sharded_topk.py``'s bound against the
    exact protocol), and agree with JAX's mesh at the same flags."""
    fast = case["load"](world, "eval_fast")
    exact = case["load"](world, "eval_exact")
    for K in (10, 20):
        for m in ("recall", "ndcg"):
            assert abs(fast[K][m] - exact[K][m]) <= 0.02, (K, m)
            assert fast[K][m] == pytest.approx(
                references["jax_mesh_fast"][K][m], abs=0.02), (K, m)


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_reports_the_same(case, world):
    ld = case["load"]
    for name in ("topk_exact_v", "topk_exact_ids", "topk_excl_ids",
                 "topk_bf16_v", "topk_pad_ids", "eval_exact", "eval_fast"):
        first = ld(world, name)
        for r in range(1, world):
            other = ld(world, name, r)
            if isinstance(first, dict):
                assert other == first, name
            else:
                assert np.array_equal(other, first), name


def test_topk_on_a_new_mesh_uses_its_live_group(monkeypatch):
    """Two meshes made in turn in one process, the process group destroyed
    between them (ROADMAP F5): the second mesh's top-k gathers over its own
    model group, not over the destroyed one, and ranks as a dense top-k."""
    import torch.distributed as dist
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.eval.retrieval import topk_for_users
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.parallel import mesh as mesh_mod
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.parallel import sharded_topk
    groups = []
    gather = sharded_topk._all_gather_into

    def spy(out, x, group):
        groups.append(group)
        gather(out, x, group)
    monkeypatch.setattr(sharded_topk, "_all_gather_into", spy)
    rng = np.random.default_rng(4)
    ue = torch.as_tensor(rng.normal(size=(20, 8)).astype(np.float32))
    ie = torch.as_tensor(rng.normal(size=(37, 8)).astype(np.float32))
    users = torch.arange(6)
    want = torch.topk(ue[users] @ ie.T, 5, dim=1).indices
    assert not dist.is_initialized()
    try:
        for _ in range(2):
            mesh = mesh_mod.make_mesh(1, device_type="cpu")
            _, ids = topk_for_users(ue, ie, users, 5, mesh=mesh)
            assert torch.equal(ids, want)
            assert groups[-1] is mesh_mod.model_group(mesh)
            dist.destroy_process_group()
        assert groups[0] is not groups[-1]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
