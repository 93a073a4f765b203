"""The PyTorch evaluation path against the JAX package's.

Random streams cannot be shared (threefry vs torch's generators), so the
sampled protocol is compared on an injected candidate matrix: JAX's batch
function runs with its samplers replaced by the same candidates.  Metrics
are compared within 1e-6 (the per-user values are the same fp32 numbers,
summed in float32 in the same order); top-k ids as sets, because the two
top-k ops may order tied scores differently.  The port's samplers are
checked by their properties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.eval import ranking as j_rank
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.eval import retrieval as j_ret
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.ops import sampling as j_samp
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.train.trainer import format_metrics_block as j_format
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.eval import ranking as t_rank
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.eval import retrieval as t_ret
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops import sampling as t_samp
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.train.trainer import format_metrics_block as t_format

KS = (10, 20)


def _emb(graph, D=8, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(graph.num_users, D)).astype(np.float32),
            rng.normal(size=(graph.num_items, D)).astype(np.float32))


def _assert_metrics_equal(j, t):
    assert sorted(j) == sorted(t)
    for K in j:
        assert sorted(j[K]) == sorted(t[K]), K
        for name, v in j[K].items():
            if isinstance(v, str):
                assert t[K][name] == v
            else:
                assert t[K][name] == pytest.approx(float(v), abs=1e-6), name


@pytest.fixture(scope="module")
def contexts(small_graph):
    return (j_rank.EvalContext.build(small_graph),
            t_rank.EvalContext.build(small_graph, "cpu"))


@pytest.mark.parametrize("extended", [False, True])
def test_sampled_metrics_with_injected_candidates(small_graph, contexts,
                                                  monkeypatch, extended):
    jctx, tctx = contexts
    ue, ie = _emb(small_graph)
    users = jctx.eval_users["test"]
    rng = np.random.default_rng(1)
    cand = rng.integers(0, small_graph.num_items, (users.size, 1 + 99))
    cand[:, 5] = cand[:, 0]          # a tie with the positive
    monkeypatch.setattr(j_rank, "sample_positives",
                        lambda key, csr, u: jnp.asarray(cand[:, 0]))
    monkeypatch.setattr(j_rank, "sample_candidate_set",
                        lambda key, csrs, u, I, n, rounds: jnp.asarray(
                            cand[:, 1:]))
    j_out = j_rank._sampled_batch.__wrapped__(
        jax.random.PRNGKey(0), jnp.asarray(ue), jnp.asarray(ie),
        jnp.asarray(users), jctx.test_csr, jctx.train_csr, jctx.item_pop_dev,
        small_graph.num_items, 99, 3, KS, extended, jctx.total_train)
    t_out = t_rank._sampled_metrics(
        torch.as_tensor(ue), torch.as_tensor(ie), torch.as_tensor(users),
        torch.as_tensor(cand), tctx.item_pop_dev, KS, extended,
        tctx.total_train, small_graph.num_items)
    for K in KS:
        for m in ("precision", "recall", "ndcg"):
            np.testing.assert_allclose(t_out[0][K][m].numpy(),
                                       np.asarray(j_out[0][K][m]),
                                       rtol=0, atol=1e-6)
    assert np.array_equal(t_out[1].numpy(), np.asarray(j_out[1]))
    if extended:
        for K in KS:
            for a, b in ((t_out[2], j_out[2]), (t_out[3], j_out[3])):
                np.testing.assert_allclose(a[K].numpy(), np.asarray(b[K]),
                                           rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("extended,batch", [(False, 512), (True, 16)])
def test_full_metrics_match_jax(small_graph, contexts, extended, batch):
    jctx, tctx = contexts
    ue, ie = _emb(small_graph, seed=2)
    cred = np.random.default_rng(3).uniform(0.2, 1.0, small_graph.num_users)
    j = j_rank.evaluate_full(jnp.asarray(ue), jnp.asarray(ie), jctx, "test",
                             Ks=KS, batch=batch, extended=extended, cred=cred)
    t = t_rank.evaluate_full(torch.as_tensor(ue), torch.as_tensor(ie), tctx,
                             "test", Ks=KS, batch=batch, extended=extended,
                             cred=cred)
    _assert_metrics_equal(j, t)
    assert j_format("TEST", j) == t_format("TEST", t)


def test_full_metrics_approx_topk_is_exact(small_graph, contexts):
    _, tctx = contexts
    ue, ie = _emb(small_graph, seed=4)
    a = t_rank.evaluate_full(torch.as_tensor(ue), torch.as_tensor(ie), tctx,
                             "val", Ks=KS, topk="exact")
    b = t_rank.evaluate_full(torch.as_tensor(ue), torch.as_tensor(ie), tctx,
                             "val", Ks=KS, topk="approx")
    assert a == b


@pytest.mark.parametrize("excl", ["none", "table", "batch"])
def test_topk_for_users_matches_jax(small_graph, excl):
    ue, ie = _emb(small_graph, seed=5)
    users = np.arange(0, small_graph.num_users, 3)
    kw_j, kw_t = {}, {}
    if excl == "table":
        rows = j_ret.build_exclusion_rows(small_graph)
        assert np.array_equal(rows, t_ret.build_exclusion_rows(small_graph))
        kw_j["exclude_rows"] = jnp.asarray(rows)
        kw_t["exclude_rows"] = torch.as_tensor(rows)
    elif excl == "batch":
        rows = j_ret.exclusion_rows_for_users(small_graph, users)
        assert np.array_equal(
            rows, t_ret.exclusion_rows_for_users(small_graph, users))
        kw_j["exclude_batch_rows"] = jnp.asarray(rows)
        kw_t["exclude_batch_rows"] = torch.as_tensor(rows)
    js, ji = j_ret.topk_for_users(jnp.asarray(ue), jnp.asarray(ie),
                                  jnp.asarray(users), 20, **kw_j)
    ts, ti = t_ret.topk_for_users(torch.as_tensor(ue), torch.as_tensor(ie),
                                  torch.as_tensor(users), 20, **kw_t)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(ti.numpy(), np.asarray(ji)):
        assert set(a) == set(b)
    if excl != "none":
        train = small_graph.user_csr("train")
        for u, row in zip(users, ti.numpy()):
            assert not set(row) & set(train.row(u))


def test_topk_for_users_mesh_not_ported(small_graph):
    """The mesh branch is ported (tests/test_torch_sharded_topk.py runs it
    on gloo ranks); what is no mesh, or a model axis with no process group,
    is refused rather than ranked on one device."""
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.parallel.mesh import ModelAxis
    ue, ie = _emb(small_graph)
    args = (torch.as_tensor(ue), torch.as_tensor(ie), torch.arange(3), 5)
    with pytest.raises(TypeError, match="DeviceMesh"):
        t_ret.topk_for_users(*args, mesh=object())
    with pytest.raises(RuntimeError, match="no process group"):
        t_ret.topk_for_users(*args, mesh=ModelAxis(size=1))


def test_format_metrics_block_identical():
    res = {10: {"precision": 0.12345, "recall": 0.5, "ndcg": 0.33333,
                "mode": "full", "item_coverage": 0.25,
                "avg_log_popularity": 1.5, "avg_self_information": 9.1,
                "cred_utility": 0.7, "high_cred_recall": 0.4,
                "low_cred_recall": 0.1},
           20: {"precision": 0.2, "recall": 0.6, "ndcg": 0.4,
                "mode": "full"}}
    assert j_format("VAL", res) == t_format("VAL", res)


def test_rejection_rounds_equal():
    for deg, n in ((1, 2), (30, 90), (20, 261_728), (500, 1000)):
        assert j_rank.rejection_rounds(deg, n) == t_rank.rejection_rounds(deg, n)


def test_first_good_matches_jax():
    rng = np.random.default_rng(6)
    cand = rng.integers(0, 100, (50, 7, 4))
    good = rng.random((50, 7, 3)) < 0.3
    want = np.asarray(j_samp._first_good(jnp.asarray(cand), jnp.asarray(good)))
    got = t_samp._first_good(torch.as_tensor(cand), torch.as_tensor(good))
    assert np.array_equal(got.numpy(), want)


def test_candidate_set_avoids_train_and_ground_truth(small_graph, contexts):
    _, tctx = contexts
    users = tctx.eval_users["test"]
    gen = torch.Generator().manual_seed(0)
    max_deg = int(small_graph.user_csr("train").degrees().max())
    rounds = t_rank.rejection_rounds(max_deg, small_graph.num_items)
    negs = t_samp.sample_candidate_set(
        gen, (tctx.test_csr, tctx.train_csr), torch.as_tensor(users),
        small_graph.num_items, 99, rounds=rounds).numpy()
    assert negs.shape == (users.size, 99)
    assert negs.min() >= 0 and negs.max() < small_graph.num_items
    tr, te = small_graph.user_csr("train"), small_graph.user_csr("test")
    for u, row in zip(users, negs):
        assert not set(row) & (set(tr.row(u)) | set(te.row(u)))
    pos = t_samp.sample_positives(gen, tctx.test_csr,
                                  torch.as_tensor(users)).numpy()
    for u, p in zip(users, pos):
        assert p in set(te.row(u))


def test_sampled_eval_is_reproducible_per_seed(small_graph, contexts):
    _, tctx = contexts
    ue, ie = (torch.as_tensor(a) for a in _emb(small_graph, seed=7))
    runs = [t_rank.evaluate_sampled(torch.Generator().manual_seed(s), ue, ie,
                                    tctx, "test", Ks=KS, batch=32)
            for s in (11, 11, 12)]
    assert runs[0] == runs[1]
    assert runs[0][20]["users_eval"] == tctx.eval_users["test"].size
