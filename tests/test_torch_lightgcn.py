"""The PyTorch LightGCN against the JAX package's, on the same parameters.

Parameters are drawn with numpy and carried into both packages
(``params_from_jax``).  fp32 ``propagate`` and ``propagate_rows`` are held
against JAX (xla backend) within rtol/atol 1e-5 for every propagation mode
and weight recipe.  bf16 is held against JAX's Pallas backend in interpret
mode: both round the ego tables, every layer's output and the weights to
bf16 and sum in fp32, so they differ by the bf16 rounding of sums taken in
another order — rtol 2e-2, atol 1e-3 after K=3 layers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.models.lightgcn import LightGCN as JLightGCN
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.utils.config import RecConfig as JRecConfig
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.models import lightgcn as t_lgcn
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.utils.config import RecConfig as TRecConfig

# (propagation, weight_mode, table_layout): all three modes, all four recipes
COMBOS = [("symmetric", "symmetric", "joint"),
          ("symmetric", "symmetric", "split"),
          ("bipartite_sync", "cred_eq322", "split"),
          ("gauss_seidel", "cu_message", "split"),
          ("gauss_seidel", "degree_aware", "split")]


def _setup(graph, prop, weight, layout, D=8, K=3, precision="fp32"):
    kw = dict(propagation=prop, weight_mode=weight, table_layout=layout,
              emb_dim=D, num_layers=K, spmm_precision=precision)
    rng = np.random.default_rng(0)
    U, I = graph.num_users, graph.num_items
    if layout == "joint":
        params = {"emb": rng.normal(0, 0.1, (U + I, D)).astype(np.float32)}
    else:
        params = {"user_emb": rng.normal(0, 0.1, (U, D)).astype(np.float32),
                  "item_emb": rng.normal(0, 0.1, (I, D)).astype(np.float32)}
    cred = rng.uniform(0.2, 1.0, U).astype(np.float32)
    return JRecConfig(**kw), TRecConfig(**kw), params, cred


@pytest.mark.parametrize("combo", COMBOS, ids=["-".join(c) for c in COMBOS])
def test_propagate_matches_jax(small_graph, combo):
    jcfg, tcfg, params, cred = _setup(small_graph, *combo)
    ju, ji = JLightGCN(jcfg, small_graph, cred, backend="xla").propagate(
        {k: jnp.asarray(v) for k, v in params.items()})
    model = t_lgcn.LightGCN(tcfg, small_graph, cred, device="cpu")
    tu, ti = model.propagate(t_lgcn.params_from_jax(params, "cpu"))
    assert tu.dtype == ti.dtype == torch.float32
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("combo", COMBOS, ids=["-".join(c) for c in COMBOS])
def test_propagate_rows_matches_jax(small_graph, combo):
    jcfg, tcfg, params, cred = _setup(small_graph, *combo)
    rng = np.random.default_rng(9)
    users = rng.integers(0, small_graph.num_users, 40)
    items = rng.integers(0, small_graph.num_items, 60)
    ju, ji = JLightGCN(jcfg, small_graph, cred, backend="xla").propagate_rows(
        {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(users), jnp.asarray(items))
    model = t_lgcn.LightGCN(tcfg, small_graph, cred, device="cpu")
    tp = t_lgcn.params_from_jax(params, "cpu")
    tu, ti = model.propagate_rows(tp, torch.as_tensor(users),
                                  torch.as_tensor(items))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-5, atol=1e-5)
    # row-gather commutes with the layer mean bit-exactly
    fu, fi = model.propagate(tp)
    assert torch.equal(tu, fu[torch.as_tensor(users)])
    assert torch.equal(ti, fi[torch.as_tensor(items)])


def test_bf16_propagate_matches_jax_pallas(small_graph):
    jcfg, tcfg, params, cred = _setup(small_graph, "gauss_seidel",
                                      "cu_message", "split",
                                      precision="bf16")
    ju, ji = JLightGCN(jcfg, small_graph, cred, backend="pallas").propagate(
        {k: jnp.asarray(v) for k, v in params.items()})
    model = t_lgcn.LightGCN(tcfg, small_graph, cred, device="cpu")
    tu, ti = model.propagate(t_lgcn.params_from_jax(params, "cpu"))
    assert tu.dtype == torch.float32
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=2e-2, atol=1e-3)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=2e-2, atol=1e-3)


def test_scores_match_jax(small_graph):
    rng = np.random.default_rng(3)
    ue = rng.normal(size=(small_graph.num_users, 8)).astype(np.float32)
    ie = rng.normal(size=(small_graph.num_items, 8)).astype(np.float32)
    users = rng.integers(0, small_graph.num_users, 16)
    items = rng.integers(0, small_graph.num_items, 16)
    T = t_lgcn.LightGCN
    np.testing.assert_allclose(
        T.score(torch.as_tensor(ue), torch.as_tensor(ie),
                torch.as_tensor(users), torch.as_tensor(items)).numpy(),
        np.asarray(JLightGCN.score(jnp.asarray(ue), jnp.asarray(ie),
                                   jnp.asarray(users), jnp.asarray(items))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        T.score_all_items(torch.as_tensor(ue), torch.as_tensor(ie),
                          torch.as_tensor(users)).numpy(),
        np.asarray(JLightGCN.score_all_items(
            jnp.asarray(ue), jnp.asarray(ie), jnp.asarray(users))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", ["joint", "split"])
def test_init_params_xavier(layout):
    cfg = TRecConfig(table_layout=layout, emb_dim=16)
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    p1 = t_lgcn.init_params(g1, cfg, 300, 200)
    p2 = t_lgcn.init_params(g2, cfg, 300, 200)
    for k, v in p1.items():
        assert torch.equal(v, p2[k])
        limit = np.sqrt(6.0 / (v.shape[0] + v.shape[1]))
        assert float(v.abs().max()) <= limit
        assert float(v.abs().max()) > 0.9 * limit
    u, i = t_lgcn.ego_tables(p1, 300)
    assert u.shape == (300, 16) and i.shape == (200, 16)
