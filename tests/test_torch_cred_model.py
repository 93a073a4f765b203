"""The PyTorch package's full-graph CredModel against the JAX package's.

Each view's normalized weights are computed on the host by the same numpy
code, so they are equal.  The forward of each view (through the SpMM's
plain version on the CPU) is within rtol 1e-5 / atol 1e-6 of JAX's xla
backend, and of its Pallas kernels in interpret mode for one view; the
gradients of a forward-only loss (through the SpMM's backward, the same
kernel on the transpose) are within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.data.features import compute_user_features
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.graph.hetero import build_heterograph
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.models import cred_model as JM
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.utils.config import CredConfig as JCfg
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.models import cred_model as TM
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops.spmm import SpmmOperator
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.utils.config import CredConfig as TCfg

from test_features import _mk_table

H = 12
VIEWS = [None, "early", "late"]


@pytest.fixture(scope="module")
def hg():
    rng = np.random.default_rng(9)
    table = _mk_table(rng, U=40, I=25, N=600)
    table.helpful_vote = np.where(rng.random(600) < 0.4,
                                  rng.integers(6, 20, 600), 0).astype(np.float32)
    g = build_heterograph(table, compute_user_features(table))
    # a view edge of weight exactly 0, and an item whose view weight is 0
    g.edge_attr[:3, 0] = 0.0
    g.edge_attr[:3, 1] = -0.5
    return g


@pytest.fixture(scope="module")
def params_np(hg):
    p = JM.init_cred_params(jax.random.PRNGKey(0), hg.user_x.shape[1],
                            hg.item_x.shape[1], H)
    return {k: np.asarray(v) for k, v in p.items()}


def test_ewa_weights_and_view_masks_equal_jax(hg):
    for beta, gamma in ((1.0, 1.0), (0.5, 2.0)):
        assert np.array_equal(TM.ewa_raw_weights(hg.edge_attr, beta, gamma),
                              JM.ewa_raw_weights(hg.edge_attr, beta, gamma))
    for view in VIEWS:
        for split in (0.5, 0.3):
            assert np.array_equal(
                TM.temporal_edge_mask(hg.edge_attr, view, split),
                JM.temporal_edge_mask(hg.edge_attr, view, split))
    nan_ts = np.isnan(hg.edge_attr[:, 3])
    early = TM.temporal_edge_mask(hg.edge_attr, "early")
    late = TM.temporal_edge_mask(hg.edge_attr, "late")
    assert nan_ts.any() and not (early | late)[nan_ts].any()


@pytest.mark.parametrize("view", VIEWS, ids=["all", "early", "late"])
def test_view_weights_equal_jax(hg, view):
    """Both packages' views with the operator construction swapped for the
    identity: the edge maps themselves are compared."""
    ident = lambda em: em     # noqa: E731
    jv = JM.build_cred_view(hg, JCfg(), view, operator_factory=ident)
    tv = TM.build_cred_view(hg, TCfg(), view, "cpu", operator_factory=ident)
    for name in ("item_from_user", "user_from_item"):
        a, b = getattr(jv, name), getattr(tv, name)
        for f in ("src", "dst", "w"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), (name, f)
        assert (a.num_src, a.num_dst) == (b.num_src, b.num_dst)
    assert np.array_equal(np.asarray(jv.w_u2i_norm), tv.w_u2i_norm.numpy())
    assert np.array_equal(np.asarray(jv.src), tv.src.numpy())
    assert np.array_equal(np.asarray(jv.dst), tv.dst.numpy())
    # the default factory builds the SpMM operators on the device
    tv = TM.build_cred_view(hg, TCfg(), view, "cpu")
    assert isinstance(tv.item_from_user, SpmmOperator)
    assert tv.item_from_user.num_dst == hg.num_items


def _jax_forward(hg, params_np, view, backend):
    model = JM.CredModel(hg, JCfg(hidden_dim=H), backend=backend)
    p = {k: jnp.asarray(v) for k, v in params_np.items()}
    return [np.asarray(x) for x in jax.jit(
        model.forward, static_argnums=(1,))(p, view, model.state)]


@pytest.mark.parametrize("view", VIEWS, ids=["all", "early", "late"])
def test_forward_matches_jax_xla(hg, params_np, view):
    model = TM.CredModel(hg, TCfg(hidden_dim=H), device="cpu")
    params = TM.cred_params_from_jax(params_np, "cpu")
    with torch.no_grad():
        got = [x.numpy() for x in model.forward(params, view)]
    for g, w in zip(got, _jax_forward(hg, params_np, view, "xla")):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_forward_matches_jax_pallas_interpret(hg, params_np):
    model = TM.CredModel(hg, TCfg(hidden_dim=H), device="cpu")
    params = TM.cred_params_from_jax(params_np, "cpu")
    with torch.no_grad():
        got = [x.numpy() for x in model.forward(params, "early")]
    for g, w in zip(got, _jax_forward(hg, params_np, "early", "pallas")):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("view", ["early", "late"])
def test_forward_gradients_match_jax(hg, params_np, view):
    rng = np.random.default_rng(4)
    c_cred = rng.normal(size=hg.num_users).astype(np.float32)
    c_u = rng.normal(size=(hg.num_users, H)).astype(np.float32)
    c_i = rng.normal(size=(hg.num_items, H)).astype(np.float32)
    jmodel = JM.CredModel(hg, JCfg(hidden_dim=H), backend="xla")

    def jloss(p):
        cred, hu, hi = jmodel.forward(p, view)
        return (cred * c_cred).sum() + (hu * c_u).sum() + (hi * c_i).sum()

    jg = jax.jit(jax.grad(jloss))({k: jnp.asarray(v)
                                   for k, v in params_np.items()})
    model = TM.CredModel(hg, TCfg(hidden_dim=H), device="cpu")
    params = {k: v.requires_grad_() for k, v in
              TM.cred_params_from_jax(params_np, "cpu").items()}
    cred, hu, hi = model.forward(params, view)
    loss = ((cred * torch.as_tensor(c_cred)).sum()
            + (hu * torch.as_tensor(c_u)).sum()
            + (hi * torch.as_tensor(c_i)).sum())
    tg = torch.autograd.grad(loss, list(params.values()))
    for k, g in zip(params, tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_params_round_trip_and_init(hg, params_np):
    t = TM.cred_params_from_jax(params_np, "cpu")
    assert set(t) == set(params_np)
    for k, v in t.items():
        assert v.dtype == torch.float32
        assert np.array_equal(v.numpy(), params_np[k])
    gen = torch.Generator().manual_seed(0)
    init = TM.init_cred_params(gen, hg.user_x.shape[1], hg.item_x.shape[1], H)
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        {k: v.shape for k, v in params_np.items()}
    for k, v in init.items():
        fan_in = params_np[k.replace("_b", "_w")].shape[0]
        assert float(v.abs().max()) <= 1.0 / np.sqrt(fan_in)
    again = TM.init_cred_params(torch.Generator().manual_seed(0),
                                hg.user_x.shape[1], hg.item_x.shape[1], H)
    assert all(torch.equal(init[k], again[k]) for k in init)
