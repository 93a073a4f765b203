"""The PyTorch package's SLAS sampling and sampled forward against the JAX
package's.

The sampler's tables come from the same numpy code, so they are equal.  The
draws cannot share a random stream (threefry is JAX's), so the tests feed
the JAX package's own uniforms (``jax.random.uniform`` of the key its
``gumbel_topk`` would use) into the port: the drawn ids must then be JAX's,
ties included — a node with fewer valid candidates than k fills its last
slots with ``-inf`` scores, which ``lax.top_k`` orders lowest index first.
The sampled forward is held against JAX on JAX's draws within 1e-5, and the
port's own draws against Plackett-Luce inclusion probabilities.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.data.features import compute_user_features
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.graph.hetero import build_heterograph
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.models import cred_slas as JS
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.models.cred_model import init_cred_params
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.ops import slas as JSL
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.ops.sampling import gumbel_topk as j_gumbel_topk
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.utils.config import CredConfig as JCfg
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.models import cred_slas as TS
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.models.cred_model import cred_params_from_jax
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops import slas as TSL
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops.sampling import gumbel_topk
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.utils.config import CredConfig as TCfg

from test_features import _mk_table

H = 8
TABLES = ("item_feat_norm", "user_mu", "user_labeled", "u_items", "u_eids",
          "i_users", "i_eids", "edge_view_early", "edge_view_late")


@pytest.fixture(scope="module")
def hg():
    rng = np.random.default_rng(9)
    table = _mk_table(rng, U=40, I=25, N=600)
    table.helpful_vote = np.where(rng.random(600) < 0.4,
                                  rng.integers(6, 20, 600), 0).astype(np.float32)
    return build_heterograph(table, compute_user_features(table))


def _u(key, shape):
    return torch.as_tensor(np.array(jax.random.uniform(key, shape)))


@pytest.mark.parametrize("pad_deg", [None, 4, 64])
def test_sampler_tables_equal_jax(hg, pad_deg):
    j = JSL.SlasSampler.build(hg, JCfg(), pad_deg=pad_deg)
    t = TSL.SlasSampler.build(hg, TCfg(), pad_deg=pad_deg)
    for f in TABLES:
        a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (t.kappa, t.upweight_labeled) == (j.kappa, j.upweight_labeled)
    if pad_deg == 4:
        assert t.u_items.shape[1] == t.i_users.shape[1] == 4


def test_sampler_pad_deg_from_config(hg):
    t = TSL.SlasSampler.build(hg, TCfg(slas_pad_deg=6))
    assert t.u_items.shape[1] == t.i_users.shape[1] == 6


@pytest.mark.parametrize("with_ids", [True, False])
def test_padded_rows_equal_jax(with_ids):
    rng = np.random.default_rng(2)
    deg = rng.integers(0, 9, 30)
    deg[[0, 7]] = 0
    indptr = np.concatenate([[0], np.cumsum(deg)])
    indices = rng.integers(0, 50, indptr[-1]).astype(np.int32)
    eids = rng.permutation(indptr[-1]).astype(np.int64) if with_ids else None
    for P in (1, 5, 12):
        a = JSL._padded_rows(indptr, indices, eids, P, 50)
        b = TSL._padded_rows(indptr, indices, eids, P, 50)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype == np.int32 and np.array_equal(x, y)
    empty = TSL._padded_rows(np.zeros(4, np.int64), np.zeros(0, np.int32),
                             None, 3, 9)
    assert (empty[0] == 9).all() and (empty[1] == -1).all()


@pytest.mark.parametrize("k", [1, 4, 9])
def test_gumbel_topk_on_jax_uniforms_equals_jax(k):
    """Rows with fewer valid candidates than k (ties among -inf), a fully
    masked row, and k wider than the pool (k=9 > P=6)."""
    rng = np.random.default_rng(k)
    B, P = 7, 6
    logits = rng.normal(size=(B, P)).astype(np.float32)
    mask = rng.random((B, P)) < 0.6
    mask[0] = [True, False, False, False, False, False]
    mask[1] = False
    key = jax.random.PRNGKey(k)
    ji, jv = j_gumbel_topk(key, jnp.asarray(logits), k, jnp.asarray(mask))
    ti, tv = gumbel_topk(None, torch.as_tensor(logits), k,
                         torch.as_tensor(mask), uniforms=_u(key, (B, P)))
    assert ti.shape == tv.shape == (B, k)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)
    if k > 1:
        assert ti[0, :3].tolist() == [0, 1, 2][:min(k, 3)]  # lax.top_k order


def test_gumbel_topk_draws_from_the_generator():
    logits = torch.zeros(3, 5)
    a = gumbel_topk(torch.Generator().manual_seed(1), logits, 2)[0]
    b = gumbel_topk(torch.Generator().manual_seed(1), logits, 2)[0]
    c = gumbel_topk(torch.Generator().manual_seed(2), logits, 2)[0]
    assert torch.equal(a, b) and not torch.equal(a, c)


def _plackett_luce_inclusion(w, k):
    """P(i among the first k draws without replacement, p ∝ w), exactly."""
    n = len(w)
    inc = np.zeros(n)
    for seq in itertools.permutations(range(n), k):
        p, left = 1.0, w.sum()
        for i in seq:
            p *= w[i] / left
            left -= w[i]
        for i in seq:
            inc[i] += p
    return inc


def test_gumbel_topk_inclusion_follows_plackett_luce():
    """A 5-candidate row, k=2: inclusion counts of the port's own draws
    against the exact Plackett-Luce inclusion probabilities (chi-square,
    p > 1e-4; each draw includes k candidates, so the counts sum to k*n)."""
    logits = np.log(np.array([0.05, 0.1, 0.2, 0.25, 0.4]))
    n, k = 200_000, 2
    idx, _ = gumbel_topk(torch.Generator().manual_seed(7),
                         torch.as_tensor(logits, dtype=torch.float32)
                         .expand(n, 5), k)
    counts = np.bincount(idx.reshape(-1).numpy(), minlength=5)
    want = _plackett_luce_inclusion(np.exp(logits), k)
    assert abs(want.sum() - k) < 1e-12
    chi2, p = stats.chisquare(counts, want * n)
    assert p > 1e-4, (chi2, p, counts, want * n)


@pytest.mark.parametrize("view", [None, "early", "late"])
def test_sampler_draws_on_jax_uniforms_equal_jax(hg, view):
    j = JSL.SlasSampler.build(hg, JCfg(), pad_deg=None)
    t = TSL.SlasSampler.build(hg, TCfg(), pad_deg=None)
    users = np.arange(hg.num_users, dtype=np.int32)
    key = jax.random.PRNGKey(3)
    ji, jm = j.sample_items_for_users(key, jnp.asarray(users), 6, view)
    ti, tm = t.sample_items_for_users(
        None, torch.as_tensor(users), 6, view,
        uniforms=_u(key, (users.size, t.u_items.shape[1])))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    # item ids of invalid slots may be the pad id: clipped before gathers
    items = np.asarray(ji).reshape(-1)
    ju, jum = j.sample_users_for_items(key, jnp.asarray(items), 4)
    tu, tum = t.sample_users_for_items(
        None, torch.as_tensor(items), 4,
        uniforms=_u(key, (items.size, t.i_users.shape[1])))
    assert np.array_equal(tu.numpy(), np.asarray(ju))
    assert np.array_equal(tum.numpy(), np.asarray(jum))


def _jax_draws(j_data, seeds, key, view, ki, ku):
    """The draws JAX's ``slas_forward`` makes with ``key``."""
    k1, k2 = jax.random.split(key)
    s = j_data.sampler
    items, imask = s.sample_items_for_users(k1, seeds, ki, view)
    users, umask = s.sample_users_for_items(k2, items.reshape(-1), ku)
    umask = umask & imask.reshape(-1, 1)
    return (k1, k2), TS.SlasDraws(*(torch.as_tensor(np.array(x)) for x in
                                    (items, imask, users, umask)))


@pytest.mark.parametrize("view", [None, "early", "late"])
@pytest.mark.parametrize("pad_deg", [None, 3])
def test_slas_forward_on_jax_draws_matches_jax(hg, view, pad_deg):
    ki, ku = 5, 4
    jcfg, tcfg = JCfg(slas_pad_deg=pad_deg), TCfg(slas_pad_deg=pad_deg)
    j_data = JS.build_slas_graph_data(hg, jcfg)
    t_data = TS.build_slas_graph_data(hg, tcfg, "cpu")
    p = init_cred_params(jax.random.PRNGKey(1), hg.user_x.shape[1],
                         hg.item_x.shape[1], H)
    tp = cred_params_from_jax({k: np.asarray(v) for k, v in p.items()}, "cpu")
    seeds = np.array(list(range(0, hg.num_users, 3)) + [0, 0], np.int32)
    key = jax.random.PRNGKey(11)
    want = jax.jit(lambda p, s, k: JS.slas_forward(p, j_data, s, k, view,
                                                   ki, ku))(
        p, jnp.asarray(seeds), key)
    (k1, k2), draws = _jax_draws(j_data, jnp.asarray(seeds), key, view, ki, ku)
    P = t_data.sampler.u_items.shape[1]
    seeds_t = torch.as_tensor(seeds)
    with torch.no_grad():
        got = TS.slas_aggregate(tp, t_data, seeds_t, draws)
        drawn = TS.slas_forward(
            tp, t_data, seeds_t, None, view, ki, ku,
            uniforms=(_u(k1, (seeds.size, P)), _u(k2, (seeds.size * ki, P))))
    flat = lambda out: [out[0], out[1], out[2], *out[3]]   # noqa: E731
    for g, d, w in zip(flat(got), flat(drawn), flat(want)):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(d.numpy(), w, rtol=1e-5, atol=1e-5)
    assert np.isfinite(got[1].numpy()).all()
    assert float(got[3][0].max()) <= 1.0 + 1e-5


def test_first_match_edge_ids_take_the_first_slot():
    rows = torch.tensor([[4, 7, 4, 9], [2, 2, 5, 5]], dtype=torch.int32)
    eids = torch.tensor([[10, 11, 12, -1], [20, 21, 22, 23]],
                        dtype=torch.int32)
    slots = torch.tensor([[4, 9, 3], [5, 2, 2]], dtype=torch.int32)
    got = TS._first_match_eids(rows, eids, slots)
    # no match (3) falls back to slot 0, as argmax over all-False does
    assert got.tolist() == [[10, -1, 10], [22, 20, 20]]
