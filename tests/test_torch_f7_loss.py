"""The late-epoch training loss, the port against the JAX package over many
epochs, and the training samplers held to JAX's by their distribution.

* Twenty epochs of ``vanilla``, ``cu_message`` and ``degree_aware`` from the
  same parameters, each epoch on the JAX trainer's own draws: the JAX side
  runs its jitted epoch (``RecTrainer._build_epoch_fn``) from its key; the
  port gets the permutation, positives and negatives that epoch drew
  (the same key splits and samplers, replayed outside the jit) through
  ``RecTrainer.run_epoch``.  Every epoch's mean loss within rtol 2e-6 of
  JAX's (400 such epochs stay within 3.3e-7), and the parameters after the
  last within 1e-5.
* The epoch's layout: the port's ``draw_epoch`` and the JAX epoch both hold
  a permutation of the train users, padded with user 0 to whole batches,
  and the mask of the real slots.
* The samplers at a fixed seed, 400 draws for each train user: the (user,
  item) counts of each package's positives, uniform negatives and pop-mix
  negatives against their exact distribution (chi-square goodness of fit)
  and against each other (chi-square homogeneity, each user's draws a
  multinomial of its own), each at p > 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from test_torch_trainer import FIT, _cred

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.configs.presets import get_preset as j_preset
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.graph.build import synthetic_bipartite_graph
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.ops import sampling as j_samp
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.train.trainer import RecTrainer as JTrainer
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.configs.presets import get_preset as t_preset
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.models.lightgcn import params_from_jax
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops import sampling as t_samp
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops.adam import adam_init
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.train.trainer import RecTrainer

EPOCHS = 20
LOSS_RTOL = 2e-6
PARAM_TOL = 1e-5
DRAWS = 400            # draws for each train user in the sampler tests
P_MIN = 1e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small shapes: one intra-op thread, so that this file adds no thread
    contention to the test workers running beside it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graph():
    return synthetic_bipartite_graph(num_users=150, num_items=80,
                                     edges_per_user=20.0, seed=3, power=0.6)


def _jax_draws(jtr, key, bundle):
    """The draws of one JAX epoch from ``key`` (``epoch_fn``'s own code,
    outside the jit): ``(users, pos, neg, mask)`` as (nb, B) numpy arrays
    and the epoch's next key."""
    B = jtr.cfg.batch_size
    n = jtr.train_users.size
    nb = -(-n // B)
    kperm, ksamp, key = jax.random.split(key, 3)
    perm = jax.random.permutation(kperm, jtr.train_users_dev)
    users_flat = jnp.concatenate([perm, jnp.zeros((nb * B - n,), jnp.int32)])
    pos, neg = jtr._sample_epoch(ksamp, users_flat, bundle)
    mask = jnp.arange(nb * B) < n
    return tuple(np.asarray(x).reshape(nb, B).astype(
        bool if x is mask else np.int64)
        for x in (users_flat, pos, neg, mask)), key


@pytest.mark.parametrize("preset", ["vanilla", "cu_message", "degree_aware"])
def test_twenty_epochs_on_jax_draws_match_jax(graph, preset):
    jtr = JTrainer(j_preset(preset).replace(**FIT), graph, cred=_cred(graph),
                   verbose=False)
    tr = RecTrainer(t_preset(preset).replace(**FIT), graph,
                    cred=_cred(graph), device="cpu", verbose=False)
    j_params, j_opt, key = jtr.init_state(seed=5)
    t_params = params_from_jax({k: np.asarray(v)
                                for k, v in j_params.items()}, "cpu")
    t_opt = adam_init(t_params)
    bundle = jtr.train_state_bundle()
    epoch_fn = jtr._build_epoch_fn()
    for epoch in range(EPOCHS):
        batches, next_key = _jax_draws(jtr, key, bundle)
        j_params, j_opt, key, j_loss = epoch_fn(j_params, j_opt, key,
                                                jtr.train_users_dev, bundle)
        assert np.array_equal(np.asarray(key), np.asarray(next_key))
        t_loss = tr.run_epoch(t_params, t_opt, tuple(
            torch.as_tensor(x) for x in batches)).mean()
        assert float(t_loss) == pytest.approx(float(j_loss),
                                              rel=LOSS_RTOL), epoch
    assert t_opt.count == EPOCHS * batches[0].shape[0]
    for k, v in j_params.items():
        np.testing.assert_allclose(t_params[k].numpy(), np.asarray(v),
                                   rtol=PARAM_TOL, atol=PARAM_TOL)


def test_epoch_layout_matches_jax(graph):
    jtr = JTrainer(j_preset("cu_message").replace(**FIT), graph,
                   cred=_cred(graph), verbose=False)
    tr = RecTrainer(t_preset("cu_message").replace(**FIT), graph,
                    cred=_cred(graph), device="cpu", verbose=False)
    (ju, jp, jn, jm), _ = _jax_draws(jtr, jax.random.PRNGKey(0),
                                     jtr.train_state_bundle())
    gen = torch.Generator().manual_seed(0)
    tu, tp, tn, tm = (x.numpy() for x in tr.draw_epoch(gen))
    assert tu.shape == ju.shape and tm.dtype == jm.dtype == bool
    assert np.array_equal(tm, jm)
    n = int(jm.sum())
    assert n == tr.train_users.size
    for users in (tu.ravel(), ju.ravel()):
        assert np.array_equal(np.sort(users[:n]), tr.train_users)
        assert not users[n:].any()              # padded with user 0
    for a, b in ((tp, jp), (tn, jn)):
        assert a.shape == b.shape == tu.shape


def _pair_counts(graph, rows, items):
    """(user, item) draw counts as a (U, I) array."""
    return np.bincount(np.asarray(rows) * graph.num_items + np.asarray(items),
                       minlength=graph.num_users * graph.num_items).reshape(
                           graph.num_users, graph.num_items)


def _gof_and_homogeneity(t_counts, j_counts, expected):
    """p of each side's goodness of fit to ``expected`` and of their
    homogeneity.  Every user's draws are a multinomial of their own (a
    fixed total), so the degrees of freedom are, summed over users, the
    cells with mass less one."""
    live = expected > 0
    assert t_counts[~live].sum() == 0 and j_counts[~live].sum() == 0
    users = live.any(1)
    dof = int(live.sum() - users.sum())
    out = []
    for c in (t_counts, j_counts):
        chi = ((c[live] - expected[live]) ** 2 / expected[live]).sum()
        out.append(stats.chi2.sf(chi, dof))
    # both sides draw the same total for each user: the pooled expectation
    # of a cell is the mean of the two counts
    both = (t_counts + j_counts) > 0
    e = (t_counts + j_counts)[both] / 2.0
    chi = (((t_counts[both] - e) ** 2 + (j_counts[both] - e) ** 2) / e).sum()
    out.append(stats.chi2.sf(chi, int(both.sum() - both.any(1).sum())))
    return out


def _expected(graph, rows_per_user, weights_of):
    """Expected (user, item) counts: ``rows_per_user`` draws of each train
    user, item weights ``weights_of(u)`` (zero off the support)."""
    tr = graph.user_csr("train")
    exp = np.zeros((graph.num_users, graph.num_items))
    for u in np.nonzero(tr.degrees() > 0)[0]:
        w = weights_of(u, tr.indices[tr.indptr[u]:tr.indptr[u + 1]])
        exp[u] = rows_per_user * w / w.sum()
    return exp


@pytest.mark.parametrize("sampler", ["positives", "uniform", "popmix"])
def test_sampler_distribution_matches_jax(graph, sampler):
    tr = graph.user_csr("train")
    users = np.nonzero(tr.degrees() > 0)[0]
    rows = np.tile(users, DRAWS)
    I = graph.num_items
    t_csr = t_samp.DeviceCSR.from_host(tr, I, "cpu")
    j_csr = j_samp.DeviceCSR.from_host(tr, I)
    gen = torch.Generator().manual_seed(11)
    key = jax.random.PRNGKey(11)
    t_rows, j_rows = torch.as_tensor(rows), jnp.asarray(rows, jnp.int32)
    deg = graph.train_item_degrees()
    if sampler == "positives":
        t = t_samp.sample_positives(gen, t_csr, t_rows)
        j = j_samp.sample_positives(key, j_csr, j_rows)

        def weights(u, row):
            w = np.zeros(I)
            w[row] = 1.0
            return w
    elif sampler == "uniform":
        t = t_samp.sample_negatives_uniform(gen, t_csr, t_rows, I)
        j = j_samp.sample_negatives_uniform(key, j_csr, j_rows, I)

        def weights(u, row):
            w = np.ones(I)
            w[row] = 0.0
            return w
    else:
        t = t_samp.sample_negatives_popmix(
            gen, t_csr, t_rows,
            t_samp.PopMixSampler.build(deg, "cpu", mix_pop=0.7, gamma=0.75))
        j = j_samp.sample_negatives_popmix(
            key, j_csr, j_rows,
            j_samp.PopMixSampler.build(deg, mix_pop=0.7, gamma=0.75))
        pop = np.power(deg.astype(np.float64) + 1.0, 0.75)
        mixture = 0.7 * pop / pop.sum() + 0.3 / I

        def weights(u, row):
            w = mixture.copy()
            w[row] = 0.0
            return w
    expected = _expected(graph, DRAWS, weights)
    p_port, p_jax, p_both = _gof_and_homogeneity(
        _pair_counts(graph, rows, t.numpy()),
        _pair_counts(graph, rows, np.asarray(j)), expected)
    assert min(p_port, p_jax, p_both) > P_MIN, (p_port, p_jax, p_both)
