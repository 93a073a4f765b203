"""F10's diagnostics on the card (marked ``cuda``: each skips without one).
Run them on the card past ``tests/conftest.py``, which imports JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_f10_on_card.py``.

F10 (``ROADMAP.md`` Queue 3): degree_aware's late-epoch loss on the parity
graph, the port on the card against the JAX package on a CPU, sits more
than 2 pooled SE above JAX's over eight seeds a side, while the port on a
CPU is within.  ``tests/test_torch_f7_loss.py`` holds the port on the CPU
to JAX's arithmetic (twenty epochs on JAX's own draws) and its samplers to
JAX's distribution.  These two tests hold the card to the CPU in the same
two ways, without JAX:

* the arithmetic: twenty epochs of degree_aware from one set of
  parameters, each epoch on one set of draws made on the CPU, run on the
  card and on the CPU: every epoch's mean loss within rtol 2e-6 (the bound
  the CPU port keeps to JAX's) and the parameters after the last within
  1e-5;
* the draws: the card's positives, uniform negatives and pop-mix negatives,
  400 for each train user from a CUDA generator, against their exact
  distribution by chi-square (p > 1e-3), as the CPU's are held.
"""

import numpy as np
import pytest
import torch
from scipy import stats

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.configs.presets import get_preset
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.graph.build import synthetic_bipartite_graph
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops import sampling
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops.adam import adam_init
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.train.trainer import RecTrainer

EPOCHS = 20
LOSS_RTOL = 2e-6
PARAM_TOL = 1e-5
DRAWS = 400
P_MIN = 1e-3
# tests/test_torch_f7_loss.py's graph and fit settings
FIT = dict(batch_size=64, eval_every=1, sampled_negatives=20, Ks=(5, 10))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _graph():
    return synthetic_bipartite_graph(num_users=150, num_items=80,
                                     edges_per_user=20.0, seed=3, power=0.6)


def _cred(graph):
    return np.random.default_rng(0).uniform(
        0.2, 1.0, graph.num_users).astype(np.float32)


@pytest.mark.cuda
def test_degree_aware_epochs_on_the_card_match_the_cpu():
    _card()
    graph = _graph()
    cfg = get_preset("degree_aware").replace(**FIT)
    cpu = RecTrainer(cfg, graph, cred=_cred(graph), device="cpu",
                     verbose=False)
    card = RecTrainer(cfg, graph, cred=_cred(graph), device="cuda",
                      verbose=False)
    p_cpu, o_cpu, gen = cpu.init_state(seed=5)
    p_card = {k: v.to("cuda").clone() for k, v in p_cpu.items()}
    o_card = adam_init(p_card)
    for epoch in range(EPOCHS):
        batches = cpu.draw_epoch(gen)
        l_cpu = float(cpu.run_epoch(p_cpu, o_cpu, batches).mean())
        l_card = float(card.run_epoch(p_card, o_card, tuple(
            b.to("cuda") for b in batches)).mean())
        assert l_card == pytest.approx(l_cpu, rel=LOSS_RTOL), epoch
    for k, v in p_cpu.items():
        np.testing.assert_allclose(p_card[k].cpu().numpy(), v.numpy(),
                                   rtol=PARAM_TOL, atol=PARAM_TOL)


def _expected(graph, weights_of):
    """Expected (user, item) counts of DRAWS draws for each train user."""
    tr = graph.user_csr("train")
    exp = np.zeros((graph.num_users, graph.num_items))
    for u in np.nonzero(tr.degrees() > 0)[0]:
        w = weights_of(tr.indices[tr.indptr[u]:tr.indptr[u + 1]])
        exp[u] = DRAWS * w / w.sum()
    return exp


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["positives", "uniform", "popmix"])
def test_samplers_on_the_card_follow_their_distribution(sampler):
    _card()
    graph = _graph()
    tr = graph.user_csr("train")
    I = graph.num_items
    users = np.nonzero(tr.degrees() > 0)[0]
    rows = torch.as_tensor(np.tile(users, DRAWS), device="cuda")
    csr = sampling.DeviceCSR.from_host(tr, I, "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    deg = graph.train_item_degrees()
    if sampler == "positives":
        got = sampling.sample_positives(gen, csr, rows)

        def weights(row):
            w = np.zeros(I)
            w[row] = 1.0
            return w
    elif sampler == "uniform":
        got = sampling.sample_negatives_uniform(gen, csr, rows, I)

        def weights(row):
            w = np.ones(I)
            w[row] = 0.0
            return w
    else:
        got = sampling.sample_negatives_popmix(
            gen, csr, rows, sampling.PopMixSampler.build(
                deg, "cuda", mix_pop=0.7, gamma=0.75))
        pop = np.power(deg.astype(np.float64) + 1.0, 0.75)
        mixture = 0.7 * pop / pop.sum() + 0.3 / I

        def weights(row):
            w = mixture.copy()
            w[row] = 0.0
            return w
    expected = _expected(graph, weights)
    counts = np.bincount(rows.cpu().numpy() * I + got.cpu().numpy(),
                         minlength=graph.num_users * I).reshape(
                             graph.num_users, I)
    live = expected > 0
    assert counts[~live].sum() == 0
    dof = int(live.sum() - live.any(1).sum())
    chi = ((counts[live] - expected[live]) ** 2 / expected[live]).sum()
    assert stats.chi2.sf(chi, dof) > P_MIN
