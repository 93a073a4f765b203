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

On the parity harness's graph itself (8,000 users, 24,000 items, the graph
of F10's runs), the card's draws beside the JAX trainer's
(``scripts/jax_streams.py``, the replica of its threefry streams):

* positives, 400 for each of the 7,986 train users: each user's counts
  against the uniform over its row, and the card's against the replica's
  (homogeneity);
* uniform negatives, 400 for each train user: each user's counts in 16
  bins of item ids against its exact distribution (uniform over the items
  not in its row), the counts by item pooled over users, the same for the
  replica's, the two against each other; and no negative is one of the
  user's own train items (only the unchecked last candidate could be one,
  with probability (deg / I)^9);
* the epoch's permutation (``torch.randperm`` on the card), 2,000 of them:
  how often each user lands in the first of the two batches, against the
  binomial of a uniform permutation.

Across epochs under ``fit``'s one generator (its initial tables, then every
epoch's draws, as ``RecTrainer.init_state`` and ``draw_epoch`` make them):
how often a user's positive, and its negative, repeat from one epoch to the
next, against the exact count and variance of independent draws from
their laws; and the initial tables against epoch 1's draws (each user's
mean initial row against its place in the permutation, its positive's and
its negative's id; the mean initial rows of the items drawn against their
expectation under the laws).  Each p > 1e-3.  Its CPU case runs on a
150 x 80 graph for 60 epochs with the CPU's generator, and runs here
without a card; the card's on the parity graph for 400 epochs.
"""

import numpy as np
import pytest
import torch
from scipy import stats

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.configs.presets import get_preset
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.graph.build import synthetic_bipartite_graph
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops import sampling
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops.adam import adam_init
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.models.lightgcn import ego_tables
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.scripts import jax_streams, parity_run
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.train.trainer import RecTrainer

EPOCHS = 20
LOSS_RTOL = 2e-6
PARAM_TOL = 1e-5
DRAWS = 400
P_MIN = 1e-3
# tests/test_torch_f7_loss.py's graph and fit settings
FIT = dict(batch_size=64, eval_every=1, sampled_negatives=20, Ks=(5, 10))
# the parity harness's graph (parity_run build's defaults)
PARITY_GRAPH = dict(num_users=8000, num_items=24000, edges_per_user=8.0,
                    seed=7, power=1.0, hash_split="md5")
NEG_BINS = 16
PERMS = 2000
BATCH = 4096                  # the parity configurations' batch
DEVICE = "cuda"


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


def _sf(chi: float, dof: int) -> float:
    return float(stats.chi2.sf(chi, dof))


def _parity_draws(kind: str):
    """DRAWS draws for each train user of the parity graph: the card's
    (a CUDA generator) and the replica's of JAX's (a threefry key), with
    the graph's train membership as a (U, I) bool array."""
    graph = synthetic_bipartite_graph(**PARITY_GRAPH)
    tr = graph.user_csr("train")
    I = graph.num_items
    users = np.nonzero(tr.degrees() > 0)[0]
    rows = np.tile(users, DRAWS)
    t_rows = torch.as_tensor(rows, device=DEVICE)
    csr = sampling.DeviceCSR.from_host(tr, I, DEVICE)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(11)
    key = jax_streams.prng_key(11)
    if kind == "positives":
        card = sampling.sample_positives(gen, csr, t_rows)
        jax = jax_streams.sample_positives(key, tr, rows)
    else:
        card = sampling.sample_negatives_uniform(gen, csr, t_rows, I)
        jax = jax_streams.sample_negatives_uniform(key, tr, rows, I, 8)
    member = np.zeros((graph.num_users, I), bool)
    member[np.repeat(np.arange(graph.num_users), tr.degrees()),
           tr.indices] = True
    return graph, tr, rows, card.cpu().numpy(), np.asarray(jax), member


def _homogeneity(a: np.ndarray, b: np.ndarray) -> float:
    """p of two count arrays (one row a multinomial of the same total on
    each side) coming from one distribution."""
    both = (a + b) > 0
    e = (a + b)[both] / 2.0
    chi = (((a[both] - e) ** 2 + (b[both] - e) ** 2) / e).sum()
    rows = both.any(-1).sum() if a.ndim > 1 else 1
    return _sf(chi, int(both.sum() - rows))


@pytest.mark.cuda
def test_positives_on_the_parity_graph_follow_the_row():
    _card()
    graph, tr, rows, card, jax, member = _parity_draws("positives")
    I, deg = graph.num_items, tr.degrees()
    live = deg > 0
    exp = DRAWS / np.maximum(deg, 1)
    ps = []
    counts = []
    for got in (card, jax):
        c = np.bincount(rows.astype(np.int64) * I + got,
                        minlength=graph.num_users * I).reshape(-1, I)
        assert c[~member].sum() == 0
        chi = ((c - exp[:, None]) ** 2 / exp[:, None])[member].sum()
        ps.append(_sf(chi, int(member.sum() - live.sum())))
        counts.append(np.where(member, c, 0)[live])
    ps.append(_homogeneity(*counts))
    assert min(ps) > P_MIN, ps


@pytest.mark.cuda
def test_uniform_negatives_on_the_parity_graph_follow_their_law():
    _card()
    graph, tr, rows, card, jax, member = _parity_draws("uniform")
    I, deg = graph.num_items, tr.degrees()
    live = deg > 0
    bins = np.arange(I) * NEG_BINS // I
    # each user's exact distribution: uniform over the items not in its row
    free = ~member[live]
    per_bin = np.stack([free[:, bins == b].sum(1) for b in range(NEG_BINS)],
                       axis=1)
    exp_bin = DRAWS * per_bin / free.sum(1, keepdims=True)
    exp_item = DRAWS * (free / free.sum(1, keepdims=True)).sum(0)
    ps, by_bin, by_item = [], [], []
    for got in (card, jax):
        assert not member[rows, got].any(), "a negative in its user's row"
        c = np.zeros((graph.num_users, NEG_BINS))
        np.add.at(c, (rows, bins[got]), 1)
        c = c[live]
        ps.append(_sf(((c - exp_bin) ** 2 / exp_bin).sum(),
                      int(live.sum()) * (NEG_BINS - 1)))
        ci = np.bincount(got, minlength=I)
        ps.append(_sf(((ci - exp_item) ** 2 / exp_item).sum(), I - 1))
        by_bin.append(c)
        by_item.append(ci)
    ps += [_homogeneity(*by_bin), _homogeneity(*by_item)]
    assert min(ps) > P_MIN, ps


@pytest.mark.cuda
def test_the_cards_permutation_splits_the_batches_uniformly():
    _card()
    graph = synthetic_bipartite_graph(**PARITY_GRAPH)
    n = int((graph.user_csr("train").degrees() > 0).sum())
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(11)
    first = torch.zeros(n, dtype=torch.int64, device=DEVICE)
    for _ in range(PERMS):
        first[torch.randperm(n, generator=gen, device=DEVICE)[:BATCH]] += 1
    c = first.cpu().numpy().astype(np.float64)
    q = BATCH / n
    # each permutation puts BATCH users in the first batch: n - 1 dof
    chi = ((c - PERMS * q) ** 2 / (PERMS * q * (1 - q))).sum()
    assert _sf(chi * (n - 1) / n, n - 1) > P_MIN



# the across-epoch check: a device's graph and epochs, and fit's seed
INDEPENDENCE = {"cpu": (dict(num_users=150, num_items=80, edges_per_user=20.0,
                             seed=3, power=0.6), 60),
                "cuda": (PARITY_GRAPH, 400)}
INDEPENDENCE_SEED = 7


def _repeat_z(obs: float, a: np.ndarray, b: np.ndarray, epochs: int):
    """p of ``obs`` lag-1 repeats over ``epochs`` iid draws a user, where
    a user's law has sum p^2 = ``a`` and sum p^3 = ``b``: the count's exact
    mean and variance (neighbouring pairs share a draw), two-sided normal
    tail."""
    mean = (epochs - 1) * a.sum()
    var = ((epochs - 1) * (a - a ** 2) + 2 * (epochs - 2) * (b - a ** 2)).sum()
    return float(2 * stats.norm.sf(abs(obs - mean) / np.sqrt(var)))


def _law_z(got: np.ndarray, mean: np.ndarray, var: np.ndarray) -> float:
    """p of the sum of one value a user, each with its mean and variance
    under the draws' laws, two-sided normal tail."""
    return float(2 * stats.norm.sf(abs((got - mean).sum())
                                   / np.sqrt(var.sum())))


def _independence(dev: str) -> dict:
    """The p values of the across-epoch check on ``dev``."""
    spec, epochs = INDEPENDENCE[dev]
    graph = synthetic_bipartite_graph(**spec)
    cfg = parity_run.framework_config("degree_aware", epochs, 2,
                                      INDEPENDENCE_SEED)
    tr = RecTrainer(cfg, graph, device=dev, verbose=False)
    params, _, gen = tr.init_state(INDEPENDENCE_SEED)
    U, I = graph.num_users, graph.num_items
    users = tr.train_users
    csr = graph.user_csr("train")
    rows = [csr.indices[csr.indptr[u]:csr.indptr[u + 1]] for u in users]
    # the positive's law: uniform over the row's slots
    pos_p = [np.unique(r, return_counts=True)[1] / r.size for r in rows]
    a_pos = np.array([(p ** 2).sum() for p in pos_p])
    b_pos = np.array([(p ** 3).sum() for p in pos_p])
    # the uniform negative's: the first of neg_rounds uniform candidates
    # not in the row, else one more unchecked
    m = np.array([np.unique(r).size for r in rows], np.float64)
    tail = (m / I) ** cfg.neg_rounds
    p_in = tail / I
    p_out = (1 - tail) / (I - m) + tail / I
    a_neg = (I - m) * p_out ** 2 + m * p_in ** 2
    b_neg = (I - m) * p_out ** 3 + m * p_in ** 3
    live = torch.as_tensor(users, device=dev)
    last = None
    repeats = np.zeros(2)
    for epoch in range(epochs):
        u, pos, neg, mask = (x.reshape(-1) for x in tr.draw_epoch(gen))
        u, pos, neg = u[mask], pos[mask], neg[mask]
        by_user = torch.full((2, U), -1, dtype=torch.int64, device=dev)
        by_user[0, u] = pos
        by_user[1, u] = neg
        by_user = by_user[:, live]
        if last is None:
            place = torch.empty(U, dtype=torch.float64, device=dev)
            place[u] = torch.arange(u.numel(), dtype=torch.float64,
                                    device=dev)
            first = (place[live].cpu().numpy(), by_user.cpu().numpy())
        else:
            repeats += (by_user == last).sum(1).cpu().numpy()
        last = by_user
    user_emb, item_emb = (t.double().mean(1).cpu().numpy()
                          for t in ego_tables(params, U))
    x = user_emb[users]
    place, (pos1, neg1) = first
    y_rows = [item_emb[r] for r in rows]
    y_all = item_emb.sum()
    y_in = np.array([item_emb[np.unique(r)].sum() for r in rows])
    y2_in = np.array([(item_emb[np.unique(r)] ** 2).sum() for r in rows])
    neg_mean = p_out * (y_all - y_in) + p_in * y_in
    neg_var = (p_out * ((item_emb ** 2).sum() - y2_in) + p_in * y2_in
               - neg_mean ** 2)
    return {
        "positive repeats": _repeat_z(repeats[0], a_pos, b_pos, epochs),
        "negative repeats": _repeat_z(repeats[1], a_neg, b_neg, epochs),
        "user row vs place": float(stats.pearsonr(x, place).pvalue),
        "user row vs positive": float(stats.pearsonr(x, pos1).pvalue),
        "user row vs negative": float(stats.pearsonr(x, neg1).pvalue),
        "positive's item row": _law_z(item_emb[pos1],
                                      np.array([y.mean() for y in y_rows]),
                                      np.array([y.var() for y in y_rows])),
        "negative's item row": _law_z(item_emb[neg1], neg_mean, neg_var),
    }


@pytest.mark.parametrize("dev", ["cpu",
                                 pytest.param("cuda", marks=pytest.mark.cuda)])
def test_fits_generator_draws_independently_across_epochs(dev):
    if dev == "cuda":
        _card()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ps = _independence(dev)
    finally:
        torch.set_num_threads(n)
    print(f"[independence] {dev}: " + ", ".join(
        f"{k} p {v:.3g}" for k, v in ps.items()))
    assert min(ps.values()) > P_MIN, ps
