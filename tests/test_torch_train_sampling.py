"""The PyTorch package's training samplers.

Random streams differ between the packages (threefry vs torch's
generators), so the samplers are held to their properties: the alias table
is ``np.array_equal`` to the JAX package's (it is host numpy in both);
negatives never hit a train item (the residual after 8 rounds is
(deg/I)^8 per draw, below 1e-7 on these graphs, so none is expected); and
the pop-mix draws follow ``mix * (deg+1)^gamma + (1 - mix) * uniform`` by a
chi-square test at p > 1e-4.
"""

import numpy as np
import pytest
import torch
from scipy import stats

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.ops import sampling as j_samp
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops import sampling as t_samp


def _dists():
    rng = np.random.default_rng(0)
    return {
        "uniform": np.ones(500),
        "powerlaw": np.power(rng.zipf(1.6, 3000).astype(np.float64) + 1.0,
                             0.75),
        "one_heavy": np.concatenate([[5000.0], np.ones(2000)]),
        "few_heavy": np.concatenate([np.full(4, 900.0), rng.random(5000)]),
        "point_mass": np.eye(1, 64, 17)[0] + 0.0,
    }


@pytest.mark.parametrize("name", list(_dists()))
def test_alias_table_equals_jax(name):
    prob = _dists()[name]
    ja, jl = j_samp.build_alias_table(prob)
    ta, tl = t_samp.build_alias_table(prob)
    assert np.array_equal(ta, ja) and np.array_equal(tl, jl)
    # the table reproduces the distribution exactly
    n = prob.size
    recon = ta / n
    np.add.at(recon, tl, (1.0 - ta) / n)
    np.testing.assert_allclose(recon, prob / prob.sum(), atol=1e-12)


def _csr(graph, membership):
    return t_samp.DeviceCSR.from_host(graph.user_csr("train"),
                                      graph.num_items, "cpu", membership)


def _members(graph):
    tr = graph.user_csr("train")
    return [set(tr.indices[tr.indptr[u]:tr.indptr[u + 1]].tolist())
            for u in range(graph.num_users)]


@pytest.mark.parametrize("membership", ["hash", "bsearch"])
def test_uniform_negatives_never_hit_train_items(small_graph, membership):
    csr = _csr(small_graph, membership)
    gen = torch.Generator().manual_seed(0)
    rows = torch.arange(small_graph.num_users).repeat(50)
    neg = t_samp.sample_negatives_uniform(gen, csr, rows,
                                          small_graph.num_items)
    members = _members(small_graph)
    assert neg.dtype == torch.int64 and neg.shape == rows.shape
    assert int(neg.min()) >= 0 and int(neg.max()) < small_graph.num_items
    hits = sum(int(n) in members[int(r)] for r, n in zip(rows, neg))
    assert hits == 0
    # one generator state, one draw
    again = t_samp.sample_negatives_uniform(
        torch.Generator().manual_seed(0), csr, rows, small_graph.num_items)
    assert torch.equal(neg, again)


@pytest.mark.parametrize("membership", ["hash", "bsearch"])
def test_popmix_negatives_never_hit_train_items(small_graph, membership):
    csr = _csr(small_graph, membership)
    sampler = t_samp.PopMixSampler.build(small_graph.train_item_degrees(),
                                         "cpu", mix_pop=0.7, gamma=0.75)
    gen = torch.Generator().manual_seed(1)
    rows = torch.arange(small_graph.num_users).repeat(50)
    neg = t_samp.sample_negatives_popmix(gen, csr, rows, sampler)
    members = _members(small_graph)
    hits = sum(int(n) in members[int(r)] for r, n in zip(rows, neg))
    assert hits == 0


def test_popmix_frequencies_match_the_mixture():
    rng = np.random.default_rng(2)
    deg = rng.zipf(1.8, 200).clip(max=400).astype(np.int64) - 1
    mix, gamma = 0.7, 0.75
    sampler = t_samp.PopMixSampler.build(deg, "cpu", mix_pop=mix, gamma=gamma)
    pop = np.power(deg + 1.0, gamma)
    want = mix * pop / pop.sum() + (1.0 - mix) / deg.size
    n = 400_000
    draws = sampler.draw(torch.Generator().manual_seed(3), (n,), "cpu")
    counts = np.bincount(draws.numpy(), minlength=deg.size)
    chi2, p = stats.chisquare(counts, want * n)
    assert p > 1e-4, (chi2, p)


def test_popmix_fallback_when_every_candidate_is_a_member():
    """A user holding every item but one: candidates that are all members
    fall back to an unchecked uniform draw."""
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.graph.csr import CSR
    I = 6
    csr = t_samp.DeviceCSR.from_host(
        CSR(indptr=np.array([0, I], np.int64),
            indices=np.arange(I, dtype=np.int32)),
        I, "cpu")
    sampler = t_samp.PopMixSampler.build(np.ones(I, np.int64), "cpu")
    gen = torch.Generator().manual_seed(4)
    neg = t_samp.sample_negatives_popmix(gen, csr, torch.zeros(200,
                                                               dtype=torch.int64),
                                         sampler, rounds=2)
    assert neg.shape == (200,) and int(neg.max()) < I
    assert len(set(neg.tolist())) > 1
