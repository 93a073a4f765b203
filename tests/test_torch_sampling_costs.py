"""The port's sampler-cost probe (``<port>/probes/sampling_costs.py``), the
counterpart of the JAX package's ``scripts/probe_alias.py``, the sampling
half of ``scripts/probe_adam_sampling.py`` and the membership half of
``scripts/probe_rng_membership.py``:

* on a small graph through ``main(argv, graph=)`` the record holds every
  timing of the three JAX probes (the alias and inverse-CDF draws at each
  catalogue, the four sampling calls, ``row_contains`` at (B, 2/8/32) and
  the hash table at (B, 8)), the table's size and load, JAX's two checks
  passed, and the notes on the RBG half and the Adam half;
* both popularity draws stay in range and follow their mixture
  distribution, ``mix_pop`` p(i) ∝ (deg_i + 1)^0.75 plus the uniform rest,
  by chi-square (as ``tests/test_torch_f7_loss.py`` holds the samplers);
  the float32 CDF equals JAX's probe's table, and the items it cannot draw
  (a step of 0) are counted with their mass;
* the hash table and the binary search agree on every pair of the graph
  and on random candidates;
* without a card it refuses to run unless asked for the CPU.
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.graph.build import synthetic_bipartite_graph
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops.sampling import DeviceCSR, PopMixSampler, row_contains
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.probes import sampling_costs as sc

P_MIN = 1e-3
DRAWS = 200_000


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
    return synthetic_bipartite_graph(500, 1200, 8.0, seed=0, power=1.0)


def test_record_holds_every_jax_timing(graph, tmp_path):
    with contextlib.redirect_stdout(io.StringIO()):
        rec = sc.main(["--iters", "1", "--batch", "64", "--catalogues",
                       "3000,20000", "--out", str(tmp_path / "s.json"),
                       "--device", "cpu"], graph=graph)
    assert [(r["catalogue"], r["draw"]) for r in rec["alias"]] == [
        (3000, "alias"), (3000, "cdf32"), (20000, "alias"),
        (20000, "cdf32")]
    for r in rec["alias"]:
        assert r["in_range"] and r["draws_per_call"] == 64 * 9
        assert r["us_per_draw_batch"] > 0 and r["ns_per_draw"] > 0
        assert ("items_never_drawn" in r) == (r["draw"] == "cdf32")
    assert set(rec["sampling"]["ms"]) == {
        "sample_positives", "sample_negatives_uniform (8 rounds)",
        "row_contains (B, 8)", "randint (B, 9)"}
    assert "phases 2b and 8" in rec["sampling"]["adam"]
    m = rec["membership"]
    assert set(m["ms"]) == {"row_contains (B, 2)", "row_contains (B, 8)",
                            "row_contains (B, 32)", "hash_contains (B, 8)"}
    assert all(v > 0 for v in m["ms"].values())
    assert m["agree"] and m["members_found"]
    assert m["members_checked"] > 0 and m["positives_present"] >= 0
    t = m["hash_table"]
    assert t["pairs"] == graph.user_csr("train").nnz
    assert t["size"] == t["buckets"] * t["slots_per_bucket"]
    assert 0 < t["load"] < 1 and t["fullest_bucket"] <= t["slots_per_bucket"]
    assert "Philox" in m["rng"]
    assert rec["card"] is None and rec["clock"] == "host clock, cpu"


def test_cdf_table_equals_jax_probes():
    deg = sc.catalogue_degrees(5000)
    pop = np.power(deg.astype(np.float64) + 1.0, 0.75)
    want = jnp.asarray(np.cumsum(pop / pop.sum()), jnp.float32)
    got = sc.popularity_cdf(deg, 0.75, "cpu")
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_cdf32_losses_count_the_items_it_cannot_draw():
    # the middle item's probability (2.8e-9) is below the float32 step at
    # 0.5 (2^-24 = 6e-8): its CDF step rounds to 0
    deg = np.array([10 ** 11, 0, 10 ** 11])
    p = sc.popularity(deg, 0.75)
    assert sc.cdf32_losses(deg, 0.75) == {"items_never_drawn": 1,
                                          "mass_never_drawn": p[1]}
    gen = torch.Generator()
    gen.manual_seed(0)
    d = sc.cdf_draw(gen, sc.popularity_cdf(deg, 0.75, "cpu"), 1.0,
                    (20_000,), "cpu")
    assert set(d.tolist()) == {0, 2}
    assert sc.cdf32_losses(np.arange(50), 0.75) == {
        "items_never_drawn": 0, "mass_never_drawn": 0.0}


@pytest.mark.parametrize("draw", ("alias", "cdf32"))
def test_popularity_draws_follow_their_mixture(draw):
    I = 60
    deg = sc.catalogue_degrees(I)
    sampler = PopMixSampler.build(deg, "cpu")
    gen = torch.Generator()
    gen.manual_seed(3)
    shape = (DRAWS // 10, 10)
    if draw == "alias":
        d = sampler.draw(gen, shape, "cpu")
    else:
        d = sc.cdf_draw(gen, sc.popularity_cdf(deg, 0.75, "cpu"),
                        sampler.mix_pop, shape, "cpu")
    assert int(d.min()) >= 0 and int(d.max()) < I
    pop = np.power(deg + 1.0, 0.75)
    p = sampler.mix_pop * pop / pop.sum() + (1 - sampler.mix_pop) / I
    counts = np.bincount(d.reshape(-1).numpy(), minlength=I)
    assert stats.chisquare(counts, DRAWS * p).pvalue > P_MIN


def test_hash_and_binary_search_agree(graph):
    csr = graph.user_csr("train")
    I = graph.num_items
    bs = DeviceCSR.from_host(csr, I, "cpu", membership="bsearch")
    hm = DeviceCSR.from_host(csr, I, "cpu", membership="hash").hashmem
    rows = torch.as_tensor(np.repeat(np.arange(csr.num_rows),
                                     csr.degrees()))
    cols = torch.as_tensor(np.asarray(csr.indices, np.int64))
    assert bool(hm.contains(rows, cols).all())
    users = torch.arange(graph.num_users)
    cand = torch.as_tensor(np.random.default_rng(2).integers(
        0, I, (graph.num_users, 32)))
    a = row_contains(bs, users, cand)
    assert torch.equal(a, hm.contains(users[:, None], cand))
    assert int(a.sum()) > 0


def test_refuses_the_card_default_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit), \
            contextlib.redirect_stderr(io.StringIO()) as err:
        sc.main(["--out", str(tmp_path / "s.json")])
    assert "--device cpu" in err.getvalue()
