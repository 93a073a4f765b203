"""One injected epoch of every Stage-B preset, the port against the JAX
package (the pattern of ``tests/test_torch_trainer.py``'s
``test_injected_epoch_matches_jax``: the same numpy parameters and
``(users, pos, neg, mask)`` batches into the port's ``RecTrainer.run_epoch``
and into a JAX loop of ``RecTrainer._loss_fn`` + ``optax.adam``).

Presets: ``cred_eq322`` (synchronous bipartite, Eq 3.22 weights),
``cred_eq322_fair`` (its fairness term, ``lambda_fair=1e-2``),
``degree_aware``, ``pop_neg``, ``pop_extended``, ``vanilla_200`` and
``scaled_10m`` at reduced size (its D=128, K=4 and "per_epoch" schedule, on
the 150 x 80 graph with batch 64).  Per-step losses within 1e-6, parameters
after the epoch within 1e-5.  ``pop_extended``'s extended metric block
(coverage, popularity, credibility groups) on one set of parameters, in
full-catalogue mode, within 1e-6 of JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_trainer import FIT, _cred, _jax_epoch, _mk, _numpy_epoch

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.configs.presets import get_preset as j_preset
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.graph.build import synthetic_bipartite_graph
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.train.trainer import RecTrainer as JTrainer
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.models.lightgcn import params_from_jax
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops.adam import adam_init

PRESETS = ["cred_eq322", "cred_eq322_fair", "degree_aware", "pop_neg",
           "pop_extended", "vanilla_200", "scaled_10m"]


@pytest.fixture(scope="module")
def train_graph():
    return synthetic_bipartite_graph(num_users=150, num_items=80,
                                     edges_per_user=20.0, seed=3, power=0.6)


def _params(tr, seed=1):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(0, 0.1, tuple(v.shape)).astype(np.float32)
            for k, v in tr.init_state()[0].items()}


@pytest.mark.parametrize("preset", PRESETS)
def test_injected_epoch_matches_jax(train_graph, preset):
    tr = _mk(train_graph, preset)
    cfg = tr.cfg
    if preset == "scaled_10m":
        assert (cfg.emb_dim, cfg.num_layers, cfg.propagation_schedule) == \
            (128, 4, "per_epoch")
    if preset == "cred_eq322_fair":
        assert cfg.lambda_fair != 0.0
    params = _params(tr)
    batches = _numpy_epoch(train_graph, FIT["batch_size"], seed=2)
    j_params, j_losses = _jax_epoch(train_graph, preset, {}, params, batches)

    t_params = params_from_jax(params, "cpu")
    opt = adam_init(t_params)
    t_losses = tr.run_epoch(t_params, opt,
                            tuple(torch.as_tensor(x) for x in batches))
    assert opt.count == batches[0].shape[0] == 3
    np.testing.assert_allclose(t_losses.numpy(), j_losses, rtol=0, atol=1e-6)
    for k in params:
        np.testing.assert_allclose(t_params[k].numpy(), j_params[k],
                                   rtol=1e-5, atol=1e-5)
        assert not np.allclose(j_params[k], params[k])   # it did train


def test_pop_extended_metric_block_matches_jax(train_graph):
    kw = {"eval_mode": "full"}
    tr = _mk(train_graph, "pop_extended", **kw)
    assert tr.cfg.extended_metrics
    params = _params(tr, seed=7)
    got = tr.evaluate(params_from_jax(params, "cpu"), "test")
    jtr = JTrainer(j_preset("pop_extended").replace(**{**FIT, **kw}),
                   train_graph, cred=_cred(train_graph), verbose=False)
    want = jtr.evaluate({k: jnp.asarray(v) for k, v in params.items()},
                        "test")
    assert sorted(got) == sorted(want)
    for K in want:
        assert "cred_utility" in want[K] and "item_coverage" in want[K]
        assert sorted(got[K]) == sorted(want[K])
        for m, v in want[K].items():
            if m == "mode":
                assert got[K][m] == v
            else:
                assert got[K][m] == pytest.approx(float(v), abs=1e-6), (K, m)
