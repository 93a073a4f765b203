"""The PyTorch package's Stage-B training against the JAX package's.

Random streams differ between the packages, so the parity tests inject the
same numpy parameters and the same pre-drawn ``(users, pos, neg, mask)``
batches into both: the port's ``RecTrainer.run_epoch`` against a JAX loop of
``RecTrainer._loss_fn`` + ``optax.adam`` + ``optax.apply_updates``, both
Adam states starting from zeros.  Tolerances: per-step losses within 1e-6
and the parameters after one epoch within 1e-5 (fp32 sums taken in another
order; the port's Adam folds the bias correction as the probe kernel does,
``tests/test_torch_adam.py``).

The rest holds ``fit`` to the JAX package's behaviour on the 150 x 80 graph
of ``tests/test_trainer.py``: it learns, the "per_epoch" schedule keeps the
ego term live, one seed gives bit-identical fits, ``metrics.jsonl`` has the
same layout, and a resumed run equals an uninterrupted one.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.configs.presets import get_preset as j_preset
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.graph.build import synthetic_bipartite_graph
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.train.trainer import RecTrainer as JTrainer
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.configs.presets import get_preset as t_preset
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.models.lightgcn import params_from_jax
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops.adam import adam_init
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.train.checkpoint import TrainCheckpointer
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.train.trainer import RecTrainer

FIT = dict(batch_size=64, eval_every=1, sampled_negatives=20, Ks=(5, 10))
# (preset, overrides): cu_message in both schedules, vanilla (joint table)
PARITY = [("cu_message", {}),
          ("cu_message", {"propagation_schedule": "per_epoch"}),
          ("vanilla", {})]


@pytest.fixture(scope="module")
def train_graph():
    return synthetic_bipartite_graph(num_users=150, num_items=80,
                                     edges_per_user=20.0, seed=3, power=0.6)


def _cred(graph):
    return np.random.default_rng(0).uniform(
        0.2, 1.0, graph.num_users).astype(np.float32)


def _mk(graph, preset="vanilla", **kw):
    cfg = t_preset(preset).replace(**{**FIT, **kw})
    return RecTrainer(cfg, graph, cred=_cred(graph), device="cpu",
                      verbose=False)


def _numpy_epoch(graph, B, seed):
    """One epoch's batches drawn with numpy: a permutation of the train
    users padded with user 0, a uniform positive and a uniform non-member
    negative per slot, and the validity mask."""
    rng = np.random.default_rng(seed)
    tr = graph.user_csr("train")
    users = np.nonzero(np.diff(tr.indptr) > 0)[0]
    n = users.size
    nb = -(-n // B)
    flat = np.concatenate([rng.permutation(users),
                           np.zeros(nb * B - n, np.int64)])
    pos, neg = [], []
    for u in flat:
        row = tr.indices[tr.indptr[u]:tr.indptr[u + 1]]
        pos.append(rng.choice(row))
        while True:
            j = rng.integers(graph.num_items)
            if j not in row:
                neg.append(j)
                break
    mask = np.arange(nb * B) < n
    return tuple(np.asarray(x).reshape(nb, B)
                 for x in (flat, np.asarray(pos, np.int64),
                           np.asarray(neg, np.int64), mask))


def _jax_epoch(graph, preset, kw, params, batches):
    cfg = j_preset(preset).replace(**{**FIT, **kw})
    jtr = JTrainer(cfg, graph, cred=_cred(graph), verbose=False)
    bundle = jtr.train_state_bundle()
    opt = optax.adam(cfg.lr)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(p)
    cached = None
    if cfg.propagation_schedule == "per_epoch":
        from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.models.lightgcn import ego_tables
        ue, ie = jtr.model.propagate(p, bundle["model"])
        eu, ei = ego_tables(p, graph.num_users)
        s = 1.0 / (cfg.num_layers + 1)
        cached = (jax.lax.stop_gradient(ue - s * eu),
                  jax.lax.stop_gradient(ie - s * ei))
    vg = jax.jit(jax.value_and_grad(jtr._loss_fn))
    losses = []
    users, pos, neg, mask = (jnp.asarray(x) for x in batches)
    for s in range(users.shape[0]):
        loss, grads = vg(p, users[s], pos[s], neg[s], mask[s], bundle, cached)
        upd, state = opt.update(grads, state, p)
        p = optax.apply_updates(p, upd)
        losses.append(float(loss))
    return {k: np.asarray(v) for k, v in p.items()}, np.asarray(losses)


@pytest.mark.parametrize("preset,kw", PARITY,
                         ids=["cu_message", "cu_message-per_epoch", "vanilla"])
def test_injected_epoch_matches_jax(train_graph, preset, kw):
    tr = _mk(train_graph, preset, **kw)
    rng = np.random.default_rng(1)
    params = {k: rng.normal(0, 0.1, tuple(v.shape)).astype(np.float32)
              for k, v in tr.init_state()[0].items()}
    batches = _numpy_epoch(train_graph, FIT["batch_size"], seed=2)
    j_params, j_losses = _jax_epoch(train_graph, preset, kw, params, batches)

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


def test_draw_epoch_pads_and_masks_the_last_batch(train_graph):
    tr = _mk(train_graph, "cu_message", batch_size=64)
    users, pos, neg, mask = tr.draw_epoch(tr.init_state()[2])
    n = tr.train_users.size
    assert users.shape == pos.shape == neg.shape == mask.shape == (3, 64)
    assert int(mask.sum()) == n and bool(mask.reshape(-1)[:n].all())
    flat = users.reshape(-1)
    assert sorted(flat[:n].tolist()) == sorted(tr.train_users.tolist())
    assert bool((flat[n:] == 0).all())
    tcsr = train_graph.user_csr("train")
    for u, p in zip(flat[:n].tolist(), pos.reshape(-1)[:n].tolist()):
        assert p in tcsr.indices[tcsr.indptr[u]:tcsr.indptr[u + 1]]


def test_fit_learns(train_graph):
    tr = _mk(train_graph, "vanilla")
    params, _, _ = tr.init_state()
    before = tr.evaluate(params, "val")[10]["recall"]
    res = tr.fit(epochs=25)
    assert res.best_val_recall > before + 0.05, (before, res.best_val_recall)
    assert np.isfinite(res.history[-1].loss)
    assert res.history[-1].loss < res.history[0].loss


def test_per_epoch_schedule_keeps_ego_term_live(train_graph):
    """With a cached-constant propagation the BPR term would sit at log 2;
    the live ego term must pull the loss below it."""
    res = _mk(train_graph, "vanilla",
              propagation_schedule="per_epoch").fit(epochs=25)
    assert res.history[-1].loss < 0.692, res.history[-1].loss
    assert res.history[-1].loss < res.history[0].loss - 5e-4


def test_two_fits_with_one_seed_are_bit_identical(train_graph):
    r1 = _mk(train_graph, "cu_message").fit(epochs=3)
    r2 = _mk(train_graph, "cu_message").fit(epochs=3)
    assert [h.loss for h in r1.history] == [h.loss for h in r2.history]
    for k in r1.best_params:
        assert torch.equal(r1.best_params[k], r2.best_params[k])


def test_metrics_jsonl_has_the_jax_layout(train_graph, tmp_path):
    def layout(path):
        recs = [json.loads(ln) for ln in path.read_text().splitlines()]
        return [(r["event"], sorted(r),
                 sorted(r.get("val", r.get("test", {})).get("10", {})))
                for r in recs]

    jcfg = j_preset("cu_message").replace(**FIT, out_dir=str(tmp_path / "j"),
                                          save_best=False)
    JTrainer(jcfg, train_graph, cred=_cred(train_graph),
             verbose=False).fit(epochs=2)
    _mk(train_graph, "cu_message", out_dir=str(tmp_path / "t"),
        save_best=False).fit(epochs=2)
    got = layout(tmp_path / "t" / "metrics.jsonl")
    assert got == layout(tmp_path / "j" / "metrics.jsonl")
    assert [g[0] for g in got] == ["epoch", "epoch", "test"]
    assert "recall" in got[0][2]


def test_checkpoint_resume_equals_uninterrupted_run(train_graph, tmp_path):
    full = _mk(train_graph, "cu_message").fit(epochs=5)
    ck = TrainCheckpointer(tmp_path / "ck")
    _mk(train_graph, "cu_message").fit(epochs=3, checkpointer=ck)
    assert ck.latest_step() == 3
    res = _mk(train_graph, "cu_message").fit(
        epochs=5, checkpointer=TrainCheckpointer(tmp_path / "ck"),
        resume=True)
    assert [h.epoch for h in res.history] == [4, 5]
    assert [h.loss for h in res.history] == [h.loss for h in full.history[3:]]
    assert res.best_val_recall == full.best_val_recall
    for k in full.best_params:
        assert torch.equal(res.best_params[k], full.best_params[k])
    assert res.test_metrics == full.test_metrics


def test_checkpoint_retention_and_cadence(tmp_path):
    """Keep-last-3, every 2: the first step, then every second one; at most
    three files stay, the latest among them."""
    ck = TrainCheckpointer(tmp_path / "ck", keep=3, every=2)
    saved = [e for e in range(1, 11)
             if ck.save(e, {"params": {"w": torch.ones(4, 2) * e},
                            "epoch": e})]
    ck.wait()
    assert saved == [1, 2, 4, 6, 8, 10]
    assert ck.all_steps() == [6, 8, 10]
    assert ck.latest_step() == 10
    got = ck.restore()
    assert got["epoch"] == 10 and torch.equal(got["params"]["w"],
                                              torch.full((4, 2), 10.0))
    assert ck.restore(6)["epoch"] == 6
    assert TrainCheckpointer(tmp_path / "empty").restore() is None


def test_deterministic_mode_is_scoped():
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.train.trainer import deterministic_algorithms
    before = torch.are_deterministic_algorithms_enabled()
    with deterministic_algorithms():
        assert torch.are_deterministic_algorithms_enabled()
    assert torch.are_deterministic_algorithms_enabled() == before
