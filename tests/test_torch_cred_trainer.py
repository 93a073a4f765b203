"""The PyTorch package's Stage-A trainer against the JAX package's.

The labelled split comes from ``np.random.default_rng(seed)`` in both, so
it is equal array for array.  One epoch in each mode, from the same numpy
parameters and the same user order (the train-user count is not a multiple
of the batch, so the last batch is padded and masked), is held against a
jitted JAX loop over ``CredTrainer._loss`` with ``optax.adam``: per-step
losses and the parameters after the epoch within 1e-5.  In SLAS mode the
port draws on the JAX loop's own uniforms (the keys ``_loss_slas`` would
split), since the random streams differ.  The loss values on the JAX side
come from ``jax.jit(_loss)``: on a padded batch the eager InfoNCE formula
is NaN (``tests/test_torch_cred_losses.py``).

The rest holds ``fit`` to the JAX package's behaviour: it learns, one seed
gives bit-identical fits, the exported CSV loads through the JAX package's
Stage-B loader, and a resumed run equals an uninterrupted one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.data.cred_io import load_credibility_vector
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.data.features import compute_user_features
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.graph.hetero import build_heterograph
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.train.cred_trainer import CredTrainer as JTrainer
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.utils.config import CredConfig as JCfg
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.models.cred_model import cred_params_from_jax
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops.adam import adam_init
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.train.checkpoint import TrainCheckpointer
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.train.cred_trainer import CredTrainer, holdout_bce_auc
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.utils.config import CredConfig as TCfg

from test_features import _mk_table

MODES = ["full_graph", "slas"]
# hidden 16, batch 8 (the train split below is not a multiple of it), SLAS
# neighbourhoods of 6 items x 5 users
SMALL = dict(hidden_dim=16, batch_size=8, lr=1e-2, k_item_neigh=6,
             k_user_neigh=5)


@pytest.fixture(scope="module")
def hg():
    """60 users, 43 labelled (24 genuine): a train split of 34, not a
    multiple of the batch of 8."""
    rng = np.random.default_rng(9)
    table = _mk_table(rng, U=60, I=30, N=700)
    helpful_p = rng.uniform(0, 1, 60)[table.uidx]
    table.helpful_vote = np.where(rng.random(700) < helpful_p,
                                  rng.integers(6, 20, 700), 0).astype(np.float32)
    return build_heterograph(table, compute_user_features(table))


def _mk(hg, mode, **kw):
    cfg = TCfg(trainer_mode=mode, **{**SMALL, **kw})
    return CredTrainer(hg, cfg, device="cpu", verbose=False)


@pytest.mark.parametrize("mode", MODES)
def test_split_equals_jax(hg, mode):
    for seed in (42, 7):
        j = JTrainer(hg, JCfg(trainer_mode=mode, seed=seed, **SMALL),
                     verbose=False)
        t = _mk(hg, mode, seed=seed)
        assert np.array_equal(t.train_users, j.train_users)
        assert np.array_equal(t.holdout_users, j.holdout_users)
    assert (t.model is None) == (mode == "slas")
    assert (t.slas_data is None) == (mode != "slas")


def _slas_uniforms(tr, key, B):
    """The uniforms JAX's ``_loss_slas`` draws from ``key``: per view, its
    ``slas_forward`` key split into the item and the user draw."""
    P = tr.slas_data.sampler.u_items.shape[1]
    Ki = tr.cfg.k_item_neigh
    out = []
    for k in jax.random.split(key):
        ka, kb = jax.random.split(k)
        out += [torch.as_tensor(np.array(jax.random.uniform(ka, (B, P)))),
                torch.as_tensor(np.array(jax.random.uniform(kb, (B * Ki, P))))]
    return tuple(out)


@pytest.mark.parametrize("mode", MODES)
def test_injected_epoch_matches_jax(hg, mode):
    tr = _mk(hg, mode)
    n, B = tr.train_users.size, tr.batch_size
    assert n % B != 0 and tr.steps_per_epoch == -(-n // B)
    jtr = JTrainer(hg, JCfg(trainer_mode=mode, **SMALL), verbose=False)
    params_np = {k: np.asarray(v) for k, v in
                 jtr._init_params(jax.random.PRNGKey(0)).items()}
    order = np.random.default_rng(3).permutation(tr.train_users)
    users_np, mask_np = (x.numpy() for x in tr.epoch_batches(None, order))
    keys = jax.random.split(jax.random.PRNGKey(5), users_np.shape[0])

    # the JAX loop
    mstate = jtr._model_state
    loss_fn = jax.jit(jtr._loss)
    grad_fn = jax.jit(jax.grad(jtr._loss))
    opt = optax.adam(jtr.cfg.lr)
    p = {k: jnp.asarray(v) for k, v in params_np.items()}
    state = opt.init(p)
    j_losses = []
    for s in range(users_np.shape[0]):
        args = (jnp.asarray(users_np[s], jnp.int32), jnp.asarray(mask_np[s]),
                keys[s], mstate, jtr.slas_data, jtr.user_y)
        j_losses.append(float(loss_fn(p, *args)))
        upd, state = opt.update(grad_fn(p, *args), state, p)
        p = optax.apply_updates(p, upd)

    t_params = cred_params_from_jax(params_np, "cpu")
    opt_t = adam_init(t_params)
    uniforms = ([_slas_uniforms(tr, k, B) for k in keys] if mode == "slas"
                else None)
    t_losses = tr.run_epoch(t_params, opt_t, None, order, uniforms)
    assert opt_t.count == users_np.shape[0]
    assert np.isfinite(j_losses).all() and torch.isfinite(t_losses).all()
    np.testing.assert_allclose(t_losses.numpy(), j_losses, rtol=0, atol=1e-5)
    for k in params_np:
        np.testing.assert_allclose(t_params[k].numpy(), np.asarray(p[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
        assert not np.allclose(params_np[k], np.asarray(p[k]))  # it trained


def test_epoch_batches_pad_and_mask(hg):
    tr = _mk(hg, "slas")
    users, mask = tr.epoch_batches(torch.Generator().manual_seed(0))
    n = tr.train_users.size
    assert users.shape == mask.shape == (tr.steps_per_epoch, tr.batch_size)
    flat = users.reshape(-1)
    assert int(mask.sum()) == n and bool(mask.reshape(-1)[:n].all())
    assert sorted(flat[:n].tolist()) == tr.train_users.tolist()
    assert bool((flat[n:] == 0).all())
    with pytest.raises(ValueError, match="order"):
        tr.epoch_batches(None, tr.train_users[:-1])


@pytest.mark.parametrize("mode", MODES)
def test_holdout_metrics_use_the_jax_formula(hg, mode):
    """The JAX trainer's holdout metrics with its scores replaced by fixed
    ones (ties included) equal the port's formula on the same scores; the
    port's own holdout metrics are finite."""
    cfg = JCfg(trainer_mode="slas", **SMALL)
    jtr = JTrainer(hg, cfg, verbose=False)
    y = hg.user_y[jtr.holdout_users]
    assert 0 < y.sum() < y.size
    rng = np.random.default_rng(0)
    for scores in (rng.uniform(0, 1, y.size).astype(np.float32),
                   rng.choice([0.2, 0.5, 0.5, 0.9], y.size).astype(np.float32)):
        jtr._slas_scores_batched = lambda *a, s=scores, **k: s
        want = jtr.holdout_metrics(None)
        got = holdout_bce_auc(y, scores)
        assert got == want
    tr = _mk(hg, mode)
    params, _, _ = tr.init_state()
    hm = tr.holdout_metrics(params)
    assert np.isfinite(hm["bce"]) and 0.0 <= hm["auc"] <= 1.0


@pytest.mark.parametrize("mode", MODES)
def test_fit_learns_and_is_bit_identical_per_seed(hg, mode):
    r1 = _mk(hg, mode).fit(epochs=12)
    r2 = _mk(hg, mode).fit(epochs=12)
    losses = [h["loss"] for h in r1.history]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert losses == [h["loss"] for h in r2.history]
    assert all(torch.equal(r1.params[k], r2.params[k]) for k in r1.params)
    assert np.array_equal(r1.cred_raw, r2.cred_raw)
    assert r1.cred_minmax.shape == (hg.num_users,)
    assert r1.cred_minmax.min() == 0.0 and r1.cred_minmax.max() == 1.0
    r3 = _mk(hg, mode, seed=1).fit(epochs=2)
    assert r3.history[0]["loss"] != r1.history[0]["loss"]


@pytest.mark.parametrize("mode", MODES)
def test_export_loads_through_jax_stage_b_loader(hg, mode, tmp_path):
    tr = _mk(hg, mode)
    res = tr.fit(epochs=2)
    paths = tr.export(res, tmp_path / "out")
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [
        "cred_model.npz", "credibility_scores_minmax.npy",
        "credibility_scores_minmax_with_user_id.csv"]
    got = load_credibility_vector(paths["csv"], hg.num_users,
                                  {u: k for k, u in enumerate(hg.user_ids)},
                                  verbose=False)
    np.testing.assert_allclose(got, res.cred_minmax, atol=2e-6)
    assert np.array_equal(np.load(paths["npy"]), res.cred_minmax)


@pytest.mark.parametrize("mode", MODES)
def test_checkpoint_resume_equals_uninterrupted_run(hg, mode, tmp_path):
    full = _mk(hg, mode).fit(epochs=5)
    ck = TrainCheckpointer(tmp_path / "ck")
    _mk(hg, mode).fit(epochs=3, checkpointer=ck)
    assert ck.latest_step() == 3
    res = _mk(hg, mode).fit(epochs=5,
                            checkpointer=TrainCheckpointer(tmp_path / "ck"),
                            resume=True)
    assert [h["epoch"] for h in res.history] == [4, 5]
    strip = lambda hs: [{k: v for k, v in h.items() if k != "seconds"}  # noqa
                        for h in hs]
    assert strip(res.history) == strip(full.history[3:])
    assert all(torch.equal(res.params[k], full.params[k]) for k in res.params)
    assert np.array_equal(res.cred_raw, full.cred_raw)


def test_default_device_is_cuda(hg):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CredTrainer(hg, TCfg())


def test_unknown_backend_raises(hg):
    with pytest.raises(ValueError, match="backend"):
        CredTrainer(hg, TCfg(), device="cpu", backend="xla")


def test_torch_backend_equals_auto_on_the_cpu(hg):
    """On CPU tensors "auto" runs the plain versions, so both backends give
    the same bits."""
    a = _mk(hg, "full_graph").fit(epochs=2)
    b = CredTrainer(hg, TCfg(trainer_mode="full_graph", **SMALL),
                    device="cpu", backend="torch", verbose=False).fit(epochs=2)
    assert [h["loss"] for h in a.history] == [h["loss"] for h in b.history]
    assert np.array_equal(a.cred_raw, b.cred_raw)
