"""The chunked backend on the port's main path against the JAX package's
``backend="pallas"`` (Pallas in interpret mode), on the same numpy inputs.

* ``LightGCN.propagate`` and ``propagate_rows`` under
  ``spmm_backend="chunked"``: symmetric / joint, bipartite_sync and
  gauss_seidel, at 1e-5 in fp32 and 2e-2 / 1e-3 in bf16 (cu_message); with
  the default blocks (R = 512: one block, one slice) and with operators of
  R = 32, T = 32 on both sides (several slices).  The padded chain engages,
  and ``propagate_rows`` equals ``propagate``'s rows bit for bit, with and
  without a step's plans.
* One injected cu_message epoch through ``RecTrainer`` (its step plans over
  the padded tables) against a jitted JAX loop on ``spmm_backend="pallas"``,
  at the tolerances of ``tests/test_torch_trainer_presets.py``; two chunked
  fits with one seed are bit-identical.
* Three full-graph Stage-A steps of ``CredTrainer(backend="chunked")``
  against JAX's ``CredTrainer(backend="pallas")`` at the tolerances of
  ``tests/test_torch_cred_trainer.py``.

The mesh keeps the CSR kernel under "chunked":
``tests/test_torch_sharding.py::test_chunked_backend_on_a_mesh_runs_the_csr_kernel``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_cred_trainer import SMALL, hg  # noqa: F401
from test_torch_trainer import FIT, _cred, _numpy_epoch

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.configs.presets import get_preset as j_preset
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.graph.build import synthetic_bipartite_graph
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.models.lightgcn import LightGCN as JLightGCN
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.ops.spmm import SpmmOperator as JOp
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.train.cred_trainer import CredTrainer as JCredTrainer
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.train.trainer import RecTrainer as JTrainer
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.utils.config import CredConfig as JCredCfg
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.utils.config import RecConfig as JRecConfig
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.configs.presets import get_preset as t_preset
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.models.cred_model import cred_params_from_jax
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.models.lightgcn import LightGCN, params_from_jax
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops.adam import adam_init
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops.gather import gather_plans
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops.segment_plan import PadLayout
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops.spmm import SpmmOperator
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.train.cred_trainer import CredTrainer
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.train.trainer import RecTrainer
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.utils.config import CredConfig as TCredCfg
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.utils.config import RecConfig as TRecConfig

COMBOS = [("symmetric", "symmetric", "joint"),
          ("bipartite_sync", "cred_eq322", "split"),
          ("gauss_seidel", "cu_message", "split")]
SMALL_R, SMALL_T = 32, 32


def _factories(blocks: str, precision: str):
    """(port, JAX) operator factories: None = the models' defaults."""
    if blocks == "default":
        return None, None
    return ((lambda em: SpmmOperator(em, "cpu", backend="chunked",
                                     precision=precision, block_rows=SMALL_R,
                                     chunk_edges=SMALL_T)),
            (lambda em: JOp(em, backend="pallas", precision=precision,
                            block_rows=SMALL_R, chunk_edges=SMALL_T)))


def _models(graph, combo, blocks, precision="fp32", D=8, K=3):
    prop, weight, layout = combo
    kw = dict(propagation=prop, weight_mode=weight, table_layout=layout,
              emb_dim=D, num_layers=K, spmm_precision=precision)
    rng = np.random.default_rng(0)
    U, I = graph.num_users, graph.num_items
    if layout == "joint":
        params = {"emb": rng.normal(0, 0.1, (U + I, D)).astype(np.float32)}
    else:
        params = {"user_emb": rng.normal(0, 0.1, (U, D)).astype(np.float32),
                  "item_emb": rng.normal(0, 0.1, (I, D)).astype(np.float32)}
    cred = rng.uniform(0.2, 1.0, U).astype(np.float32)
    tf, jf = _factories(blocks, precision)
    tm = LightGCN(TRecConfig(spmm_backend="chunked", **kw), graph, cred,
                  device="cpu", operator_factory=tf)
    jm = JLightGCN(JRecConfig(spmm_backend="pallas", **kw), graph, cred,
                   operator_factory=jf)
    return tm, jm, params


@pytest.mark.parametrize("blocks", ["default", "R32"])
@pytest.mark.parametrize("combo", COMBOS, ids=["-".join(c) for c in COMBOS])
def test_propagate_matches_jax_pallas(small_graph, combo, blocks):
    tm, jm, params = _models(small_graph, combo, blocks)
    chain = tm._padded_chain()
    assert chain is not None
    ops = (chain,) if combo[0] == "symmetric" else chain
    assert all(isinstance(o.src_layout, PadLayout) for o in ops)
    if blocks == "R32":
        assert max(len(o.fwd.plans) for o in ops) > 1
    tu, ti = tm.propagate(params_from_jax(params, "cpu"))
    ju, ji = jm.propagate({k: jnp.asarray(v) for k, v in params.items()})
    assert tu.shape == (small_graph.num_users, 8)
    assert ti.shape == (small_graph.num_items, 8)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("blocks", ["default", "R32"])
@pytest.mark.parametrize("combo", COMBOS, ids=["-".join(c) for c in COMBOS])
def test_propagate_rows_matches_jax_and_propagate(small_graph, combo, blocks):
    tm, jm, params = _models(small_graph, combo, blocks)
    rng = np.random.default_rng(3)
    users = rng.integers(0, small_graph.num_users, 40)
    items = rng.integers(0, small_graph.num_items, 50)
    tp = params_from_jax(params, "cpu")
    u_t, i_t = torch.as_tensor(users), torch.as_tensor(items)
    ru, ri = tm.propagate_rows(tp, u_t, i_t)
    ju, ji = jm.propagate_rows({k: jnp.asarray(v) for k, v in params.items()},
                               jnp.asarray(users), jnp.asarray(items))
    np.testing.assert_allclose(ru.numpy(), np.asarray(ju), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ri.numpy(), np.asarray(ji), rtol=1e-5, atol=1e-5)
    fu, fi = tm.propagate(tp)
    assert torch.equal(ru, fu[u_t]) and torch.equal(ri, fi[i_t])
    # with a step's plans into the tables the rows are gathered from
    nu, ni = tm.gather_table_rows()
    if combo[0] != "symmetric":
        assert (nu, ni) == (tm.item_from_user.src_layout.padded_rows,
                            tm.user_from_item.src_layout.padded_rows)
        assert nu > small_graph.num_users and ni > small_graph.num_items
    plans = (gather_plans(u_t[None], nu)[0], gather_plans(i_t[None], ni)[0])
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    pu, pi = tm.propagate_rows(leaves, u_t, i_t, plans)
    assert torch.equal(pu, ru) and torch.equal(pi, ri)
    # the plans' backward equals the stock gathers'
    g = torch.autograd.grad((pu.sum() + 2 * pi.sum()), list(leaves.values()))
    leaves2 = {k: v.clone().requires_grad_() for k, v in tp.items()}
    su, si = tm.propagate_rows(leaves2, u_t, i_t)
    g2 = torch.autograd.grad((su.sum() + 2 * si.sum()), list(leaves2.values()))
    for a, b in zip(g, g2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("blocks", ["default", "R32"])
def test_bf16_cu_message_matches_jax_pallas(small_graph, blocks):
    tm, jm, params = _models(small_graph, COMBOS[2], blocks, precision="bf16")
    tu, ti = tm.propagate(params_from_jax(params, "cpu"))
    ju, ji = jm.propagate({k: jnp.asarray(v) for k, v in params.items()})
    assert tu.dtype == torch.float32
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=2e-2, atol=1e-3)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=2e-2, atol=1e-3)


def test_auto_keeps_the_csr_kernel(small_graph):
    """A deliberate divergence: the JAX package's "auto" picks its Pallas
    layout on a TPU, the port's "auto" is the CSR kernel (faster on the
    H100, ``PERF.md``); the chunk layout is asked for by name."""
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops.spmm import CsrDirection
    assert TRecConfig().spmm_backend == "auto"
    tm = LightGCN(TRecConfig(propagation="gauss_seidel",
                             weight_mode="cu_message", table_layout="split",
                             emb_dim=8), small_graph, device="cpu")
    assert tm._padded_chain() is None
    for op in (tm.item_from_user, tm.user_from_item):
        assert not op.padded_chain and op.src_layout is None
        assert isinstance(op.fwd, CsrDirection)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def train_graph():
    return synthetic_bipartite_graph(num_users=150, num_items=80,
                                     edges_per_user=20.0, seed=3, power=0.6)


def _trainers(graph, blocks):
    tf, jf = _factories(blocks, "fp32")
    cfg = t_preset("cu_message").replace(spmm_backend="chunked", **FIT)
    tr = RecTrainer(cfg, graph, cred=_cred(graph), device="cpu",
                    verbose=False, operator_factory=tf)
    jcfg = j_preset("cu_message").replace(spmm_backend="pallas", **FIT)
    jtr = JTrainer(jcfg, graph, cred=_cred(graph), verbose=False,
                   operator_factory=jf)
    return tr, jtr


def _jax_epoch(jtr, params, batches):
    bundle = jtr.train_state_bundle()
    opt = optax.adam(jtr.cfg.lr)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(p)
    vg = jax.jit(jax.value_and_grad(jtr._loss_fn))
    losses = []
    for s in range(batches[0].shape[0]):
        loss, grads = vg(p, *(jnp.asarray(x[s]) for x in batches), bundle,
                         None)
        upd, state = opt.update(grads, state, p)
        p = optax.apply_updates(p, upd)
        losses.append(float(loss))
    return {k: np.asarray(v) for k, v in p.items()}, np.asarray(losses)


@pytest.mark.parametrize("blocks", ["default", "R32"])
def test_injected_epoch_matches_jax_pallas(train_graph, blocks):
    tr, jtr = _trainers(train_graph, blocks)
    assert tr.model._padded_chain() is not None
    rng = np.random.default_rng(1)
    params = {k: rng.normal(0, 0.1, tuple(v.shape)).astype(np.float32)
              for k, v in tr.init_state()[0].items()}
    batches = _numpy_epoch(train_graph, FIT["batch_size"], seed=2)
    j_params, j_losses = _jax_epoch(jtr, params, batches)

    t_params = params_from_jax(params, "cpu")
    opt = adam_init(t_params)
    t_losses = tr.run_epoch(t_params, opt,
                            tuple(torch.as_tensor(x) for x in batches))
    assert opt.count == batches[0].shape[0] == 3
    np.testing.assert_allclose(t_losses.numpy(), j_losses, rtol=0, atol=1e-6)
    for k in params:
        assert t_params[k].shape == params[k].shape      # exact rows
        np.testing.assert_allclose(t_params[k].numpy(), j_params[k],
                                   rtol=1e-5, atol=1e-5)
        assert not np.allclose(j_params[k], params[k])   # it did train


def test_step_plans_cover_the_padded_tables(train_graph):
    tr, _ = _trainers(train_graph, "default")
    users, pos, neg, _ = tr.draw_epoch(torch.Generator().manual_seed(0))
    p_u, p_i = tr.step_plans(users, pos, neg)[0]
    assert (p_u.num_dst, p_i.num_dst) == tr.model.gather_table_rows() == \
        (512, 512)


def test_pad_layout_rows_of_with_a_plan():
    # a padded table's rows through a plan over the padded rows: the stock
    # gather's values and gradient, zeros on the pad rows
    rng = np.random.default_rng(5)
    lay = PadLayout(37, 48)
    p = lay.to_padded(torch.as_tensor(rng.standard_normal((37, 8)),
                                      dtype=torch.float32))
    ids = torch.as_tensor(rng.integers(0, 37, 60))
    plan = gather_plans(ids[None], 48)[0]
    a = p.clone().requires_grad_()
    b = p.clone().requires_grad_()
    ra, rb = lay.rows_of(a, ids, plan, "torch"), lay.rows_of(b, ids)
    assert torch.equal(ra, p[ids]) and torch.equal(rb, p[ids])
    ct = torch.as_tensor(rng.standard_normal(ra.shape), dtype=torch.float32)
    (ga,), (gb,) = (torch.autograd.grad(r, t, ct) for r, t in ((ra, a),
                                                              (rb, b)))
    np.testing.assert_allclose(ga.numpy(), gb.numpy(), rtol=1e-6, atol=1e-6)
    assert ga.shape == (48, 8) and not ga[37:].any()
    with pytest.raises(ValueError):
        lay.rows_of(p[:40], ids)


def test_two_chunked_fits_are_bit_identical(train_graph):
    cfg = t_preset("cu_message").replace(spmm_backend="chunked", epochs=2,
                                         **FIT)
    a, b = (RecTrainer(cfg, train_graph, cred=_cred(train_graph),
                       device="cpu", verbose=False).fit() for _ in range(2))
    assert [h.loss for h in a.history] == [h.loss for h in b.history]
    for k in a.best_params:
        assert a.best_params[k].shape[0] in (train_graph.num_users,
                                             train_graph.num_items)
        assert torch.equal(a.best_params[k], b.best_params[k])
    assert a.test_metrics == b.test_metrics


# ---------------------------------------------------------------------------
# Stage A, full-graph mode
# ---------------------------------------------------------------------------

def test_cred_full_graph_steps_match_jax_pallas(hg):  # noqa: F811
    tr = CredTrainer(hg, TCredCfg(trainer_mode="full_graph", **SMALL),
                     device="cpu", backend="chunked", verbose=False)
    view = tr.model.views[None]
    assert view.item_from_user.backend == "chunked"
    assert tr.backend == "auto"               # gathers and Adam: kernels
    jtr = JCredTrainer(hg, JCredCfg(trainer_mode="full_graph", **SMALL),
                       backend="pallas", verbose=False)
    params_np = {k: np.asarray(v) for k, v in
                 jtr._init_params(jax.random.PRNGKey(0)).items()}
    order = np.random.default_rng(3).permutation(tr.train_users)
    users_np, mask_np = (x.numpy() for x in tr.epoch_batches(None, order))
    steps = 3

    mstate = jtr._model_state
    loss_fn = jax.jit(jtr._loss)
    grad_fn = jax.jit(jax.grad(jtr._loss))
    opt = optax.adam(jtr.cfg.lr)
    p = {k: jnp.asarray(v) for k, v in params_np.items()}
    state = opt.init(p)
    key = jax.random.PRNGKey(5)
    j_losses = []
    for s in range(steps):
        args = (jnp.asarray(users_np[s], jnp.int32), jnp.asarray(mask_np[s]),
                key, mstate, jtr.slas_data, jtr.user_y)
        j_losses.append(float(loss_fn(p, *args)))
        upd, state = opt.update(grad_fn(p, *args), state, p)
        p = optax.apply_updates(p, upd)

    t_params = cred_params_from_jax(params_np, "cpu")
    opt_t = adam_init(t_params)
    t_losses = torch.stack([
        tr.train_step(t_params, opt_t, torch.as_tensor(users_np[s]),
                      torch.as_tensor(mask_np[s])) for s in range(steps)])
    np.testing.assert_allclose(t_losses.numpy(), j_losses, rtol=0, atol=1e-5)
    for k in params_np:
        np.testing.assert_allclose(t_params[k].numpy(), np.asarray(p[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
