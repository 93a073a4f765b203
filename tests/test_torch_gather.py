"""The row gathers' segment-sum backward (``ops/gather.py``) against the JAX
package's gathers and against numpy.

* Gradients of ``gather_rows`` equal ``jax.grad`` of the JAX package's
  ``smoothness_loss`` (XLA's scatter-add) within rtol / atol 1e-5 (fp32 sums
  in another order), on ``small_graph`` and on a hub graph whose rows have
  hundreds of duplicates, with long rows cut at 8 and at 64 ids, for plans
  taken from an operator direction and for plans built in a batch.
* The plain backward equals the two-level numpy sum (each row in id order;
  a row of more than L ids in L-id pieces, added in piece order) bit for
  bit, in fp32 and bf16.
* ``gather_plans`` builds the same plans as ``CsrDirection.from_edges``
  over the ids; a plan that does not fit the gather raises; a plan over a
  tail-padded row count gathers from the exact rows, and its gradient is
  the padded gradient's leading rows.
* Every row gather with a gradient in a Stage-B step and in a Stage-A
  full-graph step runs its backward through the segment-sum (counted).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.models import losses as JL
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.models import losses as TL
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops import gather, spmm_cuda
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops.spmm import CsrDirection

H = 16
LS = [8, 64]


def _hub_edges(seed=0, U=70, I=40, E=1500):
    """Edges with a hub user of 520 and a hub item of 610 duplicates."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, U, E)
    dst = rng.integers(0, I, E)
    src[:520], dst[520:1130] = 5, 7
    o = rng.permutation(E)
    return src[o], dst[o], U, I


def _edges(name, small_graph):
    if name == "hub":
        return _hub_edges()
    src, dst = small_graph.train_edges
    return (np.asarray(src, np.int64), np.asarray(dst, np.int64),
            small_graph.num_users, small_graph.num_items)


def _host_plan(idx, N, L):
    """The plan by definition: the ids as the destinations of edges whose
    sources are the edge ids, unit weights."""
    E = idx.size
    return CsrDirection.from_edges(np.arange(E), idx, np.ones(E), E, N,
                                   "cpu", L)


def _plans(kind, src, dst, U, I, L):
    if kind == "batch":
        return (gather.gather_plans(torch.as_tensor(src)[None], U, L)[0],
                gather.gather_plans(torch.as_tensor(dst)[None], I, L)[0])
    # Stage A's route: the operators' forward CSRs (user_from_item has the
    # users as destinations, item_from_user the items)
    w = np.ones(src.size)
    return (gather.plan_from_direction(
                CsrDirection.from_edges(dst, src, w, I, U, "cpu", L)),
            gather.plan_from_direction(
                CsrDirection.from_edges(src, dst, w, U, I, "cpu", L)))


@pytest.mark.parametrize("kind", ["direction", "batch"])
@pytest.mark.parametrize("L", LS)
@pytest.mark.parametrize("graph", ["small_graph", "hub"])
def test_gradient_matches_jax_smoothness(small_graph, graph, L, kind):
    src, dst, U, I = _edges(graph, small_graph)
    rng = np.random.default_rng(3)
    hs = rng.normal(size=(U, H)).astype(np.float32)
    hd = rng.normal(size=(I, H)).astype(np.float32)
    w = rng.uniform(-0.2, 1.0, src.size).astype(np.float32)
    jv, jg = jax.value_and_grad(
        lambda a, b: JL.smoothness_loss(a, b, jnp.asarray(src),
                                        jnp.asarray(dst), jnp.asarray(w)),
        argnums=(0, 1))(jnp.asarray(hs), jnp.asarray(hd))

    plans = _plans(kind, src, dst, U, I, L)
    if graph == "hub":
        assert plans[0].pieces.num_long > 0 and plans[1].pieces.num_long > 0
    a = torch.as_tensor(hs).requires_grad_()
    b = torch.as_tensor(hd).requires_grad_()
    loss = TL.smoothness_loss(a, b, torch.as_tensor(src), torch.as_tensor(dst),
                              torch.as_tensor(w), plans=plans)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jv), rtol=1e-6)
    for got, want in ((a.grad, jg[0]), (b.grad, jg[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def _two_level(indptr, src, g, L):
    """The summation order in numpy float32, row by row."""
    y = np.zeros((indptr.size - 1, g.shape[1]), np.float32)
    for r in range(indptr.size - 1):
        b, e = int(indptr[r]), int(indptr[r + 1])
        step = L if e - b > L else max(e - b, 1)
        acc = np.zeros(g.shape[1], np.float32)
        for p in range(b, e, step):
            part = np.zeros(g.shape[1], np.float32)
            for k in range(p, min(p + step, e)):
                part = part + g[src[k]]
            acc = acc + part
        y[r] = acc
    return y


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("L", LS)
def test_plain_backward_is_the_two_level_sum(L, dtype):
    idx, _, N, _ = _hub_edges(1)
    dt = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]
    plan = gather.gather_plans(torch.as_tensor(idx)[None], N, L)[0]
    rng = np.random.default_rng(4)
    table = torch.as_tensor(rng.normal(size=(N, H)).astype(np.float32)
                            ).to(dt).requires_grad_()
    g = torch.as_tensor(rng.normal(size=(idx.size, H)).astype(np.float32)
                        ).to(dt)
    out = gather.gather_rows(table, torch.as_tensor(idx), plan)
    assert torch.equal(out, table.detach()[torch.as_tensor(idx)])
    out.backward(g)
    want = _two_level(plan.indptr.numpy(), plan.src.numpy(),
                      g.float().numpy(), L)
    assert table.grad.dtype == dt
    assert torch.equal(table.grad, torch.as_tensor(want).to(dt))


def test_bf16_backward_rounds_once_unlike_jax():
    """A bf16 table's gradient rows are summed in fp32 and rounded once;
    XLA's bf16 scatter-add on the CPU rounds after every add, so on a row of
    610 duplicates the JAX gradient is further from the exact sum (a
    divergence logged in ROADMAP.md)."""
    _, idx, _, N = _hub_edges(2)
    rng = np.random.default_rng(5)
    g = torch.as_tensor(rng.normal(size=(idx.size, H)).astype(np.float32)
                        ).to(torch.bfloat16)
    exact = np.zeros((N, H))
    np.add.at(exact, idx, g.double().numpy())
    table = torch.zeros(N, H, dtype=torch.bfloat16, requires_grad=True)
    plan = gather.gather_plans(torch.as_tensor(idx)[None], N)[0]
    gather.gather_rows(table, torch.as_tensor(idx), plan).backward(g)
    got = table.grad.double().numpy()
    # within half a bf16 unit of the last place (2^-8 relative) of the exact
    # sum, plus the fp32 sum's own error
    assert (np.abs(got - exact) <= 2.0 ** -8 * np.abs(exact) + 1e-4).all()
    _, vjp = jax.vjp(lambda t: t[jnp.asarray(idx)],
                     jnp.zeros((N, H), jnp.bfloat16))
    jgot = np.asarray(vjp(jnp.asarray(g.float().numpy()).astype(
        jnp.bfloat16))[0]).astype(np.float64)
    assert np.abs(got - exact).max() <= np.abs(jgot - exact).max()


@pytest.mark.parametrize("L", [4, 8, 64])
def test_gather_plans_equal_the_host_plans(L):
    """Steps with a hub, with no long row, with runs of exactly L and L+1
    ids, all of one id, and an empty table row range."""
    rng = np.random.default_rng(6)
    N, E = 30, 160
    steps = [np.concatenate([np.full(100, 4), rng.integers(0, N, 60)]),
             rng.permutation(np.arange(E) % N),
             np.concatenate([np.full(L, 2), np.full(L + 1, 9),
                             rng.integers(10, N, E - 2 * L - 1)]),
             np.full(E, 29)]
    ids = np.stack([rng.permutation(s) for s in steps])
    plans = gather.gather_plans(torch.as_tensor(ids), N, L)
    assert len(plans) == len(steps)
    for s, p in enumerate(plans):
        want = _host_plan(ids[s], N, L)
        for f in ("indptr", "src", "w"):
            assert torch.equal(getattr(p, f), getattr(want, f)), (s, f)
        assert (p.num_src, p.num_dst) == (E, N)
        assert p.pieces.indptr is p.indptr
        assert p.pieces.edges_per_piece == L
        for f in ("start", "row", "rows", "first"):
            assert torch.equal(getattr(p.pieces, f),
                               getattr(want.pieces, f)), (s, f)
    # the direction route gives the same plan
    d = CsrDirection.from_edges(rng.integers(0, 5, E), ids[0],
                                rng.normal(size=E), 5, N, "cpu", L)
    p = gather.plan_from_direction(d)
    want = _host_plan(ids[0], N, L)
    assert p.indptr is d.indptr and p.pieces is d.pieces
    assert torch.equal(p.src, want.src) and torch.equal(p.w, want.w)


def test_a_plan_that_does_not_fit_raises():
    idx = torch.as_tensor(np.random.default_rng(7).integers(0, 20, 50))
    plan = gather.gather_plans(idx[None], 20)[0]
    table = torch.randn(20, 4, requires_grad=True)
    with pytest.raises(ValueError, match="the plan gathers 50 ids"):
        gather.gather_rows(table, idx[:49], plan)
    with pytest.raises(ValueError, match="from 20 rows"):
        gather.gather_rows(torch.randn(21, 4), idx, plan)
    with pytest.raises(ValueError):
        gather.gather_rows(table, idx.view(5, 10), plan)
    with pytest.raises(ValueError, match="outside"):
        gather.gather_plans(idx[None], 19)
    with pytest.raises(ValueError, match=r"\(S, E\)"):
        gather.gather_plans(idx, 20)
    with pytest.raises(ValueError, match="no sort order"):
        gather.plan_from_direction(plan)
    # without a plan: the stock gather
    assert torch.equal(gather.gather_rows(table, idx), table[idx])


def _count_segment_sums(monkeypatch):
    calls = []

    def counted(*a, **kw):
        assert kw["kernel"] is spmm_cuda.GATHER_KERNEL
        calls.append(a[3].shape)
        return spmm_cuda.segment_spmm(*a, **kw)

    monkeypatch.setattr(gather, "segment_spmm", counted)
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_padded_plan_on_the_exact_rows(dtype):
    rng = np.random.default_rng(9)
    idx = torch.as_tensor(rng.integers(0, 20, 50))
    plan = gather.gather_plans(idx[None], 24)[0]       # 4 pad rows
    table = torch.as_tensor(rng.standard_normal((20, 4)), dtype=dtype)
    padded = torch.cat([table, torch.zeros(4, 4, dtype=dtype)])
    ct = torch.as_tensor(rng.standard_normal((50, 4)), dtype=dtype)
    a = table.clone().requires_grad_()
    p = padded.clone().requires_grad_()
    ra, rp = gather.gather_rows(a, idx, plan), gather.gather_rows(p, idx, plan)
    assert torch.equal(ra, table[idx]) and torch.equal(rp, table[idx])
    (ga,), (gp,) = (torch.autograd.grad(r, t, ct) for r, t in ((ra, a),
                                                              (rp, p)))
    assert ga.shape == (20, 4) and gp.shape == (24, 4)
    assert torch.equal(ga, gp[:20]) and not gp[20:].any()


@pytest.mark.parametrize("preset,kw,per_step", [
    ("cu_message", {}, 10), ("vanilla", {}, 10),
    ("cu_message", {"propagation_schedule": "per_epoch"}, 4),
    ("cu_message", {"spmm_precision": "bf16"}, 10)],
    ids=["split", "joint", "per_epoch", "bf16"])
def test_stage_b_step_gathers_run_the_segment_sum(small_graph, monkeypatch,
                                                  preset, kw, per_step):
    """A K=3 step: K+1 user and K+1 item gathers of the propagation (or the
    two cached-table gathers under per_epoch) and the two ego gathers; the
    kernel path and backend="torch" give the same epoch."""
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.configs.presets import get_preset
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.train.trainer import RecTrainer
    cfg = get_preset(preset).replace(batch_size=64, emb_dim=8, **kw)
    cred = np.random.default_rng(0).uniform(0.2, 1, small_graph.num_users)
    tr = RecTrainer(cfg, small_graph, cred=cred.astype(np.float32),
                    device="cpu", verbose=False)
    params, opt, gen = tr.init_state()
    batches = tr.draw_epoch(gen)
    calls = _count_segment_sums(monkeypatch)
    losses = tr.run_epoch(params, opt, batches)
    nb = batches[0].shape[0]
    assert len(calls) == per_step * nb and torch.isfinite(losses).all()
    # one step without injected plans builds its own
    del calls[:]
    tr.train_step(params, opt, *(b[0] for b in batches),
                  tr._epoch_cache(params))
    assert len(calls) == per_step


def test_stage_a_full_graph_step_gathers_run_the_segment_sum(monkeypatch):
    """Five a step: the score and both views' user tables at the seeds, and
    the smoothness term's two edge gathers."""
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.graph.hetero import synthetic_heterograph
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.train.cred_trainer import CredTrainer
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.utils.config import CredConfig
    hg = synthetic_heterograph(num_users=80, num_items=50, num_edges=900,
                               seed=1)
    cfg = CredConfig(trainer_mode="full_graph", hidden_dim=8, batch_size=16)
    tr = CredTrainer(hg, cfg, device="cpu", verbose=False)
    plans = tr.model.views["early"].smooth_plans
    assert torch.equal(plans[0].indptr,
                       tr.model.views["early"].user_from_item.fwd.indptr)
    params, opt, gen = tr.init_state()
    calls = _count_segment_sums(monkeypatch)
    tr.run_epoch(params, opt, gen)
    # the seed rows (the score, then both views' user tables) and the
    # smoothness term's two gathers of every edge
    B, E = tr.batch_size, hg.num_edges
    step = [(B, 8), (B, 8), (E, 8), (E, 8), (B, 1)]
    assert sorted(tuple(c) for c in calls) == \
        sorted(step * tr.steps_per_epoch)


@pytest.mark.cuda
@pytest.mark.parametrize("L", LS)
def test_kernel_bit_equal_to_cpu_plain_on_card(L):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py phase 2 runs this "
                    "comparison at the main path's shapes)")
    idx, _, N, _ = _hub_edges(8)
    plan = gather.gather_plans(torch.as_tensor(idx, device="cuda")[None], N,
                               L)[0]
    g = torch.randn(idx.size, 64)
    for dt in (torch.float32, torch.bfloat16):
        before = spmm_cuda.GATHER_KERNEL.launches
        table = torch.zeros(N, 64, dtype=dt, device="cuda",
                            requires_grad=True)
        gather.gather_rows(table, torch.as_tensor(idx, device="cuda"),
                           plan).backward(g.to(dt).cuda())
        assert spmm_cuda.GATHER_KERNEL.launches == before + 1
        want = _two_level(plan.indptr.cpu().numpy(), plan.src.cpu().numpy(),
                          g.to(dt).float().numpy(), L)
        assert torch.equal(table.grad.cpu(), torch.as_tensor(want).to(dt))
