"""The sharded SpMM's host planning against JAX's, element for element.

``balanced_spans``, the ``SpanLayout`` maps, both modes of ``_plan_dir``,
the choice "auto" makes and the operator's ``stats`` must equal the JAX
package's for model sizes P in {1, 2, 3, 4, 8}, on small_graph's and a
zipf graph's cu_message maps.  The port plans from a ``ModelAxis`` alone
(no process group); each rank keeps only its own row of the stacked plan,
as a CSR of its real edges.
"""

import numpy as np
import pytest
import torch

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.graph.build import synthetic_bipartite_graph
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.graph.operators import message_edge_maps
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.parallel import sharded_spmm as j_ss
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.parallel.mesh import make_mesh as j_make_mesh
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.graph.operators import EdgeMap
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.parallel import sharded_spmm as t_ss
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.parallel.mesh import ModelAxis, factor_mesh

SIZES = (1, 2, 3, 4, 8)
GRAPHS = ("small", "zipf")


@pytest.fixture(scope="module")
def graphs(small_graph):
    zipf = synthetic_bipartite_graph(num_users=2000, num_items=6000,
                                     edges_per_user=10.0, seed=3, power=1.0)
    out = {}
    for name, g in (("small", small_graph), ("zipf", zipf)):
        cred = np.random.default_rng(1).uniform(0.2, 1.0, g.num_users)
        out[name] = [EdgeMap(src=np.asarray(m.src), dst=np.asarray(m.dst),
                             w=np.asarray(m.w), num_src=m.num_src,
                             num_dst=m.num_dst)
                     for m in message_edge_maps(g, cred.astype(np.float32))]
    return out


def _j_mesh(P):
    return j_make_mesh(P, shape=(1, P))


def _layouts(em, P):
    """(JAX, port) source and destination layouts of one map."""
    out = []
    for n, ids in ((em.num_src, em.src), (em.num_dst, em.dst)):
        jb = j_ss.balanced_spans(np.bincount(ids, minlength=n), P)
        tb = t_ss.balanced_spans(np.bincount(ids, minlength=n), P)
        assert np.array_equal(jb, tb)
        out.append((j_ss.SpanLayout(jb, _j_mesh(P)),
                    t_ss.SpanLayout(tb, ModelAxis(P))))
    return out


def test_factor_mesh_equals_jax():
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.parallel.mesh import factor_mesh as j_factor
    for n in range(1, 33):
        assert factor_mesh(n) == j_factor(n)


@pytest.mark.parametrize("P", SIZES)
@pytest.mark.parametrize("graph", GRAPHS)
def test_spans_and_layout_maps_equal_jax(graphs, graph, P):
    for em in graphs[graph]:
        for jl, tl in _layouts(em, P):
            assert (tl.P, tl.rows_max, tl.padded_rows, tl.num_rows) == \
                (jl.P, jl.rows_max, jl.padded_rows, jl.num_rows)
            assert np.array_equal(tl.boundaries, jl.boundaries)
            assert np.array_equal(tl.fwd, np.asarray(jl.fwd))
            assert np.array_equal(tl.inv, np.asarray(jl.inv))
            assert np.array_equal(tl.mask, np.asarray(jl.mask))
            rows = np.arange(tl.num_rows)[::3]
            assert np.array_equal(tl.slot_of(rows), jl.slot_of(rows))
            assert tl.equals(tl) and tl.equals(
                t_ss.SpanLayout(tl.boundaries.copy(), ModelAxis(P)))


@pytest.mark.parametrize("mode", ("halo", "allgather"))
@pytest.mark.parametrize("P", SIZES)
@pytest.mark.parametrize("graph", GRAPHS)
def test_plans_equal_jax(graphs, graph, P, mode):
    for em in graphs[graph]:
        (jsl, tsl), (jdl, tdl) = _layouts(em, P)
        jp = j_ss._plan_dir(em.src, em.dst, em.w, jsl, jdl, _j_mesh(P), mode)
        tp = t_ss._plan_dir(em.src, em.dst, em.w, tsl, tdl, mode)
        for field in ("src_ref", "dst_local", "w"):
            assert np.array_equal(getattr(tp, field),
                                  np.asarray(getattr(jp, field))), field
        if mode == "halo":
            assert np.array_equal(tp.send_idx, np.asarray(jp.send_idx))
        else:
            assert tp.send_idx is None and jp.send_idx is None
        assert (tp.e_max, tp.h_max, tp.pad_fraction, tp.edge_counts) == \
            (jp.e_max, jp.h_max, jp.pad_fraction, jp.edge_counts)


@pytest.mark.parametrize("P", SIZES)
@pytest.mark.parametrize("graph", GRAPHS)
def test_auto_choice_and_stats_equal_jax(graphs, graph, P):
    for em in graphs[graph]:
        for mode in ("auto", "halo", "allgather"):
            j = j_ss.ShardedSpmmOperator(em, _j_mesh(P), mode=mode)
            t = t_ss.ShardedSpmmOperator(em, ModelAxis(P), mode=mode)
            assert t.stats == j.stats
            assert t.collective_rows == j.collective_rows
            assert t.pad_fraction == j.pad_fraction


@pytest.mark.parametrize("coord", (0, 1, 3))
def test_each_rank_keeps_its_row_as_a_csr(graphs, coord):
    """Rank ``coord`` of 4 holds its real edges (pads dropped) as a CSR
    over its rows_max slots, in the plan's order, and in halo mode its own
    send lists."""
    em = graphs["zipf"][0]
    for mode in ("halo", "allgather"):
        op = t_ss.ShardedSpmmOperator(em, ModelAxis(4, coord), mode=mode)
        plan = t_ss._plan_dir(em.src, em.dst, em.w, op.src_layout,
                              op.dst_layout, mode)
        local = op.fwd
        k = plan.edge_counts[coord]
        c = local.csr
        assert torch.equal(c.src, torch.as_tensor(plan.src_ref[coord, :k]))
        assert torch.equal(c.w, torch.as_tensor(plan.w[coord, :k]))
        dst = torch.repeat_interleave(torch.arange(c.num_dst),
                                      c.indptr[1:] - c.indptr[:-1])
        assert torch.equal(dst, torch.as_tensor(
            plan.dst_local[coord, :k]).long())
        assert c.num_dst == op.dst_layout.rows_max
        if mode == "halo":
            assert c.num_src == 4 * plan.h_max
            assert torch.equal(local.send_idx, torch.as_tensor(
                plan.send_idx[coord].reshape(-1)).long())
        else:
            assert c.num_src == op.src_layout.padded_rows
            assert local.send_idx is None


def test_host_plan_cannot_exchange(graphs):
    op = t_ss.ShardedSpmmOperator(graphs["small"][0], ModelAxis(2))
    with pytest.raises(RuntimeError, match="no process group"):
        op.apply_padded(torch.zeros(op.src_layout.rows_max, 4))


def test_balanced_spans_padding_waste_on_zipf(graphs):
    """Edge-count-balanced spans keep each rank's edge padding under 20% on
    a zipf(1.0) graph (``tests/test_sharded_spmm.py``'s bound)."""
    for em in graphs["zipf"]:
        op = t_ss.ShardedSpmmOperator(em, ModelAxis(8))
        assert op.pad_fraction < 0.20, (em.num_dst, op.pad_fraction)


def test_halo_volume_below_allgather():
    rng = np.random.default_rng(2)
    em = EdgeMap(src=rng.integers(0, 4000, 8000).astype(np.int32),
                 dst=rng.integers(0, 4000, 8000).astype(np.int32),
                 w=rng.normal(size=8000).astype(np.float32),
                 num_src=4000, num_dst=4000)
    halo = t_ss.ShardedSpmmOperator(em, ModelAxis(8), mode="halo")
    ag = t_ss.ShardedSpmmOperator(em, ModelAxis(8), mode="allgather")
    assert halo.collective_rows < ag.collective_rows


def test_auto_mode_records_true_halo_h_max():
    """"auto" keeps the considered halo plan's h_max where allgather won
    (the built allgather plan's own h_max is a placeholder 1)."""
    rng = np.random.default_rng(3)
    em = EdgeMap(src=rng.integers(0, 67, 700).astype(np.int32),
                 dst=rng.integers(0, 93, 700).astype(np.int32),
                 w=rng.normal(size=700).astype(np.float32),
                 num_src=67, num_dst=93)
    auto = t_ss.ShardedSpmmOperator(em, ModelAxis(8), mode="auto")
    halo = t_ss.ShardedSpmmOperator(em, ModelAxis(8), mode="halo")
    for d in ("fwd", "bwd"):
        assert auto.stats[d]["halo_h_max_considered"] == \
            halo.stats[d]["h_max"] == halo.stats[d]["halo_h_max_considered"]
    assert auto.stats["fwd_mode"] == "allgather"
    assert auto.stats["fwd"]["h_max"] == 1
    assert auto.stats["fwd"]["halo_h_max_considered"] > 1


def test_training_under_a_mesh_is_not_ported(small_graph):
    """Training under a mesh is ported (``parallel/sharding.py``, run on
    gloo ranks by ``tests/test_torch_sharding.py``).  On a host-planning
    ``ModelAxis``, which has no process group, the trainer plans its
    operators and shards its tables, and ``fit`` and ``propagate_rows``
    raise at their first collective, naming the missing group."""
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.configs.presets import get_preset
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.models.lightgcn import init_params
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.train.trainer import RecTrainer
    cfg = get_preset("cu_message").replace(emb_dim=8)
    tr = RecTrainer(cfg, small_graph, device="cpu", verbose=False,
                    mesh=ModelAxis(1))
    assert tr.model.item_from_user.padded_chain
    blocks = tr.init_state()[0]
    assert {k: tuple(v.shape) for k, v in blocks.items()} == {
        "user_emb": (small_graph.num_users, 8),
        "item_emb": (small_graph.num_items, 8)}
    with pytest.raises(RuntimeError, match="no process group"):
        tr.fit(epochs=1)
    params = init_params(torch.Generator().manual_seed(0), cfg,
                         small_graph.num_users, small_graph.num_items)
    with pytest.raises(RuntimeError, match="no process group"):
        tr.model.propagate_rows(params, torch.arange(2), torch.arange(2))
