"""Stage A on a device mesh: the port's ``CredModel`` and ``CredTrainer`` on
the edge-sharded operators, on gloo ranks, against the port on one device.

Worlds 2 (mesh (1, 2)) and 4 (mesh (2, 2)) each run once, at once, as
spawned CPU processes (``tests/torch_mesh_worker.py``, suite "cred", 120 s
limit), on ``synthetic_heterograph(96, 64, 800, seed=1)`` with hidden 16
(the JAX package's dry run, ``__graft_entry__.py:125-140``):

  * the full-graph forward in every view (None, "early", "late") is
    bit-equal to one device: the sharded apply equals ``SpmmOperator``'s;
  * one injected full-graph epoch (the same order of the train users, batch
    32) on the mesh is within 1e-6 (losses) and 1e-5 (parameters) of one
    device: the parameters stay replicated, every rank takes the same batch.

In process: the smoothness term's gather plans, built from the edges' ids,
equal the plans of the default operators' forward CSRs bit for bit, with
the default operators and with the mesh's (planned on the host).
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from torch_mesh_worker import spawn_ranks

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.graph.hetero import synthetic_heterograph, synthetic_heterograph_from_edges
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.models.cred_model import CredModel, build_cred_view, init_cred_params
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops.adam import adam_init
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops.gather import plan_from_direction
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.parallel.mesh import ModelAxis
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.parallel.sharded_spmm import ShardedSpmmOperator
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.train.cred_trainer import CredTrainer
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.utils.config import CredConfig

WORLDS = (2, 4)
VIEWS = (None, "early", "late")
CFG = CredConfig(hidden_dim=16, trainer_mode="full_graph", batch_size=32)


@pytest.fixture(scope="module")
def hg():
    return synthetic_heterograph(num_users=96, num_items=64, num_edges=800,
                                 seed=1)


@pytest.fixture(scope="module")
def case(hg, tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_cred")
    tr = CredTrainer(hg, CFG, device="cpu", verbose=False)
    params = init_cred_params(torch.Generator().manual_seed(1),
                              hg.user_x.shape[1], hg.item_x.shape[1], 16)
    order = np.random.default_rng(3).permutation(tr.train_users)
    inp = {"order": order,
           **{f"cred_{k}": v.numpy() for k, v in params.items()}}
    np.savez(out / "inputs_cred.npz", **inp)
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        list(pool.map(lambda w: spawn_ranks("cred", w, out), WORLDS))

    def load(world, name, rank=0):
        return np.load(out / f"w{world}_{name}_r{rank}.npy")
    return {"tr": tr, "params": params, "order": order, "load": load}


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_forward_bit_equal_to_one_device(case, hg, world):
    model = CredModel(hg, CFG, "cpu")
    with torch.no_grad():
        for view in VIEWS:
            ref = model.forward(case["params"], view)
            for name, t in zip(("cred", "h_u2", "h_i1"), ref):
                for r in range(world):
                    got = case["load"](world, f"fwd_{view}_{name}", r)
                    assert np.array_equal(got, t.numpy()), (view, name, r)


@pytest.mark.parametrize("world", WORLDS)
def test_injected_full_graph_epoch_matches_one_device(case, world):
    leaves = {k: v.clone() for k, v in case["params"].items()}
    losses = case["tr"].run_epoch(leaves, adam_init(leaves), None,
                                  order=case["order"])
    assert losses.numel() == case["tr"].steps_per_epoch > 1
    for r in range(world):
        np.testing.assert_allclose(case["load"](world, "epoch_losses", r),
                                   losses.numpy(), rtol=0, atol=1e-6)
        for k, v in leaves.items():
            got = case["load"](world, f"epoch_{k}", r)
            np.testing.assert_allclose(got, v.numpy(), rtol=1e-5, atol=1e-5)
            assert not np.allclose(got, case["params"][k].numpy())


@pytest.mark.parametrize("graph", ["small", "hub"])
@pytest.mark.parametrize("factory", ["default", "mesh"])
def test_smoothness_plans_from_the_ids_equal_the_operators(hg, factory,
                                                           graph):
    """The plans of ``h_u2[src]`` and ``h_i1[dst]`` equal those of the
    default operators' forward CSRs (user<-item, item<-user), whichever
    operators the view is built on; "hub" has a user and an item of more
    than ``LONG_ROW_EDGES`` edges (long-row pieces in both plans)."""
    if graph == "hub":
        rng = np.random.default_rng(5)
        edges = np.stack([np.concatenate([rng.integers(0, 96, 700),
                                          np.full(150, 3)]),
                          np.concatenate([np.full(200, 7),
                                          rng.integers(0, 64, 650)])])
        hg = synthetic_heterograph_from_edges(edges.astype(np.int32), 96, 64,
                                              seed=2)
    make = None if factory == "default" else functools.partial(
        ShardedSpmmOperator, mesh=ModelAxis(2, 1))
    default = build_cred_view(hg, CFG, "early", "cpu")
    view = build_cred_view(hg, CFG, "early", "cpu", operator_factory=make)
    want = (plan_from_direction(default.user_from_item.fwd),
            plan_from_direction(default.item_from_user.fwd))
    for got, ref in zip(view.smooth_plans, want):
        assert (got.num_src, got.num_dst) == (ref.num_src, ref.num_dst)
        for name in ("indptr", "src", "w"):
            assert torch.equal(getattr(got, name), getattr(ref, name)), name
        for name in ("start", "row", "rows", "first"):
            assert torch.equal(getattr(got.pieces, name),
                               getattr(ref.pieces, name)), name
        assert got.pieces.edges_per_piece == ref.pieces.edges_per_piece
        assert (got.pieces.num_long > 0) == (graph == "hub")
