"""The port's sharded training (``parallel/sharding.py``, ``RecTrainer`` on a
mesh) on gloo ranks against JAX and against the port on one device.

Worlds 2 (mesh (1, 2)) and 4 (mesh (2, 2): two model groups in two data
replicas) each run once, at once, as spawned CPU processes
(``tests/torch_mesh_worker.py``, suite "train", 120 s limit), on
small_graph with D=16, K=2 and batch 64.  The counterparts of
``tests/test_sharding.py``:

  * one step of ``make_sharded_train_step`` (each data replica on its
    columns of the batch) equals JAX's ``make_sharded_train_step`` step,
    jitted unsharded: loss within 1e-5, parameters within rtol 1e-5 / atol
    1e-6; so does the port's unsharded oracle;
  * tables of a graph whose user and item counts do not split in P are
    padded to ``ceil(N/P) * P``, each rank holds ``1/P`` of the rows, the
    pad rows of the parameters and both moments stay exactly 0 through an
    epoch, and ``_trim`` gives back exact rows;
  * ``fit`` with popmix and ``lambda_fair=0.1``, and with the "per_epoch"
    schedule: per-epoch losses within 1e-5 of the port on one device and
    test recall within 1e-4 (the ranks draw the samples a one-device fit
    draws, so only the order of the sums differs);
  * a fit resumed from a checkpoint (written by rank 0) equals the
    uninterrupted one;
  * ``propagate_rows`` on span layouts equals the full propagate's rows;
  * at world 2, a fit on the (2, 1) mesh made after the (1, 2) one matches
    one device, and a later evaluation on the (1, 2) mesh ranks through its
    own live group (ROADMAP F5).

Every rank reports the same losses, metrics and tables.
"""

import functools
import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from torch_mesh_worker import spawn_ranks

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.graph.build import synthetic_bipartite_graph
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.models.lightgcn import LightGCN as JLightGCN
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.parallel.mesh import make_mesh as j_make_mesh
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.parallel.sharding import make_sharded_train_step as j_make_step
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.utils.config import RecConfig as JRecConfig
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.train.trainer import RecTrainer
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.utils.config import RecConfig

WORLDS = (2, 4)
B = 64
FIT = dict(name="mesh_e2e", propagation="gauss_seidel",
           weight_mode="cu_message", table_layout="split",
           negative_sampler="popmix", lambda_fair=0.1, emb_dim=16,
           num_layers=2, batch_size=64, epochs=4, eval_every=2,
           eval_mode="full", seed=3)
FITS = {"e2e": FIT,
        "per_epoch": dict(FIT, name="mesh_per_epoch", lambda_fair=0.0,
                          propagation_schedule="per_epoch", seed=4)}


@pytest.fixture(scope="module")
def case(small_graph, tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_train")
    rng = np.random.default_rng(2)
    U, I = small_graph.num_users, small_graph.num_items
    inp = {"cred": rng.uniform(0.3, 1.0, U).astype(np.float32),
           "step_user_emb": rng.normal(0, 0.1, (U, 16)).astype(np.float32),
           "step_item_emb": rng.normal(0, 0.1, (I, 16)).astype(np.float32),
           "step_users": rng.integers(0, U, B),
           "step_pos": rng.integers(0, I, B),
           "step_neg": rng.integers(0, I, B),
           "rows_users": rng.integers(0, U, 32),
           "rows_items": rng.integers(0, I, 32)}
    small_graph.save_npz(out / "graph.npz")
    np.savez(out / "inputs_train.npz", **inp)
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        list(pool.map(lambda w: spawn_ranks("train", w, out), WORLDS))

    def load(world, name, rank=0):
        path = out / f"w{world}_{name}_r{rank}"
        if path.with_suffix(".json").exists():
            res = json.loads(path.with_suffix(".json").read_text())
            return {int(k): v for k, v in res.items()}
        return np.load(path.with_suffix(".npy"))
    return {"inp": inp, "load": load}


@pytest.fixture(scope="module")
def single(small_graph, case):
    """The port's fits on one device, by tag."""
    cred = case["inp"]["cred"]
    return {tag: RecTrainer(RecConfig(**kw), small_graph, cred=cred,
                            device="cpu", verbose=False).fit()
            for tag, kw in FITS.items()}


@pytest.fixture(scope="module")
def jax_step(small_graph, case):
    """JAX's ``make_sharded_train_step`` step, jitted unsharded."""
    inp = case["inp"]
    cfg = JRecConfig(propagation="gauss_seidel", weight_mode="cu_message",
                     table_layout="split", emb_dim=16, num_layers=2)
    model = JLightGCN(cfg, small_graph, backend="xla")
    opt = optax.adam(1e-3)
    params = {k: jnp.asarray(inp[f"step_{k}"])
              for k in ("user_emb", "item_emb")}
    step, _, _ = j_make_step(model, opt, j_make_mesh(2, shape=(1, 2)))
    p, _, loss = jax.jit(step)(params, opt.init(params),
                               *(jnp.asarray(inp[f"step_{k}"], jnp.int32)
                                 for k in ("users", "pos", "neg")))
    return {k: np.asarray(v) for k, v in p.items()}, float(loss)


@pytest.mark.parametrize("who", ["step", "oracle"])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_step_matches_jax_unsharded(case, jax_step, world, who):
    j_params, j_loss = jax_step
    assert abs(float(case["load"](world, f"{who}_loss")) - j_loss) < 1e-5
    for k, v in j_params.items():
        np.testing.assert_allclose(case["load"](world, f"{who}_{k}"), v,
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_row_sharding_pads_non_divisible_tables(case, world):
    graph = synthetic_bipartite_graph(467, 1003, 8.0, seed=11)
    P = 2                                   # the model axis of both meshes
    for k, n in (("user_emb", graph.num_users), ("item_emb", graph.num_items)):
        assert n % P != 0
        padded = -(-n // P) * P
        for r in range(world):
            ld = functools.partial(case["load"], world, rank=r)
            assert ld(f"pad_block_{k}").tolist() == [padded // P, 16]
            assert ld(f"pad_trim_{k}").tolist() == [n, 16]
            p, m, v = (ld(f"pad_{t}_{k}") for t in "pmv")
            assert p.shape == m.shape == v.shape == (padded, 16)
            for t in (p, m, v):
                assert not t[n:].any()              # exactly 0
            assert m[:n].any() and v[:n].any()      # the rest trained


def _close_fit(load, world, tag, ref, rank=0):
    losses = load(world, f"fit_{tag}_losses", rank)
    np.testing.assert_allclose(losses, [h.loss for h in ref.history],
                               rtol=0, atol=1e-5)
    metrics = load(world, f"fit_{tag}_metrics", rank)
    for K in ref.test_metrics:
        assert abs(metrics[K]["recall"] - ref.test_metrics[K]["recall"]) \
            < 1e-4, K


@pytest.mark.parametrize("tag", list(FITS))
@pytest.mark.parametrize("world", WORLDS)
def test_fit_matches_one_device(case, single, world, tag):
    _close_fit(case["load"], world, tag, single[tag])
    for k, v in single[tag].best_params.items():
        got = case["load"](world, f"fit_{tag}_{k}")
        assert got.shape == tuple(v.shape)          # exact rows
        np.testing.assert_allclose(got, v.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_resumed_fit_equals_uninterrupted(case, world):
    ld = functools.partial(case["load"], world)
    assert np.array_equal(ld("fit_resumed_losses"), ld("fit_e2e_losses")[2:])
    assert ld("fit_resumed_metrics") == ld("fit_e2e_metrics")
    for k in ("user_emb", "item_emb"):
        assert np.array_equal(ld(f"fit_resumed_{k}"), ld(f"fit_e2e_{k}"))


@pytest.mark.parametrize("world", WORLDS)
def test_chunked_backend_on_a_mesh_runs_the_csr_kernel(case, world):
    """Under ``spmm_backend="chunked"`` the mesh's operators stay the
    edge-sharded CSR ones (the JAX package's sharded operator ignores the
    backend): every local sum goes through ``segment_spmm`` as
    ``SHARDED_KERNEL``, no chunk plan runs, and the fit is the "auto" one
    bit for bit."""
    ld = functools.partial(case["load"], world)
    assert ld("chunked_csr").tolist() == [True]
    n, all_sharded, chunk_calls = ld("chunked_calls").tolist()
    assert n > 0 and all_sharded and chunk_calls == 0
    assert np.array_equal(ld("fit_chunked_losses"), ld("fit_e2e_losses")[:2])


@pytest.mark.parametrize("preset", ["cu_message", "vanilla"])
@pytest.mark.parametrize("world", WORLDS)
def test_propagate_rows_span_layout_matches_full(case, world, preset):
    rows = case["load"](world, f"rows_{preset}")
    assert np.array_equal(rows, case["load"](world, f"rows_{preset}_full"))


def test_second_mesh_in_one_process(case, single):
    """(1, 2) then (2, 1) over the same two ranks (ROADMAP F5): the fit on
    the second mesh matches one device, and evaluating its best tables on
    the first mesh again gives its test metrics."""
    _close_fit(case["load"], 2, "mesh21", single["e2e"])
    again = case["load"](2, "eval_mesh12_again")
    metrics = case["load"](2, "fit_mesh21_metrics")
    for K in metrics:
        for m in ("precision", "recall", "ndcg"):
            assert again[K][m] == pytest.approx(metrics[K][m], abs=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_reports_the_same(case, world):
    names = (["step_loss", "oracle_loss"]
             + [f"fit_{t}_{k}" for t in ("e2e", "per_epoch", "resumed")
                for k in ("losses", "metrics", "user_emb", "item_emb")]
             + [f"rows_{p}" for p in ("cu_message", "vanilla")]
             + [f"pad_{t}_{k}" for t in "pmv"
                for k in ("user_emb", "item_emb")])
    if world == 2:
        names += [f"fit_mesh21_{k}" for k in ("losses", "metrics")]
    for name in names:
        first = case["load"](world, name)
        for r in range(1, world):
            got = case["load"](world, name, r)
            if isinstance(first, dict):
                assert got == first, name
            else:
                assert np.array_equal(got, first), name
