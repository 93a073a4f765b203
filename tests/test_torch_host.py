"""The PyTorch package's host layer against the JAX package's.

Config and presets, graph building, CSR, the four edge-weight recipes and
the npz / CSV files are numpy in both packages, so they must be equal
exactly (``np.array_equal``), not within a tolerance.
"""

import dataclasses

import numpy as np
import pytest
import torch

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.configs import presets as j_presets
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.data import cred_io as j_cred_io
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.data import ingest as j_ingest
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.graph import build as j_build
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.graph import operators as j_ops
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.train import checkpoint as j_ckpt
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.utils import config as j_config
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.configs import presets as t_presets
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.data import cred_io as t_cred_io
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.data import ingest as t_ingest
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.graph import build as t_build
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.graph import operators as t_ops
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.models.lightgcn import params_from_jax
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.train import checkpoint as t_ckpt
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.utils import config as t_config

GRAPHS = {
    "small": dict(fn="synthetic_bipartite_graph",
                  kw=dict(num_users=120, num_items=90, edges_per_user=12.0,
                          seed=7, power=0.8)),
    "planted": dict(fn="synthetic_bipartite_graph_planted",
                    kw=dict(num_users=150, num_items=200, edges_per_user=6.0,
                            seed=3, coarse_clusters=4, fine_per_coarse=4)),
}


def _graphs(kind):
    spec = GRAPHS[kind]
    return (getattr(j_build, spec["fn"])(**spec["kw"]),
            getattr(t_build, spec["fn"])(**spec["kw"]))


@pytest.mark.parametrize("cls", ["RecConfig", "IngestConfig", "CredConfig"])
def test_config_fields_and_defaults_equal(cls):
    j, t = getattr(j_config, cls)(), getattr(t_config, cls)()
    assert [f.name for f in dataclasses.fields(j)] == \
        [f.name for f in dataclasses.fields(t)]
    assert j.to_dict() == t.to_dict()


def test_presets_equal():
    assert sorted(j_presets.PRESETS) == sorted(t_presets.PRESETS)
    for name, cfg in j_presets.PRESETS.items():
        assert t_presets.get_preset(name).to_dict() == cfg.to_dict(), name


def test_spmm_backend_values():
    t_config.RecConfig(spmm_backend="torch").validate()
    for bad in ("xla", "pallas"):
        with pytest.raises(AssertionError):
            t_config.RecConfig(spmm_backend=bad).validate()


@pytest.mark.parametrize("kind", sorted(GRAPHS))
def test_graph_edges_and_csr_equal(kind):
    jg, tg = _graphs(kind)
    assert (jg.num_users, jg.num_items) == (tg.num_users, tg.num_items)
    for split in ("train", "val", "test"):
        assert np.array_equal(jg.edges(split), tg.edges(split))
        for side in ("user_csr", "item_csr"):
            jc, tc = getattr(jg, side)(split), getattr(tg, side)(split)
            assert np.array_equal(jc.indptr, tc.indptr)
            assert np.array_equal(jc.indices, tc.indices)
    assert np.array_equal(jg.train_item_degrees(), tg.train_item_degrees())


@pytest.mark.parametrize("kind", sorted(GRAPHS))
@pytest.mark.parametrize("mode", ["symmetric", "cred_eq322", "cu_message",
                                  "degree_aware"])
def test_weight_recipes_equal(kind, mode):
    jg, tg = _graphs(kind)
    cred = np.random.default_rng(1).uniform(0.0, 1.0, jg.num_users)
    jm = j_ops.build_edge_maps(jg, mode, cred.astype(np.float32))
    tm = t_ops.build_edge_maps(tg, mode, cred.astype(np.float32))
    jm = jm if isinstance(jm, tuple) else (jm,)
    tm = tm if isinstance(tm, tuple) else (tm,)
    assert len(jm) == len(tm)
    for a, b in zip(jm, tm):
        for f in ("src", "dst", "w"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        assert (a.num_src, a.num_dst) == (b.num_src, b.num_dst)


def test_md5_split_bucket_equal():
    for k in range(200):
        assert j_ingest.md5_split_bucket(f"u{k}", f"i{k * 7}") == \
            t_ingest.md5_split_bucket(f"u{k}", f"i{k * 7}")


def test_graph_npz_round_trip_across_packages(tmp_path):
    jg, _ = _graphs("small")
    jg.save_npz(tmp_path / "j.npz")
    tg = t_build.BipartiteGraph.load_npz(tmp_path / "j.npz")
    tg.save_npz(tmp_path / "t.npz")
    back = j_build.BipartiteGraph.load_npz(tmp_path / "t.npz")
    for split in ("train", "val", "test"):
        assert np.array_equal(back.edges(split), jg.edges(split))
    assert back.user_ids == jg.user_ids and back.item_ids == jg.item_ids


@pytest.mark.parametrize("layout", ["split", "joint"])
def test_params_npz_across_packages(tmp_path, layout):
    rng = np.random.default_rng(0)
    if layout == "split":
        params = {"user_emb": rng.normal(size=(7, 4)).astype(np.float32),
                  "item_emb": rng.normal(size=(5, 4)).astype(np.float32)}
    else:
        params = {"emb": rng.normal(size=(12, 4)).astype(np.float32)}
    j_ckpt.save_params_npz(tmp_path / "jax.npz", params)
    loaded = t_ckpt.load_params_npz(tmp_path / "jax.npz")
    carried = params_from_jax(params, "cpu")
    assert sorted(loaded) == sorted(params)
    for k in params:
        assert torch.equal(loaded[k], carried[k])
    t_ckpt.save_params_npz(tmp_path / "torch.npz", loaded)
    back = j_ckpt.load_params_npz(tmp_path / "torch.npz")
    for k in params:
        assert np.array_equal(np.asarray(back[k]), params[k])


def test_cred_csv_across_packages(tmp_path):
    jg, _ = _graphs("small")
    cred = np.random.default_rng(2).uniform(0, 1, jg.num_users)
    t_cred_io.save_credibility_csv(tmp_path / "c.csv", cred, jg.user_ids)
    a = j_cred_io.load_credibility_vector(tmp_path / "c.csv", jg.num_users,
                                          jg.user2idx, verbose=False)
    b = t_cred_io.load_credibility_vector(tmp_path / "c.csv", jg.num_users,
                                          jg.user2idx, verbose=False)
    assert np.array_equal(a, b)
