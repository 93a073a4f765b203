"""The PyTorch package's heterograph against the JAX package's: the same
numpy code, so every array is equal (NaN timestamps in the same places),
and an npz written by either package loads in the other."""

import numpy as np
import pytest

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.data.features import compute_user_features as j_features
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.graph import hetero as JH
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.utils.config import CredConfig as JCfg
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.data.features import compute_user_features as t_features
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.graph import hetero as TH
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.utils.config import CredConfig as TCfg

from test_features import _mk_table

ARRAYS = ("user_x", "user_y", "item_x", "edges", "edge_attr")


def assert_hetero_equal(a, b):
    for f in ARRAYS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), f
    assert list(a.feature_keys) == list(b.feature_keys)
    assert list(a.user_ids or []) == list(b.user_ids or [])


@pytest.mark.parametrize("feature_set,graph_set", [
    ("v0", "cred7"), ("v1", "cred7"), ("v1", "all")])
def test_build_heterograph_equals_jax(feature_set, graph_set):
    rng = np.random.default_rng(11)
    t = _mk_table(rng, U=30, I=20, N=500)
    t.extra["user_unique_tokens"] = rng.integers(1, 40, 30).astype(np.int64)
    a = JH.build_heterograph(t, j_features(t, JCfg(feature_set=feature_set)),
                             graph_feature_set=graph_set)
    b = TH.build_heterograph(t, t_features(t, TCfg(feature_set=feature_set)),
                             graph_feature_set=graph_set)
    assert_hetero_equal(a, b)
    assert np.isnan(b.edge_attr[:, 3]).any()
    assert b.user_x.shape[1] == (7 if graph_set == "cred7" else 9)
    assert tuple(TH.CRED_GRAPH_FEATURE_KEYS) == tuple(JH.CRED_GRAPH_FEATURE_KEYS)


def test_unknown_graph_feature_set_raises():
    t = _mk_table(np.random.default_rng(1), U=10, I=8, N=60)
    with pytest.raises(ValueError, match="graph_feature_set"):
        TH.build_heterograph(t, t_features(t), graph_feature_set="bogus")


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_heterograph_equals_jax(seed):
    kw = dict(num_users=70, num_items=40, num_edges=500, seed=seed)
    assert_hetero_equal(JH.synthetic_heterograph(**kw),
                        TH.synthetic_heterograph(**kw))


def test_synthetic_heterograph_from_edges_equals_jax():
    rng = np.random.default_rng(2)
    edges = np.stack([rng.integers(0, 90, 700), rng.integers(0, 50, 700)])
    a = JH.synthetic_heterograph_from_edges(edges, 90, 50, seed=3)
    b = TH.synthetic_heterograph_from_edges(edges, 90, 50, seed=3)
    assert_hetero_equal(a, b)
    assert set(np.unique(b.user_y)) <= {-1, 0, 1}


def test_npz_round_trip_across_packages(tmp_path):
    hg = TH.synthetic_heterograph(num_users=50, num_items=30, num_edges=300)
    hg.save_npz(tmp_path / "t.npz")
    assert_hetero_equal(JH.HeteroGraph.load_npz(tmp_path / "t.npz"), hg)
    assert_hetero_equal(TH.HeteroGraph.load_npz(tmp_path / "t.npz"), hg)
    JH.synthetic_heterograph(num_users=50, num_items=30,
                             num_edges=300).save_npz(tmp_path / "j.npz")
    back = TH.HeteroGraph.load_npz(tmp_path / "j.npz")
    assert_hetero_equal(back, hg)
    assert (back.num_users, back.num_items, back.num_edges) == (50, 30, 300)
