"""The PyTorch package's Stage-A labels and features against the JAX
package's: the same numpy code, so every array and every CSV byte must be
equal, on tables from ``tests/test_features.py``'s generator and on a table
read from a small JSONL by both packages' ingest."""

import json

import numpy as np
import pytest

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.data import features as JF
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.data.ingest import ingest_jsonl as j_ingest
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.utils.config import CredConfig as JCfg
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.utils.config import IngestConfig as JIngestCfg
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.data import features as TF
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.data.ingest import ingest_jsonl as t_ingest
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.utils.config import CredConfig as TCfg

from test_features import _mk_table


def _table(seed, feature_set):
    rng = np.random.default_rng(seed)
    t = _mk_table(rng, U=30, I=20, N=500)
    if feature_set == "v1":
        t.extra["user_unique_tokens"] = rng.integers(1, 40, 30).astype(
            np.int64)
    return t


def _assert_features_equal(a, b):
    assert a.keys == b.keys
    assert a.values.dtype == b.values.dtype
    assert np.array_equal(a.values, b.values)
    for f in ("total_reviews", "helpful_reviews", "Ru", "label"):
        assert np.array_equal(getattr(a.labels, f), getattr(b.labels, f)), f


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_labels_equal_jax(seed):
    t = _table(seed, "v0")
    for th in (5, 3):
        a = JF.build_user_labels(t, JCfg(helpful_vote_threshold=th))
        b = TF.build_user_labels(t, TCfg(helpful_vote_threshold=th))
        for f in ("total_reviews", "helpful_reviews", "Ru", "label"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), (th, f)
        assert a.label_names() == b.label_names()


@pytest.mark.parametrize("feature_set", ["v0", "v1"])
@pytest.mark.parametrize("seed", [0, 3])
def test_features_equal_jax(feature_set, seed):
    t = _table(seed, feature_set)
    a = JF.compute_user_features(t, JCfg(feature_set=feature_set))
    b = TF.compute_user_features(t, TCfg(feature_set=feature_set))
    _assert_features_equal(a, b)
    assert TF.V0_FEATURE_KEYS == JF.V0_FEATURE_KEYS
    assert TF.V1_FEATURE_KEYS == JF.V1_FEATURE_KEYS


def test_v1_requires_token_union():
    t = _table(4, "v0")
    with pytest.raises(ValueError, match="corpus-level"):
        TF.compute_user_features(t, TCfg(feature_set="v1"))


@pytest.mark.parametrize("feature_set", ["v0", "v1"])
def test_csvs_equal_jax(feature_set, tmp_path):
    t = _table(5, feature_set)
    a = JF.compute_user_features(t, JCfg(feature_set=feature_set))
    b = TF.compute_user_features(t, TCfg(feature_set=feature_set))
    JF.save_labels_csv(tmp_path / "jl.csv", t, a.labels)
    TF.save_labels_csv(tmp_path / "tl.csv", t, b.labels)
    JF.save_features_csv(tmp_path / "jf.csv", t, a)
    TF.save_features_csv(tmp_path / "tf.csv", t, b)
    assert (tmp_path / "jl.csv").read_bytes() == (tmp_path / "tl.csv").read_bytes()
    assert (tmp_path / "jf.csv").read_bytes() == (tmp_path / "tf.csv").read_bytes()
    assert TF.features_to_csv_rows(t, b) == JF.features_to_csv_rows(t, a)


def test_features_from_jsonl_equal_jax(tmp_path):
    """Both packages' Python readers on one JSONL (label counters over every
    record with a user id, token hashes for v1), then labels and both
    feature sets."""
    rng = np.random.default_rng(6)
    words = ["good", "bad", "fit", "color", "broke", "value", "don't"]
    recs = []
    for k in range(300):
        r = {"user_id": f"u{rng.integers(12)}",
             "parent_asin": f"i{rng.integers(9)}",
             "rating": float(rng.integers(1, 6)),
             "timestamp": int(1.5e12 + rng.integers(0, 90) * 86_400_000),
             "helpful_vote": int(rng.choice([0, 2, 6, 9])),
             "verified_purchase": bool(rng.random() < 0.7),
             "text": " ".join(rng.choice(words, rng.integers(0, 6)))}
        if k % 37 == 0:
            r.pop("parent_asin")       # counted for labels, not an edge
        recs.append(r)
    path = tmp_path / "r.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in recs) + "\n")
    jt = j_ingest(path, JIngestCfg(jsonl_path=str(path), backend="python"),
                  collect_token_hashes=True)
    tt = t_ingest(path, collect_token_hashes=True)
    for fs in ("v0", "v1"):
        _assert_features_equal(JF.compute_user_features(jt, JCfg(feature_set=fs)),
                               TF.compute_user_features(tt, TCfg(feature_set=fs)))


@pytest.mark.parametrize("case", ["normal", "nan", "constant", "single"])
def test_gaussian_kde_equals_jax(case):
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.eval.report import _gaussian_kde as j_kde
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.eval.report import _gaussian_kde as t_kde
    rng = np.random.default_rng(8)
    x = {"normal": rng.normal(size=300), "constant": np.full(20, 2.0),
         "nan": np.where(rng.random(50) < 0.2, np.nan, rng.normal(size=50)),
         "single": np.array([1.5])}[case].astype(np.float32)
    grid = np.linspace(-3, 3, 41)
    got = t_kde(x, grid)
    assert np.array_equal(got, j_kde(x, grid))
    assert np.isfinite(got).all() and (got.any() == (case in ("normal", "nan")))
