"""The PyTorch package's native C++ JSONL reader against its Python reader
and against the JAX package's native reader.

The JSONL is the one of ``tests/test_native_ingest.py``'s ``_write_demo``
(copied): records without a rating or a user, a broken line and a line with
an invalid UTF-8 byte.  Every column, id list and label counter must be
equal, bit for bit; ``backend="auto"`` must pick the native reader when g++
builds it and the Python reader when the build fails, where
``backend="native"`` raises.
"""

import json
import shutil

import numpy as np
import pytest

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.data import ingest as j_ingest
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.utils.config import IngestConfig as JIngestCfg
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.data import ingest as t_ingest
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.data.native import ingest_native
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.utils.config import IngestConfig

COLUMNS = ("uidx", "iidx", "rating", "timestamp", "helpful_vote", "verified",
           "split", "positive", "tok_count", "uniq_tok_count")


def _write_demo(path, rng, n=800):
    with open(path, "wb") as f:
        for k in range(n):
            rec = {
                "user_id": f"user_{int(rng.integers(0, 60))}",
                "parent_asin": f"B{int(rng.integers(0, 45)):07d}",
                "rating": float(rng.integers(1, 6)),
                "timestamp": int(1.5e12 + rng.integers(0, 3e10)),
                "helpful_vote": int(rng.integers(0, 12)),
                "verified_purchase": bool(rng.integers(0, 2)),
                "title": "Great product! it's nice",
                "text": "The FIT and coölor are great don't you think "
                        * int(rng.integers(1, 3)),
                "images": [{"url": "http://x", "sizes": [1, 2]}],
            }
            if k % 50 == 0:
                rec.pop("rating")          # invalid record, has user
            if k % 71 == 0:
                rec.pop("user_id")         # invalid record, no user
            f.write(json.dumps(rec).encode() + b"\n")
        f.write(b"{broken\n")
        f.write(b'{"user_id": "u\xffx", "parent_asin": "A1", "rating": 5.0}\n')


@pytest.fixture(autouse=True)
def _compiler():
    """The native reader is built with g++: without one there is nothing to
    test (a g++ that fails to build it fails the tests)."""
    if shutil.which(ingest_native.CXX) is None:
        pytest.skip("no g++ to build the native reader")


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    p = tmp_path_factory.mktemp("native") / "d.jsonl"
    _write_demo(p, np.random.default_rng(0))
    return p


def _read(path, backend, text_stats=True):
    return t_ingest.ingest_jsonl(path, IngestConfig(jsonl_path=str(path),
                                                    backend=backend),
                                 with_text_stats=text_stats,
                                 collect_token_hashes=text_stats)


def _assert_tables_equal(a, b):
    assert a.user_ids == b.user_ids and a.item_ids == b.item_ids
    assert a.user2idx == b.user2idx and a.item2idx == b.item2idx
    for c in COLUMNS:
        x, y = getattr(a, c), getattr(b, c)
        assert x.dtype == y.dtype and np.array_equal(x, y, equal_nan=(
            c == "helpful_vote")), c
    # the native reader counts the interned users only (zeros included), the
    # Python reader every user with a record (the JAX package's test
    # compares them the same way)
    for k in ("label_total", "label_helpful"):
        for u in b.user_ids:
            assert a.extra[k].get(u, 0) == b.extra[k].get(u, 0), (k, u)
    if "user_unique_tokens" in b.extra:
        assert np.array_equal(a.extra["user_unique_tokens"],
                              b.extra["user_unique_tokens"])


@pytest.mark.parametrize("text_stats", [True, False],
                         ids=["token_stats", "no_text"])
def test_native_table_equals_python_reader(demo, text_stats):
    nat = _read(demo, "native", text_stats)
    py = _read(demo, "python", text_stats)
    assert nat.extra["backend"] == "native" and "backend" not in py.extra
    assert nat.extra["bad_lines"] == 1
    # the last line has no helpful_vote: NaN in both readers
    assert nat.num_records > 700 and np.isnan(nat.helpful_vote).sum() == 1
    _assert_tables_equal(nat, py)


def test_native_table_equals_jax_native(demo):
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.data.native import ingest_native as j_native
    try:
        j_native.load_library()
    except ImportError:
        pytest.skip("the JAX package's native library does not build here")
    j = j_ingest.ingest_jsonl(demo, JIngestCfg(jsonl_path=str(demo),
                                               backend="native"),
                              collect_token_hashes=True)
    assert j.extra["backend"] == "native"
    t = _read(demo, "native")
    _assert_tables_equal(t, j)
    assert t.extra["bad_lines"] == j.extra["bad_lines"]


def test_split_bucket_native_matches_md5(demo):
    py = _read(demo, "python")
    pairs = [("A", "B"), ("user_1", "B0000001"), ("x" * 30, "y"),
             ("ü", "日")] + [(py.user_ids[u], py.item_ids[i]) for u, i in
                             zip(py.uidx[:50], py.iidx[:50])]
    for uid, iid in pairs:
        for tp, vp in ((0.8, 0.1), (0.5, 0.25)):
            assert ingest_native.split_bucket_native(uid, iid, tp, vp) == \
                t_ingest.md5_split_bucket(uid, iid, tp, vp)


def test_library_is_built_into_the_build_directory():
    lib = ingest_native.load_library()
    path = ingest_native.library_path()
    assert path.is_file() and path.parent == ingest_native.BUILD_DIR
    assert path.parent.parent.name == "build"
    assert ingest_native.SOURCE.parent != path.parent
    assert lib is ingest_native.load_library()


def test_auto_takes_native_and_native_raises_when_the_build_fails(
        demo, tmp_path, monkeypatch):
    assert _read(demo, "auto").extra.get("backend") == "native"
    # a compiler that fails, a fresh build directory, nothing loaded yet
    monkeypatch.setattr(ingest_native, "_lib", None)
    monkeypatch.setattr(ingest_native, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(ingest_native, "CXX", "false")
    with pytest.raises(ImportError, match="native ingest library"):
        _read(demo, "native")
    auto = _read(demo, "auto")
    assert "backend" not in auto.extra
    _assert_tables_equal(auto, _read(demo, "python"))
    assert not list((tmp_path / "b").glob("*"))     # no partial library left
