"""The port's two-stage north-star pipeline
(``<port>/scripts/two_stage_10m.py``) against the JAX package's
``scripts/two_stage_10m.py`` (imported by path), both run at a size the
script's fixed 16 x 16 planted clusters allow: 2,000 users, 4,000 items, 8
edges a user, one epoch a stage, SLAS candidates capped at 16.

* the heterograph is array-equal to JAX's ``synthetic_heterograph_from_edges``
  on the same edges;
* ``summary.json`` has the keys of JAX's (this run's and the committed
  ``runs/two_stage_10m/summary.json``), the same deterministic fields
  (edges, labelled users, mode, cap, epochs, evaluated users), and
  ``peak_hbm_gb`` null on the CPU;
* JAX's and the port's ``load_credibility_vector`` read the port's CSV to
  the same vector, one score per user;
* ``--skip-a`` reuses the CSV;
* without ``--device cpu`` and without a card it exits non-zero and names
  the flag (no fallback).
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.data.cred_io import load_credibility_vector as j_load
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.graph.hetero import synthetic_heterograph_from_edges as j_hetero
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.bench import northstar_graph
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.data.cred_io import load_credibility_vector
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.graph.hetero import synthetic_heterograph_from_edges
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.scripts import two_stage_10m

ROOT = Path(__file__).resolve().parents[1]
SIZE = ["--users", "2000", "--items", "4000", "--edges-per-user", "8",
        "--cred-epochs", "1", "--rec-epochs", "1", "--pad-deg", "16"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both scripts' summaries and output directories."""
    port_out = tmp_path_factory.mktemp("port")
    port = two_stage_10m.main(SIZE + ["--device", "cpu", "--out",
                                      str(port_out)])
    jax_out = tmp_path_factory.mktemp("jax")
    spec = importlib.util.spec_from_file_location(
        "jax_two_stage_10m", ROOT / "scripts" / "two_stage_10m.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["two_stage_10m.py", *SIZE, "--out",
                                 str(jax_out)])
        mod.main()
    return {"port": port, "port_out": port_out,
            "jax": json.loads((jax_out / "summary.json").read_text())}


@pytest.fixture(scope="module")
def graph():
    return northstar_graph(2000, 4000, 8.0)


def test_heterograph_equals_jax(graph):
    edges = np.concatenate([graph.train_edges, graph.val_edges,
                            graph.test_edges], axis=1)
    got = synthetic_heterograph_from_edges(edges, graph.num_users,
                                           graph.num_items, seed=1)
    want = j_hetero(edges, graph.num_users, graph.num_items, seed=1)
    for name in ("user_x", "user_y", "item_x", "edges", "edge_attr"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.user_ids == want.user_ids
    assert list(got.feature_keys) == list(want.feature_keys)


def test_summary_has_jax_keys(runs):
    port, jax = runs["port"], runs["jax"]
    on_disk = json.loads((runs["port_out"] / "summary.json").read_text())
    assert on_disk == json.loads(json.dumps(port))
    committed = json.loads(
        (ROOT / "runs" / "two_stage_10m" / "summary.json").read_text())
    for stage in ("stage_a", "stage_b"):
        assert set(port[stage]) == set(jax[stage]) == set(committed[stage])
        assert port[stage]["peak_hbm_gb"] is None
    assert port["device"] == "cpu" and port["card"] is None
    for k in ("edges", "labeled_users", "trainer_mode", "slas_pad_deg",
              "epochs"):
        assert port["stage_a"][k] == jax["stage_a"][k]
    assert port["stage_a"]["trainer_mode"] == "slas"
    assert port["stage_b"]["epochs"] == jax["stage_b"]["epochs"] == 1
    assert set(port["stage_b"]["test"]) == set(jax["stage_b"]["test"])
    for K, metrics in port["stage_b"]["test"].items():
        assert set(metrics) == set(jax["stage_b"]["test"][K])
        assert metrics["users_eval"] == jax["stage_b"]["test"][K]["users_eval"]
        assert all(np.isfinite(v) for v in metrics.values())
    lo, mid, hi = port["stage_a"]["cred_percentiles_p10_p50_p90"]
    assert 0.0 <= lo <= mid <= hi <= 1.0


def test_csv_reads_to_the_same_vector(runs, graph):
    csv = runs["port"]["stage_a"]["csv"]
    got = load_credibility_vector(csv, graph.num_users, graph.user2idx,
                                  verbose=False)
    want = j_load(csv, graph.num_users, graph.user2idx, verbose=False)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2000,) and got.min() == 0.0 and got.max() == 1.0
    scores = np.load(Path(csv).parent / "credibility_scores_minmax.npy")
    np.testing.assert_allclose(got, scores, atol=5e-7)


def test_skip_a_reuses_the_csv(runs, tmp_path, capsys):
    out = tmp_path
    name = two_stage_10m.CSV_NAME
    (out / name).write_bytes((runs["port_out"] / name).read_bytes())
    capsys.readouterr()
    summary = two_stage_10m.main(SIZE + ["--device", "cpu", "--skip-a",
                                         "--out", str(out)])
    assert summary["stage_a"] == {
        "csv": str(out / name),
        "note": "reused (--skip-a)"}
    assert summary["stage_b"]["epochs"] == 1
    assert "used=2,000 skipped_not_in_graph=0" in capsys.readouterr().out


def test_without_a_card_exits_and_names_the_flag(monkeypatch, capsys,
                                                 tmp_path):
    monkeypatch.setattr(two_stage_10m.torch.cuda, "is_available",
                        lambda: False)
    with pytest.raises(SystemExit) as e:
        two_stage_10m.main(SIZE + ["--out", str(tmp_path)])
    assert e.value.code != 0
    assert "--device cpu" in capsys.readouterr().err
    assert not any(tmp_path.iterdir())
