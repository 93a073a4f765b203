"""The port's scaling projection (``<port>/scripts/scaling_projection.py``)
against the JAX package's ``scripts/scaling_projection.py`` (imported by
path) on a small planted graph:

* ``plan_volumes`` at P = 2 and 4 equals JAX's, element for element (JAX's
  planner on the 8-device CPU mesh of ``tests/conftest.py``);
* for the same injected terms and link bandwidth, every projected number
  (collective bytes and seconds, T(P), efficiency, evaluation) equals what
  JAX's ``main`` computes;
* terms no CUDA card measured (JAX's TPU record) and terms of another
  message precision are refused; the output marks the bandwidths as not
  measured and carries none of JAX's TPU constants;
* the P=4 halo rows equal a ``sharding_report`` record of the same graph
  (whose credibility does not change them), and a record that differs is
  an error.
"""

import contextlib
import importlib.util
import inspect
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.graph.build import synthetic_bipartite_graph_planted as j_planted
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.bench import northstar_graph
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.graph.operators import build_edge_maps
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.parallel.mesh import ModelAxis
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.parallel.sharded_spmm import ShardedSpmmOperator
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.scripts import scaling_projection as sp
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.scripts import sharding_report as sr

ROOT = Path(__file__).resolve().parents[1]
SMALL = (600, 1500, 10.0)
TERMS = {"propagate_s": 0.0118, "epoch_s": 0.383, "scan_steps_s": 0.3712,
         "eval_epoch_s": 8.1, "fixed_s": 0.0, "device": "cuda",
         "card": "NVIDIA H100 80GB HBM3, 700.00 W",
         "config": "scaled_10m(planted 10M, fp32 messages, per_epoch)"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small shapes: one intra-op thread, so that this file adds no thread
    contention to the test workers running beside it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_scaling_projection", ROOT / "scripts" / "scaling_projection.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def graphs():
    jg = j_planted(*SMALL, seed=0, power=1.0, coarse_clusters=16,
                   fine_per_coarse=16, mix=(0.55, 0.25, 0.20))
    return northstar_graph(*SMALL), jg


def _main(argv, **kw):
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        return sp.main(argv, **kw)


@pytest.mark.parametrize("P", (2, 4))
def test_plan_volumes_equal_jax(graphs, jax_script, P):
    g, jg = graphs
    assert (g.train_edges == jg.train_edges).all()
    assert sp.plan_volumes(g, P) == jax_script.plan_volumes(jg, P)


def test_projection_equals_jax_arithmetic(graphs, jax_script, tmp_path,
                                          monkeypatch):
    g, jg = graphs
    terms = tmp_path / "terms.json"
    terms.write_text(json.dumps(TERMS))
    link = 450.0
    monkeypatch.setattr(jax_script, "ICI_GBPS", {P: link for P in (2, 4, 8)})
    monkeypatch.setattr(jax_script, "build_graph", lambda: jg)
    monkeypatch.setattr(sys, "argv", ["scaling_projection.py", "--terms",
                                      str(terms), "--out",
                                      str(tmp_path / "jax.json")])
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        jax_script.main()
    want = json.loads((tmp_path / "jax.json").read_text())["projections"]
    got = _main(["--terms", str(terms), "--sharding-report", "", "--out",
                 str(tmp_path / "port.json"), "--device", "cpu"],
                graph=g)["projections"]
    assert set(got) == set(want) == {"2", "4", "8"}
    for P in got:
        assert got[P]["volumes"] == want[P]["volumes"]
        for k, v in want[P].items():
            if k != "volumes":
                assert got[P][k] == pytest.approx(v, rel=1e-12), (P, k)


def test_refuses_tpu_terms_and_a_precision_mismatch(graphs, tmp_path):
    tpu = json.loads((ROOT / "runs" / "scaling_terms.json").read_text())
    with pytest.raises(ValueError, match="CUDA card"):
        sp.check_terms(tpu)
    with pytest.raises(ValueError, match="CUDA card"):
        sp.check_terms({**TERMS, "card": None})
    with pytest.raises(ValueError, match="different precision"):
        sp.check_terms({**TERMS, "config": TERMS["config"].replace(
            "fp32", "bf16")})
    sp.check_terms(TERMS)
    with pytest.raises(ValueError, match="CUDA card"):
        _main(["--terms", str(ROOT / "runs" / "scaling_terms.json"),
               "--sharding-report", "", "--out", str(tmp_path / "p.json"),
               "--device", "cpu"], graph=graphs[0])


def test_assumptions_are_stated_not_measured(graphs, tmp_path):
    terms = tmp_path / "terms.json"
    terms.write_text(json.dumps(TERMS))
    rep = _main(["--terms", str(terms), "--sharding-report", "",
                 "--link-gbps", "300", "--out", str(tmp_path / "p.json"),
                 "--device", "cpu"], graph=graphs[0])
    a = rep["assumptions"]
    assert a["HBM_GBps"] == {**sp.ASSUMPTIONS["HBM_GBps"]}
    assert a["link_GBps_per_gpu_each_way"]["value"] == 300.0
    assert not any(v["measured"] for v in (a["HBM_GBps"],
                                           a["link_GBps_per_gpu_each_way"]))
    assert "PROJECTION" in rep["label"] and rep["card"] is None
    src = inspect.getsource(sp)
    assert "819" not in src and "ICI" not in src


def test_halo_plan_does_not_depend_on_the_weights(graphs):
    """The check's premise: the sharding report's uniform(0.2, 1)
    credibility and the projection's all-ones plan the same halo rows."""
    g = graphs[0]
    ones = build_edge_maps(g, "cu_message", np.ones(g.num_users, np.float32))
    drawn = build_edge_maps(g, "cu_message", np.random.default_rng(0).uniform(
        0.2, 1.0, g.num_users).astype(np.float32))
    assert not np.array_equal(ones[0].w, drawn[0].w)
    for a, b in zip(ones, drawn):
        pa = ShardedSpmmOperator(a, ModelAxis(sp.CHECK_P), mode="halo").stats
        pb = ShardedSpmmOperator(b, ModelAxis(sp.CHECK_P), mode="halo").stats
        assert sr.record_stats(pa) == sr.record_stats(pb)


def test_halo_rows_equal_the_sharding_record(graphs, tmp_path):
    g = graphs[0]
    stats = sr.operator_stats(g, sp.CHECK_P)
    record = {"graph": sr.graph_key(g),
              "operators": {k: sr.record_stats(v) for k, v in stats.items()}}
    path = tmp_path / "sharding.json"
    path.write_text(json.dumps(record))
    terms = tmp_path / "terms.json"
    terms.write_text(json.dumps(TERMS))
    argv = ["--terms", str(terms), "--sharding-report", str(path), "--out",
            str(tmp_path / "p.json"), "--device", "cpu"]
    check = _main(argv, graph=g, report_graph=g)["sharding_report_check"]
    assert check["equal"] and check["P"] == 4
    assert "do not depend on the edge weights" in check["weights"]
    # the record's graph planned again rather than the projection's plan
    other = northstar_graph(*SMALL)
    assert _main(argv, graph=g, report_graph=other)[
        "sharding_report_check"]["equal"]
    assert set(check["operators"]) == {"item_from_user", "user_from_item"}
    record["operators"]["user_from_item"]["halo_rows"] += 4
    path.write_text(json.dumps(record))
    with pytest.raises(AssertionError, match="differ"):
        _main(argv, graph=g, report_graph=g)


def test_refuses_the_card_default_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        _main(["--out", str(tmp_path / "p.json")])
