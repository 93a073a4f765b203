"""The port's reference regression runner
(``<port>/scripts/reference_regression.py``) against the JAX package's
``scripts/reference_regression.py``.

* its ``small`` and ``ref`` graphs are array-equal to the JAX package's
  ``synthetic_bipartite_graph`` at the JAX script's arguments;
* every line of the six committed JAX logs (``runs/*_ref_scale.out``)
  matches ``chip_smoke.LOG_LINE``, and so does every line the port prints
  at ``--scale small --epochs 2 --device cpu``; ``--out`` tees the same
  text;
* the metrics JSONL has the keys of the committed JAX record of the same
  preset, plus ``card`` (null on the CPU) on the final line, and the
  ``[REGRESSION]`` line's edges/s is the JAX script's E * K * 2 * 2 * nb;
* ``--jsonl`` trains on an ingested review stream;
* overrides, ``--epochs`` and ``--cred`` reach the trainer's config;
* without ``--device cpu`` and without a card it exits non-zero.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.graph.build import synthetic_bipartite_graph as j_graph
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.data.ingest import ingest_jsonl
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.examples.end_to_end import make_demo_jsonl
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.graph.build import build_bipartite_graph
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.scripts import reference_regression as rr

ROOT = Path(__file__).resolve().parents[1]
PRESETS = ("vanilla", "cu_message", "pop_neg", "degree_aware",
           "pop_extended", "cred_eq322")
# the JAX script's graph calls (scripts/reference_regression.py:57-67)
JAX_SCALES = {"small": dict(num_users=2_000, num_items=3_000,
                            edges_per_user=16.0, seed=0, power=0.9),
              "ref": dict(num_users=58_867, num_items=261_728,
                          edges_per_user=7.9, seed=0, power=1.0)}


def _keys(rec):
    return chip_smoke._keys(rec)


@pytest.mark.parametrize("scale", ["small", "ref"])
def test_graph_equals_jax(scale):
    ours, theirs = rr.scale_graph(scale), j_graph(**JAX_SCALES[scale])
    assert (ours.num_users, ours.num_items) == (theirs.num_users,
                                                theirs.num_items)
    for split in ("train", "val", "test"):
        np.testing.assert_array_equal(ours.edges(split), theirs.edges(split))


@pytest.mark.parametrize("preset", PRESETS)
def test_jax_log_lines_match_the_format(preset):
    lines = (ROOT / "runs" / f"{preset}_ref_scale.out").read_text() \
        .splitlines()
    line_re = re.compile(chip_smoke.LOG_LINE)
    assert [ln for ln in lines if not line_re.fullmatch(ln)] == []
    assert lines[-1].startswith(f"[REGRESSION] preset={preset} epochs=400")


@pytest.fixture(scope="module")
def small_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("rr")
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        final = rr.main(["--preset", "pop_extended", "--scale", "small",
                         "--epochs", "2", "--device", "cpu", "--out",
                         str(d / "run.out"), "--metrics-jsonl",
                         str(d / "m.jsonl")])
    return {"final": final, "stdout": buf.getvalue(), "dir": d}


def test_main_prints_the_reference_format(small_run):
    text = small_run["stdout"]
    line_re = re.compile(chip_smoke.LOG_LINE)
    assert [ln for ln in text.splitlines() if not line_re.fullmatch(ln)] == []
    assert (small_run["dir"] / "run.out").read_text() == text
    lines = text.splitlines()
    assert lines[0].startswith("Loaded edges. Users=2,000 Items=3,000")
    assert lines[1] == "Using device: cpu"
    assert [ln[:8] for ln in lines if ln.startswith("Epoch")] == \
        ["Epoch 01", "Epoch 02"]
    # extended metrics on the K= lines, as the preset evaluates them
    assert any(" COV=" in ln and " SI=" in ln for ln in lines)
    # the JAX script's propagation edges: E * K * 2 * 2 * nb an epoch
    g = rr.scale_graph("small")
    E = g.train_edges.shape[1]
    nb = -(-int((g.user_csr("train").degrees() > 0).sum()) // 4096)
    wall = small_run["final"]["wall_seconds"]
    m = re.search(r"propagation_edges_per_sec=([\d,]+)", lines[-1])
    assert int(m.group(1).replace(",", "")) == pytest.approx(
        E * 3 * 2 * 2 * nb * 2 / wall, rel=1e-3, abs=1)


def test_metrics_jsonl_has_the_jax_keys(small_run):
    ours = [json.loads(ln) for ln in
            (small_run["dir"] / "m.jsonl").read_text().splitlines()]
    jax = [json.loads(ln) for ln in
           (ROOT / "runs" / "pop_extended_ref_scale_metrics.jsonl")
           .read_text().splitlines()]
    assert len(ours) == 3
    assert [_keys(r) for r in ours[:-1]] == [_keys(jax[0])] * 2
    assert _keys(ours[-1]) == {**_keys(jax[-1]), "card": None}
    assert ours[-1]["card"] is None
    assert ours[-1] == json.loads(json.dumps(small_run["final"],
                                             default=float))
    for K in ("10", "20"):
        t = ours[-1]["test"][K]
        assert all(np.isfinite(t[k]) for k in ("precision", "recall", "ndcg"))


def test_jsonl_input(tmp_path, capsys):
    make_demo_jsonl(tmp_path / "reviews.jsonl", n=600)
    final = rr.main(["--preset", "cu_message", "--jsonl",
                     str(tmp_path / "reviews.jsonl"), "--epochs", "1",
                     "--device", "cpu", "batch_size=64"])
    out = capsys.readouterr().out
    graph = build_bipartite_graph(ingest_jsonl(tmp_path / "reviews.jsonl"))
    assert out.startswith(f"Loaded edges. {graph.summary()}\n")
    assert np.isfinite(final["test"]["20"]["recall"])


def test_overrides_reach_the_config(monkeypatch, tmp_path):
    seen = {}

    class Stop(Exception):
        pass

    def fake_trainer(cfg, graph, device):
        seen.update(cfg=cfg, device=device)
        raise Stop

    monkeypatch.setattr(rr, "RecTrainer", fake_trainer)
    with pytest.raises(Stop):
        rr.main(["--preset", "cu_message", "--scale", "small", "--epochs",
                 "7", "--cred", str(tmp_path / "c.csv"), "--device", "cpu",
                 "spmm_precision=bf16", "seed=43"])
    cfg = seen["cfg"]
    assert (cfg.name, cfg.spmm_precision, cfg.seed, cfg.epochs,
            cfg.cred_csv_path) == ("cu_message", "bf16", 43, 7,
                                   str(tmp_path / "c.csv"))
    assert str(seen["device"]) == "cpu"


def test_refuses_without_a_card(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit) as e:
        rr.main(["--scale", "small", "--epochs", "1"])
    assert e.value.code != 0
    assert "--device cpu" in capsys.readouterr().err
