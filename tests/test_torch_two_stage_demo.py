"""The port's two-stage demo (``<port>/scripts/two_stage_demo.py``) against
the JAX package's ``scripts/two_stage_demo.py`` (imported by path).

* ``make_synthetic_reviews`` writes JAX's bytes at 3,000 lines, and so does
  ``chip_smoke.write_reviews``, which calls it;
* a tiny run (one epoch a stage) writes ``summary.json`` with the keys of
  the JAX script's (committed ``runs/two_stage/summary.json``) plus
  ``card`` and Stage A's history, scores in [0, 1] for every user, and
  Stage B reads a score for every graph user from the CSV;
* without ``--device cpu`` and without a card it exits non-zero.
"""

import contextlib
import importlib.util
import io
import json
import re
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.scripts import two_stage_demo

ROOT = Path(__file__).resolve().parents[1]
SIZE = dict(n_lines=3000, n_users=300, n_items=1000)


def test_reviews_equal_jax(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "jax_two_stage_demo", ROOT / "scripts" / "two_stage_demo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with contextlib.redirect_stdout(io.StringIO()):
        mod.make_synthetic_reviews(tmp_path / "jax.jsonl", **SIZE)
        two_stage_demo.make_synthetic_reviews(tmp_path / "port.jsonl", **SIZE)
        chip_smoke.write_reviews(tmp_path / "smoke.jsonl", 3000, 300, 1000)
    jax = (tmp_path / "jax.jsonl").read_bytes()
    assert jax.count(b"\n") == 3000
    assert (tmp_path / "port.jsonl").read_bytes() == jax
    assert (tmp_path / "smoke.jsonl").read_bytes() == jax


def test_tiny_run_writes_the_jax_summary(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = two_stage_demo.main([
            "--lines", "3000", "--users", "300", "--items", "1000",
            "--cred-epochs", "1", "--rec-epochs", "1", "--pad-deg", "16",
            "--device", "cpu", "--out", str(tmp_path)])
    written = json.loads((tmp_path / "summary.json").read_text())
    jax = json.loads((ROOT / "runs" / "two_stage" / "summary.json")
                     .read_text())
    assert set(written) == set(jax) | {"card", "stage_a"}
    assert written["card"] is None
    assert set(written["test"]) == set(jax["test"])
    assert set(written["test"]["20"]) == set(jax["test"]["20"])
    assert written == json.loads(json.dumps(summary, default=float))
    hist = written["stage_a"]["history"]
    assert [h["epoch"] for h in hist] == [1]
    assert set(hist[0]) == {"epoch", "loss", "holdout_bce", "holdout_auc",
                            "seconds"}
    assert written["stage_a"]["slas_pad_deg"] == 16
    scores = np.load(tmp_path / "credibility_scores_minmax.npy")
    assert np.isfinite(scores).all()
    assert scores.min() >= 0.0 and scores.max() <= 1.0
    text = buf.getvalue()
    users = int(re.search(r"stage B graph: Users=([\d,]+)", text).group(1)
                .replace(",", ""))
    assert re.findall(r"used=([\d,]+)", text) == [f"{users:,}"]


def test_refuses_without_a_card(tmp_path, capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit) as e:
        two_stage_demo.main(["--out", str(tmp_path)])
    assert e.value.code != 0
    assert "--device cpu" in capsys.readouterr().err
    assert not (tmp_path / "reviews.jsonl").exists()
