"""The port's end-to-end walk-through (``<port>/examples/end_to_end.py``)
against the JAX package's ``examples/end_to_end.py`` (imported by path).

* ``make_demo_jsonl`` writes JAX's bytes, broken last line included;
* the walk-through runs on the CPU at ``--epochs 2``: the ingest keeps the
  JAX reader's counts, Stage A writes the CSV contract, Stage B trains the
  asked epochs with extended metrics, all finite;
* without ``--device cpu`` and without a card it exits non-zero.
"""

import contextlib
import importlib.util
import io
from pathlib import Path

import numpy as np
import pytest

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.data.ingest import ingest_jsonl as j_ingest
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.examples import end_to_end

ROOT = Path(__file__).resolve().parents[1]


def test_demo_jsonl_equals_jax(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "jax_end_to_end", ROOT / "examples" / "end_to_end.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.make_demo_jsonl(tmp_path / "jax.jsonl")
    end_to_end.make_demo_jsonl(tmp_path / "port.jsonl")
    jax = (tmp_path / "jax.jsonl").read_bytes()
    assert jax.endswith(b"{broken json line\n")
    assert (tmp_path / "port.jsonl").read_bytes() == jax


def test_runs_on_the_cpu(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = end_to_end.main(["--epochs", "2", "--device", "cpu",
                               "--out", str(tmp_path)])
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("[e2e]")]
    jt = j_ingest(tmp_path / "reviews.jsonl")
    assert lines[1] == (f"[e2e] ingested: {jt.num_records} records, "
                        f"{jt.num_users} users, {jt.num_items} items")
    assert (tmp_path / "credibility_scores_minmax_with_user_id.csv").exists()
    assert len(res.history) == 2
    assert all(np.isfinite(h.loss) for h in res.history)
    assert set(res.test_metrics) == {5, 10}
    t = res.test_metrics[10]
    assert all(np.isfinite(t[k]) for k in ("recall", "ndcg",
                                           "item_coverage"))
    assert lines[-1] == (f"[e2e] test coverage@10 = "
                         f"{t['item_coverage']:.4f}")


def test_refuses_without_a_card(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit) as e:
        end_to_end.main(["--epochs", "1"])
    assert e.value.code != 0
    assert "--device cpu" in capsys.readouterr().err
