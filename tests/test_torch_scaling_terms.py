"""The port's scaling-terms probe (``<port>/probes/scaling_terms.py``)
against the JAX package's ``scripts/probe_scaling_terms.py``: on a small
planted graph through ``main(argv, graph=)`` it writes the JAX record's
keys (``runs/scaling_terms.json``) plus ``card``, ``iters`` and ``clock``,
finite positive terms with scan_steps_s = epoch_s - propagate_s, and a
``config`` equal to the one the JAX probe forms from the JAX preset at the
same precision; ``--spmm-precision`` and the trainer's own precision name
the same messages; without a card it refuses to run unless asked for the
CPU."""

import contextlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.configs.presets import get_preset as j_preset
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.bench import northstar_graph, northstar_trainer
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.probes import scaling_terms

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small shapes: one intra-op thread, so that this file adds no thread
    contention to the test workers running beside it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graph():
    return northstar_graph(400, 900, 8.0)


def _jax_config(precision: str) -> str:
    """The JAX probe's label, formed from the JAX preset."""
    overrides = {} if precision == "preset" else {"spmm_precision": precision}
    cfg = j_preset("scaled_10m", epochs=2, seed=0, **overrides)
    return (f"scaled_10m(planted 10M, {cfg.spmm_precision} messages, "
            f"{cfg.propagation_schedule})")


@pytest.mark.parametrize("precision", ("preset", "bf16"))
def test_terms_keep_jax_keys_and_label(graph, tmp_path, precision):
    out = tmp_path / "terms.json"
    with contextlib.redirect_stdout(io.StringIO()):
        rec = scaling_terms.main(["--spmm-precision", precision, "--iters",
                                  "1", "--out", str(out), "--device", "cpu"],
                                 graph=graph)
    jax_rec = json.loads((ROOT / "runs" / "scaling_terms.json").read_text())
    assert set(rec) == set(jax_rec) | {"card", "iters", "clock"}
    assert json.loads(out.read_text()) == rec
    assert rec["config"] == _jax_config(precision)
    for k in ("propagate_s", "epoch_s", "eval_epoch_s"):
        assert np.isfinite(rec[k]) and rec[k] > 0, k
    assert rec["scan_steps_s"] == max(rec["epoch_s"] - rec["propagate_s"],
                                      0.0)
    assert rec["fixed_s"] == 0.0
    assert rec["device"] == "cpu" and rec["card"] is None
    assert rec["clock"] == "host clock, cpu"


def test_trainer_passed_in_keeps_its_precision(graph, tmp_path):
    """``trainer=`` (chip_smoke's phase 18 trainer) is measured as it is; a
    precision it was not built with is refused."""
    tr = northstar_trainer(graph, "cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        rec = scaling_terms.main(["--iters", "1", "--out",
                                  str(tmp_path / "t.json"), "--device",
                                  "cpu"], trainer=tr)
    assert rec["config"] == _jax_config("preset")
    with pytest.raises(ValueError, match="messages are fp32"):
        scaling_terms.main(["--spmm-precision", "bf16", "--device", "cpu",
                            "--out", str(tmp_path / "u.json")], trainer=tr)


def test_refuses_the_card_default_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit), \
            contextlib.redirect_stderr(io.StringIO()) as err:
        scaling_terms.main(["--out", str(tmp_path / "t.json")])
    assert "--device cpu" in err.getvalue()
