"""The port's evaluation-equivalence and schedule drivers
(``<port>/scripts/eval_equiv_r4.py``, ``schedule_compare.py``) against the
JAX package's ``scripts/eval_equiv_r4.py`` and ``schedule_compare.py``.

* ``_topk_lists`` in each mode against JAX's (imported by path) on one set
  of tables over a small planted graph: the exact sets equal JAX's exact
  sets; the bf16 scores are bit-equal to JAX's and the bf16 sets equal
  JAX's ties aside (an item in one set only ties the K-th score: at bf16,
  ``lax.top_k`` keeps the lowest index among ties and ``torch.topk`` any),
  their raw mean Jaccard@20 >= 0.98 (0.987 here, from those ties); the
  port's approx lists equal its exact lists (it ranks "approx" exactly);
* ``train`` (2 epochs, each mode), ``overlap`` and ``report`` on the CPU
  write the JAX keys plus ``card`` (and ``overlap`` the overlap of bf16
  tables scored in fp32); the approx arm equals the exact arm;
* ``schedule_compare`` runs both schedules for 2 epochs with the keys of
  the JAX record ``runs/schedule_compare.json`` plus ``card``.
"""

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.eval.ranking import EvalContext as JEvalContext
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.graph.build import synthetic_bipartite_graph_planted as j_planted
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.eval.retrieval import exclusion_rows_for_users, mask_excluded
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops.sampling import DeviceCSR
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.probes.eval_breakdown import sets_agree
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.scripts import eval_equiv_r4, schedule_compare

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(num_users=600, num_items=1500, edges_per_user=10.0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small shapes: one intra-op thread, so that this file adds no thread
    contention to the test workers running beside it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_eval_equiv_r4", ROOT / "scripts" / "eval_equiv_r4.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(eval_equiv_r4, "GRAPH", dict(SMALL))
    return eval_equiv_r4.build_graph()


def test_topk_lists_match_jax(small):
    jg = j_planted(SMALL["num_users"], SMALL["num_items"],
                   SMALL["edges_per_user"], seed=0, power=1.0,
                   coarse_clusters=16, fine_per_coarse=16,
                   mix=(0.55, 0.25, 0.20))
    assert np.array_equal(jg.train_edges, small.train_edges)
    rng = np.random.default_rng(0)
    ue = rng.normal(size=(small.num_users, 32)).astype(np.float32)
    ie = rng.normal(size=(small.num_items, 32)).astype(np.float32)
    users = np.nonzero(small.user_csr("val").degrees() > 0)[0]
    jax = _jax_script()
    ctx = JEvalContext.build(jg)
    val_csr = DeviceCSR.from_host(small.user_csr("val"), small.num_items,
                                  "cpu")
    port = {m: eval_equiv_r4._topk_lists(torch.as_tensor(ue),
                                         torch.as_tensor(ie), small, val_csr,
                                         users, m, batch=128)
            for m in eval_equiv_r4.MODES}
    want = {m: jax._topk_lists(jnp.asarray(ue), jnp.asarray(ie), ctx, users,
                               m, batch=128) for m in ("exact", "bf16")}
    assert all(v.shape == (users.size, 20) for v in port.values())
    same = [set(a) == set(b) for a, b in zip(port["exact"], want["exact"])]
    assert all(same)
    assert np.array_equal(port["approx"], port["exact"])
    s16 = mask_excluded(torch.as_tensor(ue).bfloat16()[users]
                        @ torch.as_tensor(ie).bfloat16().T, torch.as_tensor(
                            exclusion_rows_for_users(small, users)), -1e9)
    j16 = (jnp.asarray(ue).astype(jnp.bfloat16)[users]
           @ jnp.asarray(ie).astype(jnp.bfloat16).T).astype(jnp.float32)
    live = s16.float().numpy() > -1e8
    assert np.array_equal(s16.float().numpy()[live], np.asarray(j16)[live])
    assert sets_agree(s16, torch.as_tensor(want["bf16"]),
                      torch.as_tensor(port["bf16"])) == 1.0
    jac = eval_equiv_r4.jaccard_stats(port["bf16"], want["bf16"])
    assert jac["mean"] >= 0.98, jac


def test_train_overlap_report_on_cpu(small, tmp_path):
    d = str(tmp_path)
    with contextlib.redirect_stdout(io.StringIO()):
        recs = {m: eval_equiv_r4.main(["train", "--mode", m, "--epochs", "2",
                                       "--dir", d, "--device", "cpu"],
                                      graph=small)
                for m in eval_equiv_r4.MODES}
        ov = eval_equiv_r4.main(["overlap", "--dir", d, "--device", "cpu",
                                 "--max-users", "200"], graph=small)
        text = eval_equiv_r4.main(["report", "--dir", d])
    jax = json.loads((ROOT / "runs" / "eval_equiv_r4" / "train_exact.json")
                     .read_text())
    for m, r in recs.items():
        written = json.loads((tmp_path / f"train_{m}.json").read_text())
        assert set(written) == set(jax) | {"card"}
        assert set(written["history"][0]) == set(jax["history"][0])
        assert set(written["test"]) == set(jax["test"])
        assert len(written["history"]) == 2 and (tmp_path /
                                                 f"params_{m}.npz").exists()
    assert recs["approx"]["test"] == recs["exact"]["test"]
    jov = json.loads((ROOT / "runs" / "eval_equiv_r4" / "overlap.json")
                     .read_text())
    extra = f"jaccard_{eval_equiv_r4.BF16_FP32_SCORES}_vs_exact"
    assert set(ov) == set(jov) | {"seconds", "card", extra}
    assert ov["n_users"] == 200 and set(ov[extra]) == set(
        jov["jaccard_bf16_vs_exact"])
    assert ov["jaccard_approx_vs_exact"]["frac_identical"] == 1.0
    assert "approx arm equal to the exact arm (TEST block and best val): " \
        "yes" in text
    assert "| exact | " in text and "| bf16 | " in text


def test_schedule_compare_both_schedules_on_cpu(small, tmp_path):
    out = tmp_path / "schedule_compare.json"
    with contextlib.redirect_stdout(io.StringIO()):
        schedule_compare.main(["2", "--out", str(out), "--device", "cpu"],
                              graph=small)
    rec = json.loads(out.read_text())
    jax = json.loads((ROOT / "runs" / "schedule_compare.json").read_text())
    assert set(rec) == set(jax) | {"card"} and rec["card"] is None
    assert rec["protocol"] == jax["protocol"]
    for s in schedule_compare.SCHEDULES:
        assert set(rec[s]) == set(jax[s]) and rec[s]["epochs"] == 2
        assert set(rec[s]["test"]) == set(jax[s]["test"])
        assert set(rec[s]["test"]["20"]) == set(jax[s]["test"]["20"])
        assert 0.0 <= rec[s]["test"]["20"]["recall"] <= 1.0
