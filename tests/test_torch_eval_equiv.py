"""The port's evaluation-equivalence and schedule drivers
(``<port>/scripts/eval_equiv_r4.py``, ``schedule_compare.py``) against the
JAX package's ``scripts/eval_equiv_r4.py`` and ``schedule_compare.py``.

* ``_topk_lists`` in each mode against JAX's (imported by path) on one set
  of tables over a small planted graph: the exact sets equal JAX's exact
  sets; the port's approx lists equal its exact lists (it ranks "approx"
  exactly).  The bf16 arm follows the TPU, not JAX on a CPU: it scores
  bf16 tables with fp32 sums (JAX's ``_full_batch`` on a CPU rounds each
  score to bf16).  So its scores are held to the JAX product with fp32
  accumulation (``jnp.dot(..., preferred_element_type=jnp.float32)``)
  within the bound of a different summation order, and its sets equal the
  top-K of that product, ties aside (an item in one set only ties the K-th
  score), with a raw mean Jaccard@20 >= 0.98;
* the bf16 scores at the tables' own scale (0.1) within rtol / atol 1e-6
  of that JAX product, far from the bf16-rounded scores;
* ``train`` (2 epochs, each mode), ``overlap`` and ``report`` on the CPU
  write the JAX keys plus ``card``; the approx arm equals the exact arm;
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
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.eval.ranking import _full_batch
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.eval.retrieval import exclusion_rows_for_users, mask_excluded, score_product
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
    want = {"exact": jax._topk_lists(jnp.asarray(ue), jnp.asarray(ie), ctx,
                                     users, "exact", batch=128)}
    assert all(v.shape == (users.size, 20) for v in port.values())
    same = [set(a) == set(b) for a, b in zip(port["exact"], want["exact"])]
    assert all(same)
    assert np.array_equal(port["approx"], port["exact"])
    excl = torch.as_tensor(exclusion_rows_for_users(small, users))
    s16 = mask_excluded(score_product(torch.as_tensor(ue)[users],
                                      torch.as_tensor(ie), "bf16"), excl, -1e9)
    j16 = np.array(_jax_fp32_sums(ue[users], ie))
    live = s16.numpy() > -1e8
    assert s16.dtype == torch.float32
    # two fp32 sums of the same 32 exact bf16 products in different orders
    # differ by at most 2 (D - 1) u sum_k |p_k| (u = 2^-24)
    terms = np.abs(_bf16(ue[users])) @ np.abs(_bf16(ie)).T
    gap = np.abs(s16.numpy() - j16)[live]
    assert (gap <= 2 * 31 * 2.0 ** -24 * terms[live]).all(), gap.max()
    # the top-K of the JAX product (masked as the port masks)
    ref = mask_excluded(torch.as_tensor(j16), excl, -1e9)
    want["bf16"] = torch.topk(ref, 20, dim=1)[1].numpy()
    assert sets_agree(ref, torch.as_tensor(want["bf16"]),
                      torch.as_tensor(port["bf16"])) == 1.0
    jac = eval_equiv_r4.jaccard_stats(port["bf16"], want["bf16"])
    assert jac["mean"] >= 0.98, jac


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16, as fp32."""
    return torch.as_tensor(a).bfloat16().float().numpy()


def _jax_fp32_sums(u: np.ndarray, items: np.ndarray):
    """The bf16 score product as the TPU kept it: bf16 operands, fp32
    accumulation and output."""
    return jnp.dot(jnp.asarray(u).astype(jnp.bfloat16),
                   jnp.asarray(items).astype(jnp.bfloat16).T,
                   preferred_element_type=jnp.float32)


def test_bf16_scores_sum_in_fp32_like_the_tpu(small):
    """The bf16 arm's scores at the tables' scale (0.1, the scale of the
    initial and trained embeddings) equal JAX's bf16 product with fp32
    accumulation within rtol / atol 1e-6 (summation order only), while the
    scores rounded to bf16, as before, miss it by far more; ``_full_batch``
    in bf16 ranks the top-20 of that product."""
    rng = np.random.default_rng(1)
    ue = (0.1 * rng.normal(size=(small.num_users, 32))).astype(np.float32)
    ie = (0.1 * rng.normal(size=(small.num_items, 32))).astype(np.float32)
    users = np.nonzero(small.user_csr("val").degrees() > 0)[0][:128]
    got = score_product(torch.as_tensor(ue)[users], torch.as_tensor(ie),
                        "bf16")
    want = np.array(_jax_fp32_sums(ue[users], ie))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    rounded = got.bfloat16().float().numpy()
    assert np.abs(rounded - want).max() > 100 * 1e-6
    excl = torch.as_tensor(exclusion_rows_for_users(small, users))
    csr = DeviceCSR.from_host(small.user_csr("val"), small.num_items, "cpu")
    _, top, _, _ = _full_batch(torch.as_tensor(ue), torch.as_tensor(ie),
                               torch.as_tensor(users), excl, csr, None, (20,),
                               False, 1, small.num_items, score_dtype="bf16")
    ref = mask_excluded(torch.as_tensor(want), excl, -1e9)
    assert sets_agree(ref, torch.topk(ref, 20, dim=1)[1], top) == 1.0


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
    assert set(ov) == set(jov) | {"seconds", "card"}
    assert ov["n_users"] == 200 and set(ov["jaccard_bf16_vs_exact"]) == set(
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
