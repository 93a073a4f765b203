"""The port's Stage-A parity harness (``<port>/scripts/cred_parity_run.py``)
against the JAX package's ``scripts/cred_parity_run.py`` (imported by
path; it imports the JAX package inside its functions only).

* ``build_planted_heterograph`` is array-equal to JAX's at seeds 7 and 42
  (a small U), and ``build`` writes JAX's graph, latent q and md5 split;
* ``spearman`` and the report's verdict on fixed vectors equal the numbers
  of JAX's ``cmd_report`` (rho, percentiles, the verdict sentence);
* the committed oracle vector is a min-max vector over the 3,000 users and
  reproduces the JAX report's oracle row (``runs/cred_parity/stage_a.md``)
  within 0.01;
* ``framework`` in both modes and ``downstream`` run with ``--device cpu``
  at a small size and write their records with the JAX keys.
"""

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.scripts import cred_parity_run as cpr

ROOT = Path(__file__).resolve().parents[1]


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
        "jax_cred_parity_run", ROOT / "scripts" / "cred_parity_run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [7, 42])
def test_planted_heterograph_equals_jax(seed):
    j_hg, j_q, (j_u, j_i) = _jax_script().build_planted_heterograph(
        U=200, I=500, seed=seed)
    hg, q, (u, i) = cpr.build_planted_heterograph(U=200, I=500, seed=seed)
    assert np.array_equal(q, j_q)
    assert np.array_equal(u, j_u) and np.array_equal(i, j_i)
    for k in ("user_x", "user_y", "item_x", "edges", "edge_attr"):
        a, b = getattr(hg, k), getattr(j_hg, k)
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True), k
    assert hg.feature_keys == j_hg.feature_keys
    assert hg.user_ids == j_hg.user_ids


def test_build_writes_jax_arrays(tmp_path, monkeypatch):
    # the port's build at a small size against JAX's function and JAX's md5
    # split, array for array
    jax = _jax_script()
    monkeypatch.setattr(cpr, "USERS", 300)
    monkeypatch.setattr(cpr, "ITEMS", 600)
    with contextlib.redirect_stdout(io.StringIO()):
        cpr.main(["build", "--dir", str(tmp_path / "port"), "--seed", "42"])
    hg, q, (u, i) = jax.build_planted_heterograph(U=300, I=600, seed=42)
    g = np.load(tmp_path / "port" / "graph.npz")
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.data.ingest import md5_split_bucket
    b = np.array([md5_split_bucket(f"u{x}", f"i{y}") for x, y in zip(u, i)])
    for split, k in (("train_edges", 0), ("val_edges", 1), ("test_edges", 2)):
        assert np.array_equal(g[split], np.stack([u[b == k], i[b == k]]))
    assert np.array_equal(np.load(tmp_path / "port" / "latent_q.npy"), q)
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.graph.hetero import HeteroGraph
    loaded = HeteroGraph.load_npz(tmp_path / "port" / "hg.npz")
    assert np.array_equal(loaded.edge_attr, hg.edge_attr, equal_nan=True)


def _fixed(d: Path, n=400):
    """Fixed score vectors, latent q and downstream records in ``d``."""
    rng = np.random.default_rng(5)
    q = rng.uniform(0, 1, n)
    d.mkdir(parents=True, exist_ok=True)
    np.save(d / "latent_q.npy", q)
    vecs = {"oracle": q + rng.normal(0, 0.2, n),
            "full_graph": q + rng.normal(0, 0.3, n),
            "slas": q + rng.normal(0, 0.25, n)}
    for k, v in vecs.items():
        v = (v - v.min()) / (v.max() - v.min())
        np.save(d / f"cred_{k}.npy", v.astype(np.float32))
    ds = {f"{c}/{s}": {"recall": 0.7 + 0.01 * k, "ndcg": 0.5 + 0.01 * k}
          for k, (c, s) in enumerate((c, s) for c in cpr.STAGE_B
                                     for s in ("ones",) + cpr.SOURCES)}
    (d / "downstream.json").write_text(json.dumps(ds))
    return q, vecs


def test_report_numbers_equal_jax(tmp_path, monkeypatch):
    _fixed(tmp_path)
    jax = _jax_script()
    monkeypatch.setattr(jax, "DIR", tmp_path)

    class Args:
        out = str(tmp_path / "jax_stage_a.md")
    with contextlib.redirect_stdout(io.StringIO()):
        jax.cmd_report(Args())
        port = cpr.main(["report", "--dir", str(tmp_path), "--oracle",
                         str(tmp_path / "cred_oracle.npy"), "--jax-dir",
                         str(tmp_path / "none")])
    jtext = (tmp_path / "jax_stage_a.md").read_text()
    j_rows = cpr.jax_rows(tmp_path / "jax_stage_a.md")
    p_rows = {}
    for ln in port.splitlines():
        cells = [c.strip() for c in ln.strip().strip("|").split("|")]
        if ln.startswith("| ") and cells[0] in j_rows:
            p_rows[cells[0]] = cells[1:]
    for name in ("oracle", "full_graph", "slas"):
        assert p_rows[name][:6] == j_rows[name], name      # p10 .. rho
    for name in ("cu_message/slas", "cred_eq322/ones"):
        assert p_rows[name][:2] == j_rows[name]
    j_verdict = [ln for ln in jtext.splitlines()
                 if ln.startswith("**Verdict")][0]
    p_verdict = [ln for ln in port.splitlines()
                 if ln.startswith("**Verdict")][0]
    assert p_verdict.replace("the port's trainers", "framework trainers") \
        == j_verdict
    a, b = (np.load(tmp_path / f"cred_{k}.npy") for k in ("slas", "oracle"))
    assert cpr.spearman(a, b) == jax.spearman(a, b)


def test_verdict_rule_flags_like_jax(tmp_path, monkeypatch):
    # slas = the oracle's scores compressed: ranks equal, percentiles off
    _fixed(tmp_path)
    o = np.load(tmp_path / "cred_oracle.npy")
    np.save(tmp_path / "cred_slas.npy", (0.4 + 0.2 * o).astype(np.float32))
    jax = _jax_script()
    monkeypatch.setattr(jax, "DIR", tmp_path)

    class Args:
        out = str(tmp_path / "jax_stage_a.md")
    with contextlib.redirect_stdout(io.StringIO()):
        jax.cmd_report(Args())
    creds = {k: np.load(tmp_path / f"cred_{k}.npy") for k in cpr.SOURCES}
    v = cpr.verdict(creds, json.loads(
        (tmp_path / "downstream.json").read_text()))
    assert not v["accept"]
    assert "**Verdict: FLAG**" in (tmp_path / "jax_stage_a.md").read_text()
    assert v["rho_vs_oracle"]["slas"] == pytest.approx(1.0)
    assert max(v["slas_pct_delta"]) > cpr.PCT_TOL


def test_committed_oracle_reproduces_the_jax_row():
    d = ROOT / cpr.DIR
    o = np.load(d / "cred_oracle.npy")
    assert o.shape == (3000,) and o.dtype == np.float32
    assert o.min() == 0.0 and o.max() == 1.0
    _, q, _ = cpr.build_planted_heterograph(U=3000, I=6000, seed=42)
    row = [float(x) for x in cpr.jax_rows(
        ROOT / "runs" / "cred_parity" / "stage_a.md")["oracle"][:5]]
    got = list(np.percentile(o, [10, 50, 90, 99])) + [cpr.spearman(o, q)]
    assert np.allclose(got, row, atol=0.01), (got, row)
    for mode in cpr.MODES:                 # the JAX framework's, on a CPU
        v = np.load(d / "jax_cpu" / f"cred_{mode}.npy")
        assert v.shape == (3000,) and cpr.spearman(v, o) >= cpr.RHO_MIN


def test_framework_and_downstream_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(cpr, "USERS", 300)
    monkeypatch.setattr(cpr, "ITEMS", 600)
    d = str(tmp_path)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cpr.main(["build", "--dir", d])
        recs = {m: cpr.main(["framework", "--mode", m, "--dir", d,
                             "--epochs", "2", "--device", "cpu"])
                for m in cpr.MODES}
        np.save(tmp_path / "oracle.npy",
                np.load(tmp_path / "cred_slas.npy"))
        ds = cpr.main(["downstream", "--dir", d, "--oracle",
                       str(tmp_path / "oracle.npy"), "--epochs", "2",
                       "--sources", "ones,oracle",
                       "--device", "cpu"])
        text = cpr.main(["report", "--dir", d, "--oracle",
                         str(tmp_path / "oracle.npy")])
    for m, r in recs.items():
        v = np.load(tmp_path / f"cred_{m}.npy")
        assert v.shape == (300,) and v.min() == 0.0 and v.max() == 1.0
        assert len(r["holdout_auc"]) == 2 and r["card"] is None
        assert json.loads((tmp_path / f"framework_{m}.json").read_text()) \
            == json.loads(json.dumps(r))
    assert sorted(ds) == sorted(f"{c}/{s}" for c in cpr.STAGE_B
                                for s in ("ones", "oracle"))
    assert all(sorted(v) == ["ndcg", "recall"] for v in ds.values())
    assert json.loads((tmp_path / "downstream.json").read_text()) == ds
    assert "**Verdict: " in text and "| slas | " in text
    assert "Epoch 02" in out.getvalue()
