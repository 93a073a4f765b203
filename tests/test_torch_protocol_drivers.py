"""The remaining protocol drivers as parts of ``scripts/protocol.py``.

* the new driver modules import with ``jax`` blocked and pull in no module
  of the JAX package or of the root ``scripts/``;
* the parts ``eval_equiv``, ``schedule``, ``ingest``, ``sharding`` and
  ``eval_breakdown`` run on the CPU at a tiny size and write their records
  (the 10M graphs replaced by a small one, the epochs and lines cut);
* ``summary`` holds the drivers' records against the JAX package's: the
  JAX records themselves in the port's place give PASS rows, a missing
  record a PENDING row; the F7 rows hold the port's seed spread against
  the committed JAX logs;
* ``parity_run report`` ends with the Stage-A report when there is one.
"""

import contextlib
import io
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.graph.build import synthetic_bipartite_graph
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.scripts import eval_equiv_r4, parity_run, protocol, schedule_compare

ROOT = Path(__file__).resolve().parents[1]
PORT = ("beyond_binary_fake_user_detection_a_credibility_aware_graph_based_"
        "recommender_system_tpu_torch")
MODULES = ("scripts.cred_parity_run", "scripts.eval_equiv_r4",
           "scripts.schedule_compare", "scripts.ingest_bench",
           "scripts.sharding_report", "probes.eval_breakdown",
           "scripts.protocol")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small shapes: one intra-op thread, so that this file adds no thread
    contention to the test workers running beside it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_driver_modules_import_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for m in {MODULES!r}:\n"
        f"    importlib.import_module('{PORT}.' + m)\n"
        "bad = sorted(m for m, v in sys.modules.items() if v is not None\n"
        "             and m.startswith('jax')\n"
        f"             or (m.startswith('{PORT[:-6]}') and not\n"
        f"                 m.startswith('{PORT}'))\n"
        "             or m.split('.')[0] == 'scripts')\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_parts_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(eval_equiv_r4, "GRAPH", dict(
        num_users=500, num_items=1200, edges_per_user=10.0))
    monkeypatch.setattr(eval_equiv_r4, "EPOCHS", 1)
    monkeypatch.setattr(schedule_compare, "EPOCHS", 1)
    monkeypatch.setattr(protocol, "INGEST_LINES", 3000)
    small = synthetic_bipartite_graph(800, 1500, 8.0, seed=0, power=1.0)
    monkeypatch.setattr(protocol, "_GRAPHS", {"large": small})
    with contextlib.redirect_stdout(io.StringIO()):
        protocol.main(["eval_equiv", "schedule", "ingest", "sharding",
                       "eval_breakdown", "--out", str(tmp_path),
                       "--device", "cpu"])
    ee = tmp_path / "eval_equiv_r4"
    assert sorted(p.name for p in ee.iterdir()) == [
        "overlap.json", "report.md", "train_approx.json", "train_bf16.json",
        "train_exact.json"]                      # the parameters are gone
    sc = json.loads((tmp_path / "schedule_compare.json").read_text())
    assert sc["per_epoch"]["epochs"] == sc["per_batch"]["epochs"] == 1
    ib = json.loads((tmp_path / "ingest_bench.json").read_text())
    assert ib["rows_kept"] == ib["lines"] == 3000
    sh = json.loads((tmp_path / "sharding_report.json").read_text())
    assert sh["graph"]["users"] == 800 and sh["differences_from_jax_record"]
    eb = json.loads((tmp_path / "eval_breakdown.json").read_text())
    assert min(eb["sets_agree_min"].values()) == 1.0
    logs = sorted(p.name for p in (tmp_path / "logs").iterdir())
    assert "eval_equiv_overlap.out" in logs and "ingest_bench.out" in logs


def _rows(text):
    return {ln.split("|")[1].strip(): ln for ln in text.splitlines()
            if ln.startswith("| ")}


def test_summary_holds_the_drivers_against_jax(tmp_path):
    # the JAX records in the port's place: every row PASS; no Stage-A run
    jr = ROOT / "runs"
    shutil.copytree(jr / "eval_equiv_r4", tmp_path / "eval_equiv_r4")
    shutil.copy(jr / "schedule_compare.json", tmp_path)
    shutil.copy(jr / "ingest_bench.json", tmp_path)
    sh = json.loads((jr / "sharding_report.json").read_text())
    (tmp_path / "sharding_report.json").write_text(json.dumps(
        {**sh, "differences_from_jax_record": []}))
    (tmp_path / "eval_breakdown.json").write_text(json.dumps(
        {"sets_agree_min": {"topk_chunked_vs_full": 1.0}}))
    rows = _rows("\n".join(protocol.driver_lines(tmp_path, jr)))
    for label in ("eval_equiv exact: TEST R@20", "eval_equiv bf16: TEST R@20",
                  "eval_equiv: bf16 mean Jaccard@20 vs exact",
                  "schedule per_epoch: TEST R@20",
                  "schedule per_batch: TEST R@20",
                  "ingest: rows_kept of 10,000,000 lines",
                  "sharding report against runs/sharding_report.json",
                  "ranking probe: chunked top-k sets equal to full width "
                  "(min share)",
                  # JAX's approx arm gave its exact arm's TEST block too
                  "eval_equiv: approx arm equal to exact (the port ranks it "
                  "exactly)"):
        assert rows[label].endswith("| PASS |"), rows[label]
    assert rows["Stage A: rho(slas, oracle)"].endswith("| PENDING |")
    assert rows["Stage A: JAX's verdict rule"] == \
        "| Stage A: JAX's verdict rule | missing | ACCEPT | PENDING |"
    # an R@20 off by more than the limit fails
    sc = json.loads((jr / "schedule_compare.json").read_text())
    sc["per_batch"]["test"]["20"]["recall"] += 0.0025
    (tmp_path / "schedule_compare.json").write_text(json.dumps(sc))
    rows = _rows("\n".join(protocol.driver_lines(tmp_path, jr)))
    assert rows["schedule per_batch: TEST R@20"].endswith("| FAIL |")


def test_summary_stage_a_rows(tmp_path):
    # the oracle vector in each mode's place: rho 1, deltas 0, ACCEPT
    d = tmp_path / "cred_parity"
    d.mkdir()
    o = np.load(ROOT / protocol.CRED_ORACLE)
    for mode in ("full_graph", "slas"):
        np.save(d / f"cred_{mode}.npy", o)
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.scripts import cred_parity_run
    _, q, _ = cred_parity_run.build_planted_heterograph(U=3000, I=6000,
                                                        seed=42)
    np.save(d / "latent_q.npy", q)
    rows = _rows("\n".join(protocol.driver_lines(tmp_path, ROOT / "runs")))
    assert rows["Stage A: rho(slas, oracle)"].startswith(
        "| Stage A: rho(slas, oracle) | 1.0000 (0.9655) |")
    assert rows["Stage A: JAX's verdict rule"].endswith("ACCEPT | PASS |")
    label = ("Stage A: the oracle vector against stage_a.md's oracle row "
             "(p10/p50/p90/p99/rho vs q)")
    assert rows[label].endswith("| 0.01 | PASS |")
    assert "Stage A: rho(slas, JAX slas on a CPU)" in rows


def _log(path, losses):
    path.write_text("".join(f"Epoch {k + 1:02d} | loss={x:.6f}\n"
                            for k, x in enumerate(losses)))


def test_summary_spread_rows(tmp_path, monkeypatch):
    # the committed JAX logs against a port side equal to them: diff 0
    jax_dir = ROOT / protocol.SPREAD_JAX
    port = tmp_path / "seeds" / "port_cpu"
    port.mkdir(parents=True)
    for p in protocol.SPREAD_PRESETS:
        for s in protocol.SPREAD_SEEDS:
            shutil.copy(jax_dir / f"{p}_s{s}.out", port)
    lines = protocol.spread_lines(tmp_path, jax_dir)
    rows = [ln for ln in lines if ln.startswith("| vanilla, parity graph | ")]
    assert len(rows) == 2 and "+0.000000" in rows[1] \
        and rows[1].endswith("| PASS |")
    want = [protocol.log_mean_loss(jax_dir / f"vanilla_s{s}.out")
            for s in protocol.SPREAD_SEEDS]
    assert rows[0].startswith("| vanilla, parity graph | JAX, CPU | "
                              + ", ".join(
        f"{v:.6f}" for v in want) + " | ")
    # a port side 5% lower fails; a short log is missing
    for s in protocol.SPREAD_SEEDS:
        text = (jax_dir / f"vanilla_s{s}.out").read_text()
        losses = [float(x) * 0.95 for x in protocol._EPOCH_LOSS.findall(text)]
        _log(port / f"vanilla_s{s}.out", losses)
    _log(port / "degree_aware_s45.out", [0.5] * 10)
    lines = protocol.spread_lines(tmp_path, jax_dir)
    rows = [ln for ln in lines
            if ln.startswith("| vanilla, parity graph | port")]
    assert rows[0].endswith("| FAIL |")
    rows = [ln for ln in lines
            if ln.startswith("| degree_aware, parity graph | port")]
    assert ", missing |" in rows[0]
    assert protocol.spread_lines(tmp_path / "none", tmp_path / "none") == []


def test_parity_report_ends_with_stage_a(tmp_path, monkeypatch):
    (tmp_path / "stage_a.md").write_text("## Stage-A parity: test\n")
    monkeypatch.setattr(parity_run, "STAGE_A_DIR", str(tmp_path))
    args = type("A", (), dict(dir=str(tmp_path), jax_dir=str(
        ROOT / "runs" / "parity"), report_out=str(tmp_path / "q.md")))()
    with contextlib.redirect_stdout(io.StringIO()):
        text = parity_run.cmd_report(args)
    lines = text.rstrip().splitlines()
    assert lines[-3] == "## Stage-A parity: test"
    assert lines[-1].startswith(f"Raw Stage-A artifacts: `{tmp_path}/` ")
    monkeypatch.setattr(parity_run, "STAGE_A_DIR", str(tmp_path / "none"))
    with contextlib.redirect_stdout(io.StringIO()):
        assert "Stage-A" not in parity_run.cmd_report(args)


def _metrics(path, losses):
    path.write_text("".join(json.dumps({"epoch": k + 1, "loss": x}) + "\n"
                            for k, x in enumerate(losses))
                    + json.dumps({"test": {}}) + "\n")


def test_loss_limit_from_both_sides_seed_spread(tmp_path):
    pc = ROOT / "runs" / "precision_compare"
    base = protocol._loss_rel_tol(pc)
    # both spreads measured: 2x the std of the difference of two runs
    assert protocol._loss_rel_tol(pc, 0.003, 0.004) == pytest.approx(0.01)
    # a side's spread missing: 2x the precision seeds' pooled std
    assert protocol._loss_rel_tol(pc, 0.003) == base
    assert protocol._loss_rel_tol(pc, None, 0.004) == base
    assert protocol._loss_rel_tol(tmp_path) is None
    assert protocol._loss_rel_tol(tmp_path, 0.003, 0.004) == \
        pytest.approx(0.01)
    # a side's spread from its seeds at reference scale (3 make a spread)
    out, jax = tmp_path / "out", tmp_path / "jax"
    (out / "seeds").mkdir(parents=True)
    jax.mkdir()
    vals = (1.0, 1.02, 0.98, 1.01)
    _metrics(out / "vanilla_ref_scale_metrics.jsonl", [vals[0]])
    for s_, v in zip(protocol.EXTRA_SEEDS, vals[1:]):
        _metrics(out / "seeds" / f"vanilla_s{s_}.jsonl", [v])
    _metrics(jax / "vanilla_ref_scale_metrics.jsonl", [1.0])
    sp, sj = protocol._seed_spread(out, jax, "vanilla")
    assert sp == pytest.approx(np.std(vals, ddof=1) / np.mean(vals))
    # JAX's extra seeds are read from SPREAD_JAX_REF: one run is no spread
    assert sj is None or sj >= 0.0
