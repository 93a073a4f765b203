"""The remaining protocol drivers as parts of ``scripts/protocol.py``.

* the new driver modules import with ``jax`` blocked and pull in no module
  of the JAX package or of the root ``scripts/``;
* the parts ``eval_equiv``, ``schedule``, ``ingest``, ``sharding`` and
  ``eval_breakdown`` run on the CPU at a tiny size and write their records
  (the 10M graphs replaced by a small one, the epochs and lines cut);
* the parts ``scaling_terms``, ``sampling_costs`` and
  ``scaling_projection`` run on the CPU at a tiny size; the projection
  refuses the CPU's terms and takes terms labelled with a card;
* ``summary`` holds the drivers' records against the JAX package's: the
  JAX records themselves in the port's place give PASS rows, a missing
  record a PENDING row; the F7 rows hold the port's seed spread against
  the committed JAX logs; F9's row gives each side's slas p10 offset from
  the oracle over seeds, mean +/- std and n, and the two means against 2
  pooled SE; F10's rows: a replay of JAX's streams against the JAX log of
  the same seed, the port's own streams against JAX's over 32 seeds, and
  the mixed arms;
* ``protocol.replay`` on the CPU follows the JAX package's own
  ``scripts/parity_run.py framework`` log epoch by epoch;
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

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.bench import northstar_graph
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.graph.build import synthetic_bipartite_graph
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.probes import sampling_costs
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.scripts import eval_equiv_r4, parity_run, protocol, schedule_compare

ROOT = Path(__file__).resolve().parents[1]
PORT = ("beyond_binary_fake_user_detection_a_credibility_aware_graph_based_"
        "recommender_system_tpu_torch")
MODULES = ("scripts.cred_parity_run", "scripts.eval_equiv_r4",
           "scripts.schedule_compare", "scripts.ingest_bench",
           "scripts.sharding_report", "probes.eval_breakdown",
           "probes.scaling_terms", "probes.sampling_costs",
           "scripts.scaling_projection", "scripts.protocol")


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


def test_scaling_and_sampling_parts_on_cpu(tmp_path, monkeypatch):
    small = synthetic_bipartite_graph(800, 1500, 8.0, seed=0, power=1.0)
    monkeypatch.setattr(protocol, "_GRAPHS", {
        "planted": northstar_graph(400, 900, 8.0), "large": small})
    monkeypatch.setattr(sampling_costs, "CATALOGUES", (3000,))
    monkeypatch.setattr(sampling_costs, "REF_GRAPH", dict(
        num_users=300, num_items=700, edges_per_user=6.0, seed=0, power=1.0))
    with contextlib.redirect_stdout(io.StringIO()):
        protocol.main(["scaling_terms", "sampling_costs", "sharding", "--out",
                       str(tmp_path), "--device", "cpu"])
    terms = {p: json.loads((tmp_path / f"scaling_terms{p}.json").read_text())
             for p in ("", "_fp32", "_bf16")}
    assert terms[""]["config"] == terms["_fp32"]["config"] == \
        "scaled_10m(planted 10M, fp32 messages, per_epoch)"
    assert "bf16 messages" in terms["_bf16"]["config"]
    sg = json.loads((tmp_path / "sampling_costs.json").read_text())
    assert sg["membership"]["agree"] and sg["membership"]["members_found"]
    with pytest.raises(ValueError, match="CUDA card"), \
            contextlib.redirect_stdout(io.StringIO()):
        protocol.main(["scaling_projection", "--out", str(tmp_path),
                       "--device", "cpu"])
    (tmp_path / "scaling_terms.json").write_text(json.dumps(
        {**terms[""], "device": "cuda", "card": "NVIDIA H100 80GB HBM3, "
         "700.00 W"}))
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        protocol.main(["scaling_projection", "--out", str(tmp_path),
                       "--device", "cpu"])
    pj = json.loads((tmp_path / "scaling_projection.json").read_text())
    assert set(pj["projections"]) == {"2", "4", "8"}
    assert pj["sharding_report_check"]["equal"]
    rows = _rows("\n".join(protocol.driver_lines(tmp_path, ROOT / "runs")))
    for label in ("scaling projection (a projection): P=4 halo rows against "
                  "the sharding report", "sampling costs: hash table and "
                  "binary search agree, members found"):
        assert rows[label].endswith("| PASS |"), rows[label]


def test_summary_cred_seed_spread_row(tmp_path, monkeypatch):
    """F9's row on a fabricated seed set: each vector the oracle shifted by
    a constant, so its p10 offset is that constant."""
    oracle = np.load(ROOT / protocol.CRED_ORACLE)
    d, jcpu = tmp_path / "cred_parity", tmp_path / "jax_cpu"
    (jcpu / "seeds").mkdir(parents=True)
    monkeypatch.setattr(protocol, "CRED_SEEDS", (43, 44))
    for seed, c in zip((42, 43, 44), (0.10, 0.12, 0.14)):
        path = d / "cred_slas.npy" if seed == 42 else \
            d / "seeds" / f"s{seed}" / "cred_slas.npy"
        path.parent.mkdir(parents=True, exist_ok=True)
        np.save(path, oracle + c)
    np.save(jcpu / "cred_slas.npy", oracle + 0.10)
    np.save(jcpu / "seeds" / "cred_slas_s43.npy", oracle + 0.12)
    rows = protocol._cred_spread_rows(d, oracle, jcpu)
    # 2 sqrt(0.02^2 / 3 + 0.0141^2 / 2) = 0.0306
    assert rows == [
        "| Stage A: slas p10 - oracle p10 over seeds 42 and 43-44 (mean "
        "+/- std) | port +0.1200 +/- 0.0200 (n 3); JAX on a CPU +0.1100 "
        "+/- 0.0141 (n 2); diff +0.0100, 2 pooled SE 0.0306: within | "
        "(context) | |"]
    for seed, c in ((42, 0.20), (43, 0.22), (44, 0.24)):
        np.save(jcpu / "cred_slas.npy" if seed == 42 else
                jcpu / "seeds" / f"cred_slas_s{seed}.npy", oracle + c)
    row = protocol._cred_spread_rows(d, oracle, jcpu)[0]
    assert "+0.2200 +/- 0.0200 (n 3); diff -0.1000, 2 pooled SE 0.0327" \
        in row and row.endswith("outside | (context) | |")
    # one seed is no spread
    row = protocol._cred_spread_rows(d, oracle, tmp_path / "none")[0]
    assert "JAX on a CPU n 0" in row and "diff" not in row
    assert protocol._cred_spread_rows(d, None, jcpu) == []


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


def _f10_logs(d, preset, seeds, losses_of):
    d.mkdir(parents=True, exist_ok=True)
    for s in seeds:
        _log(d / f"{preset}_s{s}.out", losses_of(s))


def test_summary_f10_replay_and_seed_rows(tmp_path, monkeypatch):
    """F10's rows on tiny logs (8 epochs, means of the last 4): a replay
    row a seed against the JAX log of the same seed (the limit 1e-4 of
    JAX's mean; the largest per-epoch |diff| / loss; the first epoch past
    the logs' rounding), then the n = 2 + 2 row: the port's own streams
    against JAX's (its logs, then the card's replay), within 2 pooled SE,
    judged only when every replay row on the card passes; then a mixed
    arm's row (the port's part against JAX's streams, seed by seed)."""
    monkeypatch.setattr(protocol, "SPREAD_EPOCHS", 8)
    monkeypatch.setattr(protocol, "LOSS_WINDOW", 4)
    monkeypatch.setattr(protocol, "REPLAY_SEEDS", {"degree_aware": (42, 43)})
    monkeypatch.setattr(protocol, "SPREAD_SEEDS_BY_PRESET",
                        {"degree_aware": (42, 43)})
    monkeypatch.setattr(protocol, "F10_SEEDS", (50, 51))
    jax_dir, f10 = tmp_path / "jax", tmp_path / "f10"
    base = {42: [0.6, 0.5, 0.4, 0.3, 0.2, 0.2, 0.2, 0.2],
            43: [0.6, 0.5, 0.4, 0.3, 0.21, 0.21, 0.21, 0.21]}
    _f10_logs(jax_dir, "degree_aware", (42, 43), base.get)
    # s42: epoch 6 on drifts 3e-6 (past 2e-6 x 0.2 + 5e-7 = 9e-7), the
    # mean by 2.25e-6 of 1e-4 x 0.2; s43: the mean off by 3e-5 > 2.1e-5
    replay = {42: base[42][:5] + [0.200003] * 3,
              43: base[43][:4] + [0.21003] * 4}
    _f10_logs(f10 / "replay_h100", "degree_aware", (42, 43), replay.get)
    assert protocol.f10_lines(tmp_path / "none", jax_dir) == []
    lines = protocol.f10_lines(tmp_path, jax_dir)
    rows = {ln.split("|")[2].strip(): ln for ln in lines
            if ln.startswith("| degree_aware | ")}
    assert rows["42"] == ("| degree_aware | 42 | h100 | 0.200000 | "
                          "0.200002 | +0.0000022 | 0.0000200 | PASS | "
                          "1.50e-05 | 6 |")
    assert rows["43"].startswith("| degree_aware | 43 | h100 | 0.210000 | "
                                 "0.210030 | +0.0000300 | 0.0000210 | FAIL |")
    assert rows["43"].endswith("| 5 |")
    # the port's own streams: seeds 42-43 (seeds_parity) and 50-51
    own = {42: 0.25, 43: 0.27, 50: 0.26, 51: 0.30}
    _f10_logs(tmp_path / "seeds" / "port_h100", "degree_aware", (42, 43),
              lambda s: [own[s]] * 8)
    _f10_logs(f10 / "port_h100", "degree_aware", (50, 51),
              lambda s: [own[s]] * 8)
    rep = {50: 0.22, 51: 0.24}
    _f10_logs(f10 / "replay_h100", "degree_aware", (50, 51),
              lambda s: [rep[s]] * 8)
    row = protocol.f10_lines(tmp_path, jax_dir)[-1]
    assert row.endswith("NOT JUDGED: a replay row fails on the card, so "
                        "the replay does not stand for JAX |")
    # with every replay row passing, the row is judged: JAX's side is its
    # logs at 42-43 and the replay at 50-51
    _f10_logs(f10 / "replay_h100", "degree_aware", (43,), base.get)
    lines = protocol.f10_lines(tmp_path, jax_dir)
    assert "| 50 | 0.260000 | 0.220000 (replay) |" in lines
    p, j = [0.25, 0.27, 0.26, 0.30], [0.2, 0.21, 0.22, 0.24]
    sp, sj = np.std(p, ddof=1), np.std(j, ddof=1)
    tol = 2 * np.sqrt(sp ** 2 / 4 + sj ** 2 / 4)
    diff = np.mean(p) - np.mean(j)
    assert diff > tol
    assert lines[-1] == (
        f"| degree_aware, parity graph | 4 / 4 | {np.mean(p):.6f} +/- "
        f"{sp:.6f} | {np.mean(j):.6f} +/- {sj:.6f} | {diff:+.6f} | "
        f"{tol:.6f} | FAIL |")
    # a mixed arm: its mean difference from JAX's streams at each seed
    # within 2 standard errors of it
    monkeypatch.setattr(protocol, "F10_ARMS", ("init", "perm"))
    arm = {42: 0.201, 43: 0.212, 50: 0.222, 51: 0.239}
    _f10_logs(f10 / "mixed_init_h100", "degree_aware", (42, 43, 50, 51),
              lambda s: [arm[s]] * 8)
    lines = protocol.f10_lines(tmp_path, jax_dir)
    d = [0.001, 0.002, 0.002, -0.001]
    tol = 2 * np.std(d, ddof=1) / 2
    assert lines[-1] == (f"| init | 4 | {np.mean(list(arm.values())):.6f} "
                         f"| {np.std(d, ddof=1):.6f} | +{np.mean(d):.6f} | "
                         f"{tol:.6f} | PASS |")
    # a seed missing leaves the rows pending
    (f10 / "mixed_init_h100" / "degree_aware_s43.out").unlink()
    assert protocol.f10_lines(tmp_path, jax_dir)[-1].endswith("| PENDING |")
    (f10 / "port_h100" / "degree_aware_s51.out").unlink()
    lines = protocol.f10_lines(tmp_path, jax_dir)
    row = [ln for ln in lines if ln.startswith("| degree_aware, parity")]
    assert row[0].endswith("| PENDING |")
    assert "| 51 | missing | 0.240000 (replay) |" in lines


def test_replay_follows_the_jax_fit_log(tmp_path, capsys):
    """``protocol.replay`` on the CPU, degree_aware at seed 42 on a small
    parity graph, against the JAX package's ``scripts/parity_run.py
    framework --verbose`` on the same graph: every epoch's logged loss
    within the logs' rounding (no epoch past it)."""
    import argparse
    from test_torch_parity_run import SMALL, _jax_script
    graph = tmp_path / "graph.npz"
    parity_run.main(["build", "--out", str(graph), *SMALL])
    epochs = 4
    capsys.readouterr()
    _jax_script().cmd_framework(argparse.Namespace(
        graph=str(graph), config="degree_aware", cred=None, seed=42,
        epochs=epochs, eval_every=epochs, out=None, verbose=True,
        fast=False, eval_mode=None, platform="cpu"))
    jax_log = tmp_path / "jax.out"
    jax_log.write_text(capsys.readouterr().out)
    log = tmp_path / "replay" / "degree_aware_s42.out"
    protocol.replay(graph, "degree_aware", 42, epochs, torch.device("cpu"),
                    log)
    text = log.read_text()
    assert text.startswith("[replay] degree_aware seed 42: ")
    mine = [float(x) for x in protocol._EPOCH_LOSS.findall(text)]
    jax = [float(x) for x in protocol._EPOCH_LOSS.findall(
        jax_log.read_text())]
    assert len(mine) == len(jax) == epochs
    for a, b in zip(mine, jax):
        assert abs(a - b) <= protocol.LOG_RTOL * b + protocol.LOG_ATOL


def test_replay_on_the_ports_streams_is_fit(tmp_path, capsys):
    """``protocol.replay`` with every part of the stream from the port's
    generator logs what ``parity_run framework --verbose`` (``fit``, with
    its evaluations) logs at the same seed, epoch for epoch; one part
    from the port gives another run."""
    from test_torch_parity_run import SMALL
    graph = tmp_path / "graph.npz"
    parity_run.main(["build", "--out", str(graph), *SMALL])
    epochs = 4
    capsys.readouterr()
    parity_run.main(["framework", "--graph", str(graph), "--config",
                     "degree_aware", "--seed", "42", "--epochs",
                     str(epochs), "--eval-every", "2", "--verbose",
                     "--device", "cpu"])
    fit = protocol._EPOCH_LOSS.findall(capsys.readouterr().out)
    cpu = torch.device("cpu")
    logs = {}
    for arm in ("init+perm+samples", "perm+samples"):
        log = tmp_path / arm / "degree_aware_s42.out"
        protocol.replay(graph, "degree_aware", 42, epochs, cpu, log,
                        port_streams=tuple(arm.split("+")))
        logs[arm] = protocol._EPOCH_LOSS.findall(log.read_text())
    assert len(fit) == epochs and logs["init+perm+samples"] == fit
    assert logs["perm+samples"] != fit
    with pytest.raises(ValueError, match="unknown streams"):
        protocol.replay(graph, "degree_aware", 42, 1, cpu, tmp_path / "x",
                        port_streams=("eval",))



def _small_trainer(tmp_path, seed=42):
    from test_torch_parity_run import SMALL
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.train.trainer import RecTrainer
    graph = tmp_path / "f10" / "parity_graph.npz"
    with contextlib.redirect_stdout(io.StringIO()):
        parity_run.main(["build", "--out", str(graph), *SMALL])
    cfg = parity_run.framework_config("degree_aware", 2, 2, seed)
    return graph, RecTrainer(cfg, parity_run.load_graph(graph),
                             device="cpu", verbose=False)


def test_twogen_streams_are_fits_init_and_a_second_generator(tmp_path):
    """The twogen arm's streams: the initial tables bit-equal to
    ``RecTrainer.init_state(seed)``'s, the first two epochs' draws
    bit-equal to ``draw_epoch`` on a generator seeded seed +
    F10_EPOCH_SEED_OFFSET; without ``epoch_seed`` the epochs continue
    ``fit``'s one generator after the initial tables."""
    _, tr = _small_trainer(tmp_path)
    seed = 42
    assert protocol.F10_EPOCH_SEED_OFFSET == 10_000
    fit_params, _, fit_gen = tr.init_state(seed)
    second = torch.Generator()
    second.manual_seed(seed + protocol.F10_EPOCH_SEED_OFFSET)
    for epoch_seed, gen in ((seed + protocol.F10_EPOCH_SEED_OFFSET, second),
                            (None, fit_gen)):
        params, key, draw = protocol.replay_streams(
            tr, seed, protocol.PORT_STREAMS, epoch_seed=epoch_seed)
        assert params.keys() == fit_params.keys()
        for k, v in params.items():
            assert torch.equal(v, fit_params[k]), k
        for _ in range(2):
            batches, key = draw(key)
            want = tr.draw_epoch(gen)
            assert len(batches) == len(want) == 4
            for got, w in zip(batches, want):
                assert np.array_equal(got, w.numpy())
    with pytest.raises(ValueError, match="epoch_seed"):
        protocol.replay_streams(tr, seed, ("init",), epoch_seed=1)


def test_f10_fresh_part_writes_three_arms(tmp_path, monkeypatch):
    """``protocol f10_fresh`` on the CPU at a tiny size, one seed: the own
    arm's log (``fit``, a header naming the device), the replay of JAX's
    streams and the twogen replay, each with its epoch lines; the twogen
    log is the loop of ``run_epoch`` on ``fit``'s initial tables and the
    second generator's draws, digit for digit."""
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops.adam import adam_init
    graph, tr = _small_trainer(tmp_path, seed=74)
    epochs = 2
    monkeypatch.setattr(protocol, "SPREAD_EPOCHS", epochs)
    with contextlib.redirect_stdout(io.StringIO()):
        protocol.main(["f10_fresh", "--out", str(tmp_path), "--device",
                       "cpu", "--only", "degree_aware:74"])
    d = tmp_path / "f10"
    assert sorted(p.name for p in d.iterdir() if p.is_dir()) == [
        "port_cpu", "replay_cpu", "twogen_cpu"]
    own = (d / "port_cpu" / "degree_aware_s74.out").read_text()
    assert own.startswith("[f10_fresh] own: parity_run framework --graph ")
    assert own.splitlines()[0].endswith("--eval-every 2 on cpu")
    logs = {a: protocol._EPOCH_LOSS.findall(
        (d / f"{a}_cpu" / "degree_aware_s74.out").read_text())
        for a in ("port", "replay", "twogen")}
    assert all(len(v) == epochs for v in logs.values())
    assert not (d / "port_cpu" / "degree_aware_s75.out").exists()
    params, opt, _ = tr.init_state(74)
    opt = adam_init(params)
    gen = torch.Generator()
    gen.manual_seed(74 + protocol.F10_EPOCH_SEED_OFFSET)
    mine = [f"{float(tr.run_epoch(params, opt, tr.draw_epoch(gen)).mean()):.6f}"
            for _ in range(epochs)]
    assert logs["twogen"] == mine
    assert logs["twogen"] != logs["port"]


def _fresh_logs(out, arm, means):
    d = out / "f10" / f"{protocol.F10_ARM_DIRS[arm]}_h100"
    d.mkdir(parents=True, exist_ok=True)
    for s, m in zip(protocol.F10_FRESH_SEEDS, means):
        _log(d / f"degree_aware_s{s}.out", [0.5] * 4 + [m] * 4)


FRESH_JAX = [0.2000, 0.2010, 0.1990, 0.2005, 0.1995, 0.2000]
FRESH_BRANCHES = {
    # own - jax within its limit
    "A": dict(own=[0.2003, 0.2012, 0.1994, 0.2006, 0.1999, 0.2001],
              twogen=[0.2001, 0.2009, 0.1991, 0.2004, 0.1996, 0.2002]),
    # own beyond jax, twogen within jax, own beyond twogen
    "B1": dict(own=[0.2030, 0.2041, 0.2019, 0.2036, 0.2025, 0.2031],
               twogen=[0.2001, 0.2009, 0.1991, 0.2004, 0.1996, 0.2002]),
    # own beyond jax, twogen beyond jax too
    "B2": dict(own=[0.2030, 0.2041, 0.2019, 0.2036, 0.2025, 0.2031],
               twogen=[0.2028, 0.2039, 0.2020, 0.2033, 0.2026, 0.2030]),
}


@pytest.mark.parametrize("branch", sorted(FRESH_BRANCHES))
def test_summary_fresh_rows_follow_the_rule(tmp_path, monkeypatch, branch):
    """F10's decision on synthetic logs (six seeds, 8 epochs, means of the
    last 4): the rows own - jax, twogen - jax and own - twogen with 2
    pooled SE (Welch's standard error, held against ``scipy.stats``), the
    branch the fixed rule gives, the spread's two-sided F test, PENDING
    while a seed is missing; seeds 42-73 enter no verdict."""
    from scipy import stats
    monkeypatch.setattr(protocol, "SPREAD_EPOCHS", 8)
    monkeypatch.setattr(protocol, "LOSS_WINDOW", 4)
    monkeypatch.setattr(protocol, "REPLAY_SEEDS", {"degree_aware": (42,)})
    monkeypatch.setattr(protocol, "F10_FRESH_SEEDS", tuple(range(74, 80)))
    jax_dir = tmp_path / "jax"
    _f10_logs(jax_dir, "degree_aware", (42,), lambda s: [0.3] * 8)
    _f10_logs(tmp_path / "f10" / "replay_h100", "degree_aware", (42,),
              lambda s: [0.3] * 8)
    assert protocol.fresh_lines(tmp_path, jax_dir) == []
    arms = dict(FRESH_BRANCHES[branch], jax=FRESH_JAX)
    for arm, means in arms.items():
        _fresh_logs(tmp_path, arm, means)
    lines = protocol.fresh_lines(tmp_path, jax_dir)
    assert "| 74 | 0.500000 | " not in lines   # the last 4 epochs' means
    assert f"| 74 | {arms['own'][0]:.6f} | {arms['jax'][0]:.6f} | " \
           f"{arms['twogen'][0]:.6f} |" in lines
    rows = {ln.split("|")[1].strip(): ln for ln in lines
            if ln.startswith("| own - ") or ln.startswith("| twogen - ")}
    beyond = {}
    for x, y in (("own", "jax"), ("twogen", "jax"), ("own", "twogen")):
        a, b = np.array(arms[x]), np.array(arms[y])
        t = stats.ttest_ind(a, b, equal_var=False)
        diff = a.mean() - b.mean()
        se = diff / t.statistic                  # Welch's standard error
        assert se == pytest.approx(np.sqrt(a.var(ddof=1) / 6
                                           + b.var(ddof=1) / 6), rel=1e-9)
        got = protocol.two_means(list(a), list(b))
        assert got["limit"] == pytest.approx(2 * se, rel=1e-9)
        assert got["p"] == pytest.approx(t.pvalue, rel=1e-9)
        beyond[x, y] = abs(diff) > 2 * se
        assert rows[f"{x} - {y}"].endswith(
            f"| {diff:+.6f} | {2 * se:.6f} | {t.pvalue:.3g} | "
            + ("yes" if beyond[x, y] else "no") + " |")
    want = ("A" if not beyond["own", "jax"] else "B1"
            if not beyond["twogen", "jax"] and beyond["own", "twogen"]
            else "B2")
    assert want == branch
    assert f"**Branch: {branch}: {protocol.F10_BRANCHES[branch]}.**" in lines
    # the spread's F test, two-sided
    f = np.var(arms["own"], ddof=1) / np.var(FRESH_JAX, ddof=1)
    p = 2 * min(stats.f.cdf(f, 5, 5), stats.f.sf(f, 5, 5))
    assert protocol.two_means(arms["own"], FRESH_JAX)["f_p"] == \
        pytest.approx(p, rel=1e-9)
    spread = [ln for ln in lines if ln.startswith("Not judged: ")][0]
    assert f"F test p {p:.3g}: F11 " + (
        "opens" if p < 0.01 else "does not open") in spread
    # seeds 42-73 are context only: without them no pooled row, the same
    # branch
    assert not [ln for ln in lines if ln.startswith("Context")]
    # a missing seed leaves the branch pending
    (tmp_path / "f10" / "twogen_h100" / "degree_aware_s79.out").unlink()
    lines = protocol.fresh_lines(tmp_path, jax_dir)
    assert "**Branch: PENDING.**" in lines
    assert [ln for ln in lines if ln.startswith("| twogen - jax")][0] \
        .endswith("| PENDING |")


def test_fresh_constants_are_the_fixed_design():
    assert protocol.F10_FRESH_SEEDS == tuple(range(74, 138))
    assert len(protocol.F10_FRESH_SEEDS) == 64
    assert not set(protocol.F10_FRESH_SEEDS) & (
        set(protocol.spread_seeds("degree_aware")) | set(protocol.F10_SEEDS))
    assert protocol.F10_FRESH_ARMS == ("own", "jax", "twogen")
    assert protocol.F10_SE_LIMIT == 2.0 and protocol.F10_SPREAD_P == 0.01
    epoch_seeds = {s + protocol.F10_EPOCH_SEED_OFFSET
                   for s in protocol.F10_FRESH_SEEDS}
    used = set(range(42, 138)) | {s + 999 for s in range(42, 138)}
    assert not epoch_seeds & used
