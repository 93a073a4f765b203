"""The reference protocol's entry points as a whole.

* every new entry-point module imports with ``jax`` blocked and pulls in no
  module of the JAX package or of the root ``scripts/``;
* the port's ``precision_compare`` prints the JAX script's table on the
  committed ``runs/precision_compare`` records;
* ``scripts/protocol.py`` runs the precision part (4 runs on the small
  graph, 1 epoch) and writes the four metrics files and their table, and
  the seeds part its metrics files;
* ``summary`` holds each record against the JAX package's: quality rows,
  and loss rows whose limit comes from the port's two precision seeds.
"""

import contextlib
import io
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import pytest

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.scripts import precision_compare, protocol

ROOT = Path(__file__).resolve().parents[1]
PORT = ("beyond_binary_fake_user_detection_a_credibility_aware_graph_based_"
        "recommender_system_tpu_torch")
MODULES = ("scripts.reference_regression", "scripts.precision_compare",
           "scripts.parity_run", "scripts.two_stage_demo", "scripts.protocol",
           "examples.end_to_end")


def test_modules_import_without_jax():
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


def test_precision_table_equals_jax():
    jax = subprocess.run([sys.executable, "scripts/precision_compare.py"],
                         cwd=ROOT, capture_output=True, text=True,
                         check=True).stdout
    with contextlib.redirect_stdout(io.StringIO()):
        ours = precision_compare.main(["--dir", str(ROOT / "runs" /
                                                     "precision_compare")])
    assert ours + "\n" == jax
    assert len(ours.splitlines()) == 2 + 6


@pytest.fixture
def short(monkeypatch):
    """The protocol's runs on the small graph for one epoch."""
    monkeypatch.setattr(protocol, "SCALE", "small")
    monkeypatch.setattr(protocol, "REFERENCE_EPOCHS", 1)


def test_precision_part_writes_its_records(tmp_path, short):
    with contextlib.redirect_stdout(io.StringIO()):
        protocol.main(["precision", "--out", str(tmp_path), "--device",
                       "cpu"])
    d = tmp_path / "precision_compare"
    assert sorted(p.name for p in d.glob("*.jsonl")) == [
        f"cu_message_{p}_s{s}.jsonl" for p in ("bf16", "fp32")
        for s in (42, 43)]
    table = (tmp_path / "PRECISION.md").read_text().splitlines()
    assert table[0].startswith("| run | epochs |")
    assert [ln.split("|")[2].strip() for ln in table[2:]] == ["1"] * 4
    assert (tmp_path / "logs" / "cu_message_bf16_s43.out").read_text() \
        .startswith("Loaded edges. Users=2,000")


def test_seeds_part_writes_its_records(tmp_path, short, monkeypatch):
    monkeypatch.setattr(protocol, "SEED_PRESETS", ("vanilla",))
    monkeypatch.setattr(protocol, "EXTRA_SEEDS", (43,))
    with contextlib.redirect_stdout(io.StringIO()):
        protocol.main(["seeds", "--out", str(tmp_path), "--device", "cpu"])
    rec = [json.loads(ln) for ln in
           (tmp_path / "seeds" / "vanilla_s43.jsonl").read_text()
           .splitlines()]
    assert len(rec) == 2 and "loss" in rec[0] and "test" in rec[1]
    text = "\n".join(protocol.summary_lines(tmp_path, ROOT / "runs"))
    row = [ln for ln in text.splitlines() if ln.startswith("| vanilla | ")
           and "by seed" not in ln][-1]
    # the preset's own seed has no run here: only seed 43's mean is there
    assert row.startswith(f"| vanilla | missing, {rec[0]['loss']:.6f} | ")


def _late_mean(path):
    losses = [json.loads(ln)["loss"] for ln in
              path.read_text().splitlines()[:-1]]
    return statistics.fmean(losses[-50:])


def test_summary_holds_records_against_jax(tmp_path):
    # the JAX package's own records in the port's place: diff 0, PASS;
    # every run not there is PENDING
    rec = (ROOT / "runs" / "cu_message_ref_scale_metrics.jsonl").read_text()
    (tmp_path / "cu_message_ref_scale_metrics.jsonl").write_text(rec)
    shutil.copytree(ROOT / "runs" / "precision_compare",
                    tmp_path / "precision_compare")
    with contextlib.redirect_stdout(io.StringIO()):
        protocol.main(["summary", "--out", str(tmp_path), "--jax-runs",
                       str(ROOT / "runs")])
    text = (tmp_path / "SUMMARY.md").read_text()
    pc = ROOT / "runs" / "precision_compare"
    var = []
    for p in ("fp32", "bf16"):
        a, b = (_late_mean(pc / f"cu_message_{p}_s{s}.jsonl")
                for s in (42, 43))
        var.append(((a - b) / ((a + b) / 2)) ** 2 / 2)
    rel = 2 * statistics.fmean(var) ** 0.5
    assert f"over the port's two precision seeds ({rel:.6f})" in text
    j = _late_mean(ROOT / "runs" / "cu_message_ref_scale_metrics.jsonl")
    rows = [ln for ln in text.splitlines() if ln.startswith("| cu_message |")]
    assert rows == [
        "| cu_message | recall@20 | 0.8231 | 0.8231 | +0.0000 | 0.0100 | "
        "PASS | 582.3 / 582.3 |",
        "| cu_message | ndcg@20 | 0.6905 | 0.6905 | +0.0000 | 0.0100 | "
        "PASS | 582.3 / 582.3 |",
        "| cu_message | last epoch's VAL recall@20 | 0.8231 | 0.8231 | "
        "+0.0000 | 0.0100 | PASS | |",
        f"| cu_message | mean loss, last 50 epochs | {j:.6f} | {j:.6f} | "
        f"+0.000000 | {rel * j:.6f} | PASS | |"]
    assert "| cu_message_bf16_s43 | mean loss, last 50 epochs | " \
        "0.090897 | 0.090897 | +0.000000 |" in text
    assert "| vanilla | recall@20 | 0.8248 | missing | | | PENDING |" in text
    assert "| vanilla | mean loss, last 50 epochs | 0.088162 | missing | " \
        "| | PENDING |" in text
    assert "| scaled_10m | recall@20 | 0.2185 | missing | | | PENDING |" \
        in text
    assert "Two-stage demo" not in text
