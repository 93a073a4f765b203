"""The port's quality-parity harness (``<port>/scripts/parity_run.py``)
against the JAX package's ``scripts/parity_run.py`` (imported by path; it
imports the JAX package inside its commands only).

* ``CONFIG_MAP``, ``REAL_CRED`` and ``EXT_METRICS`` equal JAX's;
* ``build`` at small arguments writes arrays equal to JAX's ``cmd_build``;
* ``report`` on the committed ``runs/parity`` records (the JAX framework's
  in the port's column) reproduces every row of ``docs/QUALITY_PARITY.md``
  (oracle, framework, diff, tol, verdict) string for string;
* ``framework`` on a tiny graph on the CPU appends one line with the keys of
  the JAX harness's records plus ``card``, in both protocols.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.scripts import parity_run

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--users", "300", "--items", "900", "--edges-per-user", "6",
         "--seed", "3"]


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_parity_run", ROOT / "scripts" / "parity_run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(text):
    """(config, metric, table) -> the row's cells, of every row with a
    verdict."""
    out, table = {}, "sampled"
    for ln in text.splitlines():
        if ln.startswith("## Fast-mode"):
            table = "full"
        cells = [c.strip() for c in ln.strip().strip("|").split("|")]
        if len(cells) >= 7 and cells[-1] in ("PASS", "FAIL"):
            out[(cells[0], cells[1], table)] = cells
    return out


DOC_ROWS = _rows((ROOT / "docs" / "QUALITY_PARITY.md").read_text())


def test_config_map_equals_jax():
    jax = _jax_script()
    assert parity_run.CONFIG_MAP == jax.CONFIG_MAP
    assert parity_run.REAL_CRED == jax.REAL_CRED
    assert parity_run.EXT_METRICS == jax.EXT_METRICS


def test_build_equals_jax(tmp_path, capsys):
    parity_run.main(["build", "--out", str(tmp_path / "p" / "graph.npz"),
                     *SMALL])
    jax = _jax_script()
    import argparse
    jax.cmd_build(argparse.Namespace(out=str(tmp_path / "j" / "graph.npz"),
                                     users=300, items=900, edges_per_user=6.0,
                                     seed=3))
    ours, theirs = (np.load(tmp_path / d / "graph.npz") for d in ("p", "j"))
    assert sorted(ours.files) == sorted(theirs.files)
    for k in theirs.files:
        np.testing.assert_array_equal(ours[k], theirs[k])
    np.testing.assert_array_equal(np.load(tmp_path / "p" / "cred.npy"),
                                  np.load(tmp_path / "j" / "cred.npy"))


@pytest.fixture(scope="module")
def report_rows(tmp_path_factory):
    out = tmp_path_factory.mktemp("report") / "QUALITY_PARITY.md"
    text = parity_run.cmd_report(type("A", (), dict(
        dir=str(ROOT / "runs" / "parity"),
        jax_dir=str(ROOT / "runs" / "parity"), report_out=str(out)))())
    assert out.read_text() == text
    return _rows(text)


def test_report_has_every_row_of_the_docs(report_rows):
    assert len(DOC_ROWS) == 26
    assert sorted(report_rows) == sorted(DOC_ROWS)


@pytest.mark.parametrize("key", sorted(DOC_ROWS),
                         ids=lambda k: "-".join(k))
def test_report_row_equals_the_docs(report_rows, key):
    ours, doc = report_rows[key], DOC_ROWS[key]
    # oracle and framework cells, then diff, tol and verdict; the port's
    # report adds the JAX framework's column, here the same records
    assert ours[:4] + ours[-3:] == doc[:4] + doc[-3:]
    assert ours[4] == ours[3]


@pytest.fixture(scope="module")
def tiny_graph(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny")
    parity_run.main(["build", "--out", str(d / "graph.npz"), *SMALL])
    return d


@pytest.mark.parametrize("config,fast", [("cred_eq322", False),
                                         ("cu_message", True)])
def test_framework_writes_the_jax_keys(tiny_graph, config, fast):
    out = tiny_graph / f"{config}_{fast}.jsonl"
    rec = parity_run.main(["framework", "--graph",
                           str(tiny_graph / "graph.npz"), "--config", config,
                           "--seed", "1", "--epochs", "2", "--eval-every",
                           "1", "--device", "cpu", "--out", str(out)]
                          + (["--fast"] if fast else []))
    lines = out.read_text().splitlines()
    assert len(lines) == 1
    written = json.loads(lines[0])
    jax = json.loads((ROOT / "runs" / "parity" / "framework_fast.jsonl")
                     .read_text().splitlines()[0])
    assert set(written) == set(jax) | {"card"}
    assert written["card"] is None
    assert (written["config"], written["seed"], written["fast"],
            written["eval_mode"]) == (config, 1, fast,
                                      "full" if fast else "sampled")
    assert set(written["test"]) == {"10", "20"}
    assert all(np.isfinite(v) for v in written["test"]["20"].values())
    assert written == json.loads(json.dumps(rec))
