"""The port's ingest bench (``<port>/scripts/ingest_bench.py``) against the
JAX package's ``scripts/ingest_bench.py`` on a 2,000-line stream: the same
file bytes, ``rows_kept`` equal to JAX's, and JAX's keys plus ``host_cpu``,
``card`` and ``write_s``; a file it did not write stays."""

import contextlib
import io
import json
import subprocess
import sys
from pathlib import Path

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.scripts import ingest_bench

ROOT = Path(__file__).resolve().parents[1]
SIZE = ["--lines", "2000", "--users", "300", "--items", "900",
        "--python-lines", "1000"]


def test_record_matches_jax(tmp_path):
    out = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "ingest_bench.py"), *SIZE,
         "--path", str(tmp_path / "jax.jsonl")], cwd=tmp_path,
        capture_output=True, text=True, check=True).stdout
    jax = json.loads(out.strip().splitlines()[-1])
    with contextlib.redirect_stdout(io.StringIO()):
        rec = ingest_bench.main([*SIZE, "--path", str(tmp_path / "p.jsonl"),
                                 "--out", str(tmp_path / "port.json"),
                                 "--device", "cpu"])
    assert set(rec) == set(jax) | {"host_cpu", "card", "write_s"}
    for k in ("lines", "bytes", "rows_kept", "python_prefix_lines"):
        assert rec[k] == jax[k], k
    assert rec["rows_kept"] == 2000 and rec["card"] is None
    assert json.loads((tmp_path / "port.json").read_text()) == rec
    assert not (tmp_path / "p.jsonl").exists()       # it wrote it: removed


def test_an_existing_file_is_kept(tmp_path):
    path = tmp_path / "given.jsonl"
    with contextlib.redirect_stdout(io.StringIO()):
        ingest_bench.main([*SIZE, "--path", str(path), "--keep", "--out",
                           str(tmp_path / "a.json"), "--device", "cpu"])
        rec = ingest_bench.main([*SIZE, "--path", str(path), "--out",
                                 str(tmp_path / "b.json"), "--device",
                                 "cpu"])
    assert path.exists() and "write_s" not in rec
    assert rec["rows_kept"] == 2000
