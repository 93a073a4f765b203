"""A copy of the benchmark at a toy size, for runs on the CPU."""

import json
import shutil
from pathlib import Path

import pytest

from benchmark import graphs

REPO = Path(__file__).resolve().parents[2]


def shrink(root: Path) -> Path:
    """Copy ``BENCHMARK.json`` and the benchmark's data, drivers,
    references, generators and readers under ``root``, every graph cut to
    300 users and 900 items and every mix to a few units; returns the
    copy's benchmark folder."""
    here = root / "benchmark"
    for d in ("configs", "traffic", "kinds", "references", "generators",
              "metrics"):
        shutil.copytree(REPO / "benchmark" / d, here / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg["graph"].update(users=300, items=900, edges_per_user=8.0)
        if cfg["graph"]["generator"] == "planted":
            cfg["graph"].update(coarse_clusters=2, fine_per_coarse=2)
        cfg["overrides"].update(batch_size=64, emb_dim=16)
        if "eval_batch" in cfg["overrides"]:
            cfg["overrides"]["eval_batch"] = 32
        (root / c["file"]).write_text(json.dumps(cfg))
    for name, small in (("serve", dict(pool=64, sample_from=32,
                                       sample_requests=8, min_users=8,
                                       max_users=40, trace_requests=5)),
                        ("eval", dict(trace_batches=2))):
        path = here / "traffic" / f"{name}.json"
        t = json.loads(path.read_text())
        t.update(small)
        path.write_text(json.dumps(t))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return here


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """``(root, here)`` of a toy copy; graphs are cached under tmp."""
    monkeypatch.setattr(graphs, "CACHE_DIR", tmp_path / "cache")
    return tmp_path, shrink(tmp_path)
