"""Finds a cell's configuration, traffic mix, driver, reference and
per-layer metrics by the names in ``BENCHMARK.json`` and its files.

Under the benchmark's folder:

* ``configs/<config>.json``: a configuration (the port's preset and
  overrides, the graph's generator and parameters, the reference it is
  judged against);
* ``traffic/<mix>.json``: a traffic mix, whose ``kind`` names its driver;
* ``kinds/<kind>.py``: the driver of a kind of traffic (a class
  ``Driver``);
* ``references/<reference>.py``: a plain reference model (``build(run,
  dtype)``);
* ``generators/<generator>.py``: a frozen graph generator (``generate``);
* ``metrics/<metric>.py``: a per-layer metric's reader (``read(run) ->
  float | None``).

Nothing here lists a name: a new cell, configuration, mix, kind,
reference, generator or metric is a new file and a new entry."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
_LOADED: Dict[Path, object] = {}


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    spec: dict = field(repr=False, default_factory=dict)
    here: Path = HERE


def read_spec(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def find_cell(name: str, root: Path = HERE.parent, here: Path = HERE
              ) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json`` with its
    configuration and traffic files (read from ``here``) and the metrics it
    reports: the end-to-end metrics that list it (or list no cells), and
    the per-layer metrics that list it or, listing none, move one of its
    end-to-end metrics."""
    spec = read_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg = configs[w["config"]]
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads((here / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _reports(m, name, names)]
    return Cell(name=name, config=config, traffic=traffic, end_to_end=e2e,
                per_layer=per_layer, spec=w, here=here)


def load(folder: str, name: str, here: Path = HERE):
    """The module ``<here>/<folder>/<name>.py``, loaded once."""
    path = here / folder / f"{name}.py"
    if path not in _LOADED:
        if not path.exists():
            raise KeyError(f"no file {path}")
        mod_name = "benchmark_{}_{}".format(
            folder, name.replace(".", "_").replace("-", "_"))
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def driver(kind: str, here: Path = HERE) -> type:
    """``Driver`` of ``kinds/<kind>.py``."""
    return load("kinds", kind, here).Driver


def metric_reader(name: str, here: Path = HERE) -> Callable:
    """``read`` of ``metrics/<name>.py``."""
    return load("metrics", name, here).read


def read_metrics(metrics: List[dict], run, here: Path = HERE
                 ) -> Dict[str, dict]:
    """Each metric's reading of ``run``, with its unit; a reader that finds
    nothing to read returns None and its metric is left out."""
    out = {}
    for m in metrics:
        value = metric_reader(m["name"], here)(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
