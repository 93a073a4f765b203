"""The harness on the CPU: the spec, finding files by name (and a new cell,
kind and reference taken as added files), the window, the import check, the
frozen generators, the trace arithmetic and a toy pass of every traffic
mix."""

import hashlib
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import graphs, registry
from benchmark.imports import JAX_PACKAGE, PORT_PACKAGE, forbidden_loaded
from benchmark.run import main, run_cell
from benchmark.tracing import Trace, kernel_name
from benchmark.window import (OpenWindow, Window, arrivals, p95_ms, rate,
                              readings)

REPO = Path(__file__).resolve().parents[2]

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())


def test_spec_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for x in SPEC[group]:
            assert NAME.match(x["name"]), x["name"]
            assert x["name"] not in names
            names.add(x["name"])
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert (REPO / c["file"]).exists()
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("device_trace", "host_clock")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert (REPO / "benchmark" / "metrics" / f"{m['name']}.py").exists()
        for w in m.get("workloads", []):
            cell = registry.find_cell(w)
            assert m["moves"] in {x["name"] for x in cell.end_to_end}
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        cell = registry.find_cell(w["name"])
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2 and cell.per_layer
        assert got == {"setup_s"} | set(cell.traffic["end_to_end"])
        assert (REPO / "benchmark" / "kinds"
                / f"{cell.traffic['kind']}.py").exists()
        assert (REPO / "benchmark" / "references"
                / f"{cell.config['reference']}.py").exists()
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_a_cell_is_found_by_its_names():
    cell = registry.find_cell("scaled_10m.train")
    assert cell.config["preset"] == "scaled_10m"
    assert cell.traffic["kind"] == "train"
    assert {m["name"] for m in cell.end_to_end} == {"train_samples_per_s",
                                                    "setup_s"}
    assert "fused_adam_roofline" in {m["name"] for m in cell.per_layer}
    with pytest.raises(KeyError):
        registry.find_cell("no_such.cell")


def _digest(root):
    return {p.relative_to(root).as_posix():
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_new_cell_is_added_as_files_alone(tiny):
    root, here = tiny
    before = _digest(here)
    cfg = json.loads((here / "configs" / "cu_message_ref.json").read_text())
    cfg["graph"]["seed"] = 5
    (here / "configs" / "new_cfg.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "traffic" / "serve.json").read_text())
    mix["max_users"] = 20
    (here / "traffic" / "small_serve.json").write_text(json.dumps(mix))
    (here / "metrics" / "new.metric.py").write_text(
        "def read(run):\n    return 7.0 if run == 'x' else None\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "new_cfg", "source": "s",
                            "file": "benchmark/configs/new_cfg.json",
                            "reduced": [], "why": "w"})
    spec["workloads"].append({"name": "new_cfg.small_serve",
                              "config": "new_cfg", "traffic": "small_serve",
                              "chips": 1, "why": "w"})
    spec["per_layer"].append({"name": "new.metric", "unit": "ms",
                              "better": "lower", "source": "host_clock",
                              "layer": "ranking", "moves": "serve_p95_ms",
                              "workloads": ["new_cfg.small_serve"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = registry.find_cell("new_cfg.small_serve", root, here)
    assert cell.config["graph"]["seed"] == 5
    assert cell.traffic["max_users"] == 20
    assert "new.metric" in {m["name"] for m in cell.per_layer}
    assert registry.read_metrics(
        [m for m in cell.per_layer if m["name"] == "new.metric"], "x",
        here) == {"new.metric": {"value": 7.0, "unit": "ms"}}
    after = _digest(here)
    assert {k: v for k, v in after.items() if k in before} == before
    out = run_cell(cell, 3, 0.2, False, torch.device("cpu"))
    assert out["correct"]


NEW_KIND = '''
import torch

from benchmark.drivers import make_tables, port
from benchmark.window import Window


class Driver:
    CONTROL = CONTROL_OVERRIDES = None
    FAULTS = ()

    def __init__(self, run):
        self.run, self.failed = run, 0
        self.tr = port("train.trainer").RecTrainer(
            run.cfg, run.graph, device=run.device, verbose=False)

    def start(self, seed):
        r = self.run
        self.p0 = make_tables(seed, r.users, r.items, r.cfg.emb_dim, r.device)

    def unit(self):
        with torch.no_grad():
            self.answer = self.tr.model.propagate(self.p0)
        return float(self.run.users)

    warm = trace = unit

    def window(self, seconds):
        return Window(seconds).run(self.unit)

    def release(self):
        self.tr = None

    def judge(self, answer):
        ref = self.run.reference_model().propagate(
            self.p0["user_emb"].double(), self.p0["item_emb"].double())
        return {"prop_gap": max(float((a.double() - b).abs().max())
                                for a, b in zip(answer, ref))}
'''

NEW_REFERENCE = '''
import torch


class Dense:
    """Gauss-Seidel layers on a dense item x user matrix."""

    def __init__(self, run, dtype):
        u, i = (torch.as_tensor(x, dtype=torch.int64) for x in run.train)
        du = torch.bincount(u, minlength=run.users).clamp(min=1).to(dtype)
        di = torch.bincount(i, minlength=run.items).clamp(min=1).to(dtype)
        self.A = torch.zeros(run.items, run.users, dtype=dtype)
        self.A[i, u] = (du[u] * di[i]).rsqrt()
        self.K = run.cfg.num_layers

    def propagate(self, eu, ei):
        us, its = [eu], [ei]
        for _ in range(self.K):
            its.append(self.A @ us[-1])
            us.append(self.A.T @ its[-1])
        return torch.stack(us).mean(0), torch.stack(its).mean(0)


def build(run, dtype=torch.float64):
    return Dense(run, dtype)
'''


def test_a_new_kind_and_reference_are_added_as_files_alone(tiny):
    """A kind of traffic the harness has no driver for, judged against a
    reference it has no file for: both come as new files, with a new
    configuration, mix and cell, and no file of the benchmark is edited."""
    root, here = tiny
    before = _digest(here)
    (here / "kinds" / "propagate.py").write_text(NEW_KIND)
    (here / "references" / "dense.gauss_seidel.py").write_text(NEW_REFERENCE)
    cfg = json.loads((here / "configs" / "cu_message_ref.json").read_text())
    cfg["reference"] = "dense.gauss_seidel"
    (here / "configs" / "dense.json").write_text(json.dumps(cfg))
    (here / "traffic" / "propagate.json").write_text(json.dumps(
        {"kind": "propagate", "end_to_end": {"prop_users_per_s": "rate"},
         "limits": {"prop_gap": 1e-5}}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "dense", "source": "s",
                            "file": "benchmark/configs/dense.json",
                            "reduced": [], "why": "w"})
    spec["workloads"].append({"name": "dense.propagate", "config": "dense",
                              "traffic": "propagate", "chips": 1,
                              "why": "w"})
    spec["end_to_end"].append({"name": "prop_users_per_s",
                               "unit": "users/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock",
                               "workloads": ["dense.propagate"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = registry.find_cell("dense.propagate", root, here)
    assert [m["name"] for m in cell.end_to_end] == ["setup_s",
                                                    "prop_users_per_s"]
    out = run_cell(cell, 2**31 + 7, 0.2, False, torch.device("cpu"))
    assert out["correct"] and out["attempted"] >= 1
    assert 0 < out["checks"]["prop_gap"]["value"] < 1e-5
    after = _digest(here)
    assert {k: v for k, v in after.items() if k in before} == before


def test_the_window_takes_all_work_over_all_time():
    win = Window(0.05).run(lambda: (time.sleep(0.01), 3.0)[1])
    assert win.work == 3.0 * win.units
    assert win.elapsed >= 0.05
    assert sum(win.latencies) <= win.elapsed
    assert win.rate == pytest.approx(win.work / win.elapsed)
    assert rate(10.0, 4.0) == 2.5
    with pytest.raises(ValueError):
        rate(1.0, 0.0)


def test_arrivals_are_evenly_spaced():
    a = arrivals(200.0, 5.0)
    assert a.size == 1000 and a[0] == 0.0
    np.testing.assert_allclose(np.diff(a), 1 / 200)


def test_an_open_window_times_each_request_from_when_it_was_due():
    offsets = np.array([0.0, 0.001, 0.002, 0.030])
    win = OpenWindow(offsets).run(lambda: (time.sleep(0.005), 2.0)[1])
    assert win.units == 4 and win.work == 8.0
    # the second and third arrive while the first is served: they wait
    assert win.latencies[2] > win.latencies[0] + 0.004
    assert win.latencies[3] < win.latencies[2]
    assert win.elapsed >= 0.035


def test_a_window_reads_its_rate_and_tail():
    win = Window(1.0)
    win.work, win.elapsed, win.latencies = 50.0, 2.0, [0.001 * k
                                                       for k in range(1, 101)]
    assert readings(win) == {"rate": 25.0, "p95_ms": pytest.approx(95.05)}


def test_the_tail_is_over_all_requests():
    lat = np.arange(1, 101) / 1e3
    assert p95_ms(lat) == pytest.approx(95.05)
    assert p95_ms([0.002] * 19 + [1.0]) == pytest.approx(0.002e3 + 0.05
                                                          * 998.0)


def test_the_import_check_compares_whole_top_level_names():
    assert PORT_PACKAGE.startswith(JAX_PACKAGE)
    assert forbidden_loaded([PORT_PACKAGE, PORT_PACKAGE + ".ops",
                             "numpy", "jaxtyping", "flaxen"]) == []
    assert forbidden_loaded(["jax.numpy", "jaxlib", "flax.linen",
                             JAX_PACKAGE + ".ops"]) == sorted(
        ["jax", "jaxlib", "flax", JAX_PACKAGE])


def test_the_harness_loads_no_jax():
    code = ("import sys, torch; from benchmark import run, calibrate; "
            "from benchmark.drivers import port; "
            "port('train.trainer'); port('eval.retrieval'); "
            "from benchmark.imports import forbidden_loaded; "
            "print(forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("generator,kw", [
    ("zipf", dict(hash_split="md5")), ("zipf", dict(hash_split="fast")),
    ("planted", dict(coarse_clusters=3, fine_per_coarse=2,
                     mix=(0.5, 0.3, 0.2)))])
def test_the_frozen_generators_give_the_ports_edges(generator, kw):
    from importlib import import_module
    build = import_module(f"{PORT_PACKAGE}.graph.build")
    port_fn = {"zipf": build.synthetic_bipartite_graph,
               "planted": build.synthetic_bipartite_graph_planted}[generator]
    g = port_fn(400, 700, 6.0, seed=3, power=1.0, **kw)
    tr, va, te = graphs.generator(generator)(400, 700, 6.0, seed=3,
                                             power=1.0, **kw)
    for a, b in ((tr, g.train_edges), (va, g.val_edges), (te, g.test_edges)):
        np.testing.assert_array_equal(a, b)


def test_a_graph_is_built_once_into_a_fixed_path(tmp_path, monkeypatch):
    monkeypatch.setattr(graphs, "CACHE_DIR", tmp_path)
    spec = {"generator": "zipf", "users": 50, "items": 80,
            "edges_per_user": 4.0, "seed": 1, "power": 1.0,
            "hash_split": "fast"}
    path = graphs.cache_path(spec)
    assert path == graphs.cache_path(dict(spec)) and path.parent == tmp_path
    first = graphs.load_edges(spec)
    assert path.exists() and [p.name for p in tmp_path.iterdir()] == \
        [path.name]
    second = graphs.load_edges(spec)
    for a, b in zip(first[2:], second[2:]):
        np.testing.assert_array_equal(a, b)


def test_kernel_names_from_records():
    for rec, name in (
            ("void rows_kernel<float, float, 4, 1>(long const*, int)",
             "rows_kernel"),
            ("void (anonymous namespace)::rows_kernel<float>(int)",
             "rows_kernel"),
            ("_Z16long_rows_kernelIfEvPKfPKiS3_PT_i", "long_rows_kernel"),
            ("fused_adam_multi_kernel(LeafTable, float, float)",
             "fused_adam_multi_kernel")):
        assert kernel_name(rec) == name


def test_trace_busy_idle_and_completeness():
    tr = Trace(device=[("void rows_kernel<float>(int)", 10.0, 20.0),
                       ("void long_rows_kernel<float>(int)", 15.0, 30.0),
                       ("Memcpy DtoH (Device -> Pageable)", 50.0, 60.0),
                       ("void fused_adam_multi_kernel(T)", 80.0, 90.0)],
               host=[("aten::item", 30.0, 50.0), ("bench.epoch", 0.0, 100.0),
                     ("cudaLaunchKernel", 5.0, 6.0)],
               window=(0.0, 100.0), launches=3,
               counters={"spmm": 1, "fused_adam": 1})
    assert tr.window_s == pytest.approx(1e-4)
    assert tr.busy_s() == pytest.approx(40e-6)
    gaps = dict(tr.idle_gaps())
    assert gaps["aten::item"] == pytest.approx(20e-6)
    assert gaps["bench.epoch"] == pytest.approx(30e-6)
    assert gaps["cudaLaunchKernel"] == pytest.approx(10e-6)
    assert tr.complete({"rows_kernel": 1, "fused_adam_multi_kernel": 1})
    assert not tr.complete({"rows_kernel": 2})
    assert tr.kernel_s(("rows_kernel", "long_rows_kernel")) == \
        pytest.approx(25e-6)
    assert tr.idle_pct() == pytest.approx(60.0)
    # from the start of the host's "bench.epoch" on, without Adam
    assert tr.device_s_since("aten::item", ("fused_adam_multi_kernel",)) \
        == pytest.approx(10e-6)
    lost = Trace(device=tr.device[:1], host=tr.host, window=tr.window,
                 launches=3)
    assert not lost.complete({})


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_a_toy_pass_of_each_traffic_writes_no_device_metric(tiny, workload):
    root, here = tiny
    cell = registry.find_cell(workload, root, here)
    out = run_cell(cell, 2**31 + 11, 0.3, False, torch.device("cpu"))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert out["metrics"] == {}
    assert out["device"]["platform"] == "cpu"
    assert list(out)[-1] == "checks"
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]


def test_no_card_no_result(capsys):
    assert main(["--workload", "scaled_10m.train", "--seed", "1",
                 "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_no_result_outside_the_repository(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text(
        (REPO / "BENCHMARK.json").read_text())
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    out = subprocess.run([sys.executable, "-m", "benchmark.run",
                          "--workload", "cu_message_ref.serve", "--seed",
                          "1", "--seconds", "1"], cwd=tmp_path,
                         capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""
