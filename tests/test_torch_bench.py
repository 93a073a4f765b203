"""The port's bench (``<port>/bench.py``) against the JAX package's root
``bench.py`` (imported by path; it imports the JAX package inside its
functions only).

* ``build_graph("small")`` gives JAX's arrays exactly (the same numpy);
* ``main`` at ``--scale small --device cpu`` prints one JSON line with the
  JAX bench's keys in both modes, with JAX's ``edges_per_step`` formula;
* without ``--device cpu`` and without a card it exits non-zero and names
  the flag (no fallback);
* ``bench_northstar`` on a small planted graph times the propagation that
  JAX's ``RecTrainer(scaled_10m)._propagate_fn`` computes on the same
  parameters, within 1e-5 * |ref| + 1e-6, and returns JAX's keys with
  ``value == E * 2K / propagate_s``;
* no TPU constant of the JAX bench's roofline is in the port's.
"""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.configs.presets import get_preset as j_preset
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.graph.build import synthetic_bipartite_graph_planted as j_planted
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.train.trainer import RecTrainer as JTrainer
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch import bench
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.graph.build import synthetic_bipartite_graph_planted
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.models.lightgcn import LightGCN, params_from_jax
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops.adam import adam_init
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.train.trainer import RecTrainer

ROOT = Path(__file__).resolve().parents[1]
JAX_HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline"}
JAX_NORTHSTAR_KEYS = {"metric", "value", "unit", "definition", "propagate_s",
                      "epoch_s"}
SMALL = ["--device", "cpu", "--scale", "small", "--iters", "1",
         "--no-northstar"]


@pytest.fixture(scope="module")
def jax_bench():
    spec = importlib.util.spec_from_file_location("jax_root_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_small_graph_equals_jax(jax_bench):
    got = bench.build_graph("small")
    want = jax_bench.build_graph("small")
    assert (got.num_users, got.num_items) == (want.num_users, want.num_items)
    for split in ("train", "val", "test"):
        np.testing.assert_array_equal(got.edges(split), want.edges(split))


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("mode,precision", [("epoch", "bf16"),
                                            ("step", "fp32")])
def test_main_prints_the_jax_headline(capsys, mode, precision):
    out = bench.main(SMALL + ["--mode", mode, "--precision", precision])
    lines = _json_lines(capsys.readouterr().out)
    assert lines == [json.loads(json.dumps(out))]
    line = lines[0]
    # JAX's keys; vs_baseline_same_precision only where JAX prints it
    want = JAX_HEADLINE_KEYS | ({"vs_baseline_same_precision"}
                                if precision != "fp32" else set())
    assert want <= set(line)
    assert ("vs_baseline_same_precision" in line) == (precision != "fp32")
    assert line["metric"] == "train_edges_per_sec_per_chip"
    assert line["unit"] == "edges/s"
    E = bench.build_graph("small").train_edges.shape[1]
    assert line["edges_per_step"] == E * 3 * 2 * 2      # JAX: E*K*2*2
    assert line["value"] == pytest.approx(line["edges_per_step"]
                                          / line["step_s"], rel=1e-12)
    assert line["value"] > 0 and line["vs_baseline"] > 0
    # a CPU run names its device and claims no share of the card's bound
    assert line["device"] == "cpu" and line["card"] is None
    assert line["share_of_bound"] is None and line["bound_step_s"] > 0


def test_main_without_a_card_exits_and_names_the_flag(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        bench.main(["--scale", "small", "--iters", "1", "--no-northstar"])
    assert e.value.code != 0
    captured = capsys.readouterr()
    assert "--device cpu" in captured.err
    assert not _json_lines(captured.out)


def test_northstar_propagation_equals_jax(monkeypatch):
    kw = dict(num_users=1500, num_items=2600, edges_per_user=9.0, seed=3,
              power=1.1)
    graph = synthetic_bipartite_graph_planted(**kw)
    jgraph = j_planted(**kw)
    jtr = JTrainer(j_preset("scaled_10m", epochs=2, seed=0), jgraph,
                   verbose=False)
    j_params = {k: np.asarray(v) for k, v in jtr.init_state()[0].items()}
    ref = [np.asarray(t) for t in jtr._propagate_fn(
        {k: jnp.asarray(v) for k, v in j_params.items()}, jtr.model.state)]

    def init_state(self, seed=None):
        params = params_from_jax(j_params, self.device)
        gen = torch.Generator(device=self.device).manual_seed(0)
        return params, adam_init(params), gen

    seen = []
    propagate = LightGCN.propagate

    def recording(self, params):
        out = propagate(self, params)
        seen.append([t.detach().clone() for t in out])
        return out

    monkeypatch.setattr(RecTrainer, "init_state", init_state)
    monkeypatch.setattr(LightGCN, "propagate", recording)
    line = bench.bench_northstar(graph=graph, iters=1, device="cpu")

    # the first propagation is the timed loop's warm-up, on the parameters
    # the trainer started from
    for got, want in zip(seen[0], ref):
        assert got.shape == want.shape == (got.shape[0], 128)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert JAX_NORTHSTAR_KEYS <= set(line)
    assert line["metric"] == "northstar_propagation_edges_per_sec_per_chip"
    E = graph.train_edges.shape[1]
    assert line["value"] == E * 2 * 4 / line["propagate_s"]
    assert line["epoch_s"] > 0 and line["steps_per_epoch"] == 1
    assert line["peak_memory_gb"] is None and line["device"] == "cpu"
    # 2 timed propagations, then 2 epochs each with its cache's: the loops
    # ran what they say
    assert len(seen) == 4


def test_no_tpu_constant_in_the_port_bench():
    text = Path(bench.__file__).read_text()
    for const in ("819e9", "5.5e-9", "819 GB", "v5e"):
        assert const not in text
