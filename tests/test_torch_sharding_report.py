"""The port's sharding report (``<port>/scripts/sharding_report.py``): its
plan of ``scaled_10m``'s two operators on a small zipf graph over a model
axis of 4 equals ``JAX: parallel/sharded_spmm.py``'s on the 8-device CPU
mesh of ``tests/conftest.py`` (data 2 x model 4, the JAX script's mesh),
stat for stat; the exclusion block equals the JAX script's computation;
the record keeps the keys of ``runs/sharding_report.json`` and compares
itself with it element for element."""

import contextlib
import io
import json
from pathlib import Path

import jax
import numpy as np

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.configs.presets import get_preset as j_preset
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.eval.retrieval import exclusion_rows_for_users as j_excl
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.graph.build import synthetic_bipartite_graph as j_graph
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.graph.operators import build_edge_maps as j_maps
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.parallel.mesh import make_mesh
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.parallel.sharded_spmm import ShardedSpmmOperator as JOp
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.graph.build import synthetic_bipartite_graph
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.scripts import sharding_report as sr

ROOT = Path(__file__).resolve().parents[1]

ARGS = (3000, 8000, 10.0)


def _json(x):
    return json.loads(json.dumps(x))


def test_stats_equal_jax_on_the_cpu_mesh():
    assert len(jax.devices()) >= 8
    jg = j_graph(*ARGS, seed=0, power=1.0)
    g = synthetic_bipartite_graph(*ARGS, seed=0, power=1.0)
    cred = np.random.default_rng(0).uniform(
        0.2, 1.0, jg.num_users).astype(np.float32)
    mesh = make_mesh(8, shape=(2, 4))
    want = {name: JOp(em, mesh=mesh, mode="halo").stats for name, em in
            zip(sr.OPERATORS, j_maps(jg, j_preset("scaled_10m").weight_mode,
                                     cred))}
    got = sr.operator_stats(g, 4)
    assert sr.differences(_json(got), _json(want)) == []
    users = np.random.default_rng(1).integers(0, g.num_users, 512)
    excl = j_excl(jg, users)
    block = sr.exclusion_block(g)
    assert block["batch_rows_shape"] == list(excl.shape)
    assert block["batch_bytes"] == excl.nbytes


def test_record_keys_and_self_comparison(tmp_path):
    g = synthetic_bipartite_graph(*ARGS, seed=0, power=1.0)
    with contextlib.redirect_stdout(io.StringIO()):
        rec = sr.main(["--out", str(tmp_path / "r.json"), "--device", "cpu"],
                      graph=g)
    jax_rec = json.loads((ROOT / "runs" / "sharding_report.json").read_text())
    assert set(rec) == set(jax_rec) | {"card",
                                        "differences_from_jax_record"}
    for name in sr.OPERATORS:
        op, jop = rec["operators"][name], jax_rec["operators"][name]
        assert set(op) == set(jop)
        assert set(op["fwd"]) == set(jop["fwd"]) == set(sr.DIR_KEYS)
    # a small graph differs from the record in its numbers, not its keys
    diff = rec["differences_from_jax_record"]
    assert diff and not any(d.endswith(": missing") for d in diff)
    assert sr.differences(jax_rec, jax_rec) == []
    assert sr.differences({"a": [1, 2.5]}, {"a": [1, 2.25]}) == \
        ["/a[1]: 2.5 != 2.25"]
