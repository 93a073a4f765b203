"""The PyTorch package's CLI against the JAX package's, and its imports.

``evaluate --device cpu`` with ``eval_mode=full`` on a saved graph and a
JAX-written ``best_model.npz`` must print the same metric block as the JAX
CLI (full mode has no random stream, so the strings are compared exactly).
``train-rec --device cpu`` writes the JAX command's three outputs, and the
JAX ``evaluate`` on the port-written ``best_model.npz`` prints the same
metrics as the port's.  ``train-cred --device cpu`` writes the JAX
command's six artefacts in both trainer modes, its intermediate CSVs equal
the JAX package's, and the port's ``train-rec --cred`` reads its scores.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.cli import main as j_cli
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.train.checkpoint import save_params_npz
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.cli import main as t_cli

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ("beyond_binary_fake_user_detection_a_credibility_aware_graph_"
           "based_recommender_system_tpu")
PORT_PKG = JAX_PKG + "_torch"


@pytest.fixture(scope="module")
def saved(small_graph, tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    small_graph.save_npz(d / "graph.npz")
    rng = np.random.default_rng(0)
    save_params_npz(d / "best_model.npz", {
        "user_emb": rng.normal(0, 0.1, (small_graph.num_users, 8)
                               ).astype(np.float32),
        "item_emb": rng.normal(0, 0.1, (small_graph.num_items, 8)
                               ).astype(np.float32)})
    np.save(d / "cred.npy", rng.uniform(0.2, 1.0, small_graph.num_users))
    return d


def _metric_lines(out: str):
    return [ln for ln in out.splitlines() if "metrics:" in ln or "K=" in ln]


def test_evaluate_full_matches_jax_cli(saved, capsys):
    j_cli.main(["merge-user-ids", "--npy", str(saved / "cred.npy"),
                "--graph", str(saved / "graph.npz"),
                "--out", str(saved / "cred.csv")])
    args = ["evaluate", "--graph", str(saved / "graph.npz"),
            "--params", str(saved / "best_model.npz"),
            "--preset", "cu_message", "--cred", str(saved / "cred.csv"),
            "emb_dim=8", "eval_mode=full"]
    capsys.readouterr()
    j_cli.main(args)
    j_out = capsys.readouterr().out
    res = t_cli.run(args + ["--device", "cpu"])
    t_out = capsys.readouterr().out
    assert _metric_lines(t_out) == _metric_lines(j_out)
    assert len(_metric_lines(t_out)) == 3
    j_json = json.loads(j_out.strip().splitlines()[-1])
    t_json = json.loads(t_out.strip().splitlines()[-1])
    for K in j_json:
        for m in ("precision", "recall", "ndcg"):
            assert t_json[K][m] == pytest.approx(j_json[K][m], abs=1e-6)
            assert res[int(K)][m] == t_json[K][m]


def test_evaluate_sampled_runs_on_cpu(saved, capsys):
    res = t_cli.run(["evaluate", "--graph", str(saved / "graph.npz"),
                     "--params", str(saved / "best_model.npz"),
                     "--preset", "cu_message", "emb_dim=8",
                     "--device", "cpu"])
    assert res[20]["mode"] == "sampled(1pos+neg)"
    assert 0.0 <= res[20]["recall"] <= 1.0
    # the console entry point returns None, so sys.exit(main()) exits 0
    assert t_cli.main(["evaluate", "--graph", str(saved / "graph.npz"),
                       "--params", str(saved / "best_model.npz"),
                       "--preset", "cu_message", "emb_dim=8",
                       "--device", "cpu"]) is None


def test_merge_user_ids_same_csv(saved, tmp_path):
    base = ["merge-user-ids", "--npy", str(saved / "cred.npy"),
            "--graph", str(saved / "graph.npz")]
    j_cli.main(base + ["--out", str(tmp_path / "j.csv")])
    t_cli.main(base + ["--out", str(tmp_path / "t.csv"), "--device", "cpu"])
    assert (tmp_path / "j.csv").read_text() == (tmp_path / "t.csv").read_text()


def test_build_graph_same_npz(tmp_path):
    recs = [{"user_id": f"u{k % 7}", "parent_asin": f"i{(k * 5) % 11}",
             "rating": 3 + k % 3, "text": "fine", "timestamp": k}
            for k in range(120)]
    (tmp_path / "r.jsonl").write_text(
        "\n".join(json.dumps(r) for r in recs) + "\n{bad json\n")
    j_cli.main(["build-graph", "--jsonl", str(tmp_path / "r.jsonl"),
                "--out", str(tmp_path / "j"), "backend=python"])
    t_cli.main(["build-graph", "--jsonl", str(tmp_path / "r.jsonl"),
                "--out", str(tmp_path / "t"), "--device", "cpu"])
    a, b = (np.load(tmp_path / d / "graph.npz", allow_pickle=True)
            for d in ("j", "t"))
    for k in a.files:
        assert np.array_equal(a[k], b[k]), k


def test_default_device_is_cuda(saved):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_cli.main(["evaluate", "--graph", str(saved / "graph.npz"),
                    "--params", str(saved / "best_model.npz")])


def test_training_commands_not_registered():
    """Both training commands are registered now: train-cred (Stage A) and
    train-rec parse with the JAX command's flags and default to the card;
    train-cred's --mesh N needs N processes, as train-rec's and evaluate's
    do: without a launcher it names torchrun."""
    ap = t_cli.build_parser()
    args = ap.parse_args(["train-cred", "--jsonl", "r.jsonl", "--out", "d",
                          "--plots", "--checkpoint", "--resume",
                          "--ckpt-keep", "2", "--ckpt-every", "3",
                          "epochs=2", "trainer_mode=full_graph"])
    assert args.fn is t_cli.cmd_train_cred and args.device == "cuda"
    assert (args.plots, args.checkpoint, args.resume, args.ckpt_keep,
            args.ckpt_every) == (True, True, True, 2, 3)
    assert args.overrides == ["epochs=2", "trainer_mode=full_graph"]
    with pytest.raises(SystemExit):
        ap.parse_args(["train-cred", "--out", "d"])      # --jsonl required
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2 "
                                           "-m .* train-cred"):
        t_cli.run(["train-cred", "--jsonl", "r.jsonl", "--out", "d",
                   "--mesh", "2", "--device", "cpu"])
    args = ap.parse_args(["train-rec", "--graph", "g.npz"])
    assert args.fn is t_cli.cmd_train_rec and args.device == "cuda"


CRED_ARTEFACTS = ["cred_model.npz", "credibility_scores_minmax.npy",
                  "credibility_scores_minmax_with_user_id.csv",
                  "graph_hetero.npz", "user_features.csv", "user_labels.csv"]


@pytest.fixture(scope="module")
def reviews(tmp_path_factory):
    """A tiny review JSONL with both label classes."""
    rng = np.random.default_rng(4)
    helpful_p = rng.uniform(0, 1, 40)
    recs = []
    for _ in range(500):
        u = int(rng.integers(40))
        recs.append({"user_id": f"u{u}", "parent_asin": f"i{rng.integers(25)}",
                     "rating": float(rng.integers(1, 6)),
                     "timestamp": int(1.5e12 + rng.integers(0, 10 ** 10)),
                     "helpful_vote": int(rng.random() < helpful_p[u]) * 9,
                     "verified_purchase": bool(rng.random() < 0.7),
                     "text": "good fit" if u % 2 else "broke don't buy"})
    path = tmp_path_factory.mktemp("reviews") / "r.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in recs) + "\n")
    return path


@pytest.mark.parametrize("mode", ["slas", "full_graph"])
def test_train_cred_writes_the_six_artefacts(reviews, tmp_path, mode):
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.data.features import (
        compute_user_features, save_features_csv, save_labels_csv)
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.data.ingest import ingest_jsonl
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.utils.config import IngestConfig
    out = tmp_path / "cred"
    res = t_cli.run(["train-cred", "--jsonl", str(reviews), "--out", str(out),
                     "--checkpoint", "--device", "cpu", "epochs=2",
                     "hidden_dim=8", "batch_size=16", f"trainer_mode={mode}"])
    assert sorted(p.name for p in out.iterdir() if p.is_file()) == \
        CRED_ARTEFACTS
    assert any((out / "cred_ckpt").glob("*.pt"))
    assert [h["epoch"] for h in res.history] == [1, 2]
    assert np.isfinite([h["loss"] for h in res.history]).all()
    scores = np.load(out / "credibility_scores_minmax.npy")
    assert np.array_equal(scores, res.cred_minmax)
    assert scores.min() == 0.0 and scores.max() == 1.0
    # the intermediate CSVs are the JAX package's, byte for byte
    table = ingest_jsonl(reviews, IngestConfig(jsonl_path=str(reviews),
                                               backend="python"))
    feats = compute_user_features(table)
    save_labels_csv(tmp_path / "labels.csv", table, feats.labels)
    save_features_csv(tmp_path / "features.csv", table, feats)
    assert (out / "user_labels.csv").read_bytes() == \
        (tmp_path / "labels.csv").read_bytes()
    assert (out / "user_features.csv").read_bytes() == \
        (tmp_path / "features.csv").read_bytes()


def test_train_cred_plots_and_jax_reads_the_params(reviews, tmp_path):
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.models.cred_model import init_cred_params
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.train.checkpoint import load_params_npz
    import jax
    pytest.importorskip("matplotlib")
    out = tmp_path / "cred"
    t_cli.run(["train-cred", "--jsonl", str(reviews), "--out", str(out),
               "--plots", "--device", "cpu", "epochs=1", "hidden_dim=8",
               "batch_size=16"])
    assert len(list((out / "plots").glob("dist_*.png"))) == 7
    got = load_params_npz(out / "cred_model.npz")
    want = init_cred_params(jax.random.PRNGKey(0), 7, 2, 8)
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert all(v.dtype == np.float32 for v in got.values())


def test_train_cred_then_train_rec_reads_the_scores(reviews, tmp_path):
    """The two-stage contract: train-rec --cred loads the CSV that the
    port's train-cred wrote, by user id, into its LightGCN weights."""
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.graph.build import BipartiteGraph
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.train.trainer import RecTrainer
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.configs.presets import get_preset
    t_cli.run(["train-cred", "--jsonl", str(reviews), "--out",
               str(tmp_path / "cred"), "--device", "cpu", "epochs=1",
               "hidden_dim=8", "batch_size=16"])
    t_cli.run(["build-graph", "--jsonl", str(reviews), "--out",
               str(tmp_path / "g"), "--device", "cpu"])
    csv = tmp_path / "cred" / "credibility_scores_minmax_with_user_id.csv"
    graph = BipartiteGraph.load_npz(tmp_path / "g" / "graph.npz")
    tr = RecTrainer(get_preset("cu_message").replace(
        cred_csv_path=str(csv), emb_dim=8), graph, device="cpu",
        verbose=False)
    assert tr.cred.shape == (graph.num_users,)
    assert np.isfinite(tr.cred).all() and (tr.cred != 1.0).any()
    res = t_cli.run(["train-rec", "--graph", str(tmp_path / "g" / "graph.npz"),
                     "--preset", "cu_message", "--cred", str(csv),
                     "--device", "cpu", "epochs=1", "emb_dim=8",
                     "batch_size=64", "eval_mode=full"])
    assert np.isfinite(res.history[0].loss)


def test_train_rec_writes_outputs_and_jax_evaluate_agrees(saved, tmp_path,
                                                          capsys):
    out = tmp_path / "rec"
    res = t_cli.run(["train-rec", "--graph", str(saved / "graph.npz"),
                     "--preset", "cu_message", "--out", str(out),
                     "--checkpoint", "--device", "cpu", "epochs=2",
                     "emb_dim=8", "batch_size=64", "eval_mode=full"])
    assert {p.name for p in out.iterdir()} >= {
        "best_model.npz", "test_metrics.json", "metrics.jsonl", "ckpt"}
    assert [h.epoch for h in res.history] == [1, 2]
    written = json.loads((out / "test_metrics.json").read_text())
    assert written["20"]["recall"] == res.test_metrics[20]["recall"]
    with np.load(out / "best_model.npz") as z:
        assert sorted(z.files) == ["item_emb", "user_emb"]

    args = ["evaluate", "--graph", str(saved / "graph.npz"),
            "--params", str(out / "best_model.npz"), "--preset",
            "cu_message", "emb_dim=8", "eval_mode=full"]
    capsys.readouterr()
    j_cli.main(args)
    j_out = capsys.readouterr().out
    t_res = t_cli.run(args + ["--device", "cpu"])
    t_out = capsys.readouterr().out
    assert _metric_lines(t_out) == _metric_lines(j_out)
    j_json = json.loads(j_out.strip().splitlines()[-1])
    for K in j_json:
        for m in ("precision", "recall", "ndcg"):
            assert t_res[int(K)][m] == pytest.approx(j_json[K][m], abs=1e-6)
            assert written[K][m] == pytest.approx(j_json[K][m], abs=1e-6)


def test_train_rec_mesh_not_supported(saved):
    """Without a card, a mesh of cards is not supported: --mesh without
    --device cpu raises before any process group exists (as on one
    device)."""
    import torch.distributed as dist
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the mesh runs there")
    for cmd in (["train-rec", "--graph", str(saved / "graph.npz")],
                ["train-cred", "--jsonl", "r.jsonl", "--out", "d"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_cli.run(cmd + ["--mesh", "1"])
        assert not dist.is_initialized()


def _port_cli(args):
    """The port's CLI in a subprocess (so that no process group outlives
    the test): its stdout."""
    proc = subprocess.run([sys.executable, "-m", f"{PORT_PKG}.cli", *args],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_train_rec_mesh_one_matches_single(saved, tmp_path):
    """``train-rec --mesh 1 --device cpu`` (a world of one over gloo: the
    sharded step, checkpoints by rank 0) writes the outputs of the
    one-device command: exact-row tables within 1e-5, test metrics within
    1e-4, the same epochs."""
    args = ["train-rec", "--graph", str(saved / "graph.npz"), "--preset",
            "cu_message", "--checkpoint", "--device", "cpu", "epochs=2",
            "emb_dim=8", "batch_size=64", "eval_mode=full",
            "negative_sampler=popmix", "lambda_fair=0.1"]
    t_cli.run(args + ["--out", str(tmp_path / "one")])
    out = _port_cli(args + ["--out", str(tmp_path / "mesh"), "--mesh", "1"])
    assert "mesh: {'data': 1, 'model': 1}" in out
    assert any((tmp_path / "mesh" / "ckpt").glob("*.pt"))
    one, mesh = (json.loads((tmp_path / d / "test_metrics.json").read_text())
                 for d in ("one", "mesh"))
    for K in one:
        for m in ("precision", "recall", "ndcg"):
            assert mesh[K][m] == pytest.approx(one[K][m], abs=1e-4)
    with np.load(tmp_path / "one" / "best_model.npz") as a, \
            np.load(tmp_path / "mesh" / "best_model.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-5)
    epochs = [json.loads(ln)["loss"] for ln in
              (tmp_path / "mesh" / "metrics.jsonl").read_text().splitlines()
              if '"epoch"' in ln and '"loss"' in ln]
    assert len(epochs) == 2 and np.isfinite(epochs).all()


def test_train_cred_mesh_one_full_graph(reviews, tmp_path):
    """``train-cred --mesh 1 --device cpu trainer_mode=full_graph``: Stage A
    on the edge-sharded operators writes the six artefacts, its scores
    within 1e-5 of the one-device command's."""
    args = ["train-cred", "--jsonl", str(reviews), "--device", "cpu",
            "epochs=2", "hidden_dim=8", "batch_size=16",
            "trainer_mode=full_graph"]
    t_cli.run(args + ["--out", str(tmp_path / "one")])
    out = _port_cli(args + ["--out", str(tmp_path / "mesh"), "--mesh", "1"])
    assert "mesh: {'data': 1, 'model': 1}" in out
    assert sorted(p.name for p in (tmp_path / "mesh").iterdir()
                  if p.is_file()) == CRED_ARTEFACTS
    one, mesh = (np.load(tmp_path / d / "credibility_scores_minmax.npy")
                 for d in ("one", "mesh"))
    assert np.isfinite(mesh).all() and mesh.min() >= 0 and mesh.max() <= 1
    np.testing.assert_allclose(mesh, one, rtol=0, atol=1e-5)


def test_evaluate_mesh_one_matches_single(saved, capsys):
    """``evaluate --mesh 1 --device cpu`` (a world of one over gloo, in a
    subprocess so that no process group outlives the test) prints the
    metric block of ``evaluate --device cpu`` and of the JAX CLI's
    ``evaluate --mesh 2``, its JSON within 1e-6."""
    j_cli.main(["merge-user-ids", "--npy", str(saved / "cred.npy"),
                "--graph", str(saved / "graph.npz"),
                "--out", str(saved / "cred.csv")])
    args = ["evaluate", "--graph", str(saved / "graph.npz"),
            "--params", str(saved / "best_model.npz"),
            "--preset", "cu_message", "--cred", str(saved / "cred.csv"),
            "emb_dim=8", "eval_mode=full", "extended_metrics=true"]
    capsys.readouterr()
    j_cli.main(args + ["--mesh", "2"])
    j_out = capsys.readouterr().out
    assert "mesh: {'data': 1, 'model': 2}" in j_out
    t_cli.run(args + ["--device", "cpu"])
    single = capsys.readouterr().out
    proc = subprocess.run(
        [sys.executable, "-m", f"{PORT_PKG}.cli", *args, "--mesh", "1",
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    mesh_out = proc.stdout
    assert "mesh: {'data': 1, 'model': 1}" in mesh_out
    assert len(_metric_lines(mesh_out)) == 3
    assert _metric_lines(mesh_out) == _metric_lines(single) == \
        _metric_lines(j_out)
    j_json = json.loads(j_out.strip().splitlines()[-1])
    t_json = json.loads(mesh_out.strip().splitlines()[-1])
    for K in j_json:
        for m in ("precision", "recall", "ndcg", "item_coverage",
                  "cred_utility", "high_cred_recall", "low_cred_recall"):
            assert t_json[K][m] == pytest.approx(j_json[K][m], abs=1e-6)


def test_evaluate_mesh_n_without_launcher_raises(saved, monkeypatch):
    """--mesh 2 in one process (no torchrun environment) names the
    launcher and creates no process group."""
    import torch.distributed as dist
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        t_cli.run(["evaluate", "--graph", str(saved / "graph.npz"),
                   "--params", str(saved / "best_model.npz"),
                   "--mesh", "2", "--device", "cpu"])
    assert not dist.is_initialized()


def test_port_imports_without_jax():
    mods = sorted(
        PORT_PKG + "." + ".".join(p.relative_to(ROOT / PORT_PKG)
                                  .with_suffix("").parts)
        for p in (ROOT / PORT_PKG).rglob("*.py") if p.name != "__main__.py")
    mods = [m.removesuffix(".__init__") for m in mods]
    assert PORT_PKG + ".probes.window_kernel" in mods
    for m in ("data.features", "graph.hetero", "models.cred_model",
              "models.cred_slas", "ops.slas", "train.cred_trainer",
              "data.native.ingest_native", "ops.gather"):
        assert f"{PORT_PKG}.{m}" in mods, m
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['jaxlib'] = None; import importlib; "
            f"[importlib.import_module(m) for m in {mods!r}]; "
            "import chip_smoke; "
            f"bad = [m for m in sys.modules if m.startswith({JAX_PKG!r}) "
            f"and not m.startswith({PORT_PKG!r})]; "
            "assert not bad, bad; print(len(sys.modules))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert len(mods) > 20


def test_no_port_source_names_jax():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|optax|orbax|" + JAX_PKG + r")\b"
        r"(?!_torch)", re.M)
    files = list((ROOT / PORT_PKG).rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for p in files:
        assert not pattern.search(p.read_text()), p
