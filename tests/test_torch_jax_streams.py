"""The numpy replica of the JAX trainer's random streams
(``<port>/scripts/jax_streams.py``) against ``jax.random`` and the JAX
package's trainer, on the CPU.

* The primitives bit for bit: ``PRNGKey`` and ``split``, ``randint`` with
  scalar and array bounds (an empty range gives ``minval``), ``uniform`` on
  [0, 1) and [-a, a) (one fused multiply-add, rounded once: ``fma32``
  against exact rationals), ``permutation`` at one and two sort rounds.
* The trainer's streams: ``init_state`` equal to ``RecTrainer.init_state``
  for split and joint tables; ``epoch_draws`` equal to the JAX epoch's own
  draws (``tests/test_torch_f7_loss.py``'s ``_jax_draws``) for three epochs
  of the chained key, uniform negatives (degree_aware) and pop-mix
  (pop_neg); on the parity harness's graph, which the port's
  ``parity_run build`` makes element-equal to the JAX script's, the first
  epoch of degree_aware at seed 42.
* Twenty degree_aware epochs of the port on the replica's init and draws,
  with no JAX call on the port's side, within rtol 2e-6 of the JAX
  package's jitted epochs (``RecTrainer._build_epoch_fn``).
* ``runs/torch_h100/f10/jax_small.json``, the fixture ``chip_smoke.py``
  holds the card to, regenerated from JAX and held equal.  Write it with
  ``python tests/test_torch_jax_streams.py --write``.
"""

import argparse
import hashlib
import json
import sys
from fractions import Fraction
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_f7_loss import _jax_draws
from test_torch_parity_run import _jax_script
from test_torch_trainer import FIT, _cred

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.configs.presets import get_preset as j_preset
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.graph.build import BipartiteGraph as JGraph
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.graph.build import synthetic_bipartite_graph as j_graph
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.train.trainer import RecTrainer as JTrainer
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.utils.config import RecConfig as JConfig
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.configs.presets import get_preset as t_preset
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.models.lightgcn import params_from_jax
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops.adam import adam_init
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops.sampling import PopMixSampler
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.scripts import jax_streams as js
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.scripts import parity_run
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.train.trainer import RecTrainer

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "runs" / "torch_h100" / "f10" / "jax_small.json"
# tests/test_torch_f7_loss.py's graph; degree_aware at seed 5
SMALL_GRAPH = dict(num_users=150, num_items=80, edges_per_user=20.0, seed=3,
                   power=0.6)
SEED = 5
EPOCHS = 20
LOSS_RTOL = 2e-6
PARAM_TOL = 1e-5
DRAW_EPOCHS = 3
# a regenerated fixture's losses against the committed ones: one float32
# ulp of a loss near 0.69 (5.96e-8) is 8.6e-8 of it
FIXTURE_RTOL = 1e-7


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small shapes: one intra-op thread, so that this file adds no thread
    contention to the test workers running beside it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graph():
    return j_graph(**SMALL_GRAPH)


def _key(seed):
    return jax.random.PRNGKey(seed)


# --------------------------------------------------------------------------
# the primitives

@pytest.mark.parametrize("seed", [0, 5, 42, 2 ** 31 - 1, -1])
def test_prng_key_equals_jax(seed):
    assert np.array_equal(js.prng_key(seed), np.asarray(_key(seed)))


@pytest.mark.parametrize("n", [2, 3, 4])
def test_split_equals_jax(n):
    for seed in (0, 42):
        want = np.asarray(jax.random.split(_key(seed), n))
        got = js.split(js.prng_key(seed), n)
        assert got.dtype == np.uint32 and np.array_equal(got, want)
    # a chain of splits, as the epochs walk it
    k, kn = _key(7), js.prng_key(7)
    for _ in range(5):
        k = jax.random.split(k, 3)[2]
        kn = js.split(kn, 3)[2]
    assert np.array_equal(kn, np.asarray(k))


@pytest.mark.parametrize("shape,lo,hi", [
    ((1000,), 0, 7),                  # a small span, not a power of 2
    ((64, 9), 0, 24_000),             # a negative draw's shape
    ((257,), 0, 2 ** 16),             # a power of 2
    ((33,), -5, 2 ** 31 - 1),         # a span over 2^31
    ((33,), 3, 3),                    # maxval == minval: minval
    ((33,), 5, 2),                    # maxval < minval: minval
])
def test_randint_scalar_bounds_equal_jax(shape, lo, hi):
    want = np.asarray(jax.random.randint(_key(42), shape, lo, hi))
    got = js.randint(js.prng_key(42), shape, lo, hi)
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)


def test_randint_array_maxval_equals_jax():
    """``sample_positives``' draw: ``maxval`` the degree of each row, with
    rows of degree 1 and 0 (the JAX sampler passes ``max(deg, 1)``) and an
    empty range."""
    hi = np.tile(np.array([1, 0, 5, 100, 3, 24_000, -2, 65_537], np.int32),
                 50)
    want = np.asarray(jax.random.randint(_key(3), hi.shape, 0,
                                         jnp.asarray(hi)))
    got = js.randint(js.prng_key(3), hi.shape, 0, hi)
    assert np.array_equal(got, want)
    assert (got[hi <= 0] == 0).all()


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.0156, 0.0156),
                                   (-0.2732, 0.2732)])
def test_uniform_equals_jax(lo, hi):
    shape = (700, 64)
    want = np.asarray(jax.random.uniform(_key(9), shape, jnp.float32, lo, hi))
    got = js.uniform(js.prng_key(9), shape, lo, hi)
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def _round32(x: Fraction) -> np.float32:
    """The float32 nearest the rational ``x``, ties to even."""
    r = np.float32(float(x))
    cands = [np.nextafter(r, np.float32(-np.inf)), r,
             np.nextafter(r, np.float32(np.inf))]
    best = min(abs(Fraction(float(c)) - x) for c in cands)
    near = [c for c in cands if abs(Fraction(float(c)) - x) == best]
    return min(near, key=lambda c: int(np.array(c).view(np.uint32)) & 1)


def test_fma32_rounds_once():
    """``fma32`` against the exact rational a * b + c rounded once: random
    triples, and two sums that a float64 sum rounded again to float32 gets
    wrong (1 + 2^-23 + 2^-24 -+ 2^-70: halfway in float64, not exactly)."""
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, 3000).astype(np.float32)
    b = np.float32(0.0417)
    c = np.float32(-0.0208)
    got = js.fma32(a, b, c)
    for x, g in zip(a, got):
        want = _round32(Fraction(float(x)) * Fraction(float(b))
                        + Fraction(float(c)))
        assert g == want
    one_ulp = np.float32(1 + 2.0 ** -23)
    for sign, want in ((1, one_ulp), (-1, one_ulp)):
        x = np.float32(2.0 ** -12 * (1 + 2.0 ** -23))
        y = np.float32(sign * 2.0 ** -12 * (1 - 2.0 ** -23))
        exact = (Fraction(float(x)) * Fraction(float(y))
                 + Fraction(float(one_ulp)))
        twice = np.float32(float(np.float64(x) * np.float64(y)
                                 + np.float64(one_ulp)))
        assert _round32(exact) == want != twice
        assert js.fma32(np.array([x]), y, one_ulp)[0] == want


@pytest.mark.parametrize("n", [1, 2, 1000, 8000])
def test_permutation_equals_jax(n):
    """One stable sort round up to n = 1,000 (none at n = 1), two at
    8,000; an array of ids, as the epoch permutes the train users."""
    x = (np.arange(n, dtype=np.int32) * 3 + 1)
    want = np.asarray(jax.random.permutation(_key(11), jnp.asarray(x)))
    got = js.permutation(js.prng_key(11), x)
    assert np.array_equal(got, want)
    assert np.array_equal(js.permutation(js.prng_key(11), n), np.asarray(
        jax.random.permutation(_key(11), n)))


# --------------------------------------------------------------------------
# the trainer's streams

@pytest.mark.parametrize("preset", ["degree_aware", "vanilla"])
def test_init_state_equals_jax(graph, preset):
    """Split tables (degree_aware) and the joint table (vanilla)."""
    cfg = j_preset(preset).replace(**FIT)
    jtr = JTrainer(cfg, graph, cred=_cred(graph), verbose=False)
    j_params, _, j_key = jtr.init_state(seed=SEED)
    params, key = js.init_state(SEED, t_preset(preset).replace(**FIT),
                                graph.num_users, graph.num_items)
    assert sorted(params) == sorted(j_params)
    for k, v in j_params.items():
        assert params[k].dtype == np.float32
        assert np.array_equal(params[k], np.asarray(v)), k
    assert np.array_equal(key, np.asarray(j_key))


def _port_popmix(trainer_cfg, graph):
    if trainer_cfg.negative_sampler != "popmix":
        return None
    return PopMixSampler.build(graph.train_item_degrees(), "cpu",
                               mix_pop=trainer_cfg.neg_mix_pop,
                               gamma=trainer_cfg.neg_pop_gamma)


@pytest.mark.parametrize("preset", ["degree_aware", "pop_neg"])
def test_epoch_draws_equal_jax(graph, preset):
    """Three epochs of the chained key: uniform negatives (degree_aware)
    and the pop-mix mixture with its fallback (pop_neg)."""
    jcfg = j_preset(preset).replace(**FIT)
    tcfg = t_preset(preset).replace(**FIT)
    jtr = JTrainer(jcfg, graph, cred=_cred(graph), verbose=False)
    bundle = jtr.train_state_bundle()
    _, _, key = jtr.init_state(seed=SEED)
    _, kn = js.init_state(SEED, tcfg, graph.num_users, graph.num_items)
    popmix = _port_popmix(tcfg, graph)
    csr = graph.user_csr("train")
    for epoch in range(DRAW_EPOCHS):
        want, key = _jax_draws(jtr, key, bundle)
        got, kn = js.epoch_draws(kn, jtr.train_users, csr, tcfg,
                                 graph.num_items, popmix)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w), epoch
        assert np.array_equal(kn, np.asarray(key))


def test_parity_graph_and_first_epoch_equal_jax(tmp_path, capsys):
    """The parity harness's graph (``parity_run build`` at its defaults:
    8,000 users, 24,000 items) from both scripts, element for element,
    with its train CSR; then degree_aware's init and first epoch at seed
    42 on it (7,986 train users: two sort rounds)."""
    parity_run.main(["build", "--out", str(tmp_path / "p" / "graph.npz")])
    _jax_script().cmd_build(argparse.Namespace(
        out=str(tmp_path / "j" / "graph.npz"), users=8000, items=24000,
        edges_per_user=8.0, seed=7))
    ours, theirs = (np.load(tmp_path / d / "graph.npz") for d in ("p", "j"))
    assert sorted(ours.files) == sorted(theirs.files)
    for k in theirs.files:
        np.testing.assert_array_equal(ours[k], theirs[k])
    tg = parity_run.load_graph(tmp_path / "p" / "graph.npz")
    jg = JGraph(num_users=int(theirs["num_users"]),
                num_items=int(theirs["num_items"]),
                train_edges=theirs["train_edges"],
                val_edges=theirs["val_edges"], test_edges=theirs["test_edges"])
    for a, b in ((tg.user_csr("train"), jg.user_csr("train")),):
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
    tcfg = parity_run.framework_config("degree_aware", epochs=400,
                                       eval_every=2, seed=42)
    jcfg = JConfig(name="parity_degree_aware", epochs=400, eval_every=2,
                   seed=42, **_jax_script().CONFIG_MAP["degree_aware"])
    jtr = JTrainer(jcfg, jg, verbose=False)
    j_params, _, key = jtr.init_state()
    params, kn = js.init_state(42, tcfg, tg.num_users, tg.num_items)
    for k, v in j_params.items():
        assert np.array_equal(params[k], np.asarray(v)), k
    want, key = _jax_draws(jtr, key, jtr.train_state_bundle())
    got, kn = js.epoch_draws(kn, jtr.train_users, tg.user_csr("train"),
                             tcfg, tg.num_items)
    assert got[0].shape == (2, 4096)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert np.array_equal(kn, np.asarray(key))


def _draws_sha(batches) -> str:
    h = hashlib.sha256()
    for x in batches:
        h.update(np.ascontiguousarray(x).tobytes())
    return h.hexdigest()


def _params_sha(params) -> str:
    h = hashlib.sha256()
    for k in sorted(params):
        h.update(np.ascontiguousarray(np.asarray(params[k])).tobytes())
    return h.hexdigest()


def jax_fixture() -> dict:
    """The JAX package's side of chip_smoke's phase 22, on the CPU: its
    trainer's init (sha256) and EPOCHS jitted epochs of degree_aware on
    SMALL_GRAPH at SEED, each epoch's draws (sha256 of users, pos, neg,
    mask) and mean loss."""
    graph = j_graph(**SMALL_GRAPH)
    jtr = JTrainer(j_preset("degree_aware").replace(**FIT), graph,
                   cred=_cred(graph), verbose=False)
    params, opt, key = jtr.init_state(seed=SEED)
    init_sha = _params_sha(params)
    bundle = jtr.train_state_bundle()
    epoch_fn = jtr._build_epoch_fn()
    shas, losses = [], []
    for _ in range(EPOCHS):
        batches, _ = _jax_draws(jtr, key, bundle)
        shas.append(_draws_sha(batches))
        params, opt, key, loss = epoch_fn(params, opt, key,
                                          jtr.train_users_dev, bundle)
        losses.append(float(loss))
    return {"preset": "degree_aware", "graph": SMALL_GRAPH, "fit": FIT,
            "cred": "numpy default_rng(0).uniform(0.2, 1.0, users), float32",
            "seed": SEED, "epochs": EPOCHS, "loss_rtol": LOSS_RTOL,
            "init_sha256": init_sha, "draws_sha256": shas, "losses": losses,
            "jax": jax.__version__,
            "written_by": "python tests/test_torch_jax_streams.py --write "
                          "(the JAX package on a CPU)"}


def test_fixture_equals_jax():
    """The committed fixture is what JAX computes now: the same init and
    draws, every loss within one float32 ulp."""
    want = json.loads(FIXTURE.read_text())
    got = json.loads(json.dumps(jax_fixture()))
    for k in ("preset", "graph", "fit", "seed", "epochs", "loss_rtol",
              "init_sha256", "draws_sha256"):
        assert got[k] == want[k], k
    assert got["losses"] == pytest.approx(want["losses"], rel=FIXTURE_RTOL)


def test_replica_matches_the_fixture(graph):
    """The replica's init and draws give the fixture's hashes, which is
    what phase 22 checks on the card before it trains."""
    want = json.loads(FIXTURE.read_text())
    cfg = t_preset(want["preset"]).replace(**want["fit"])
    params, key = js.init_state(want["seed"], cfg, graph.num_users,
                                graph.num_items)
    assert _params_sha(params) == want["init_sha256"]
    users = np.nonzero(graph.user_csr("train").degrees() > 0)[0]
    for sha in want["draws_sha256"]:
        batches, key = js.epoch_draws(key, users, graph.user_csr("train"),
                                      cfg, graph.num_items)
        assert _draws_sha(batches) == sha


def test_twenty_epochs_on_the_replica_match_jax(graph):
    """The port on the replica alone (no JAX call on its side) against the
    JAX package's jitted epochs from the same seed."""
    jtr = JTrainer(j_preset("degree_aware").replace(**FIT), graph,
                   cred=_cred(graph), verbose=False)
    cfg = t_preset("degree_aware").replace(**FIT)
    tr = RecTrainer(cfg, graph, cred=_cred(graph), device="cpu",
                    verbose=False)
    j_params, j_opt, j_key = jtr.init_state(seed=SEED)
    bundle = jtr.train_state_bundle()
    epoch_fn = jtr._build_epoch_fn()
    params, key = js.init_state(SEED, cfg, graph.num_users, graph.num_items)
    params = params_from_jax(params, "cpu")
    opt = adam_init(params)
    csr = graph.user_csr("train")
    for epoch in range(EPOCHS):
        batches, key = js.epoch_draws(key, tr.train_users, csr, cfg,
                                      graph.num_items)
        loss = tr.run_epoch(params, opt, tuple(
            torch.as_tensor(b) for b in batches)).mean()
        j_params, j_opt, j_key, j_loss = epoch_fn(
            j_params, j_opt, j_key, jtr.train_users_dev, bundle)
        assert float(loss) == pytest.approx(float(j_loss), rel=LOSS_RTOL), \
            epoch
    assert np.array_equal(key, np.asarray(j_key))
    for k, v in j_params.items():
        np.testing.assert_allclose(params[k].numpy(), np.asarray(v),
                                   rtol=PARAM_TOL, atol=PARAM_TOL)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="write the JAX fixture of "
                                 "chip_smoke.py's phase 22")
    ap.add_argument("--write", action="store_true")
    if ap.parse_args().write:
        FIXTURE.parent.mkdir(parents=True, exist_ok=True)
        FIXTURE.write_text(json.dumps(jax_fixture(), indent=1) + "\n")
        print(f"wrote {FIXTURE}")
    else:
        sys.exit(ap.print_usage())
