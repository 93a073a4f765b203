"""The port's edge-sharded SpMM on gloo ranks against one device and JAX.

Worlds 2 (mesh (1, 2)) and 4 (mesh (2, 2): two model groups in two data
replicas) each run once, as spawned CPU processes
(``tests/torch_mesh_worker.py``, suite "spmm", 120 s limit), over two edge
maps: a random map with a hub row of 300 edges (long-row pieces) and
small_graph's cu_message item<-user map.  For both exchanges ("halo",
"allgather"):

  * apply is bit-equal to the port's single-device ``SpmmOperator`` (each
    destination row's edges sit on its owner rank in the same order, with
    the same pieces) and within rtol 1e-5 / atol 1e-6 of JAX's
    ``ShardedSpmmOperator`` on a mesh of the same model size (1, 2);
  * the gradient of <apply(x), g> is bit-equal to ``transpose_apply(g)``
    and within 1e-5 of ``jax.grad`` through JAX's sharded operator;
  * ``LightGCN.propagate`` on the padded chain (cu_message, split tables;
    vanilla, joint table; K=3, D=32) is bit-equal to the port on one device
    and within 1e-5 of JAX's single-device propagate, with one
    ``to_padded`` and one ``from_padded`` per table;

and the span layout's round trip and dual-gather gradients are exact.
With bf16 messages (``precision="bf16"``, ``spmm_precision="bf16"``) the
sharded apply and propagate are bit-equal to the port's one-device bf16
and within BF16_TOL of JAX's sharded operator, which sums in bf16 where the
port sums bf16 products in fp32 (ROADMAP's bf16 divergence).  Every rank's
replicated outputs are identical.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_mesh_worker import MODES, spawn_ranks

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.configs.presets import get_preset as j_preset
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.graph.operators import message_edge_maps
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.models.lightgcn import LightGCN as JLightGCN
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.parallel.mesh import make_mesh as j_make_mesh
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.parallel.sharded_spmm import ShardedSpmmOperator as JSharded
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.configs.presets import get_preset as t_preset
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.graph.operators import EdgeMap
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.models.lightgcn import LightGCN as TLightGCN
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops.spmm import SpmmOperator

WORLDS = (2, 4)
MAPS = ("hub", "ifu")
PRESETS = ("cu_message", "vanilla")
D = 16
# max |port - JAX| with bf16 messages over the largest |JAX output|: JAX
# rounds every partial sum to bf16 (8-bit significand), the port once at the
# end; the hub row's 300 terms reach 0.0226 here, the other maps and the
# propagates 0.0009-0.0059
BF16_TOL = 0.03


def _maps(small_graph, cred):
    rng = np.random.default_rng(5)
    ns, nd, E = 200, 150, 2500
    src = np.concatenate([rng.integers(0, ns, E), rng.integers(0, ns, 300)])
    dst = np.concatenate([rng.integers(0, nd, E), np.full(300, 7)])
    order = rng.permutation(src.size)
    hub = EdgeMap(src=src[order].astype(np.int32),
                  dst=dst[order].astype(np.int32),
                  w=rng.normal(size=src.size).astype(np.float32),
                  num_src=ns, num_dst=nd)
    ifu, _ = message_edge_maps(small_graph, cred)
    return {"hub": hub,
            "ifu": EdgeMap(src=np.asarray(ifu.src), dst=np.asarray(ifu.dst),
                           w=np.asarray(ifu.w), num_src=ifu.num_src,
                           num_dst=ifu.num_dst)}


@pytest.fixture(scope="module")
def case(small_graph, tmp_path_factory):
    """Inputs, written for the ranks; both worlds run at once."""
    out = tmp_path_factory.mktemp("mesh_spmm")
    rng = np.random.default_rng(0)
    U, I = small_graph.num_users, small_graph.num_items
    cred = rng.uniform(0.2, 1.0, U).astype(np.float32)
    maps = _maps(small_graph, cred)
    inp = {"cred": cred,
           "span_w": rng.integers(0, 50, 137),
           "span_x": rng.normal(size=(137, 8)).astype(np.float32),
           "cu_message_user_emb": rng.normal(0, 0.1, (U, 32)).astype(np.float32),
           "cu_message_item_emb": rng.normal(0, 0.1, (I, 32)).astype(np.float32),
           "vanilla_emb": rng.normal(0, 0.1, (U + I, 32)).astype(np.float32)}
    for name, em in maps.items():
        inp.update({f"{name}_src": em.src, f"{name}_dst": em.dst,
                    f"{name}_w": em.w, f"{name}_num_src": em.num_src,
                    f"{name}_num_dst": em.num_dst,
                    f"{name}_x": rng.normal(size=(em.num_src, D))
                    .astype(np.float32),
                    f"{name}_g": rng.normal(size=(em.num_dst, D))
                    .astype(np.float32)})
    small_graph.save_npz(out / "graph.npz")
    np.savez(out / "inputs_spmm.npz", **inp)
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        list(pool.map(lambda w: spawn_ranks("spmm", w, out), WORLDS))

    def load(world, name, rank=0):
        return np.load(out / f"w{world}_{name}_r{rank}.npy")
    return {"inp": inp, "maps": maps, "load": load}


@pytest.fixture(scope="module")
def jax_ref(case, small_graph):
    """JAX's sharded apply and gradient on a (1, 2) mesh (the ranks' model
    size) by map and mode, and its single-device propagate by preset."""
    mesh, inp = j_make_mesh(2, shape=(1, 2)), case["inp"]
    ref = {}
    for name in MAPS:
        x, g = jnp.asarray(inp[f"{name}_x"]), jnp.asarray(inp[f"{name}_g"])
        for mode in MODES:
            op = JSharded(case["maps"][name], mesh, mode=mode)
            f = jax.jit(lambda x, op=op: (
                op(x), jax.grad(lambda x: jnp.sum(op(x) * g))(x)))
            ref[name, mode] = tuple(np.asarray(a) for a in f(x))
            ref[name, mode, "bf16"] = np.asarray(
                jax.jit(op)(x.astype(jnp.bfloat16)).astype(jnp.float32))
    for preset in PRESETS:
        cfg = j_preset(preset).replace(emb_dim=32, num_layers=3)
        params = {k.removeprefix(f"{preset}_"): jnp.asarray(v)
                  for k, v in inp.items() if k.startswith(f"{preset}_")}
        ref[preset] = tuple(np.asarray(a) for a in JLightGCN(
            cfg, small_graph, inp["cred"], backend="xla").propagate(params))
        for mode in MODES:
            model = JLightGCN(
                cfg.replace(spmm_precision="bf16"), small_graph, inp["cred"],
                operator_factory=functools.partial(JSharded, mesh=mesh,
                                                   mode=mode))
            ref[preset, mode, "bf16"] = tuple(
                np.asarray(a) for a in jax.jit(model.propagate)(params))
    return ref


CASES = [(w, m, n) for w in WORLDS for m in MODES for n in MAPS]
IDS = [f"w{w}-{m}-{n}" for w, m, n in CASES]


@pytest.mark.parametrize("world,mode,name", CASES, ids=IDS)
def test_apply_bit_equal_to_one_device_and_close_to_jax(case, jax_ref, world,
                                                         mode, name):
    y = case["load"](world, f"apply_{name}_{mode}")
    em, inp = case["maps"][name], case["inp"]
    single = SpmmOperator(em, "cpu")(torch.as_tensor(inp[f"{name}_x"]))
    assert np.array_equal(y, single.numpy())
    np.testing.assert_allclose(y, jax_ref[name, mode][0], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("world,mode,name", CASES, ids=IDS)
def test_backward_is_the_transpose_apply(case, jax_ref, world, mode, name):
    dx = case["load"](world, f"grad_{name}_{mode}")
    em, inp = case["maps"][name], case["inp"]
    single = SpmmOperator(em, "cpu").transpose_apply(
        torch.as_tensor(inp[f"{name}_g"]))
    assert np.array_equal(dx, single.numpy())
    np.testing.assert_allclose(dx, jax_ref[name, mode][1], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_span_layout_round_trip_and_gradients(case, world):
    """to_padded / from_padded are exact, each one's backward is the
    other's gather: d/dx sum(to_padded(x)**2) over the shards is 2x, and
    d/dp sum(from_padded(p)**2) is 2p on real slots and 0 on pads."""
    x = case["inp"]["span_x"]
    for r in range(world):
        ld = functools.partial(case["load"], world, rank=r)
        assert np.array_equal(ld("span_back"), x)
        np.testing.assert_array_equal(ld("span_grad_x"), 2 * x)
        p = ld("span_p")
        real = np.any(p != 0, axis=1, keepdims=True)
        np.testing.assert_array_equal(ld("span_grad_p"), 2 * p * real)


PROP = [(w, m, p) for w in WORLDS for m in MODES for p in PRESETS]


@pytest.mark.parametrize("world,mode,preset", PROP,
                         ids=[f"w{w}-{m}-{p}" for w, m, p in PROP])
def test_propagate_on_the_padded_chain(case, jax_ref, small_graph, world,
                                       mode, preset):
    inp = case["inp"]
    params = {k.removeprefix(f"{preset}_"): v for k, v in inp.items()
              if k.startswith(f"{preset}_")}
    u = case["load"](world, f"prop_{preset}_{mode}_u")
    i = case["load"](world, f"prop_{preset}_{mode}_i")
    tables = len(params)
    assert case["load"](world, f"prop_{preset}_{mode}_calls").tolist() == \
        [tables, tables]
    tcfg = t_preset(preset).replace(emb_dim=32, num_layers=3)
    tu, ti = TLightGCN(tcfg, small_graph, inp["cred"], device="cpu").propagate(
        {k: torch.as_tensor(v) for k, v in params.items()})
    assert np.array_equal(u, tu.numpy()) and np.array_equal(i, ti.numpy())
    ju, ji = jax_ref[preset]
    np.testing.assert_allclose(u, ju, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(i, ji, rtol=1e-5, atol=1e-5)


def _bf16_close(got, ref):
    assert np.abs(got - ref).max() <= BF16_TOL * np.abs(ref).max()


@pytest.mark.parametrize("world,mode,name", CASES, ids=IDS)
def test_bf16_apply_bit_equal_to_one_device_and_close_to_jax(
        case, jax_ref, world, mode, name):
    y = case["load"](world, f"apply_{name}_{mode}_bf16")
    em, inp = case["maps"][name], case["inp"]
    single = SpmmOperator(em, "cpu", precision="bf16")(
        torch.as_tensor(inp[f"{name}_x"]).to(torch.bfloat16)).float()
    assert np.array_equal(y, single.numpy())
    _bf16_close(y, jax_ref[name, mode, "bf16"])


@pytest.mark.parametrize("world,mode,preset", PROP,
                         ids=[f"w{w}-{m}-{p}" for w, m, p in PROP])
def test_bf16_propagate_bit_equal_to_one_device_and_close_to_jax(
        case, jax_ref, small_graph, world, mode, preset):
    inp = case["inp"]
    params = {k.removeprefix(f"{preset}_"): torch.as_tensor(v)
              for k, v in inp.items() if k.startswith(f"{preset}_")}
    tables = len(params)
    tag = f"prop_{preset}_{mode}_bf16"
    assert case["load"](world, f"{tag}_calls").tolist() == [tables, tables]
    tcfg = t_preset(preset).replace(emb_dim=32, num_layers=3,
                                    spmm_precision="bf16")
    ref = TLightGCN(tcfg, small_graph, inp["cred"], device="cpu"
                    ).propagate(params)
    for t, r, j in zip("ui", ref, jax_ref[preset, mode, "bf16"]):
        got = case["load"](world, f"{tag}_{t}")
        assert np.array_equal(got, r.numpy())
        _bf16_close(got, j)


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_reports_the_same(case, world):
    names = ([f"{k}_{n}_{m}" for k in ("apply", "grad") for n in MAPS
              for m in MODES]
             + [f"apply_{n}_{m}_bf16" for n in MAPS for m in MODES]
             + [f"prop_{p}_{m}{b}_{t}" for p in PRESETS for m in MODES
                for b in ("", "_bf16") for t in "ui"]
             + ["span_back", "span_grad_x"])
    for name in names:
        first = case["load"](world, name)
        for r in range(1, world):
            assert np.array_equal(case["load"](world, name, r), first), name
