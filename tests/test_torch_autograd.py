"""Gradients through the PyTorch package's SpMM against the JAX package's.

``SpmmOperator.apply`` and ``transpose_apply`` are differentiable in their
input through one ``torch.autograd.Function`` whose backward is the same
product on the other direction.  The gradient of ``sum(apply(x) * c)`` is
held against ``jax.grad`` through the JAX operator's custom VJP with the xla
backend and with the Pallas kernel in interpret mode (the plain block
kernel K1 and a forced window plan K2, as ``tests/test_torch_spmm.py``
builds them), and against the dense ``A^T c``.

Tolerance: rtol/atol 1e-5 (fp32 sums taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.graph.operators import EdgeMap
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.ops import spmm as j_spmm
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.ops import spmm_pallas as j_pallas
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops import spmm_cuda
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops.spmm import SpmmOperator

CASES = ["random", "empty_rows", "duplicates", "zero_edges", "hub"]
# (label, block_rows R, chunk_edges T, window W): K1 plain, K2 forced window
PLANS = [("K1", 8, 16, 0), ("K2", 32, 16, 8)]
TOL = dict(rtol=1e-5, atol=1e-5)


def _case(name, seed=0):
    rng = np.random.default_rng(seed)
    if name == "random":
        ns, nd, E = 37, 29, 150
        src, dst = rng.integers(0, ns, E), rng.integers(0, nd, E)
    elif name == "empty_rows":
        ns, nd, E = 30, 60, 120
        src, dst = rng.integers(0, ns, E), rng.integers(0, 20, E)
    elif name == "duplicates":
        ns, nd = 6, 9
        src = np.repeat(rng.integers(0, ns, 12), 4)
        dst = np.repeat(rng.integers(0, nd, 12), 4)
        E = src.size
    elif name == "zero_edges":
        ns, nd, E = 5, 7, 0
        src = dst = np.zeros(0, np.int64)
    elif name == "hub":
        ns, nd, E = 80, 40, 700
        src = rng.integers(0, ns, E)
        dst = np.where(rng.random(E) < 0.6, 3, rng.integers(0, nd, E))
    else:
        raise ValueError(name)
    return EdgeMap(src=src.astype(np.int32), dst=dst.astype(np.int32),
                   w=rng.normal(size=E).astype(np.float32),
                   num_src=ns, num_dst=nd)


def _transpose(em):
    return EdgeMap(src=em.dst, dst=em.src, w=em.w, num_src=em.num_dst,
                   num_dst=em.num_src)


def _torch_grad(fn, x, c):
    xt = torch.as_tensor(x).requires_grad_()
    (fn(xt) * torch.as_tensor(c)).sum().backward()
    return xt.grad.numpy()


def _pallas_state(em, plan):
    _, R, T, W = plan
    order = np.argsort(em.dst, kind="stable")
    p = j_pallas.build_pallas_segment_plan(
        em.src[order], em.dst[order], em.w[order], em.num_dst,
        num_src=em.num_src, block_rows=R, chunk_edges=T, interpret=True,
        window=W)
    return j_spmm.SpmmState("pallas", None, p)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("transpose", [False, True], ids=["apply", "transpose"])
def test_grad_matches_jax_xla_and_dense(case, transpose):
    em = _case(case)
    rng = np.random.default_rng(1)
    j = j_spmm.SpmmOperator(em, backend="xla")
    t = SpmmOperator(em, "cpu")
    A = em.to_dense()
    if transpose:
        A = A.T
        jf, tf = j.transpose_apply, t.transpose_apply
    else:
        jf, tf = j.apply, t.apply
    x = rng.normal(size=(A.shape[1], 8)).astype(np.float32)
    c = rng.normal(size=(A.shape[0], 8)).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jf(v) * c))(jnp.asarray(x))
    got = _torch_grad(tf, x, c)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(got, A.T @ c.astype(np.float64), **TOL)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("plan", PLANS, ids=[p[0] for p in PLANS])
@pytest.mark.parametrize("transpose", [False, True], ids=["apply", "transpose"])
def test_grad_matches_jax_pallas_interpret(case, plan, transpose):
    em = _case(case)
    rng = np.random.default_rng(2)
    fwd, bwd = _pallas_state(em, plan), _pallas_state(_transpose(em), plan)
    t = SpmmOperator(em, "cpu")
    if transpose:
        fwd, bwd = bwd, fwd
        tf, (nin, nout) = t.transpose_apply, (em.num_dst, em.num_src)
    else:
        tf, (nin, nout) = t.apply, (em.num_src, em.num_dst)
    x = rng.normal(size=(nin, 8)).astype(np.float32)
    c = rng.normal(size=(nout, 8)).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(j_spmm.spmm_apply(fwd, bwd, v) * c))(
        jnp.asarray(x))
    got = _torch_grad(tf, x, c)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("transpose", [False, True], ids=["apply", "transpose"])
def test_graph_is_the_function_node_without_index_add(transpose):
    """The output's grad_fn is the Function's backward and the plain
    version's index_add_ never enters the autograd graph."""
    em = _case("hub")
    t = SpmmOperator(em, "cpu")
    fn = t.transpose_apply if transpose else t.apply
    x = torch.randn(em.num_dst if transpose else em.num_src, 8,
                    requires_grad=True)
    y = fn(x)
    assert y.grad_fn.name() == "_SpmmFnBackward"
    seen, stack = set(), [y.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        assert "IndexAdd" not in node.name(), node.name()
        stack.extend(n for n, _ in node.next_functions)
    names = {n.name() for n in seen}
    assert names == {"_SpmmFnBackward",
                     "torch::autograd::AccumulateGrad"}, names


def test_two_layer_chain_backward_counts_no_kernel_on_cpu(small_graph):
    """A chain of products (as propagation builds one) differentiates
    through every layer; on the CPU no kernel is launched."""
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.graph import operators as t_ops
    cred = np.random.default_rng(4).uniform(0.2, 1.0, small_graph.num_users)
    ifu, ufi = (SpmmOperator(em, "cpu") for em in t_ops.build_edge_maps(
        small_graph, "cu_message", cred.astype(np.float32)))
    Ai, Au = (em.to_dense() for em in t_ops.build_edge_maps(
        small_graph, "cu_message", cred.astype(np.float32)))
    rng = np.random.default_rng(5)
    u0 = rng.normal(size=(small_graph.num_users, 4)).astype(np.float32)
    c = rng.normal(size=(small_graph.num_users, 4)).astype(np.float32)
    before = spmm_cuda.KERNEL.launches
    got = _torch_grad(lambda u: ufi.apply(ifu.apply(u)), u0, c)
    assert spmm_cuda.KERNEL.launches == before
    np.testing.assert_allclose(got, Ai.T @ (Au.T @ c.astype(np.float64)),
                               rtol=1e-5, atol=1e-5)


def test_bf16_grad_runs_the_bf16_product():
    """bf16 precision: the backward is the bf16-message product on the
    transpose, returned in the cotangent's dtype."""
    em = _case("random")
    t = SpmmOperator(em, "cpu", precision="bf16")
    x = torch.randn(em.num_src, 8, requires_grad=True)
    c = torch.randn(em.num_dst, 8)
    (t.apply(x) * c).sum().backward()
    want = SpmmOperator(em, "cpu", precision="bf16").transpose_apply(c)
    assert x.grad.dtype == torch.float32
    assert torch.equal(x.grad, want)


@pytest.mark.parametrize("prop,weight,layout",
                         [("symmetric", "symmetric", "joint"),
                          ("bipartite_sync", "cred_eq322", "split"),
                          ("gauss_seidel", "cu_message", "split")])
def test_propagate_rows_grads_match_jax(small_graph, prop, weight, layout):
    """Gradients of the batch-row combine reach every ego table through
    every layer's SpMMs (Gauss-Seidel: the user update reads the fresh
    item layer), as jax.grad through the JAX model gives them."""
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.models.lightgcn import LightGCN as JLightGCN
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.utils.config import RecConfig as JRecConfig
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.models.lightgcn import LightGCN
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.utils.config import RecConfig
    kw = dict(propagation=prop, weight_mode=weight, table_layout=layout,
              emb_dim=8, num_layers=3)
    U, I = small_graph.num_users, small_graph.num_items
    rng = np.random.default_rng(6)
    cred = rng.uniform(0.2, 1.0, U).astype(np.float32)
    shapes = {"emb": (U + I, 8)} if layout == "joint" else {
        "user_emb": (U, 8), "item_emb": (I, 8)}
    params = {k: rng.normal(0, 0.1, s).astype(np.float32)
              for k, s in shapes.items()}
    users, items = rng.integers(0, U, 40), rng.integers(0, I, 60)
    cu = rng.normal(size=(40, 8)).astype(np.float32)
    ci = rng.normal(size=(60, 8)).astype(np.float32)

    jm = JLightGCN(JRecConfig(**kw), small_graph, cred, backend="xla")

    def jloss(p):
        u, i = jm.propagate_rows(p, jnp.asarray(users), jnp.asarray(items))
        return jnp.sum(u * cu) + jnp.sum(i * ci)

    want = jax.grad(jloss)({k: jnp.asarray(v) for k, v in params.items()})
    tm = LightGCN(RecConfig(**kw), small_graph, cred, device="cpu")
    tp = {k: torch.as_tensor(v).requires_grad_() for k, v in params.items()}
    u, i = tm.propagate_rows(tp, torch.as_tensor(users),
                             torch.as_tensor(items))
    ((u * torch.as_tensor(cu)).sum() + (i * torch.as_tensor(ci)).sum()
     ).backward()
    for k in params:
        assert float(tp[k].grad.abs().sum()) > 0
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)
