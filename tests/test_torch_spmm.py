"""The PyTorch package's SpMM against the JAX package's two backends.

On the CPU ``SpmmOperator`` runs the kernel's plain version
(``ops/spmm_cuda.segment_spmm_reference``).  It is held against
``SpmmOperator(backend="xla")`` in fp32 and against the Pallas kernel in
interpret mode, with the plain block kernel (K1, ``window=0``) and with a
forced window plan (K2), in fp32 and in bf16.

Tolerances: fp32 rtol/atol 1e-5 (the sums are taken in another order).
bf16 messages with fp32 output: rtol 1e-5, atol 1e-5 — both sides multiply
the same bf16-rounded weights and table values, exactly in fp32, and differ
only in summation order.  bf16 output: rtol 2**-7 (one bf16 rounding of
fp32 sums that differ in the last fp32 bits can move one bf16 step).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.graph.operators import EdgeMap
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.ops import spmm_pallas as j_pallas
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.ops.spmm import SpmmOperator as JSpmm
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.graph import operators as t_ops
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops import spmm_cuda
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops.spmm import CsrDirection, SpmmOperator


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


CASES = ["random", "empty_rows", "duplicates", "zero_edges", "hub"]
# (label, block_rows R, chunk_edges T, window W): K1 = _segment_kernel,
# K2 = _window_kernel
PLANS = [("K1", 8, 16, 0), ("K2", 32, 16, 8)]


def _x(rng, n, D):
    return rng.normal(size=(n, D)).astype(np.float32)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("D", [8, 64])
def test_apply_and_transpose_match_jax_xla(case, D):
    em = _case(case)
    rng = np.random.default_rng(1)
    x, g = _x(rng, em.num_src, D), _x(rng, em.num_dst, D)
    j = JSpmm(em, backend="xla")
    t = SpmmOperator(em, "cpu")
    np.testing.assert_allclose(t.apply(torch.as_tensor(x)).numpy(),
                               np.asarray(j.apply(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        t.transpose_apply(torch.as_tensor(g)).numpy(),
        np.asarray(j.transpose_apply(jnp.asarray(g))), rtol=1e-5, atol=1e-5)


def _pallas(em, x, plan, msg_dtype):
    _, R, T, W = plan
    order = np.argsort(em.dst, kind="stable")
    p = j_pallas.build_pallas_segment_plan(
        em.src[order], em.dst[order], em.w[order], em.num_dst,
        num_src=em.num_src, block_rows=R, chunk_edges=T, interpret=True,
        msg_dtype=msg_dtype, window=W)
    assert p.window == (W if em.num_edges else 0)
    return j_pallas.apply_pallas(p, x)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("plan", PLANS, ids=[p[0] for p in PLANS])
@pytest.mark.parametrize("D", [8, 64])
def test_matches_pallas_interpret_fp32(case, plan, D):
    em = _case(case)
    x = _x(np.random.default_rng(2), em.num_src, D)
    want = np.asarray(_pallas(em, jnp.asarray(x), plan, "float32"))
    got = SpmmOperator(em, "cpu").apply(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["random", "empty_rows", "hub"])
@pytest.mark.parametrize("plan", PLANS, ids=[p[0] for p in PLANS])
@pytest.mark.parametrize("D", [8, 64])
def test_matches_pallas_interpret_bf16(case, plan, D):
    em = _case(case)
    x = _x(np.random.default_rng(3), em.num_src, D)
    op = SpmmOperator(em, "cpu", precision="bf16")
    # fp32 table, bf16 messages: fp32 output, no final bf16 rounding
    want = np.asarray(_pallas(em, jnp.asarray(x), plan, "bfloat16"))
    got = op.apply(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # bf16 table: bf16 output
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want_b = np.asarray(_pallas(em, xb, plan, "bfloat16").astype(jnp.float32))
    got_b = op.apply(torch.as_tensor(x).to(torch.bfloat16)).float().numpy()
    np.testing.assert_allclose(got_b, want_b, rtol=2 ** -7, atol=1e-6)


def test_bf16_rounds_weights_like_pallas():
    """A weight that bf16 cannot hold shows the rounding: the Pallas kernel
    and the port both use bf16(w); the xla backend would not."""
    w = np.float32(1.0 + 2 ** -10)
    em = EdgeMap(src=np.array([0], np.int32), dst=np.array([0], np.int32),
                 w=np.array([w], np.float32), num_src=1, num_dst=1)
    x = np.ones((1, 4), np.float32)
    got = SpmmOperator(em, "cpu", precision="bf16").apply(torch.as_tensor(x))
    want = _pallas(em, jnp.asarray(x), PLANS[0], "bfloat16")
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert float(got[0, 0]) == 1.0


def test_empty_rows_exactly_zero():
    em = _case("empty_rows")
    y = SpmmOperator(em, "cpu").apply(torch.randn(em.num_src, 8))
    empty = np.bincount(em.dst, minlength=em.num_dst) == 0
    assert empty.sum() > 0
    assert bool((y[torch.as_tensor(empty)] == 0).all())


def test_csr_direction_is_stable_dst_sorted():
    em = _case("duplicates")
    d = CsrDirection.from_edges(em.src, em.dst, em.w, em.num_src,
                                em.num_dst, "cpu")
    order = np.argsort(em.dst, kind="stable")
    assert np.array_equal(d.src.numpy(), em.src[order])
    assert np.array_equal(d.w.numpy(), em.w[order])
    assert np.array_equal(np.diff(d.indptr.numpy()),
                          np.bincount(em.dst, minlength=em.num_dst))
    assert d.indptr.dtype == torch.int64 and d.src.dtype == torch.int32


def test_cpu_tensors_take_the_plain_version():
    em = _case("random")
    d = CsrDirection.from_edges(em.src, em.dst, em.w, em.num_src,
                                em.num_dst, "cpu")
    x = torch.randn(em.num_src, 8)
    before = spmm_cuda.KERNEL.launches
    y = spmm_cuda.segment_spmm(d.indptr, d.src, d.w, x, pieces=d.pieces)
    assert spmm_cuda.KERNEL.launches == before
    assert torch.equal(y, spmm_cuda.segment_spmm_reference(d.indptr, d.src,
                                                           d.w, x))
    with pytest.raises(ValueError):
        spmm_cuda.segment_spmm(d.indptr, d.src, d.w, x, backend="pallas",
                               pieces=d.pieces)
    with pytest.raises(ValueError):    # no kernel for the CPU
        spmm_cuda.KERNEL(d.indptr, d.src, d.w, x, pieces=d.pieces)


def test_operator_recipe_end_to_end(small_graph):
    """A real cu_message operator pair on the conftest graph, both ways."""
    cred = np.random.default_rng(4).uniform(0.2, 1.0, small_graph.num_users)
    for em in t_ops.build_edge_maps(small_graph, "cu_message",
                                    cred.astype(np.float32)):
        x = _x(np.random.default_rng(5), em.num_src, 16)
        want = em.to_dense() @ x.astype(np.float64)
        got = SpmmOperator(em, "cpu").apply(torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [8, 64, 128])
def test_kernel_matches_plain_on_card(D):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py phase 2 runs this "
                    "comparison at full size)")
    em = _case("hub")
    d = CsrDirection.from_edges(em.src, em.dst, em.w, em.num_src,
                                em.num_dst, "cuda")
    x = torch.randn(em.num_src, D, device="cuda")
    y1 = spmm_cuda.KERNEL(d.indptr, d.src, d.w, x, pieces=d.pieces)
    y2 = spmm_cuda.KERNEL(d.indptr, d.src, d.w, x, pieces=d.pieces)
    ref = spmm_cuda.segment_spmm_reference(d.indptr, d.src, d.w, x)
    assert torch.equal(y1, y2)
    torch.testing.assert_close(y1, ref, rtol=1e-5, atol=1e-6)
