"""The port's ``SpmmOperator(backend="chunked")`` against the JAX package's
``SpmmOperator(backend="pallas")`` (Pallas in interpret mode), at R = 8,
T = 16 so that each direction has several slices and many chunks.

``apply``, ``transpose_apply`` and ``apply_padded``, and the gradients that
autograd takes through each (the other direction's plans on the cotangent,
truncated or padded), within rtol / atol 1e-5 of JAX's in fp32 (the sums
run in another order than the MXU's) and 2e-2 / 1e-3 in bf16 messages.
Each gradient equals the other direction's apply bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.graph.operators import EdgeMap as JEdgeMap
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.ops.spmm import SpmmOperator as JOp
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.graph.operators import EdgeMap
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops.spmm import SpmmOperator

R, T, D = 8, 16, 12
NUM_SRC, NUM_DST, E = 37, 61, 400
TOL = {"fp32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=1e-3)}


@pytest.fixture(scope="module")
def ops():
    rng = np.random.default_rng(0)
    src = rng.integers(0, NUM_SRC, E).astype(np.int32)
    # a hub destination, and destinations no edge reaches
    dst = np.where(rng.random(E) < 0.2, 5,
                   rng.integers(0, NUM_DST - 6, E)).astype(np.int32)
    w = rng.uniform(0.1, 1.0, E).astype(np.float32)
    out = {}
    for prec in ("fp32", "bf16"):
        out[prec] = (
            SpmmOperator(EdgeMap(src=src, dst=dst, w=w, num_src=NUM_SRC,
                                 num_dst=NUM_DST), "cpu", backend="chunked",
                         precision=prec, block_rows=R, chunk_edges=T),
            JOp(JEdgeMap(src=src, dst=dst, w=w, num_src=NUM_SRC,
                         num_dst=NUM_DST), backend="pallas", block_rows=R,
                chunk_edges=T, precision=prec))
    return out


def _tables(shape_x, shape_g, dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape_x).astype(np.float32)
    g = rng.normal(size=shape_g).astype(np.float32)
    if dtype == "bf16":     # tables exactly representable in bf16
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        g = np.array(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32))
    return x, g


def _close(a: torch.Tensor, b, prec):
    np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                               **TOL[prec])


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
@pytest.mark.parametrize("form", ["apply", "transpose_apply", "apply_padded"])
def test_apply_and_gradient_match_jax(ops, form, prec):
    op, jop = ops[prec]
    assert len(op.fwd.plans) == len(op.bwd.plans) == 4
    assert op.padded_chain and jop.padded_chain
    rows_in = {"apply": NUM_SRC, "transpose_apply": NUM_DST,
               "apply_padded": op.src_layout.padded_rows}[form]
    rows_out = {"apply": NUM_DST, "transpose_apply": NUM_SRC,
                "apply_padded": op.dst_layout.padded_rows}[form]
    assert (op.src_layout.padded_rows, op.dst_layout.padded_rows) == \
        (jop.src_layout.padded_rows, jop.dst_layout.padded_rows)
    x, g = _tables((rows_in, D), (rows_out, D), prec)
    if form == "apply_padded":     # a padded table: zero pad rows
        x[NUM_SRC:] = 0.0
    xt = torch.as_tensor(x).requires_grad_()
    y = getattr(op, form)(xt)
    assert y.shape == (rows_out, D) and y.dtype == torch.float32
    (dx,) = torch.autograd.grad(y, xt, torch.as_tensor(g))

    def f(xj):
        return getattr(jop, form)(xj)
    yj, vjp = jax.vjp(f, jnp.asarray(x))
    (dxj,) = vjp(jnp.asarray(g))
    _close(y.detach(), yj, prec)
    _close(dx, dxj, prec)
    if form == "apply_padded":
        assert not y[NUM_DST:].any()          # pad rows are exact zeros
    # each gradient is the other direction's apply on the cotangent
    other = {"apply": op.transpose_apply, "apply_padded": None,
             "transpose_apply": op.apply}[form]
    gt = torch.as_tensor(g)
    want = (other(gt) if other is not None
            else op._run(op._bwd_padded, gt))
    assert torch.equal(dx, want)


def test_padded_chain_truncates_to_apply(ops):
    """Two padded layers truncated once equal two truncating applies of the
    symmetric-shaped chain A^T (A x): the pad rows never leak."""
    op, _ = ops["fp32"]
    x, _ = _tables((NUM_SRC, D), (1, D), "fp32")
    xt = torch.as_tensor(x)
    y = op.apply_padded(op.src_layout.to_padded(xt))
    z = op._run(op._bwd_padded, y)
    assert torch.equal(op.dst_layout.from_padded(y), op.apply(xt))
    assert torch.equal(op.src_layout.from_padded(z),
                       op.transpose_apply(op.apply(xt)))


def test_bad_rows_and_backend_raise(ops):
    op, _ = ops["fp32"]
    with pytest.raises(ValueError, match="rows"):
        op.apply(torch.zeros(NUM_SRC + 1, D))
    with pytest.raises(ValueError, match="rows"):
        op.apply_padded(torch.zeros(NUM_SRC, D))
    em = EdgeMap(src=np.zeros(1, np.int32), dst=np.zeros(1, np.int32),
                 w=np.ones(1, np.float32), num_src=1, num_dst=1)
    with pytest.raises(ValueError, match="backend"):
        SpmmOperator(em, "cpu", backend="pallas")
    with pytest.raises(ValueError, match="chunked"):
        SpmmOperator(em, "cpu").apply_padded(torch.zeros(1, D))
