"""The port's dst-sliced chunk plans against the JAX package's.

``ops/segment_plan.build_sliced_segment_plans`` is held array for array
against ``JAX: ops/spmm_pallas.build_sliced_segment_plans`` for S in {1, 2,
3, 4, "auto"} and windows 0, a forced 64 and "auto" on a graph of mean
degree 10 (where "auto" picks W = 64).  Slicing does not change a sum: the
slices' block spaces, one after another, equal the unsliced plan's bit for
bit through the plain version, truncated and padded.  bf16 messages: the
plain version (weights rounded to bf16, fp32 sums) within rtol 2e-2 /
atol 1e-3 of JAX's ``apply_pallas`` with ``msg_dtype="bfloat16"`` (Pallas
in interpret mode).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.graph.operators import EdgeMap as JEdgeMap
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.ops.spmm_pallas import apply_pallas
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.ops.spmm_pallas import build_sliced_segment_plans as j_sliced
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.graph.operators import EdgeMap
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops.chunk_spmm import chunk_spmm_reference
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops.segment_plan import auto_window, build_sliced_segment_plans
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops.spmm import SpmmOperator

R, T = 128, 32
NUM_SRC, NUM_DST, E = 300, 600, 6000      # 5 blocks of R, mean degree 10


def _sorted_edges(seed=0, num_src=NUM_SRC, num_dst=NUM_DST, e=E):
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, num_dst, e))
    src = rng.integers(0, num_src, e).astype(np.int32)
    w = rng.uniform(0.1, 1.0, e).astype(np.float32)
    return src, dst, w


def _jax_arrays(plan) -> dict:
    out = {k: np.asarray(getattr(plan, k)).reshape(-1) for k in
           ("src_padded", "w_padded", "local_ids", "block_id", "first_chunk")}
    out["win_start"] = (None if plan.win_start is None
                        else np.asarray(plan.win_start))
    return out


def test_auto_picks_a_window_on_this_graph():
    _, dst, _ = _sorted_edges()
    assert auto_window(dst, NUM_DST, E, R, T) == 64


@pytest.mark.parametrize("window", [0, 64, "auto"])
@pytest.mark.parametrize("slices", [1, 2, 3, 4, "auto"])
def test_sliced_plans_equal_jax(slices, window):
    src, dst, w = _sorted_edges()
    got = build_sliced_segment_plans(src, dst, w, NUM_DST, R, T,
                                     num_src=NUM_SRC, window=window,
                                     slices=slices)
    want = j_sliced(src, dst, w, NUM_DST, R, T, num_src=NUM_SRC,
                    interpret=True, window=window, slices=slices)
    assert len(got) == len(want) == (4 if slices == "auto" else slices)
    for g, j in zip(got, want):
        assert (g.num_dst, g.num_src, g.num_blocks, g.window) == \
            (j.num_dst, j.num_src, j.num_blocks, j.window)
        assert g.window == (0 if window == 0 else 64)
        a, b = g.arrays(), _jax_arrays(j)
        for k in a:
            if b[k] is None:
                assert a[k] is None, k
            else:
                assert np.array_equal(a[k], b[k]), k


def test_one_block_is_one_plan():
    src, dst, w = _sorted_edges(num_dst=R, e=400)
    for slices in ("auto", 4):
        plans = build_sliced_segment_plans(src, dst, w, R, R, T,
                                           num_src=NUM_SRC, slices=slices)
        assert len(plans) == 1 and plans[0].num_blocks == 1
    # and no edges: one plan whatever S
    empty = np.zeros(0, np.int32)
    plans = build_sliced_segment_plans(empty, empty, empty.astype(np.float32),
                                       NUM_DST, R, T, num_src=NUM_SRC,
                                       slices=4)
    assert len(plans) == 1 and plans[0].num_blocks == -(-NUM_DST // R)


def _ops(slices, precision="fp32", window_graph=True):
    rng = np.random.default_rng(4)
    src, dst, w = _sorted_edges(seed=1 if window_graph else 2)
    perm = rng.permutation(E)                  # unsorted input edges
    em = EdgeMap(src=src[perm], dst=dst[perm].astype(np.int32), w=w[perm],
                 num_src=NUM_SRC, num_dst=NUM_DST)
    return SpmmOperator(em, "cpu", backend="chunked", precision=precision,
                        block_rows=R, chunk_edges=T, slices=slices)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("slices", [2, 3, 4, "auto"])
def test_sliced_applies_bit_equal_to_unsliced(slices, precision):
    one, many = _ops(1, precision), _ops(slices, precision)
    assert len(one.fwd.plans) == 1 and len(many.fwd.plans) > 1
    assert many.src_layout.equals(one.src_layout)
    assert many.dst_layout.equals(one.dst_layout)
    x = torch.as_tensor(np.random.default_rng(5).normal(
        size=(NUM_SRC, 16)).astype(np.float32))
    g = torch.as_tensor(np.random.default_rng(6).normal(
        size=(NUM_DST, 16)).astype(np.float32))
    assert torch.equal(many.apply(x), one.apply(x))
    assert torch.equal(many.transpose_apply(g), one.transpose_apply(g))
    xp = one.src_layout.to_padded(x)
    assert torch.equal(many.apply_padded(xp), one.apply_padded(xp))


def test_bf16_reference_close_to_jax_pallas():
    src, dst, w = _sorted_edges(seed=3)
    x = np.random.default_rng(7).normal(size=(NUM_SRC, 24)).astype(np.float32)
    for window in (0, 64):
        want = np.asarray(apply_pallas(j_sliced(
            src, dst, w, NUM_DST, R, T, num_src=NUM_SRC, interpret=True,
            msg_dtype="bfloat16", window=window, slices=2),
            jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
        plans = build_sliced_segment_plans(src, dst, w, NUM_DST, R, T,
                                           num_src=NUM_SRC, window=window,
                                           slices=2)
        xb = torch.as_tensor(x).to(torch.bfloat16)
        got = torch.cat([chunk_spmm_reference(p, xb)[:p.num_dst]
                         for p in plans]).to(torch.bfloat16).float()
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=1e-3)
        # the weights are rounded: the fp32-weight sum differs
        exact = torch.cat([chunk_spmm_reference(p, xb.float())[:p.num_dst]
                           for p in plans])
        assert not torch.equal(got, exact.to(torch.bfloat16).float())


def test_jax_edge_map_agrees():
    """The operator's layouts are JAX's: padded rows of each side."""
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.ops.spmm import SpmmOperator as JOp
    src, dst, w = _sorted_edges(seed=1)
    jop = JOp(JEdgeMap(src=src, dst=dst.astype(np.int32), w=w,
                       num_src=NUM_SRC, num_dst=NUM_DST),
              backend="pallas", block_rows=R, chunk_edges=T)
    op = _ops("auto")
    assert (op.src_layout.rows, op.src_layout.padded_rows) == \
        (jop.src_layout.rows, jop.src_layout.padded_rows)
    assert (op.dst_layout.rows, op.dst_layout.padded_rows) == \
        (jop.dst_layout.rows, jop.dst_layout.padded_rows)
