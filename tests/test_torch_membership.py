"""Hash membership and row_contains against the JAX package.

The port mixes in int64 masked to 32 bits; the bucket ids must equal the
JAX package's uint32 ``_mix_np`` bit for bit, and the tables and lookups
must be identical (membership is exact: no tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.ops import membership as j_mem
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.ops import sampling as j_samp
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops import membership as t_mem
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops import sampling as t_samp


def test_mix_bits_equal_numpy_uint32():
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 2 ** 31 - 1, 20_000)
    cols = rng.integers(0, 2 ** 31 - 1, 20_000)
    rows[:4] = [0, 1, 2 ** 31 - 1, 2 ** 31 - 2]
    cols[:4] = [2 ** 31 - 1, 0, 2 ** 31 - 1, 7]
    want = j_mem._mix_np(rows, cols).astype(np.int64)
    got = t_mem._mix_torch(torch.as_tensor(rows), torch.as_tensor(cols))
    assert np.array_equal(got.numpy(), want)


def test_table_and_contains_match_jax(small_graph):
    u, i = small_graph.train_edges
    jt = j_mem.HashMembership.build(u, i)
    tt = t_mem.HashMembership.build(u, i, "cpu")
    assert jt.nbuckets == tt.nbuckets
    assert np.array_equal(np.asarray(jt.buckets), tt.buckets.numpy())
    # every train pair is a member
    assert bool(tt.contains(torch.as_tensor(u), torch.as_tensor(i)).all())
    rng = np.random.default_rng(1)
    r = rng.integers(0, small_graph.num_users, 5_000)
    c = rng.integers(0, small_graph.num_items, 5_000)
    want = np.asarray(jt.contains(jnp.asarray(r), jnp.asarray(c)))
    got = tt.contains(torch.as_tensor(r), torch.as_tensor(c)).numpy()
    assert np.array_equal(got, want)
    assert 0 < (~got).sum() < got.size


@pytest.mark.parametrize("membership", ["hash", "bsearch"])
def test_row_contains_matches_jax(small_graph, membership):
    csr = small_graph.user_csr("train")
    jd = j_samp.DeviceCSR.from_host(csr, small_graph.num_items,
                                    membership=membership)
    td = t_samp.DeviceCSR.from_host(csr, small_graph.num_items, "cpu",
                                    membership=membership)
    rng = np.random.default_rng(2)
    rows = rng.integers(0, small_graph.num_users, 64)
    cands = rng.integers(0, small_graph.num_items, (64, 3, 5))
    cands[:, 0, 0] = [csr.row(r)[0] if csr.row(r).size else 0 for r in rows]
    want = np.asarray(j_samp.row_contains(jd, jnp.asarray(rows),
                                          jnp.asarray(cands)))
    got = t_samp.row_contains(td, torch.as_tensor(rows),
                              torch.as_tensor(cands)).numpy()
    assert got.shape == cands.shape
    assert np.array_equal(got, want)
