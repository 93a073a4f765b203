"""The full evaluation's ranking probe (``<port>/probes/eval_breakdown.py``):
the chunked top-k gives the full-width top-k sets (chunks that do not
divide the catalogue, chunks narrower than K), ties are told apart from
misses, and a run on a small graph on the CPU times every part and finds
every variant's sets equal to full width."""

import contextlib
import io

import numpy as np
import pytest
import torch

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.graph.build import synthetic_bipartite_graph
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.probes import eval_breakdown as eb


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small shapes: one intra-op thread, so that this file adds no thread
    contention to the test workers running beside it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n,chunks,k", [(1000, 32, 20), (3000, 7, 20),
                                        (64, 16, 20), (50, 50, 5)])
def test_chunked_topk_is_full_width(n, chunks, k):
    s = torch.randn(9, n, generator=torch.Generator().manual_seed(n))
    v, ids = eb.chunked_topk(s, k, chunks)
    fv, fi = torch.topk(s, k, dim=1)
    assert torch.equal(v, fv)
    assert all(set(a.tolist()) == set(b.tolist()) for a, b in zip(ids, fi))
    assert eb.sets_agree(s, fi, ids) == 1.0


def test_sets_agree_ties_aside():
    s = torch.tensor([[5.0, 4.0, 3.0, 3.0, 1.0]])
    ref = torch.tensor([[0, 1, 2]])
    assert eb.sets_agree(s, ref, torch.tensor([[0, 1, 3]])) == 1.0  # a tie
    assert eb.sets_agree(s, ref, torch.tensor([[0, 1, 4]])) == 0.0  # a miss


def test_run_on_cpu(tmp_path):
    g = synthetic_bipartite_graph(2000, 3000, 10.0, seed=0, power=1.0)
    with contextlib.redirect_stdout(io.StringIO()):
        rec = eb.main(["--batches", "3", "--batch", "256", "--dim", "32",
                       "--out", str(tmp_path / "eb.json"), "--device",
                       "cpu"], graph=g)
    assert set(rec["ms_per_batch"]) == set(eb.PARTS)
    assert all(np.isfinite(v) and v >= 0 for v in rec["ms_per_batch"].values())
    assert rec["sets_agree_min"] == {"topk_chunked_vs_full": 1.0,
                                     "topk_bf16_chunked_vs_bf16_full": 1.0}
    assert 0.5 < rec["bf16_jaccard_vs_fp32_mean"] <= 1.0
    assert rec["clock"] == "host clock, cpu" and rec["card"] is None
    assert len(rec["per_batch"]) == 3
