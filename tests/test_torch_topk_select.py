"""The exact top-k select (``ops/topk_select.py``, ``csrc/topk_select.cu``).

The plain version, a stable descending sort cut to k, must give
``jax.lax.top_k``'s id lists, equal scores in ascending id, on inputs with
planted ties, masked rows (-1e9, -inf) and rows with fewer than k finite
scores.  The wrapper takes the plain version for a CPU tensor and, for any
other, checks what the kernel takes before it builds or launches anything
(here on ``meta`` tensors, which hold no data).  The single-device ranking
paths (``eval/ranking._full_batch``, ``eval/retrieval.topk_for_users``) reach
it.  The ``cuda`` tests hold the kernel to the plain version on the card,
ids and value bits equal, at the evaluation's and serving's shapes, ragged
and misaligned rows, k from 1 to 256 and adversarial rows, and read the
kernel's two counters.
"""

import numpy as np
import pytest
import torch

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.eval import ranking, retrieval
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.graph.build import synthetic_bipartite_graph
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops import topk_select as ts
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops import topk_select_cuda


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(case: str, rng, B: int = 6, I: int = 301) -> np.ndarray:
    """(B, I) fp32 scores of one kind."""
    if case == "random":
        return rng.standard_normal((B, I)).astype(np.float32)
    if case == "ties":          # few distinct values: ties everywhere
        return rng.integers(-3, 4, (B, I)).astype(np.float32)
    if case == "masked":        # half the items of each row at -1e9
        x = rng.standard_normal((B, I)).astype(np.float32)
        x[rng.random((B, I)) < 0.5] = -1e9
        return x
    if case == "all_masked":    # whole rows at -1e9 and at -inf
        x = rng.standard_normal((B, I)).astype(np.float32)
        x[0], x[1] = -1e9, -np.inf
        return x
    if case == "few_finite":    # fewer than k finite scores, the rest -inf
        x = np.full((B, I), -np.inf, np.float32)
        for b in range(B):
            ids = rng.choice(I, size=b + 1, replace=False)
            x[b, ids] = rng.integers(0, 2, b + 1)
        return x
    if case == "ascending":
        return np.tile(np.arange(I, dtype=np.float32), (B, 1))
    if case == "descending":
        return np.tile(np.arange(I, dtype=np.float32)[::-1], (B, 1))
    if case == "equal":
        return np.ones((B, I), np.float32)
    if case == "signed_zeros":  # -0.0 ties +0.0
        return np.where(rng.random((B, I)) < 0.5, np.float32(-0.0),
                        np.float32(0.0)).astype(np.float32)
    raise ValueError(case)


CPU_CASES = ("random", "ties", "masked", "all_masked", "few_finite",
             "ascending", "descending", "equal")


@pytest.mark.parametrize("case", CPU_CASES)
@pytest.mark.parametrize("k", [1, 20, 64, 256])
def test_plain_order_equals_lax_top_k(case, k):
    import jax
    x = _rows(case, np.random.default_rng(k))
    values, ids = ts.topk_select_reference(torch.as_tensor(x), k)
    jv, ji = jax.lax.top_k(x, k)
    assert ids.dtype == torch.int64 and ids.shape == (x.shape[0], k)
    assert np.array_equal(ids.numpy(), np.asarray(ji))
    assert np.array_equal(values.numpy(), np.asarray(jv))
    # the values are the scores at the ids
    assert np.array_equal(values.numpy(),
                          np.take_along_axis(x, ids.numpy(), 1))


def test_cpu_tensors_take_the_plain_version():
    x = torch.as_tensor(_rows("ties", np.random.default_rng(0)))
    before = topk_select_cuda.KERNEL.launches
    values, ids = ts.topk_select(x, 20)
    rv, ri = ts.topk_select_reference(x, 20)
    assert torch.equal(values, rv) and torch.equal(ids, ri)
    assert ts.topk_select(x, 20, count=True)[2] is None
    assert topk_select_cuda.KERNEL.launches == before
    # a signed zero keeps its own bits in the values
    z = torch.as_tensor(_rows("signed_zeros", np.random.default_rng(1)))
    zv, zi = ts.topk_select(z, 33)
    assert torch.equal(zv.view(torch.int32),
                       z.gather(1, zi).view(torch.int32))
    assert bool((zi.diff(dim=1) > 0).all())


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("scores,k,match", [
    (_meta(4, 100, dtype=torch.float16), 20, "fp32"),
    (_meta(4, 100, dtype=torch.bfloat16), 20, "fp32"),
    (_meta(400), 20, "2-D"),
    (_meta(2, 4, 100), 20, "2-D"),
    (_meta(100, 4).T, 20, "row-major"),
    (_meta(4, 200)[:, ::2], 20, "row-major"),
    (_meta(4, 100), 0, "1..256"),
    (_meta(4, 1000), 257, "1..256"),
    (_meta(4, 30), 31, "columns"),
    (_meta(1, 2 ** 31), 20, "2\\*\\*31"),
    (_meta(4, 100), 20, "CUDA tensor"),
])
def test_kernel_refuses_what_it_does_not_take(scores, k, match):
    """Every check runs before a build or a launch, so a tensor with no
    data (``meta``) shows each; a tensor the kernel takes is refused for
    not lying on a card."""
    before = topk_select_cuda.KERNEL.launches
    with pytest.raises(ValueError, match=match):
        ts.topk_select(scores, k)
    assert topk_select_cuda.KERNEL.launches == before


@pytest.mark.parametrize("rows,cols,sms,chunks", [
    (512, 1_000_000, 132, 1),   # the evaluation: 512 users over 1M items
    (256, 262_728, 132, 2),     # serving's smallest and largest requests
    (1024, 262_728, 132, 1),
    (64, 262_728, 132, 4),      # slices of at least 65,536 scores
    (9, 90, 132, 1),            # the test graphs
    (256, 262_728, 114, 1),     # a card with fewer SMs: at most one wave
])
def test_chunks_come_from_the_shape(rows, cols, sms, chunks):
    assert topk_select_cuda.chunks_for(rows, cols, sms) == chunks


@pytest.fixture(scope="module")
def graph():
    return synthetic_bipartite_graph(num_users=60, num_items=70,
                                     edges_per_user=6.0, seed=3, power=0.8)


def _spy(monkeypatch, module):
    calls = []

    def spy(scores, k, **kw):
        calls.append((tuple(scores.shape), k))
        return ts.topk_select(scores, k, **kw)
    monkeypatch.setattr(module, "topk_select", spy)
    return calls


@pytest.mark.parametrize("path", ["evaluate_full", "topk_for_users"])
def test_single_device_ranking_reaches_topk_select(graph, monkeypatch, path):
    rng = np.random.default_rng(4)
    ue = torch.as_tensor(rng.standard_normal((graph.num_users, 8)),
                         dtype=torch.float32)
    ie = torch.as_tensor(rng.standard_normal((graph.num_items, 8)),
                         dtype=torch.float32)
    if path == "evaluate_full":
        calls = _spy(monkeypatch, ranking)
        ctx = ranking.EvalContext.build(graph, "cpu")
        n = ctx.users_of("test").size
        res = ranking.evaluate_full(ue, ie, ctx, "test", Ks=(10, 20),
                                    batch=16)
        assert calls == [((16, graph.num_items), 20)] * -(-n // 16)
        assert res[20]["users_eval"] == n
    else:
        calls = _spy(monkeypatch, retrieval)
        users = np.arange(0, graph.num_users, 4)
        excl = torch.as_tensor(
            retrieval.exclusion_rows_for_users(graph, users))
        s, i = retrieval.topk_for_users(ue, ie, torch.as_tensor(users), 7,
                                        exclude_batch_rows=excl)
        assert calls == [((users.size, graph.num_items), 7)]
        want = retrieval.mask_excluded(ue[users] @ ie.T, excl,
                                       float("-inf"))
        rv, ri = ts.topk_select_reference(want, 7)
        assert torch.equal(i, ri) and torch.equal(s, rv)


@pytest.mark.parametrize("top,refused", [(256, False), (257, True)])
def test_trainer_holds_ks_to_the_kernel(graph, top, refused):
    """A full evaluation on one device ranks with the kernel on the card,
    so the trainer refuses a K it does not take, on the CPU as well."""
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.train.trainer import RecTrainer
    from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.utils.config import RecConfig
    cfg = RecConfig(Ks=(20, top), eval_mode="full", emb_dim=8, num_layers=1)
    if refused:
        with pytest.raises(ValueError, match="k up to 256"):
            RecTrainer(cfg, graph, device="cpu", verbose=False)
    else:
        RecTrainer(cfg, graph, device="cpu", verbose=False)
    # the sampled evaluation ranks without it
    RecTrainer(cfg.replace(eval_mode="sampled"), graph, device="cpu",
               verbose=False)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py times the kernel at "
                    "the evaluation's and serving's shapes)")
    return torch.device("cuda", 0)


def _held(scores: torch.Tensor, k: int) -> int:
    """The kernel against the plain version on the card: ids equal, value
    bits equal, one launch a call; returns the insertions counted."""
    before = topk_select_cuda.KERNEL.launches
    values, ids, inserted = ts.topk_select(scores, k, count=True)
    assert topk_select_cuda.KERNEL.launches == before + 1
    again_v, again_i = ts.topk_select(scores, k)
    assert topk_select_cuda.KERNEL.launches == before + 2
    rv, ri = ts.topk_select_reference(scores, k)
    assert values.dtype == torch.float32 and ids.dtype == torch.int64
    assert torch.equal(ids, ri)
    assert torch.equal(values.view(torch.int32), rv.view(torch.int32))
    assert torch.equal(again_i, ids) and torch.equal(again_v, values)
    rows, cols = scores.shape
    assert min(k, cols) <= inserted <= rows * cols
    return inserted


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols", [(512, 1_000_000), (256, 262_728),
                                       (1024, 262_728)])
def test_kernel_equals_plain_at_the_cells_shapes(rows, cols):
    dev = _card()
    g = torch.Generator(device=dev)
    g.manual_seed(rows + cols)
    scores = torch.randn(rows, cols, device=dev, generator=g)
    # masked items, as the evaluation (-1e9) and serving (-inf) leave them
    scores[torch.rand(rows, cols, device=dev, generator=g) < 1e-4] = -1e9
    inserted = _held(scores, 20)
    # a random row lets few scores past the threshold
    assert inserted < 0.05 * rows * cols


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [70_001, 262_727, 100, 37])
@pytest.mark.parametrize("misaligned", [False, True])
def test_kernel_equals_plain_on_ragged_rows(cols, misaligned):
    """Rows whose length is not a multiple of 4 (so rows start off 16-byte
    alignment), a matrix one float off alignment, and rows below a slice."""
    dev = _card()
    rows = 33
    g = torch.Generator(device=dev)
    g.manual_seed(cols)
    x = torch.randn(rows * cols, device=dev, generator=g)
    if misaligned:
        x = torch.cat([x.new_zeros(1), x])[1:]
        assert x.data_ptr() % 16 != 0
    _held(x.view(rows, cols), min(20, cols))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 20, 32, 33, 64, 65, 100, 128, 129,
                               256])
def test_kernel_equals_plain_at_every_k(k):
    dev = _card()
    g = torch.Generator(device=dev)
    g.manual_seed(k)
    _held(torch.randn(300, 100_003, device=dev, generator=g), k)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ascending", "descending", "equal",
                                  "masked", "signed_zeros", "ties",
                                  "few_finite", "all_masked"])
@pytest.mark.parametrize("k", [20, 64, 256])
def test_kernel_equals_plain_on_adversarial_rows(case, k):
    dev = _card()
    x = torch.as_tensor(_rows(case, np.random.default_rng(k), B=6,
                              I=200_003), device=dev)
    inserted = _held(x, k)
    if case == "equal":
        rv, ri = ts.topk_select(x, k)
        assert torch.equal(ri.cpu(), torch.arange(k).expand(6, k))
    if case == "ascending":
        # every score beats the threshold of the scores before it in its
        # lane; far more get in than on a random row
        assert inserted > 0.05 * x.numel()
