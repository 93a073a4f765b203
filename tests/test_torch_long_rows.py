"""Long rows of the port's SpMM: cut into fixed edge pieces, reduced in order.

A row with more than ``L`` edges is cut, from its first edge, into pieces of
``L`` edges (the last may be shorter); each piece is summed in edge order
from 0 and the row is the sum of its pieces in piece order from 0
(``ops/spmm_cuda.py``).  On the CPU the plain version must equal an explicit
numpy float32 two-level sum in that order bit for bit, rows of at most ``L``
edges must keep the plain sequential sum, and the operator must agree with
the JAX package's ``SpmmOperator(backend="xla")`` and its Pallas kernels in
interpret mode (K1 ``window=0``, K2 a forced window) on a graph whose hub
row has more than 8·L edges.

Tolerances against JAX are those of ``tests/test_torch_spmm.py``: fp32
rtol/atol 1e-5 (the sums are taken in another order: JAX accumulates the
one-hot products chunk by chunk); bf16 messages with fp32 output rtol/atol
1e-5 (both sides multiply the same bf16-rounded values exactly in fp32);
bf16 output rtol 2**-7.  Gradients against the dense ``A^T g``: 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.graph.operators import EdgeMap
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.ops import spmm_pallas as j_pallas
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.ops.spmm import SpmmOperator as JSpmm
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops import spmm_cuda
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops.spmm import CsrDirection, SpmmOperator

LS = [4, 16]
DS = [8, 64]
# (label, block_rows R, chunk_edges T, window W): K1 = _segment_kernel,
# K2 = _window_kernel
PLANS = [("K1", 8, 16, 0), ("K2", 32, 16, 8)]


def _edge_map(case, L, seed=0):
    """``hub``: a hub row of 8L+3 edges and rows of exactly L, L+1 and 2L+1
    edges among rows of 0 to 3 edges, and half the edges from source 2
    (a long row of the transpose); ``random``: rows of ~3 edges
    with a few above L; ``no_long``: every row at most L edges;
    ``zero_edges``: no edge at all."""
    rng = np.random.default_rng(seed)
    ns, nd = 60, 40
    if case == "hub":
        sizes = {5: 8 * L + 3, 7: L, 9: L + 1, 11: 2 * L + 1}
        dst = np.concatenate([np.full(n, r) for r, n in sizes.items()]
                             + [np.repeat(np.arange(20, nd),
                                          rng.integers(0, 4, nd - 20))])
        rng.shuffle(dst)
    elif case == "random":
        dst = rng.integers(0, nd, 120)
        dst[:3 * L] = 2
    elif case == "no_long":
        dst = np.repeat(np.arange(nd), rng.integers(0, L + 1, nd))
        rng.shuffle(dst)
    elif case == "zero_edges":
        dst = np.zeros(0, np.int64)
    else:
        raise ValueError(case)
    E = dst.size
    src = rng.integers(0, ns, E)
    if case == "hub":       # a source hub too: the transpose has a long row
        src[rng.random(E) < 0.5] = 2
    return EdgeMap(src=src.astype(np.int32),
                   dst=dst.astype(np.int32),
                   w=rng.normal(size=E).astype(np.float32),
                   num_src=ns, num_dst=nd)


def _direction(em, L):
    return CsrDirection.from_edges(em.src, em.dst, em.w, em.num_src,
                                   em.num_dst, "cpu", L)


def _operator(em, L, **kw):
    """A CPU operator whose two directions cut long rows at ``L``."""
    op = SpmmOperator(em, "cpu", **kw)
    op.fwd, op.bwd = _direction(em, L), _direction(_swap(em), L)
    return op


def _two_level(indptr, src, w, x, L):
    """The summation order in numpy float32, row by row."""
    y = np.zeros((indptr.size - 1, x.shape[1]), np.float32)
    for r in range(indptr.size - 1):
        b, e = int(indptr[r]), int(indptr[r + 1])
        acc = np.zeros(x.shape[1], np.float32)
        for p in range(b, e, L if e - b > L else max(e - b, 1)):
            part = np.zeros(x.shape[1], np.float32)
            for k in range(p, min(p + L, e) if e - b > L else e):
                part = part + w[k] * x[src[k]]
            acc = acc + part
        y[r] = acc
    return y


CASES = ["hub", "random", "no_long", "zero_edges"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("L", LS)
@pytest.mark.parametrize("D", DS)
def test_plain_equals_two_level_numpy_sum(case, L, D):
    d = _direction(_edge_map(case, L), L)
    x = np.random.default_rng(1).normal(size=(d.num_src, D)).astype(np.float32)
    got = spmm_cuda.segment_spmm_reference(d.indptr, d.src, d.w,
                                           torch.as_tensor(x),
                                           long_row_edges=L)
    want = _two_level(d.indptr.numpy(), d.src.numpy(), d.w.numpy(), x, L)
    assert np.array_equal(got.numpy(), want)
    # the wrapper on CPU tensors cuts at the piece table's L
    via = spmm_cuda.segment_spmm(d.indptr, d.src, d.w, torch.as_tensor(x),
                                 pieces=d.pieces)
    assert torch.equal(via, got)


@pytest.mark.parametrize("L", LS)
def test_plain_equals_two_level_numpy_sum_bf16(L):
    """bf16 table: products bf16(w) * bf16(x) are exact in fp32, summed in
    the same order, rounded to bf16 once."""
    d = _direction(_edge_map("hub", L), L)
    xb = torch.as_tensor(np.random.default_rng(2).normal(
        size=(d.num_src, 8)).astype(np.float32)).to(torch.bfloat16)
    got = spmm_cuda.segment_spmm_reference(d.indptr, d.src, d.w, xb,
                                           long_row_edges=L)
    wb = d.w.to(torch.bfloat16).float().numpy()
    want = _two_level(d.indptr.numpy(), d.src.numpy(), wb,
                      xb.float().numpy(), L)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, torch.as_tensor(want).to(torch.bfloat16))


@pytest.mark.parametrize("L", LS)
def test_short_rows_keep_the_sequential_sum(L):
    d = _direction(_edge_map("hub", L), L)
    x = torch.randn(d.num_src, 8, generator=torch.Generator().manual_seed(3))
    cut = spmm_cuda.segment_spmm_reference(d.indptr, d.src, d.w, x,
                                           long_row_edges=L)
    whole = spmm_cuda.segment_spmm_reference(d.indptr, d.src, d.w, x,
                                             long_row_edges=d.src.numel())
    short = (d.indptr[1:] - d.indptr[:-1]) <= L
    assert int((~short).sum()) == 3            # 8L+3, L+1 and 2L+1 edges
    assert torch.equal(cut[short], whole[short])
    torch.testing.assert_close(cut, whole, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("L", LS)
def test_piece_boundaries(L):
    """Rows of exactly L edges stay whole, L+1 is two pieces (L and 1),
    every edge of a long row lies in exactly one piece, in order."""
    d = _direction(_edge_map("hub", L), L)
    p = d.pieces
    ip = d.indptr.numpy()
    deg = np.diff(ip)
    assert p.edges_per_piece == L
    assert np.array_equal(p.rows.numpy(), np.flatnonzero(deg > L))
    assert deg[7] == L and 7 not in p.rows.numpy()
    assert deg[9] == L + 1
    first = p.first.numpy()
    assert first[0] == 0 and first[-1] == p.num_pieces
    for i, r in enumerate(p.rows.numpy()):
        sl = slice(first[i], first[i + 1])
        starts = p.start.numpy()[sl]
        assert np.all(p.row.numpy()[sl] == r)
        assert len(starts) == -(-deg[r] // L)
        ends = np.minimum(starts + L, ip[r + 1])
        covered = np.concatenate([np.arange(s, e) for s, e in
                                  zip(starts, ends)])
        assert np.array_equal(covered, np.arange(ip[r], ip[r + 1]))
    row9 = list(p.rows.numpy()).index(9)
    assert np.array_equal(np.diff(np.append(p.start.numpy()[
        first[row9]:first[row9 + 1]], ip[10])), [L, 1])


@pytest.mark.parametrize("case", ["no_long", "zero_edges"])
def test_operators_without_long_rows(case):
    L = 4
    d = _direction(_edge_map(case, L), L)
    assert d.pieces.num_pieces == 0 and d.pieces.num_long == 0
    assert d.pieces.first.tolist() == [0]
    x = torch.randn(d.num_src, 8)
    y = spmm_cuda.segment_spmm_reference(d.indptr, d.src, d.w, x,
                                         long_row_edges=L)
    assert torch.equal(y, spmm_cuda.segment_spmm_reference(
        d.indptr, d.src, d.w, x, long_row_edges=10 ** 6))
    if case == "zero_edges":
        assert bool((y == 0).all())


def test_piece_table_checks():
    d = _direction(_edge_map("hub", 4), 4)
    p = d.pieces
    with pytest.raises(ValueError):
        spmm_cuda.long_row_pieces(d.indptr, 0)
    with pytest.raises(ValueError):
        spmm_cuda.LongRowPieces(4, d.indptr, p.start.int(), p.row, p.rows,
                                p.first)
    with pytest.raises(ValueError):
        spmm_cuda.LongRowPieces(4, d.indptr, p.start, p.row[:-1], p.rows,
                                p.first)
    x = torch.randn(d.num_src, 8)
    with pytest.raises(ValueError):   # the kernel runs on CUDA tensors only
        spmm_cuda.KERNEL(d.indptr, d.src, d.w, x, pieces=p)
    # a table built from another indptr, even one equal to it, is refused
    with pytest.raises(ValueError):
        spmm_cuda.segment_spmm(d.indptr.clone(), d.src, d.w, x, pieces=p)
    other = _direction(_edge_map("random", 4), 4)
    with pytest.raises(ValueError):
        spmm_cuda.segment_spmm(d.indptr, d.src, d.w, x, pieces=other.pieces)


@pytest.mark.parametrize("L", LS)
@pytest.mark.parametrize("D", DS)
def test_long_rows_match_jax_xla(L, D):
    em = _edge_map("hub", L)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(em.num_src, D)).astype(np.float32)
    g = rng.normal(size=(em.num_dst, D)).astype(np.float32)
    j = JSpmm(em, backend="xla")
    t = _operator(em, L)
    assert t.fwd.pieces.num_long == 3
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
    assert p.window == W
    return j_pallas.apply_pallas(p, x)


def _swap(em):
    return EdgeMap(src=em.dst, dst=em.src, w=em.w, num_src=em.num_dst,
                   num_dst=em.num_src)


@pytest.mark.parametrize("plan", PLANS, ids=[p[0] for p in PLANS])
@pytest.mark.parametrize("L", LS)
@pytest.mark.parametrize("direction", ["apply", "transpose_apply"])
def test_long_rows_match_pallas_interpret_fp32(plan, L, direction):
    em = _edge_map("hub", L)
    jem = em if direction == "apply" else _swap(em)
    x = np.random.default_rng(5).normal(
        size=(jem.num_src, 64)).astype(np.float32)
    want = np.asarray(_pallas(jem, jnp.asarray(x), plan, "float32"))
    op = _operator(em, L)
    got = getattr(op, direction)(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("plan", PLANS, ids=[p[0] for p in PLANS])
@pytest.mark.parametrize("L", LS)
@pytest.mark.parametrize("direction", ["apply", "transpose_apply"])
def test_long_rows_match_pallas_interpret_bf16(plan, L, direction):
    em = _edge_map("hub", L)
    jem = em if direction == "apply" else _swap(em)
    x = np.random.default_rng(6).normal(
        size=(jem.num_src, 8)).astype(np.float32)
    op = _operator(em, L, precision="bf16")
    run = getattr(op, direction)
    # fp32 table, bf16 messages: fp32 output
    want = np.asarray(_pallas(jem, jnp.asarray(x), plan, "bfloat16"))
    np.testing.assert_allclose(run(torch.as_tensor(x)).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    # bf16 table: bf16 output
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want_b = np.asarray(_pallas(jem, xb, plan, "bfloat16").astype(jnp.float32))
    got_b = run(torch.as_tensor(x).to(torch.bfloat16)).float().numpy()
    np.testing.assert_allclose(got_b, want_b, rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("L", LS)
@pytest.mark.parametrize("direction", ["apply", "transpose_apply"])
def test_gradient_through_long_rows(L, direction):
    """The backward runs the other direction's CSR with its own pieces:
    dx = A^T g for apply, A g for transpose_apply, within 1e-5."""
    em = _edge_map("hub", L)
    A = em.to_dense().astype(np.float64)
    if direction == "transpose_apply":
        A = A.T
    op = _operator(em, L)
    assert op.fwd.pieces.num_long == 3 and op.bwd.pieces.num_long == 1
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.normal(size=(A.shape[1], 16)).astype(np.float32),
                        ).requires_grad_()
    g = rng.normal(size=(A.shape[0], 16)).astype(np.float32)
    y = getattr(op, direction)(x)
    (y * torch.as_tensor(g)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), A.T @ g.astype(np.float64),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("L", LS)
@pytest.mark.parametrize("D", [8, 33, 64])
def test_kernel_bit_equal_to_cpu_plain_on_card(L, D):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py phases 2 and 5 run "
                    "this comparison at full size)")
    em = _edge_map("hub", L)
    d = CsrDirection.from_edges(em.src, em.dst, em.w, em.num_src,
                                em.num_dst, "cuda", L)
    x = torch.randn(em.num_src, D)
    for dt in (torch.float32, torch.bfloat16):
        xc = x.to(dt)
        y1 = spmm_cuda.KERNEL(d.indptr, d.src, d.w, xc.cuda(), pieces=d.pieces)
        y2 = spmm_cuda.KERNEL(d.indptr, d.src, d.w, xc.cuda(), pieces=d.pieces)
        want = spmm_cuda.segment_spmm_reference(
            d.indptr.cpu(), d.src.cpu(), d.w.cpu(), xc, long_row_edges=L)
        assert torch.equal(y1, y2)
        assert torch.equal(y1.cpu(), want)
