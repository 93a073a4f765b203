"""The PyTorch package's chunked SpMM against the Pallas probe kernels.

On the CPU ``ops/chunk_spmm`` runs its plain version.  It is held against
the JAX functions run in ``pltpu.force_tpu_interpret_mode()``:

* P1: the probe's ``apply_window`` on the probe's ``build_window_plan``;
* P2: the probe's ``apply_i16`` on a JAX ``window=0`` plan (the port reads
  int16 local ids);
* P3: JAX ``apply_pallas_padded`` on a ``window=0`` plan, which has the body
  of the probe's ``apply_nopad_trunc`` (nested in that probe's ``main`` and
  not importable), and a K=3 padded chain against the same chain in JAX.

Tolerance: |port - JAX| <= 1e-6 + 1e-5 * sum_e |w_e * x_src(e)| per element,
because the MXU sums a chunk in another order than edge order.  The plain
version is also held against the CSR plain version ``segment_spmm_reference``
within the same bound, and its order (runs in edge order, then chunk
partials in chunk order) is checked bit for bit on a hub row.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.ops import spmm_pallas as j_pallas
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops import chunk_spmm as cs
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops import chunk_spmm_cuda
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops.segment_plan import PadLayout, build_segment_plan
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops.spmm import CsrDirection
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops.spmm_cuda import segment_spmm_reference

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6
R, T = 16, 16                  # full-block plans: many blocks and chunks
RW, TW = 32, 16                # window plans


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location(
        "probe_window_kernel", ROOT / "scripts" / "probe_window_kernel.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _case(name, seed=0):
    """dst-sorted (src, dst, w, num_src, num_dst)."""
    rng = np.random.default_rng(seed)
    if name == "random":
        ns, nd, E = 37, 100, 300
        src, dst = rng.integers(0, ns, E), rng.integers(0, nd, E)
    elif name == "empty_blocks":
        ns, nd, E = 30, 100, 120
        src, dst = rng.integers(0, ns, E), rng.integers(0, 20, E)
    elif name == "duplicates":
        ns, nd = 6, 40
        src = np.repeat(rng.integers(0, ns, 12), 4)
        dst = np.repeat(rng.integers(0, nd, 12), 4)
    elif name == "zero_edges":
        ns, nd = 5, 40
        src = dst = np.zeros(0, np.int64)
    elif name == "hub":
        ns, nd, E = 80, 70, 700
        src = rng.integers(0, ns, E)
        dst = np.where(rng.random(E) < 0.6, 3, rng.integers(0, nd, E))
    elif name == "inf_row0":       # real edges never read source row 0
        ns, nd, E = 40, 90, 400
        src, dst = rng.integers(1, ns, E), rng.integers(0, nd, E)
    else:
        raise ValueError(name)
    order = np.argsort(dst, kind="stable")
    w = rng.normal(size=dst.size).astype(np.float32)
    return (src[order].astype(np.int32), dst[order].astype(np.int64),
            w[order], ns, nd)


CASES = ["random", "empty_blocks", "duplicates", "zero_edges", "hub"]


def _x(case, ns, D, seed=1):
    x = np.random.default_rng(seed).normal(size=(ns, D)).astype(np.float32)
    if case == "inf_row0":
        x[0] = np.inf
    return x


def _mag(src, dst, w, x, rows):
    """sum_e |w_e * x_src(e)| per destination row (the error scale)."""
    m = np.zeros((rows, x.shape[1]), np.float64)
    np.add.at(m, dst, np.abs(w[:, None] * x[src].astype(np.float64)))
    return m


def _close(got, want, mag):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    bad = np.abs(got - want) > ATOL + RTOL * mag
    assert not bad.any(), float(np.abs(got - want).max())


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("W", [8, 16, 24])
@pytest.mark.parametrize("D", [8])
def test_window_matches_probe_apply_window_p1(probe, case, W, D):
    src, dst, w, ns, nd = _case(case)
    x = _x(case, ns, D)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(probe.apply_window(
            probe.build_window_plan(src, dst, w, nd, R=RW, T=TW, W=W),
            jnp.asarray(x)))
    plan = build_segment_plan(src, dst, w, nd, block_rows=RW, chunk_edges=TW,
                              num_src=ns, window=W)
    assert plan.window == (W if src.size else 0)
    got = cs.apply_chunked(plan, torch.as_tensor(x)).numpy()
    _close(got, want, _mag(src, dst, w, x, nd))


def _jax_plan(src, dst, w, nd, ns, **kw):
    return j_pallas.build_pallas_segment_plan(
        src, dst, w, nd, block_rows=R, chunk_edges=T, num_src=ns,
        interpret=True, window=0, **kw)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("D", [8])
def test_i16_matches_probe_apply_i16_p2(probe, case, D):
    src, dst, w, ns, nd = _case(case)
    x = _x(case, ns, D)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(probe.apply_i16(_jax_plan(src, dst, w, nd, ns),
                                          jnp.asarray(x)))
    plan = build_segment_plan(src, dst, w, nd, block_rows=R, chunk_edges=T,
                              num_src=ns, window=0)
    got = cs.apply_chunked(plan, torch.as_tensor(x), torch.int16).numpy()
    _close(got, want, _mag(src, dst, w, x, nd))
    # int16 and int32 local ids give the same plain result
    assert np.array_equal(got, cs.apply_chunked(plan, torch.as_tensor(x))
                          .numpy())


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("D", [8])
def test_padded_matches_pallas_padded_p3(case, D):
    src, dst, w, ns, nd = _case(case)
    jplan = _jax_plan(src, dst, w, nd, ns)
    lay = PadLayout(ns, -(-ns // R) * R)
    x = _x(case, ns, D)
    x_pad = lay.to_padded(torch.as_tensor(x))
    want = np.asarray(j_pallas.apply_pallas_padded(jplan, jnp.asarray(
        x_pad.numpy())))
    plan = build_segment_plan(src, dst, w, nd, block_rows=R, chunk_edges=T,
                              num_src=ns, window=0)
    got = cs.apply_chunked_padded(plan, x_pad).numpy()
    assert got.shape == (plan.num_blocks * R, D)
    mag = np.zeros((plan.num_blocks * R, D))
    mag[:nd] = _mag(src, dst, w, x, nd)
    _close(got, want, mag)
    assert not got[nd:].any()           # the block space's pad rows are zero


def test_padded_chain_matches_jax(small_graph):
    """K=3 Gauss-Seidel chain in the padded block space, as the probe's
    ``prop_padded`` runs it, against the same chain through JAX."""
    g = small_graph
    u, i = np.asarray(g.train_edges[0]), np.asarray(g.train_edges[1])
    w = np.random.default_rng(2).random(u.size).astype(np.float32)
    D = 8
    plans, jplans = [], []
    for src, dst, ns, nd in ((u, i, g.num_users, g.num_items),
                             (i, u, g.num_items, g.num_users)):
        o = np.argsort(dst, kind="stable")
        args = (src[o].astype(np.int32), dst[o].astype(np.int64), w[o], nd)
        plans.append(build_segment_plan(*args, block_rows=R, chunk_edges=T,
                                        num_src=ns, window=0))
        jplans.append(_jax_plan(*args, ns))
    lay_u = PadLayout(g.num_users, plans[1].num_blocks * R)
    lay_i = PadLayout(g.num_items, plans[0].num_blocks * R)
    rng = np.random.default_rng(3)
    u0 = rng.normal(size=(g.num_users, D)).astype(np.float32)
    i0 = rng.normal(size=(g.num_items, D)).astype(np.float32)

    def chain(apply_iu, apply_ui, uu, ii):
        acc_u, acc_i = uu, ii
        for _ in range(3):
            ii = apply_iu(uu)
            uu = apply_ui(ii)
            acc_u, acc_i = acc_u + uu, acc_i + ii
        return acc_u / 4, acc_i / 4

    got_u, got_i = chain(lambda v: cs.apply_chunked_padded(plans[0], v),
                         lambda v: cs.apply_chunked_padded(plans[1], v),
                         lay_u.to_padded(torch.as_tensor(u0)),
                         lay_i.to_padded(torch.as_tensor(i0)))
    want_u, want_i = chain(lambda v: j_pallas.apply_pallas_padded(jplans[0], v),
                           lambda v: j_pallas.apply_pallas_padded(jplans[1], v),
                           jnp.asarray(lay_u.to_padded(torch.as_tensor(u0))
                                       .numpy()),
                           jnp.asarray(lay_i.to_padded(torch.as_tensor(i0))
                                       .numpy()))
    for got, want, lay in ((got_u, want_u, lay_u), (got_i, want_i, lay_i)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
        assert not got[lay.rows:].any()


@pytest.mark.parametrize("case", CASES + ["inf_row0"])
@pytest.mark.parametrize("layout", ["block", "i16", "win8", "win24"])
def test_plain_matches_csr_plain(case, layout):
    src, dst, w, ns, nd = _case(case)
    x = _x(case, ns, 16)
    W = int(layout[3:]) if layout.startswith("win") else 0
    plan = build_segment_plan(src, dst, w, nd, block_rows=RW if W else R,
                              chunk_edges=TW if W else T, num_src=ns,
                              window=W)
    lid = torch.int16 if layout == "i16" else torch.int32
    y = cs.chunk_spmm_blocks(plan, torch.as_tensor(x), lid)
    d = CsrDirection.from_edges(src, dst, w, ns, nd, "cpu")
    want = segment_spmm_reference(d.indptr, d.src, d.w, torch.as_tensor(x))
    assert torch.isfinite(y).all()      # pad edges never read row 0 (inf)
    _close(y[:nd].numpy(), want.numpy(), _mag(src, dst, w, x, nd))
    assert not y[nd:].any()
    empty = np.bincount(dst, minlength=nd) == 0
    assert not y[:nd][torch.as_tensor(empty)].any()


def test_hub_row_sums_runs_then_chunk_partials_in_order():
    """The plain version's order, bit for bit: each chunk's run of the hub
    row summed in edge order from 0, then the partials in chunk order."""
    src, dst, w, ns, nd = _case("hub")
    x = _x("hub", ns, 8)
    plan = build_segment_plan(src, dst, w, nd, block_rows=R, chunk_edges=T,
                              num_src=ns, window=0)
    y = cs.chunk_spmm_blocks(plan, torch.as_tensor(x)).numpy()
    hub = 3
    lid = plan.local_ids.numpy().reshape(-1, T)
    blk = plan.block_id.numpy()
    chunks = np.nonzero((blk == hub // R) & (lid == hub % R).any(1))[0]
    assert chunks.size >= 20                     # a hub across many chunks
    total = np.zeros(8, np.float32)
    for g in chunks:
        part = np.zeros(8, np.float32)
        for e in np.nonzero(lid[g] == hub % R)[0]:
            k = g * T + e
            part = part + np.float32(plan.w_padded[k]) * x[plan.src_padded[k]]
        total = total + part
    assert np.array_equal(y[hub], total)


def test_cpu_tensors_take_the_plain_version():
    src, dst, w, ns, nd = _case("random")
    plan = build_segment_plan(src, dst, w, nd, block_rows=R, chunk_edges=T,
                              num_src=ns, window=0)
    wplan = build_segment_plan(src, dst, w, nd, block_rows=RW,
                               chunk_edges=TW, num_src=ns, window=8)
    x = torch.randn(ns, 8)
    before = [k.launches for k in chunk_spmm_cuda.KERNELS]
    y = cs.chunk_spmm_blocks(plan, x)
    assert [k.launches for k in chunk_spmm_cuda.KERNELS] == before
    assert torch.equal(y, cs.chunk_spmm_reference(plan, x))
    assert torch.equal(cs.apply_chunked(plan, x), y[:nd])
    assert torch.equal(cs.chunk_spmm_blocks(plan, x, backend="torch"), y)
    with pytest.raises(ValueError, match="backend"):
        cs.chunk_spmm_blocks(plan, x, backend="pallas")
    with pytest.raises(ValueError, match="fp32"):
        cs.chunk_spmm_blocks(plan, x.double())
    with pytest.raises(ValueError, match="int32 local ids"):
        cs.chunk_spmm_blocks(wplan, x, torch.int16)
    with pytest.raises(ValueError, match="int32 or int16"):
        cs.chunk_spmm_blocks(plan, x, torch.int64)
    for k in chunk_spmm_cuda.KERNELS:          # no kernel for the CPU
        with pytest.raises(ValueError, match="CUDA"):
            k(wplan if k.window else plan, x)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["block", "i16", "win8"])
@pytest.mark.parametrize("case", ["hub", "empty_blocks", "inf_row0"])
def test_kernel_matches_plain_on_card(layout, case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py phase 9 runs this "
                    "comparison at full size)")
    src, dst, w, ns, nd = _case(case)
    W = 8 if layout == "win8" else 0
    plan = build_segment_plan(src, dst, w, nd, block_rows=RW if W else R,
                              chunk_edges=TW if W else T, num_src=ns,
                              window=W, device="cuda")
    lid = torch.int16 if layout == "i16" else torch.int32
    x = torch.as_tensor(_x(case, ns, 64), device="cuda")
    y1 = cs.chunk_spmm_blocks(plan, x, lid)
    y2 = cs.chunk_spmm_blocks(plan, x, lid)
    assert torch.equal(y1, y2)
    cpu = build_segment_plan(src, dst, w, nd, block_rows=RW if W else R,
                             chunk_edges=TW if W else T, num_src=ns, window=W)
    assert torch.equal(y1.cpu(), cs.chunk_spmm_reference(cpu, x.cpu()))
