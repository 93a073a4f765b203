"""The host side of the staged chunk kernel (P1, P2, P3) of the PyTorch package.

``csrc/chunk_spmm.cu``'s ``chunk_staged_kernel`` reads, per chunk, a row of
``SegmentPlan.chunk_meta()`` (built once per plan from its arrays and
``block_chunk_offsets()``), copies source rows by 16-byte or 4-byte copies as
``ops/chunk_spmm_cuda.x_load`` says, and sums a row that runs across chunks
in parts, one per chunk of its span, counted and added in chunk order by
the CTA that brings the last part.  On the CPU:

* the offsets equal a numpy count of ``block_id``;
* the meta rows equal a loop over the chunks that follows their definition;
* the kernel's order, replayed in numpy from the meta rows (runs in edge
  order from 0, whole rows stored, span parts added in chunk order from 0,
  every other row of a chunk's range zeroed), is bit-equal to the plain
  version ``chunk_spmm_reference`` and writes every block-space row once;
  the meta rows and the replay hold for the int16 local ids of every
  full-block layout too (P2's stream);
* the load path by alignment and width, and the routing of int16 plans to
  P2's entry of the same kernel.

The ``cuda`` cases hold the kernel to the plain version on the card.
"""

import ctypes

import numpy as np
import pytest
import torch

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops import chunk_spmm as cs
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops import chunk_spmm_cuda as csc
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops.segment_plan import build_segment_plan
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.probes import chunk_profile

# (block rows R, chunk edges T, window W): T = 6 takes the threads' plan
# load; T = 12 a bulk load with int32 ids, the threads' with int16 ones
LAYOUTS = {"block": (16, 16, 0), "block_t6": (16, 6, 0),
           "block_t12": (16, 12, 0), "win8": (32, 16, 8),
           "win16": (32, 16, 16)}
# the full-block layouts read through int16 local ids (P2)
I16_LAYOUTS = [f"{k}_i16" for k, (_, _, W) in LAYOUTS.items() if not W]


def _lid_dtype(layout):
    return torch.int16 if layout.endswith("_i16") else torch.int32


def _case(name, seed=0):
    """dst-sorted (src, dst, w, num_src, num_dst)."""
    rng = np.random.default_rng(seed)
    if name == "random":
        ns, nd, E = 37, 100, 300
        src, dst = rng.integers(0, ns, E), rng.integers(0, nd, E)
    elif name == "empty_blocks":
        ns, nd, E = 30, 100, 120
        src, dst = rng.integers(0, ns, E), rng.integers(0, 20, E)
    elif name == "hub":          # one row across many chunks
        ns, nd, E = 80, 70, 700
        src = rng.integers(0, ns, E)
        dst = np.where(rng.random(E) < 0.6, 3, rng.integers(0, nd, E))
    elif name == "inf_row0":
        ns, nd, E = 40, 90, 400
        src, dst = rng.integers(1, ns, E), rng.integers(0, nd, E)
    elif name == "one_row":      # every edge on row 0: one span per block
        ns, nd, E = 20, 40, 500
        src, dst = rng.integers(0, ns, E), np.zeros(E, np.int64)
    else:
        raise ValueError(name)
    order = np.argsort(dst, kind="stable")
    w = rng.normal(size=dst.size).astype(np.float32)
    return (src[order].astype(np.int32), dst[order].astype(np.int64),
            w[order], ns, nd)


CASES = ["random", "empty_blocks", "hub", "inf_row0", "one_row"]


def _plan(case, layout):
    src, dst, w, ns, nd = _case(case)
    R, T, W = LAYOUTS[layout.removesuffix("_i16")]
    return build_segment_plan(src, dst, w, nd, block_rows=R, chunk_edges=T,
                              num_src=ns, window=W), ns


def _runs(plan, lid_dtype=torch.int32):
    """Per chunk: its (row, first edge, end edge) runs, in edge order, from
    the local ids the kernel reads."""
    R, T, W = plan.block_rows, plan.chunk_edges, plan.window
    lid = plan.local_ids_as(lid_dtype).numpy().reshape(-1, T)
    base = plan.block_id.numpy().astype(np.int64) * R
    if W:
        base = base + plan.win_start.numpy()
    out = []
    for g in range(plan.num_chunks):
        n = int((lid[g] < (W or R)).sum())
        starts = [e for e in range(n) if e == 0 or lid[g, e] != lid[g, e - 1]]
        out.append([(int(base[g] + lid[g, s]), s, e) for s, e in
                    zip(starts, starts[1:] + [n])])
    return out, base


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("case", CASES)
def test_block_chunk_offsets_equal_numpy_count(case, layout):
    plan, _ = _plan(case, layout)
    bid = plan.block_id.numpy()
    want = np.zeros(plan.num_blocks + 1, np.int64)
    want[1:] = np.cumsum(np.bincount(bid, minlength=plan.num_blocks))
    off = plan.block_chunk_offsets()
    assert off.dtype == torch.int32 and off.device == plan.device
    assert np.array_equal(off.numpy(), want)
    assert plan.block_chunk_offsets() is off        # built once


@pytest.mark.parametrize("layout", list(LAYOUTS) + I16_LAYOUTS)
@pytest.mark.parametrize("case", CASES)
def test_chunk_meta_follows_its_definition(case, layout):
    plan, _ = _plan(case, layout)
    R, G = plan.block_rows, plan.num_chunks
    runs, base = _runs(plan, _lid_dtype(layout))
    bid = plan.block_id.numpy()
    first = plan.first_chunk.numpy().astype(bool)
    last = np.append(bid[1:] != bid[:-1], True)
    want = np.zeros((G, 8), np.int64)
    for g in range(G):
        hi = bid[g] * R + R if last[g] else runs[g + 1][0][0]
        cont_in = not first[g] and runs[g][0][0] == runs[g - 1][-1][0]
        cont_out = not last[g] and runs[g][-1][0] == runs[g + 1][0][0]
        opens = cont_out and not (len(runs[g]) == 1 and cont_in)
        want[g, :4] = (bid[g], base[g], hi,
                       first[g] | last[g] << 1 | cont_in << 2 | opens << 3)
        if opens:       # the span runs on while its row is a chunk's only run
            c = g + 1
            while len(runs[c]) == 1 and not last[c] \
                    and runs[c][0][0] == runs[c + 1][0][0]:
                c += 1
            want[g, 6] = c - g + 1
            want[g + 1:c + 1, 4] = g
            want[g + 1:c + 1, 5] = c - g + 1
        if not cont_in:
            want[g, 4] = -1
    meta = plan.chunk_meta()
    assert meta.dtype == torch.int32 and meta.is_contiguous()
    assert np.array_equal(meta.numpy(), want)
    assert plan.chunk_meta() is meta


def _replay(plan, x, lid_dtype=torch.int32):
    """The staged kernel's writes, chunk by chunk in a shuffled order (CTAs
    run in no order), from the meta rows; also counts each row's writes."""
    R, T, W = plan.block_rows, plan.chunk_edges, plan.window
    meta = plan.chunk_meta().numpy()
    src = plan.src_padded.numpy().reshape(-1, T)
    w = plan.w_padded.numpy().reshape(-1, T)
    runs, _ = _runs(plan, lid_dtype)
    y = np.full((plan.num_blocks * R, x.shape[1]), np.nan, np.float32)
    writes = np.zeros(plan.num_blocks * R, np.int64)
    part = np.zeros((2 * plan.num_chunks, x.shape[1]), np.float32)
    count = np.zeros(plan.num_chunks, np.int64)
    order = np.random.default_rng(3).permutation(plan.num_chunks)
    for g in order:
        b, base, hi, flags, ga, la, lo_len, _ = (int(v) for v in meta[g])
        first, cont_in, opens = flags & 1, flags >> 2 & 1, flags >> 3 & 1
        rows = [r for r, _, _ in runs[g]]
        lo = b * R if first else rows[0]
        for r in range(lo, hi):                 # the chunk's zero rows
            if r not in rows:
                y[r] = 0
                writes[r] += 1
        for k, (row, s, e) in enumerate(runs[g]):
            acc = np.zeros(x.shape[1], np.float32)
            for j in range(s, e):
                acc = acc + w[g, j] * x[src[g, j]]
            if k == 0 and cont_in:
                part[2 * g] = acc
            elif k == len(rows) - 1 and opens:
                part[2 * g + 1] = acc
            else:
                y[row] = acc
                writes[row] += 1
        for on, start, n, k in ((cont_in, ga, la, 0),
                                (opens, g, lo_len, -1)):
            if on:
                row = rows[k]
                count[start] += 1
                if count[start] == n:           # the last part: sum the row
                    acc = np.zeros(x.shape[1], np.float32)
                    for i in range(n):
                        acc = acc + part[2 * start + 1 if i == 0
                                         else 2 * (start + i)]
                    y[row] = acc
                    writes[row] += 1
    return y, writes


@pytest.mark.parametrize("layout", list(LAYOUTS) + I16_LAYOUTS)
@pytest.mark.parametrize("case", CASES)
def test_span_replay_is_bit_equal_to_plain(case, layout):
    plan, ns = _plan(case, layout)
    x = np.random.default_rng(1).normal(size=(ns, 3)).astype(np.float32)
    if case == "inf_row0":
        x[0] = np.inf
    y, writes = _replay(plan, x, _lid_dtype(layout))
    assert (writes == 1).all()                  # every row written once
    want = cs.chunk_spmm_reference(plan, torch.as_tensor(x)).numpy()
    assert np.array_equal(y, want)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("D", [8, 63, 64, 100, 256])
def test_x_load_by_alignment_and_width(D, offset):
    """16-byte copies need x 16-byte aligned and D a multiple of 4: a table
    offset by one row is aligned exactly when D is; one float off never."""
    buf = torch.zeros((6 + offset) * D)
    assert buf.data_ptr() % 16 == 0
    x = buf[offset * D:(offset + 5) * D].view(5, D)
    assert csc.x_load(x) == ("vec" if D % 4 == 0 else "scalar")
    assert csc.x_load(buf[1:1 + 5 * D].view(5, D)) == "scalar"


def test_int16_plans_take_the_staged_kernel():
    plan, _ = _plan("hub", "block")
    wplan, _ = _plan("hub", "win8")
    assert cs._kernel(plan, torch.int16) is csc.KERNEL_I16
    assert csc.KERNEL_I16.lid_dtype == torch.int16
    assert cs._kernel(plan, torch.int32) is csc.KERNEL_BLOCK
    assert cs._kernel(wplan, torch.int32) is csc.KERNEL_WINDOW
    with pytest.raises(ValueError, match="int32 local ids"):
        cs._kernel(wplan, torch.int16)
    # the staged entries' signature: src, w, lid, meta, x, y, carry_val,
    # counter, then G, T, R, [W], D, vec, bf16, device, then the stream;
    # P2's is P3's
    ptr, i = ctypes.c_void_p, ctypes.c_int
    assert csc.KERNEL_BLOCK.argtypes == [ptr] * 8 + [i] * 7 + [ptr]
    assert csc.KERNEL_WINDOW.argtypes == [ptr] * 8 + [i] * 8 + [ptr]
    assert csc.KERNEL_I16.argtypes == csc.KERNEL_BLOCK.argtypes
    assert csc.KERNEL_I16.source == csc.KERNEL_BLOCK.source


@pytest.mark.parametrize("variant", list(chunk_profile.ABLATIONS))
def test_profile_probe_writes_each_variant(variant):
    """Every probe point and ablation of ``probes/chunk_profile.py`` is found
    in the kernel source (the card builds and runs them)."""
    text = chunk_profile.probed_source(variant).read_text()
    assert text.count("PHASE(") == 1 + len(chunk_profile.PHASES)
    assert text.count("gtime()") == 3
    assert ("D < 0" in text) == (variant in ("no_zero", "no_gather", "no_sum"))


def test_profile_probe_needs_the_card():
    with pytest.raises(RuntimeError, match="needs the card"):
        chunk_profile.run("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            chunk_profile.main([])


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py phase 9 runs these "
                    "cases at full size)")


def _check_on_card(plan_args, D, x_offset=0, lid=torch.int32):
    src, dst, w, ns, nd, R, T, W = plan_args
    plan = build_segment_plan(src, dst, w, nd, block_rows=R, chunk_edges=T,
                              num_src=ns, window=W, device="cuda")
    cpu = build_segment_plan(src, dst, w, nd, block_rows=R, chunk_edges=T,
                             num_src=ns, window=W)
    buf = torch.randn((ns + x_offset) * D, device="cuda")
    x = buf[x_offset * D:].view(ns, D)
    kernel = cs._kernel(plan, lid)
    launches = kernel.launches
    y1 = cs.chunk_spmm_blocks(plan, x, lid)
    y2 = cs.chunk_spmm_blocks(plan, x, lid)
    torch.cuda.synchronize()
    assert kernel.launches == launches + 2
    assert torch.equal(y1, y2)
    assert torch.equal(y1.cpu(), cs.chunk_spmm_reference(cpu, x.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [32, 256, 1024])
@pytest.mark.parametrize("D", [8, 63, 64, 100, 128, 256])
def test_staged_kernel_matches_plain_on_card(D, T):
    _card()
    rng = np.random.default_rng(D + T)
    E = 20_000
    src, dst = rng.integers(0, 3_000, E), np.sort(rng.integers(0, 5_000, E))
    w = rng.normal(size=E).astype(np.float32)
    _check_on_card((src.astype(np.int32), dst, w, 3_000, 5_000, 512, T, 0), D)
    _check_on_card((src.astype(np.int32), dst, w, 3_000, 5_000, 512, T, 0),
                   D, x_offset=1)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [30, 36, 256])
@pytest.mark.parametrize("D", [8, 63, 64, 256])
def test_staged_i16_kernel_matches_plain_on_card(D, T):
    """P2: T = 36 is a bulk plan load with int32 ids and the threads' with
    int16 ones; T = 30 the threads' with either."""
    _card()
    rng = np.random.default_rng(D + T)
    E = 20_000
    src, dst = rng.integers(0, 3_000, E), np.sort(rng.integers(0, 5_000, E))
    w = rng.normal(size=E).astype(np.float32)
    args = (src.astype(np.int32), dst, w, 3_000, 5_000, 64 if T < 256 else 512,
            T, 0)
    _check_on_card(args, D, lid=torch.int16)
    _check_on_card(args, D, x_offset=1, lid=torch.int16)


@pytest.mark.cuda
def test_staged_kernel_hub_block_on_card():
    """A block whose 80+ chunks hold one row: a span of 80+ parts, with
    int32 and int16 local ids."""
    _card()
    rng = np.random.default_rng(5)
    E = 30_000
    src = rng.integers(0, 4_000, E).astype(np.int32)
    dst = np.sort(np.where(rng.random(E) < 0.8, 100, rng.integers(0, 2_000, E)))
    plan = build_segment_plan(src, dst, np.ones(E, np.float32), 2_000,
                              num_src=4_000, window=0)
    assert int(torch.bincount(plan.block_id).max()) > 80
    w = rng.normal(size=E).astype(np.float32)
    for lid in (torch.int32, torch.int16):
        _check_on_card((src, dst, w, 4_000, 2_000, 512, 256, 0), 64, lid=lid)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [8, 64])
def test_staged_window_kernel_on_card(W):
    _card()
    rng = np.random.default_rng(W)
    E = 20_000
    src = rng.integers(0, 3_000, E).astype(np.int32)
    dst = np.sort(rng.integers(0, 5_000, E))
    _check_on_card((src, dst, rng.normal(size=E).astype(np.float32), 3_000,
                    5_000, 512, 256, W), 64)
