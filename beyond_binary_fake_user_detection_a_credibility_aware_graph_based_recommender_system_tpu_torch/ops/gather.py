"""Row gathers whose backward is the SpMM kernel: a fixed-order segment-sum.

The backward of ``table[idx]`` (``idx`` of E ids into an (N, H) table) is
``dtable[r] = sum_{e: idx[e] = r} g[e]`` over the (E, H) upstream gradient
``g``: the weighted segment-sum of ``ops/spmm_cuda`` with unit weights, the
gradient as the source table and the edge ids sorted by row (stably) as
``src``.  A *plan* (:data:`GatherPlan`) is that CSR, a
:class:`~.spmm.CsrDirection` with ``num_src = E``, ``num_dst = N`` and
``w = 1``, and its table of long-row pieces.  It depends only on ``idx``, so
it is built once per fixed index vector: :func:`plan_from_direction` reuses
an operator direction's CSR (Stage A's smoothness gathers index the edges'
own endpoints), :func:`gather_plans` builds a batch of plans at once
(Stage B's steps).

This replaces the backward that XLA's scatter-add gives the JAX package's
gathers (``JAX: models/losses.py:76``, ``models/lightgcn.py:267-302``,
``train/trainer.py:254-263``), which ATen ran as its deterministic
sorted ``index_put_``: that sums each row's duplicates one after another, so
a hub row of 60,954 ids took most of a Stage-A step (``PERF.md``).  The
kernel sums a row of at most ``L`` ids in id order and a longer row in
``L``-id pieces added in piece order (``ops/spmm_cuda.py``), so the gradient
is bit-reproducible and equals the plain version's ordered sums.  Every row
of ``dtable`` is written (rows no id reaches as 0): no zero table is
allocated and nothing is scattered.

:func:`gather_rows` is the gather: ``index_select`` forward (a stock op, as
XLA's gather is), the kernel backward through
``spmm_cuda.GATHER_KERNEL`` for CUDA tensors (counted apart from the
operators' applications), the plain version for CPU tensors or
``backend="torch"``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .spmm import CsrDirection
from .spmm_cuda import (GATHER_KERNEL, LONG_ROW_EDGES, LongRowPieces,
                        segment_spmm)

GatherPlan = CsrDirection


def plan_from_direction(d: CsrDirection) -> GatherPlan:
    """The plan of ``table[dst]`` for the destination ids ``dst`` of the
    edges ``d`` was built from (``CsrDirection.from_edges``), in their input
    order: ``d``'s rows and piece table, its stable sort order as ``src``."""
    if d.order is None:
        raise ValueError("the direction keeps no sort order")
    dev = d.indptr.device
    E = d.order.size
    return CsrDirection(
        indptr=d.indptr,
        src=torch.as_tensor(d.order.astype(np.int32), device=dev),
        w=torch.ones(E, dtype=torch.float32, device=dev),
        num_src=E, num_dst=d.num_dst, pieces=d.pieces)


def gather_plans(ids: torch.Tensor, num_rows: int,
                 long_row_edges: int = LONG_ROW_EDGES) -> List[GatherPlan]:
    """The plans of ``table[ids[s]]`` for every row ``s`` of ``ids`` (S, E),
    into a table of ``num_rows`` rows, on ``ids``' device.

    One stable sort, one count and one cumulative sum for all S on the
    device; one copy of the sorted ids to the host, where the long rows
    (runs of more than ``long_row_edges`` equal ids) are found, and one copy
    of all the piece tables back.  The plans share one ones vector and view
    one (S, num_rows+1) row-pointer tensor."""
    if ids.dim() != 2:
        raise ValueError(f"ids must be (S, E); got {tuple(ids.shape)}")
    S, E = ids.shape
    N, L = int(num_rows), int(long_row_edges)
    dev = ids.device
    if S == 0:
        return []
    srt, order = torch.sort(ids, dim=1, stable=True)
    h = srt.cpu().numpy()
    if E and (h[:, 0].min() < 0 or h[:, -1].max() >= N):
        raise ValueError(f"ids outside 0..{N - 1}")
    base = torch.arange(S, device=dev)[:, None] * N
    counts = torch.bincount((ids.long() + base).reshape(-1), minlength=S * N)
    indptr = torch.zeros(S, N + 1, dtype=torch.int64, device=dev)
    indptr[:, 1:] = counts.view(S, N).cumsum(1)
    src = order.to(torch.int32)
    w = torch.ones(E, dtype=torch.float32, device=dev)

    # runs of equal ids in each sorted row; a run longer than L is a long
    # row, cut from its first id into pieces of L ids
    new = np.ones((S, E), bool)
    new[:, 1:] = h[:, 1:] != h[:, :-1]
    run_step, run_start = np.nonzero(new)
    length = np.diff(np.append(run_step * E + run_start, S * E))
    long = length > L
    run_step, run_start, length = run_step[long], run_start[long], length[long]
    run_row = h[run_step, run_start]
    parts, spans = [], []
    for s in range(S):
        m = run_step == s
        n = (length[m] + L - 1) // L
        first = np.zeros(n.size + 1, np.int64)
        np.cumsum(n, out=first[1:])
        k = np.arange(first[-1]) - np.repeat(first[:-1], n)
        step = (np.repeat(run_start[m], n) + k * L,     # piece start
                np.repeat(run_row[m], n), run_row[m], first)
        spans.append([a.size for a in step])
        parts += step
    buf64 = torch.as_tensor(np.concatenate(parts).astype(np.int64), device=dev)
    buf32 = buf64.to(torch.int32)
    plans, at = [], 0
    for s in range(S):
        ip = indptr[s]
        cut = np.cumsum([at] + spans[s])
        at = int(cut[-1])
        pieces = LongRowPieces(
            edges_per_piece=L, indptr=ip, start=buf64[cut[0]:cut[1]],
            row=buf32[cut[1]:cut[2]], rows=buf32[cut[2]:cut[3]],
            first=buf32[cut[3]:cut[4]])
        plans.append(CsrDirection(indptr=ip, src=src[s], w=w, num_src=E,
                                  num_dst=N, pieces=pieces))
    return plans


class _GatherFn(torch.autograd.Function):
    """``table.index_select(0, idx)`` with the plan's segment-sum as its
    backward."""

    @staticmethod
    def forward(ctx, table, idx, plan, backend):
        ctx.plan, ctx.backend, ctx.dtype = plan, backend, table.dtype
        ctx.rows = table.shape[0]
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        p = ctx.plan
        g = segment_spmm(p.indptr, p.src, p.w, grad.contiguous(), ctx.backend,
                         ctx.dtype, pieces=p.pieces, kernel=GATHER_KERNEL)
        return g[:ctx.rows], None, None, None


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                plan: Optional[GatherPlan] = None,
                backend: str = "auto") -> torch.Tensor:
    """``table[idx]`` for a 1-D ``idx``.  With ``plan`` (the plan of this
    ``idx`` into this table's rows, or into more rows: a tail-padded table's
    plan on its exact-row table, whose gradient keeps the leading rows, a
    view) its backward is the segment-sum: the
    kernel for a CUDA gradient under ``"auto"``, which launches or raises,
    the plain version for a CPU one or under ``backend="torch"``; the
    gradient comes back in the table's dtype (a bf16 table's rows are summed
    in fp32 and rounded once).  Without a plan it is the stock ``table[idx]``
    (the reference's form, for callers outside a train step)."""
    if plan is None:
        return table[idx]
    if idx.dim() != 1 or idx.numel() != plan.num_src \
            or table.shape[0] > plan.num_dst:
        raise ValueError(
            f"the plan gathers {plan.num_src} ids from {plan.num_dst} rows; "
            f"got {tuple(idx.shape)} ids from {table.shape[0]} rows")
    return _GatherFn.apply(table, idx, plan, backend)
