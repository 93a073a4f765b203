"""Weighted sparse matrix-dense matrix products (the propagation operator).

Every propagation variant is "the same kernel, different weights":
``y[d] = sum_{e: dst[e]=d} w[e] * x[src[e]]`` with the per-edge weight
(credibility, symmetric norm, degree damping) fused into the product.

Each direction of an operator is a destination-sorted CSR (``indptr``,
``src``, ``w``) with its table of long-row pieces
(``ops/spmm_cuda.long_row_pieces``: rows of more than ``LONG_ROW_EDGES``
edges cut into pieces of that many edges), built on the host once per
operator, forward and transpose.  ``apply`` and ``transpose_apply`` run
``ops/spmm_cuda.segment_spmm``: the hand-written CUDA kernel for CUDA
tensors, its plain PyTorch version on the CPU or under ``backend="torch"``.
Edges keep their input order within a destination row (stable sort); with
the pieces that fixes each row's summation order (``ops/spmm_cuda.py``).

Both are differentiable in their input through :class:`_SpmmFn`, whose
backward is the same kernel on the other direction: ``dx = A^T @ g``
(``JAX: ops/spmm.py:92-110``), whose own piece table splits its long rows
(the backward of user<-item has the item<-user hub).  The weights are
constants of the operator.  The product itself always runs without
autograd, so no ``index_add_`` of the plain version is ever differentiated.

``backend="chunked"`` runs the JAX package's Pallas layout instead
(``JAX: ops/spmm.py:214-240``, its ``backend="pallas"``): each direction is
cut into destination slices on block-aligned cuts and each slice planned
into edge chunks (``ops/segment_plan.build_sliced_segment_plans``), run by
the staged chunk kernel (``ops/chunk_spmm.py``: ``chunk_spmm_block`` or
``chunk_spmm_window``, one launch a slice, every slice writing its rows of
one block space), its plain version on the CPU.  Such an operator also
offers the padded chain: :meth:`SpmmOperator.apply_padded` maps a source
table padded at its tail to the block grid (:class:`~.segment_plan.
PadLayout`) to the destination's block space, so a K-layer propagation
truncates once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..graph.operators import EdgeMap
from .chunk_spmm import chunk_spmm_blocks
from .segment_plan import (DEFAULT_BLOCK_ROWS, DEFAULT_CHUNK_EDGES, PadLayout,
                           build_sliced_segment_plans)
from .spmm_cuda import LONG_ROW_EDGES, LongRowPieces, long_row_pieces, segment_spmm

_MSG_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


@dataclass(frozen=True)
class CsrDirection:
    """One direction of an operator as a destination-sorted CSR and the
    piece table of its long rows.  ``order`` keeps, on the host, each
    dst-sorted edge's position in the input edge list: the gather plan of
    the destination ids (``ops/gather.plan_from_direction``) is that order
    over the same rows."""
    indptr: torch.Tensor      # (num_dst+1,) int64
    src: torch.Tensor         # (E,) int32, in dst-sorted order
    w: torch.Tensor           # (E,) float32, in dst-sorted order
    num_src: int
    num_dst: int
    pieces: LongRowPieces
    order: Optional[np.ndarray] = None    # (E,) int64, host

    @classmethod
    def from_edges(cls, src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                   num_src: int, num_dst: int, device: torch.device,
                   long_row_edges: int = LONG_ROW_EDGES) -> "CsrDirection":
        order = np.argsort(dst, kind="stable")
        indptr = np.zeros(num_dst + 1, np.int64)
        np.cumsum(np.bincount(np.asarray(dst, np.int64), minlength=num_dst),
                  out=indptr[1:])
        indptr = torch.as_tensor(indptr, device=device)
        return cls(
            indptr=indptr,
            src=torch.as_tensor(np.asarray(src, np.int32)[order], device=device),
            w=torch.as_tensor(np.asarray(w, np.float32)[order], device=device),
            num_src=int(num_src), num_dst=int(num_dst),
            pieces=long_row_pieces(indptr, long_row_edges), order=order)


@dataclass(frozen=True)
class ChunkDirection:
    """One direction as destination-sliced chunk plans (the JAX package's
    tuple of ``PallasSegmentPlan``), read from a table of ``src_rows`` rows
    and giving the first ``out_rows`` rows of its block space: ``num_src``
    and ``num_dst`` (truncating), or both padded to the block grid (the
    padded chain).  The block rows follow the slices one after another."""
    plans: tuple
    src_rows: int
    out_rows: int

    @property
    def block_rows(self) -> int:
        return sum(p.num_blocks * p.block_rows for p in self.plans)

    @classmethod
    def from_edges(cls, src, dst, w, num_src: int, num_dst: int, device,
                   block_rows: int, chunk_edges: int,
                   slices) -> "ChunkDirection":
        order = np.argsort(dst, kind="stable")
        plans = build_sliced_segment_plans(
            np.asarray(src, np.int32)[order], np.asarray(dst)[order],
            np.asarray(w, np.float32)[order], int(num_dst),
            block_rows=block_rows, chunk_edges=chunk_edges,
            num_src=int(num_src), window="auto", slices=slices,
            device=device)
        return cls(plans=plans, src_rows=int(num_src), out_rows=int(num_dst))


class _SpmmFn(torch.autograd.Function):
    """``y = op._run(fwd_dir, x)`` with ``dx = op._run(bwd_dir, g)``."""

    @staticmethod
    def forward(ctx, x, op, fwd_dir, bwd_dir):
        ctx.op, ctx.bwd_dir = op, bwd_dir
        with torch.no_grad():
            return op._run(fwd_dir, x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.op._run(ctx.bwd_dir, grad.contiguous()), None, None, None


class SpmmOperator:
    """A fixed sparse operator ``y = A @ x`` with a fused per-edge weight.

    ``backend``: "auto" (the CSR kernel for CUDA tensors, its plain version
    on the CPU), "torch" (the plain version) or "chunked" (chunk plans of
    ``block_rows`` x ``chunk_edges`` in ``slices`` destination slices, the
    JAX package's "pallas"; ``slices="auto"`` is up to 4).  ``precision``
    selects the message dtype: "fp32" (parity default) or "bf16", where the
    table and the weights are rounded to bf16 and each destination sums in
    fp32, as the JAX package's Pallas kernel does.  The result comes back in
    ``x``'s dtype.  CSR directions cut their long rows at
    :data:`~.spmm_cuda.LONG_ROW_EDGES`.
    """

    def __init__(self, edge_map: EdgeMap, device, backend: str = "auto",
                 precision: str = "fp32",
                 block_rows: int = DEFAULT_BLOCK_ROWS,
                 chunk_edges: int = DEFAULT_CHUNK_EDGES,
                 slices: int | str = "auto"):
        if precision not in _MSG_DTYPES:
            raise ValueError(f"unknown precision {precision!r}")
        if backend not in ("auto", "torch", "chunked"):
            raise ValueError(f"unknown spmm backend {backend!r}")
        self.backend = backend
        self.precision = precision
        self.num_src = edge_map.num_src
        self.num_dst = edge_map.num_dst
        self.num_edges = edge_map.num_edges
        device = torch.device(device)
        self.src_layout = self.dst_layout = None
        if backend != "chunked":
            self.fwd = CsrDirection.from_edges(
                edge_map.src, edge_map.dst, edge_map.w, edge_map.num_src,
                edge_map.num_dst, device)
            self.bwd = CsrDirection.from_edges(
                edge_map.dst, edge_map.src, edge_map.w, edge_map.num_dst,
                edge_map.num_src, device)
            return
        kw = dict(device=device, block_rows=block_rows,
                  chunk_edges=chunk_edges, slices=slices)
        self.fwd = ChunkDirection.from_edges(
            edge_map.src, edge_map.dst, edge_map.w, edge_map.num_src,
            edge_map.num_dst, **kw)
        self.bwd = ChunkDirection.from_edges(
            edge_map.dst, edge_map.src, edge_map.w, edge_map.num_dst,
            edge_map.num_src, **kw)
        # the padded chain's layouts: each side's rows padded at the tail to
        # the block grid of the direction that writes it
        src_pad, dst_pad = self.bwd.block_rows, self.fwd.block_rows
        self.src_layout = PadLayout(self.num_src, src_pad)
        self.dst_layout = PadLayout(self.num_dst, dst_pad)
        self._fwd_padded = ChunkDirection(self.fwd.plans, src_pad, dst_pad)
        self._bwd_padded = ChunkDirection(self.bwd.plans, dst_pad, src_pad)

    @property
    def padded_chain(self) -> bool:
        """True when :meth:`apply_padded` is offered (chunk plans)."""
        return self.backend == "chunked"

    def _run(self, d, x: torch.Tensor) -> torch.Tensor:
        rows = d.src_rows if isinstance(d, ChunkDirection) else d.num_src
        if x.shape[0] != rows:
            raise ValueError(f"x has {x.shape[0]} rows, operator expects "
                             f"{rows}")
        msg = x.to(_MSG_DTYPES[self.precision]).contiguous()
        if isinstance(d, CsrDirection):
            return segment_spmm(d.indptr, d.src, d.w, msg,
                                backend=self.backend, out_dtype=x.dtype,
                                pieces=d.pieces)
        y = torch.empty(d.block_rows, x.shape[1], dtype=torch.float32,
                        device=x.device)
        r = 0
        for p in d.plans:
            n = p.num_blocks * p.block_rows
            chunk_spmm_blocks(p, msg, out=y[r:r + n])
            r += n
        return y[:d.out_rows].to(x.dtype)

    def apply_padded(self, x_pad: torch.Tensor) -> torch.Tensor:
        """Padded-chain form (chunk plans only): ``x_pad`` is a source table
        padded at its tail to ``src_layout.padded_rows``; the result is the
        destination's block space (``dst_layout``), zero pad rows.  Its
        backward applies the transpose plans in padded space; pad-row
        cotangents are never read, since no edge has a pad row as source
        (``JAX: ops/spmm.py:113-137``)."""
        if not self.padded_chain:
            raise ValueError("apply_padded runs chunk plans: construct the "
                             "operator with backend='chunked'")
        return _SpmmFn.apply(x_pad, self, self._fwd_padded, self._bwd_padded)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return _SpmmFn.apply(x, self, self.fwd, self.bwd)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x)

    def transpose_apply(self, y: torch.Tensor) -> torch.Tensor:
        """y -> A^T @ y (the pre-planned backward direction)."""
        return _SpmmFn.apply(y, self, self.bwd, self.fwd)
