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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..graph.operators import EdgeMap
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

    ``precision`` selects the message dtype: "fp32" (parity default) or
    "bf16", where the table and the weights are rounded to bf16 and each
    destination sums in fp32, as the JAX package's Pallas kernel does.  The
    result comes back in ``x``'s dtype.  Both directions cut their long rows
    at :data:`~.spmm_cuda.LONG_ROW_EDGES`.
    """

    def __init__(self, edge_map: EdgeMap, device, backend: str = "auto",
                 precision: str = "fp32"):
        if precision not in _MSG_DTYPES:
            raise ValueError(f"unknown precision {precision!r}")
        self.backend = backend
        self.precision = precision
        self.num_src = edge_map.num_src
        self.num_dst = edge_map.num_dst
        self.num_edges = edge_map.num_edges
        device = torch.device(device)
        self.fwd = CsrDirection.from_edges(
            edge_map.src, edge_map.dst, edge_map.w, edge_map.num_src,
            edge_map.num_dst, device)
        self.bwd = CsrDirection.from_edges(
            edge_map.dst, edge_map.src, edge_map.w, edge_map.num_dst,
            edge_map.num_src, device)

    def _run(self, d: CsrDirection, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] != d.num_src:
            raise ValueError(f"x has {x.shape[0]} rows, operator expects "
                             f"{d.num_src}")
        msg = x.to(_MSG_DTYPES[self.precision]).contiguous()
        return segment_spmm(d.indptr, d.src, d.w, msg, backend=self.backend,
                            out_dtype=x.dtype, pieces=d.pieces)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return _SpmmFn.apply(x, self, self.fwd, self.bwd)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x)

    def transpose_apply(self, y: torch.Tensor) -> torch.Tensor:
        """y -> A^T @ y (the pre-planned backward direction)."""
        return _SpmmFn.apply(y, self, self.bwd, self.fwd)
