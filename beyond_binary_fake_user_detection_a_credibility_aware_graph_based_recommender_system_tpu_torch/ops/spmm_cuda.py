"""The weighted segment-sum SpMM kernel: build, bind, launch, plain version.

``y[d] = sum_{e in row d} w[e] * x[src[e]]`` over a destination-sorted CSR
(``indptr``, ``src``, ``w``).  The CUDA source is ``csrc/segment_spmm.cu``; it
replaces the JAX package's Pallas kernels ``_segment_kernel`` and
``_window_kernel`` (``ops/spmm_pallas.py``) and says there what bounds it on
an H100 (bytes) and what its design does about that.

**The summation order.**  A row of at most ``L`` edges (``L`` =
:data:`LONG_ROW_EDGES` unless the caller says otherwise) is summed in edge
order from 0.  A longer row is cut, from its first edge, into pieces of
``L`` edges (the last may be shorter); each piece is summed in edge order
from 0 into an fp32 partial row, and the row is the sum of its partials in
piece order from 0.  :func:`long_row_pieces` builds the piece table once per
CSR on the host; ``ops/spmm.CsrDirection`` keeps it beside the CSR.  The
wrappers take the table with the ``indptr`` it was built from and refuse
any other ``indptr``.

One application (one call of :func:`segment_spmm`, counted once in
:data:`KERNEL`'s ``launches``) is one CUDA launch when no row is long and
two when one is: the row kernel (pieces first, then every row), and the
reduction of the long rows' partials.  The row gathers' backward
(``ops/gather.py``) runs the same kernel through :data:`GATHER_KERNEL`, and
the local sums of the mesh-sharded operator (``parallel/sharded_spmm.py``)
through :data:`SHARDED_KERNEL`; each counts its applications apart from the
operators' (:data:`KERNELS`).

The kernel is compiled with ``nvcc`` for ``sm_90a`` at first use into
``build/torch_kernels/`` and loaded with ``ctypes`` (``ops/cuda_build.py``).

:func:`segment_spmm_reference` is the plain PyTorch version with the same
arithmetic and order as the kernel and as the Pallas kernel's arithmetic:
in bf16 mode the weights are rounded to bf16 too (``onehot.astype(msg.dtype)``,
``spmm_pallas.py:422-424``), products ``bf16(w) * bf16(x)`` are summed in
fp32, and the sum is cast to the output dtype once.  Its two ordered
``index_add_`` passes equal the kernel bit for bit on the CPU.
:func:`segment_spmm` takes it for CPU tensors and for ``backend="torch"``;
for a CUDA tensor under ``"auto"`` it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import cached_property
from typing import Optional

import numpy as np
import torch

from .cuda_build import CSRC, CudaKernel

SOURCE = CSRC / "segment_spmm.cu"
MAX_D = 256          # the widest row the kernel's register tile holds
# Edges per piece of a long row: the fastest of chip_smoke.py phase 5's
# sweep of 32..512 on both reference directions (PERF.md has the times).
LONG_ROW_EDGES = 64


@dataclass(frozen=True)
class LongRowPieces:
    """The rows of the CSR ``indptr`` with more than ``edges_per_piece``
    edges, cut into pieces of ``edges_per_piece`` edges from their first
    edge."""
    edges_per_piece: int
    indptr: torch.Tensor      # the CSR's (num_dst+1,) int64 row pointers
    start: torch.Tensor       # (P,) int64: each piece's first edge
    row: torch.Tensor         # (P,) int32: each piece's row
    rows: torch.Tensor        # (NL,) int32: the long rows, ascending
    first: torch.Tensor       # (NL+1,) int32: each long row's first piece; P last

    def __post_init__(self):
        dev = self.indptr.device
        for name, dt in (("indptr", torch.int64), ("start", torch.int64),
                         ("row", torch.int32), ("rows", torch.int32),
                         ("first", torch.int32)):
            t = getattr(self, name)
            if t.device != dev or t.dtype != dt or t.dim() != 1 \
                    or not t.is_contiguous():
                raise ValueError(f"pieces.{name} must be a contiguous 1-D "
                                 f"{dt} tensor on {dev}; got {t.dtype} "
                                 f"{tuple(t.shape)} on {t.device}")
        if self.row.numel() != self.start.numel() \
                or self.first.numel() != self.rows.numel() + 1:
            raise ValueError("piece table arrays disagree in length")

    @cached_property
    def pointers(self) -> tuple:
        """The four arrays' device addresses, in the kernel's order."""
        return tuple(t.data_ptr() for t in
                     (self.start, self.row, self.rows, self.first))

    @property
    def num_pieces(self) -> int:
        return self.start.numel()

    @property
    def num_long(self) -> int:
        return self.rows.numel()


def long_row_pieces(indptr: torch.Tensor,
                    edges_per_piece: int = LONG_ROW_EDGES) -> LongRowPieces:
    """The piece table of a CSR's ``indptr``, built on the host and placed
    on ``indptr``'s device."""
    L = int(edges_per_piece)
    if L <= 0:
        raise ValueError(f"edges_per_piece must be positive, got {L}")
    device = indptr.device
    ip = indptr.cpu().numpy().astype(np.int64)
    deg = np.diff(ip)
    rows = np.flatnonzero(deg > L)
    n = (deg[rows] + L - 1) // L
    first = np.zeros(rows.size + 1, np.int64)
    np.cumsum(n, out=first[1:])
    row = np.repeat(rows, n)
    k = np.arange(row.size, dtype=np.int64) - np.repeat(first[:-1], n)
    as_t = lambda a, dt: torch.as_tensor(a.astype(dt), device=device)  # noqa: E731
    return LongRowPieces(
        edges_per_piece=L, indptr=indptr,
        start=as_t(ip[row] + k * L, np.int64), row=as_t(row, np.int32),
        rows=as_t(rows, np.int32), first=as_t(first, np.int32))


def _check_pieces(pieces: LongRowPieces, indptr: torch.Tensor) -> None:
    if pieces.indptr is not indptr:
        raise ValueError("the piece table was built from another indptr "
                         "than the one given")


def segment_spmm_reference(indptr: torch.Tensor, src: torch.Tensor,
                           w: torch.Tensor, x: torch.Tensor,
                           out_dtype: Optional[torch.dtype] = None,
                           long_row_edges: int = LONG_ROW_EDGES
                           ) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arithmetic and order, any
    device): short rows by one ordered ``index_add_`` into ``y``, long rows'
    pieces by one into partials, then the partials into ``y`` in piece
    order."""
    L = int(long_row_edges)
    num_dst = indptr.numel() - 1
    E = src.numel()
    dev = x.device
    deg = indptr[1:] - indptr[:-1]
    dst = torch.repeat_interleave(torch.arange(num_dst, device=dev), deg,
                                  output_size=E)
    wk = w.to(x.dtype).float() if x.dtype == torch.bfloat16 else w.float()
    msg = wk[:, None] * x.index_select(0, src.long()).float()
    y = torch.zeros(num_dst, x.shape[1], dtype=torch.float32, device=dev)
    npieces = torch.where(deg > L, (deg + L - 1) // L, 0)
    long_edge = (deg > L)[dst]
    short = ~long_edge
    y.index_add_(0, dst[short], msg[short])
    P = int(npieces.sum())
    if P:
        first = torch.cumsum(npieces, 0) - npieces
        pos = torch.arange(E, device=dev) - indptr[:-1][dst]
        piece = (first[dst] + pos // L)[long_edge]
        part = torch.zeros(P, x.shape[1], dtype=torch.float32, device=dev)
        part.index_add_(0, piece, msg[long_edge])
        piece_row = torch.repeat_interleave(
            torch.arange(num_dst, device=dev), npieces, output_size=P)
        y.index_add_(0, piece_row, part)
    return y.to(out_dtype or x.dtype)


class SegmentSpmmKernel(CudaKernel):
    """The compiled kernel and its launch counter (``launches``: one per
    application)."""

    def __init__(self, name: str = ""):
        super().__init__(SOURCE, "segment_spmm",
                         [ctypes.c_void_p] * 5
                         + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int]
                         + [ctypes.c_void_p] * 5
                         + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                            ctypes.c_void_p], name)

    def __call__(self, indptr: torch.Tensor, src: torch.Tensor,
                 w: torch.Tensor, x: torch.Tensor,
                 out_dtype: Optional[torch.dtype] = None, *,
                 pieces: LongRowPieces) -> torch.Tensor:
        out_dtype = out_dtype or x.dtype
        dev = x.device
        if dev.type != "cuda":
            raise ValueError(f"segment_spmm kernel needs CUDA tensors, got {dev}")
        _check_pieces(pieces, indptr)
        for name, t, dt in (("indptr", indptr, torch.int64),
                            ("src", src, torch.int32), ("w", w, torch.float32)):
            if t.device != dev or t.dtype != dt or t.dim() != 1 \
                    or not t.is_contiguous():
                raise ValueError(f"{name} must be a contiguous 1-D {dt} "
                                 f"tensor on {dev}; got {t.dtype} "
                                 f"{tuple(t.shape)} on {t.device}")
        if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 2 \
                or not x.is_contiguous():
            raise ValueError(f"x must be a contiguous 2-D fp32/bf16 tensor; "
                             f"got {x.dtype} {tuple(x.shape)}")
        if out_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"unsupported output dtype {out_dtype}")
        D = x.shape[1]
        if not 0 < D <= MAX_D:
            raise ValueError(f"row width D={D} outside 1..{MAX_D}")
        E = src.numel()
        if E != w.numel():
            raise ValueError("src and w differ in length")
        num_dst = indptr.numel() - 1
        y = torch.empty(num_dst, D, dtype=out_dtype, device=dev)
        if num_dst == 0:
            return y
        P = pieces.num_pieces
        partial = torch.empty(P, D, dtype=torch.float32, device=dev) \
            if P else None
        args = (indptr.data_ptr(), src.data_ptr(), w.data_ptr(),
                x.data_ptr(), y.data_ptr(), num_dst, D,
                int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
                *pieces.pointers, partial.data_ptr() if P else None, P,
                pieces.num_long, pieces.edges_per_piece,
                torch._C._cuda_getCurrentRawStream(dev.index))
        if dev.index == torch.cuda.current_device():
            self._launch(*args)
        else:
            with torch.cuda.device(dev):
                self._launch(*args)
        return y


KERNEL = SegmentSpmmKernel()
GATHER_KERNEL = SegmentSpmmKernel("gather_backward")
SHARDED_KERNEL = SegmentSpmmKernel("sharded_spmm")
KERNELS = (KERNEL, GATHER_KERNEL, SHARDED_KERNEL)


def segment_spmm(indptr: torch.Tensor, src: torch.Tensor, w: torch.Tensor,
                 x: torch.Tensor, backend: str = "auto",
                 out_dtype: Optional[torch.dtype] = None, *,
                 pieces: LongRowPieces,
                 kernel: SegmentSpmmKernel = KERNEL) -> torch.Tensor:
    """Kernel for a CUDA tensor under ``"auto"`` (launched and counted
    through ``kernel``); plain version for a CPU tensor or
    ``backend="torch"``.  ``pieces`` is the piece table built from this
    ``indptr`` (:func:`long_row_pieces`); both paths cut long rows at its
    ``edges_per_piece``."""
    if backend not in ("auto", "torch"):
        raise ValueError(f"unknown spmm backend {backend!r}")
    if backend == "torch" or x.device.type == "cpu":
        _check_pieces(pieces, indptr)
        return segment_spmm_reference(indptr, src, w, x, out_dtype,
                                      pieces.edges_per_piece)
    return kernel(indptr, src, w, x, out_dtype, pieces=pieces)
