"""The edge-chunked SpMM: plain version and wrappers.

``y[d] = sum_{e: dst[e]=d} w[e] * x[src[e]]`` over a
:class:`~.segment_plan.SegmentPlan`, returning the plan's
``(num_blocks*R, D)`` fp32 block space (``JAX: ops/spmm_pallas.py``
``_apply_padded_blocks``; the probe kernels ``apply_window``, ``apply_i16``
and ``apply_nopad_trunc``).

:func:`chunk_spmm_reference` fixes the summation order that the CUDA kernels
(``ops/chunk_spmm_cuda.py``) follow: within a chunk each row's run of edges
is summed in edge order from 0, and a row's chunk partials are summed in
chunk order from 0.  Two ordered ``index_add_`` passes give exactly that on
the CPU.  Pad edges are dropped, never multiplied by their zero weight.  A
bf16 table follows the Pallas kernel's ``msg_dtype="bfloat16"``: the
weights are rounded to bf16 too (``onehot.astype(msg.dtype)``,
``JAX: ops/spmm_pallas.py:423``), each product is taken in fp32 and the
sums are fp32.

The wrappers take the kernel for a CUDA tensor under ``backend="auto"`` (or
raise) and the plain version for a CPU tensor or ``backend="torch"``:

* :func:`chunk_spmm_blocks` returns the raw block space, or writes it into
  ``out`` (a row range of a larger block space: the slices of one
  direction, ``ops/spmm.py``);
* :func:`apply_chunked` truncates it to ``num_dst`` rows (``apply_pallas``);
* :func:`apply_chunked_padded` keeps the block space, for a chain whose
  source table is padded to the block grid (``apply_pallas_padded``).
"""

from __future__ import annotations

from typing import Optional

import torch

from .chunk_spmm_cuda import KERNEL_BLOCK, KERNEL_I16, KERNEL_WINDOW
from .segment_plan import SegmentPlan


def chunk_spmm_reference(plan: SegmentPlan, x: torch.Tensor,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernels (same order, any device)."""
    R, T = plan.block_rows, plan.chunk_edges
    lid = plan.local_ids.long()
    e = torch.nonzero(lid < (plan.window or R)).squeeze(1)
    g = e // T
    row = plan.block_id.long()[g] * R + lid[e]
    if plan.window:
        row += plan.win_start.long()[g]
    w = plan.w_padded[e]
    if x.dtype == torch.bfloat16:
        w = w.to(torch.bfloat16).float()
    msg = w[:, None] * x.index_select(0, plan.src_padded[e].long()).float()
    new = torch.ones(e.numel(), dtype=torch.bool, device=x.device)
    new[1:] = (g[1:] != g[:-1]) | (row[1:] != row[:-1])
    run = torch.cumsum(new, 0) - 1
    part = torch.zeros(int(new.sum()), x.shape[1], dtype=torch.float32,
                       device=x.device).index_add_(0, run, msg)
    if out is None:
        out = torch.empty(plan.num_blocks * R, x.shape[1],
                          dtype=torch.float32, device=x.device)
    return out.zero_().index_add_(0, row[new], part)


def _kernel(plan: SegmentPlan, lid_dtype: torch.dtype,
            x_dtype: torch.dtype = torch.float32):
    """The kernel for this plan, id width and table type; raises on a
    combination no kernel runs, on every device alike."""
    if lid_dtype not in (torch.int32, torch.int16):
        raise ValueError(f"local ids are int32 or int16, not {lid_dtype}")
    if x_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be fp32 or bf16, got {x_dtype}")
    if lid_dtype == torch.int16 and x_dtype != torch.float32:
        raise ValueError("int16 local ids run with an fp32 table")
    if plan.window:
        if lid_dtype != torch.int32:
            raise ValueError("window plans run with int32 local ids")
        return KERNEL_WINDOW
    if lid_dtype == torch.int16:
        if plan.block_rows > torch.iinfo(torch.int16).max:
            raise ValueError(f"int16 local ids need R <= 32767, got "
                             f"{plan.block_rows}")
        return KERNEL_I16
    return KERNEL_BLOCK


def chunk_spmm_blocks(plan: SegmentPlan, x: torch.Tensor,
                      lid_dtype: torch.dtype = torch.int32,
                      backend: str = "auto",
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The raw ``(num_blocks*R, D)`` fp32 block space of an fp32 or bf16
    table, written into ``out`` when it is given.  ``lid_dtype`` int16
    reads a 2-byte local-id stream (P2; full-block plans, fp32 tables)."""
    if backend not in ("auto", "torch"):
        raise ValueError(f"unknown chunk spmm backend {backend!r}")
    kernel = _kernel(plan, lid_dtype, x.dtype)
    if backend == "torch" or x.device.type == "cpu":
        return chunk_spmm_reference(plan, x, out)
    return kernel(plan, x, out)


def apply_chunked(plan: SegmentPlan, x: torch.Tensor,
                  lid_dtype: torch.dtype = torch.int32,
                  backend: str = "auto") -> torch.Tensor:
    """The first ``num_dst`` rows of the block space."""
    return chunk_spmm_blocks(plan, x, lid_dtype, backend)[:plan.num_dst]


def apply_chunked_padded(plan: SegmentPlan, x_pad: torch.Tensor,
                         lid_dtype: torch.dtype = torch.int32,
                         backend: str = "auto") -> torch.Tensor:
    """Padded-chain form: ``x_pad`` is a source table padded at its tail to
    the block grid; the result stays in the block space with zero pad rows.
    Truncate once per chain with ``y[:num_dst]``."""
    return chunk_spmm_blocks(plan, x_pad, lid_dtype, backend)
