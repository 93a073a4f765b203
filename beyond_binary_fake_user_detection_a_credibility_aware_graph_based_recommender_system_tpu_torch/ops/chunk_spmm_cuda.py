"""The edge-chunked SpMM kernels: build, bind, launch.

``csrc/chunk_spmm.cu`` holds one kernel in three instantiations, each with
its own C entry and launch counter:

* :data:`KERNEL_BLOCK` (``chunk_spmm_block``): full-block chunks, int32
  local ids; replaces the Pallas probe kernel P3 (``apply_nopad_trunc``,
  ``scripts/probe_kernel_grid.py:128``) and the window probe's "base";
* :data:`KERNEL_WINDOW` (``chunk_spmm_window``): window chunks at
  ``win_start``; replaces P1 (``apply_window``,
  ``scripts/probe_window_kernel.py:127``);
* :data:`KERNEL_I16` (``chunk_spmm_i16``): full-block chunks reading int16
  local ids; replaces P2 (``apply_i16``,
  ``scripts/probe_window_kernel.py:182``).

Each returns the raw ``(num_blocks*R, D)`` fp32 block space of a
:class:`~.segment_plan.SegmentPlan`.  The plain version and the wrappers
that choose between it and these kernels are in ``ops/chunk_spmm.py``.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CSRC, CudaKernel
from .segment_plan import SegmentPlan

SOURCE = CSRC / "chunk_spmm.cu"
MAX_D = 256          # the widest row the kernel's register tile holds
MAX_T = 1024         # the most chunk edges one CTA's run masks cover


class ChunkSpmmKernel(CudaKernel):
    """One instantiation of the chunked kernel and its launch counter."""

    def __init__(self, symbol: str, window: bool, lid_dtype: torch.dtype):
        ints = [ctypes.c_int] * (5 if window else 4)
        super().__init__(SOURCE, symbol,
                         [ctypes.c_void_p] * (10 if window else 9) + ints
                         + [ctypes.c_void_p])
        self.window = window
        self.lid_dtype = lid_dtype

    def __call__(self, plan: SegmentPlan, x: torch.Tensor) -> torch.Tensor:
        dev = x.device
        if dev.type != "cuda":
            raise ValueError(f"{self.symbol} kernel needs CUDA tensors, "
                             f"got {dev}")
        if plan.device != dev:
            raise ValueError(f"plan on {plan.device}, x on {dev}")
        if bool(plan.window) != self.window:
            raise ValueError(f"{self.symbol} runs "
                             f"{'window' if self.window else 'full-block'} "
                             f"plans; this plan has window={plan.window}")
        if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
            raise ValueError(f"x must be a contiguous 2-D fp32 tensor; got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.shape[0] < plan.num_src:
            raise ValueError(f"x has {x.shape[0]} rows, the plan reads "
                             f"{plan.num_src}")
        D = x.shape[1]
        if not 0 < D <= MAX_D:
            raise ValueError(f"row width D={D} outside 1..{MAX_D}")
        R, T, G = plan.block_rows, plan.chunk_edges, plan.num_chunks
        if not 0 < T <= MAX_T:
            raise ValueError(f"chunk_edges T={T} outside 1..{MAX_T}")
        if plan.num_blocks * R >= 2 ** 31:
            raise ValueError("block space too large for int32 row ids")
        lid = plan.local_ids_as(self.lid_dtype)
        y = torch.empty(plan.num_blocks * R, D, dtype=torch.float32,
                        device=dev)
        carry_val = torch.empty(2 * G, D, dtype=torch.float32, device=dev)
        carry_row = torch.empty(2 * G, dtype=torch.int32, device=dev)
        ptrs = [plan.src_padded.data_ptr(), plan.w_padded.data_ptr(),
                lid.data_ptr(), plan.block_id.data_ptr(),
                plan.first_chunk.data_ptr()]
        ints = [G, T, R]
        if self.window:
            ptrs.append(plan.win_start.data_ptr())
            ints.append(plan.window)
        with torch.cuda.device(dev):
            self._launch(*ptrs, x.data_ptr(), y.data_ptr(),
                         carry_val.data_ptr(), carry_row.data_ptr(), *ints,
                         D, torch.cuda.current_stream(dev).cuda_stream)
        return y


KERNEL_BLOCK = ChunkSpmmKernel("chunk_spmm_block", False, torch.int32)
KERNEL_WINDOW = ChunkSpmmKernel("chunk_spmm_window", True, torch.int32)
KERNEL_I16 = ChunkSpmmKernel("chunk_spmm_i16", False, torch.int16)
KERNELS = (KERNEL_BLOCK, KERNEL_WINDOW, KERNEL_I16)
