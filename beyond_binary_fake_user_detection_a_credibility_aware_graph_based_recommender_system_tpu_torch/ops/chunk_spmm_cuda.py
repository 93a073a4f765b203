"""The edge-chunked SpMM kernels: build, bind, launch.

``csrc/chunk_spmm.cu`` has three entries, each with its own launch
counter:

* :data:`KERNEL_BLOCK` (``chunk_spmm_block``): full-block chunks, int32
  local ids; replaces the Pallas probe kernel P3 (``apply_nopad_trunc``,
  ``scripts/probe_kernel_grid.py:128``) and the window probe's "base";
* :data:`KERNEL_WINDOW` (``chunk_spmm_window``): window chunks at
  ``win_start``; replaces P1 (``apply_window``,
  ``scripts/probe_window_kernel.py:127``);
* :data:`KERNEL_I16` (``chunk_spmm_i16``): full-block chunks reading int16
  local ids; replaces P2 (``apply_i16``,
  ``scripts/probe_window_kernel.py:182``).

Each is one launch of ``chunk_staged_kernel`` per application (templated
on the window and the id type): a persistent grid, each chunk's source
rows staged in shared memory, and a row that runs across chunks summed
from its parts in the same launch by the CTA that brings the last part (an
integer counter per such row, from the plan's ``chunk_meta()``; no float
atomics).

Each returns the raw ``(num_blocks*R, D)`` fp32 block space of a
:class:`~.segment_plan.SegmentPlan`, into a new tensor or into ``out``.
:data:`KERNEL_BLOCK` and :data:`KERNEL_WINDOW` take an fp32 or a bf16 table
(bf16 messages, the weights rounded to bf16, fp32 sums: the Pallas
kernel's ``msg_dtype="bfloat16"``); :data:`KERNEL_I16` an fp32 one.  The plain version and the wrappers
that choose between it and these kernels are in ``ops/chunk_spmm.py``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .cuda_build import CSRC, CudaKernel
from .segment_plan import SegmentPlan

SOURCE = CSRC / "chunk_spmm.cu"
MAX_D = 256          # the widest row the kernels take
MAX_T = 1024         # the most chunk edges one CTA's run masks cover


def x_load(x: torch.Tensor) -> str:
    """How the staged kernel copies source rows of ``x`` into shared
    memory: ``"vec"`` (copies of 4 columns, which need D a multiple of 4
    and ``x`` aligned to 4 values: 16 bytes in fp32, 8 in bf16) or
    ``"scalar"`` (one value at a time, any table)."""
    aligned = (x.data_ptr() % (4 * x.element_size()) == 0
               and x.shape[1] % 4 == 0)
    return "vec" if aligned else "scalar"


class ChunkSpmmKernel(CudaKernel):
    """One entry of the staged chunk kernel and its launch counter."""

    def __init__(self, symbol: str, window: bool, lid_dtype: torch.dtype):
        # src, w, lid, meta, x, y, carry_val, counter; G, T, R, [W], D, vec,
        # bf16, device; stream
        argtypes = ([ctypes.c_void_p] * 8
                    + [ctypes.c_int] * (8 if window else 7)
                    + [ctypes.c_void_p])
        super().__init__(SOURCE, symbol, argtypes)
        self.window = window
        self.lid_dtype = lid_dtype

    def _check(self, plan: SegmentPlan, x: torch.Tensor,
               out: Optional[torch.Tensor]) -> None:
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
        dtypes = ((torch.float32,) if self.lid_dtype == torch.int16
                  else (torch.float32, torch.bfloat16))
        if x.dtype not in dtypes or x.dim() != 2 or not x.is_contiguous():
            raise ValueError(f"{self.symbol} takes a contiguous 2-D "
                             f"{'/'.join(str(d) for d in dtypes)} tensor; "
                             f"got {x.dtype} {tuple(x.shape)}")
        if x.shape[0] < plan.num_src:
            raise ValueError(f"x has {x.shape[0]} rows, the plan reads "
                             f"{plan.num_src}")
        if not 0 < x.shape[1] <= MAX_D:
            raise ValueError(f"row width D={x.shape[1]} outside 1..{MAX_D}")
        if not 0 < plan.chunk_edges <= MAX_T:
            raise ValueError(f"chunk_edges T={plan.chunk_edges} outside "
                             f"1..{MAX_T}")
        if plan.num_blocks * plan.block_rows >= 2 ** 31:
            raise ValueError("block space too large for int32 row ids")
        if out is not None:
            shape = (plan.num_blocks * plan.block_rows, x.shape[1])
            if out.dtype != torch.float32 or tuple(out.shape) != shape \
                    or out.device != dev or not out.is_contiguous() \
                    or out.data_ptr() % 16:
                raise ValueError(f"out must be a contiguous 16-byte aligned "
                                 f"fp32 {shape} tensor on {dev}; got "
                                 f"{out.dtype} {tuple(out.shape)} on "
                                 f"{out.device}")

    def __call__(self, plan: SegmentPlan, x: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The block space of ``plan`` over ``x``, written into ``out``
        (a row range of a larger block space, say) when it is given."""
        self._check(plan, x, out)
        dev = x.device
        D = x.shape[1]
        R, T, G = plan.block_rows, plan.chunk_edges, plan.num_chunks
        lid = plan.local_ids_as(self.lid_dtype)
        y = out if out is not None else torch.empty(
            plan.num_blocks * R, D, dtype=torch.float32, device=dev)
        carry_val = torch.empty(2 * G, D, dtype=torch.float32, device=dev)
        counter = torch.empty(G, dtype=torch.int32, device=dev)
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        ints = [G, T, R] + ([plan.window] if self.window else [])
        self._launch(plan.src_padded.data_ptr(), plan.w_padded.data_ptr(),
                     lid.data_ptr(), plan.chunk_meta().data_ptr(), x.data_ptr(),
                     y.data_ptr(), carry_val.data_ptr(), counter.data_ptr(),
                     *ints, D, int(x_load(x) == "vec"),
                     int(x.dtype == torch.bfloat16), dev.index, stream)
        return y


KERNEL_BLOCK = ChunkSpmmKernel("chunk_spmm_block", False, torch.int32)
KERNEL_WINDOW = ChunkSpmmKernel("chunk_spmm_window", True, torch.int32)
KERNEL_I16 = ChunkSpmmKernel("chunk_spmm_i16", False, torch.int16)
KERNELS = (KERNEL_BLOCK, KERNEL_WINDOW, KERNEL_I16)
