"""The weighted segment-sum SpMM kernel: build, bind, launch, plain version.

``y[d] = sum_{e in row d} w[e] * x[src[e]]`` over a destination-sorted CSR
(``indptr``, ``src``, ``w``).  The CUDA source is ``csrc/segment_spmm.cu``; it
replaces the JAX package's Pallas kernels ``_segment_kernel`` and
``_window_kernel`` (``ops/spmm_pallas.py``) and says there what bounds it on
an H100 (bytes) and what its design does about that.

The kernel is compiled with ``nvcc`` for ``sm_90a`` at first use into
``build/torch_kernels/`` and loaded with ``ctypes`` (``ops/cuda_build.py``).
:data:`KERNEL` counts its launches.

:func:`segment_spmm_reference` is the plain PyTorch version with the same
arithmetic as the Pallas kernel: in bf16 mode the weights are rounded to
bf16 too (``onehot.astype(msg.dtype)``, ``spmm_pallas.py:422-424``), products
``bf16(w) * bf16(x)`` are summed in fp32, and the sum is cast to the output
dtype once.  :func:`segment_spmm` takes it for CPU tensors and for
``backend="torch"``; for a CUDA tensor under ``"auto"`` it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .cuda_build import CSRC, CudaKernel

SOURCE = CSRC / "segment_spmm.cu"
MAX_D = 256          # the widest row the kernel's register tile holds


def segment_spmm_reference(indptr: torch.Tensor, src: torch.Tensor,
                           w: torch.Tensor, x: torch.Tensor,
                           out_dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arithmetic, any device)."""
    num_dst = indptr.numel() - 1
    dst = torch.repeat_interleave(
        torch.arange(num_dst, device=x.device), indptr[1:] - indptr[:-1],
        output_size=src.numel())
    wk = w.to(x.dtype).float() if x.dtype == torch.bfloat16 else w.float()
    msg = wk[:, None] * x.index_select(0, src.long()).float()
    y = torch.zeros(num_dst, x.shape[1], dtype=torch.float32, device=x.device)
    y.index_add_(0, dst, msg)
    return y.to(out_dtype or x.dtype)


class SegmentSpmmKernel(CudaKernel):
    """The compiled kernel and its launch counter (``launches``)."""

    def __init__(self):
        super().__init__(SOURCE, "segment_spmm",
                         [ctypes.c_void_p] * 5
                         + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_void_p])

    def __call__(self, indptr: torch.Tensor, src: torch.Tensor,
                 w: torch.Tensor, x: torch.Tensor,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        out_dtype = out_dtype or x.dtype
        dev = x.device
        if dev.type != "cuda":
            raise ValueError(f"segment_spmm kernel needs CUDA tensors, got {dev}")
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
        if src.numel() != w.numel():
            raise ValueError("src and w differ in length")
        num_dst = indptr.numel() - 1
        y = torch.empty(num_dst, D, dtype=out_dtype, device=dev)
        if num_dst == 0:
            return y
        with torch.cuda.device(dev):
            self._launch(
                indptr.data_ptr(), src.data_ptr(), w.data_ptr(),
                x.data_ptr(), y.data_ptr(), num_dst, D,
                int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
                torch.cuda.current_stream(dev).cuda_stream)
        return y


KERNEL = SegmentSpmmKernel()


def segment_spmm(indptr: torch.Tensor, src: torch.Tensor, w: torch.Tensor,
                 x: torch.Tensor, backend: str = "auto",
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Kernel for a CUDA tensor under ``"auto"``; plain version for a CPU
    tensor or ``backend="torch"``."""
    if backend not in ("auto", "torch"):
        raise ValueError(f"unknown spmm backend {backend!r}")
    if backend == "torch" or x.device.type == "cpu":
        return segment_spmm_reference(indptr, src, w, x, out_dtype)
    return KERNEL(indptr, src, w, x, out_dtype)
