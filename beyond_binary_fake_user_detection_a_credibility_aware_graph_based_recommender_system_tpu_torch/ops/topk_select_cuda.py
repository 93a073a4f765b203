"""The exact top-k select kernel: build, bind, launch.

``csrc/topk_select.cu`` selects the k largest scores of every row of a
row-major fp32 matrix in one read of it (a warp select per slice of a row,
then a merge of the slices' candidates), in place of ``torch.topk``'s radix
passes on the single-device ranking path.  It replaces no Pallas kernel: the
JAX package ranks there with XLA's ``lax.top_k``, whose order for equal
scores (the lower id first) it keeps.  :data:`KERNEL` counts its calls in
``launches`` (one a call, for both of its kernels).  The plain version and
the wrapper are in ``ops/topk_select.py``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .cuda_build import CSRC, CudaKernel

SOURCE = CSRC / "topk_select.cu"
MAX_K = 256
MAX_COLS = 2 ** 31 - 1           # ids and the grid's CTAs fit an int
# the chunk rule: at most one wave of CTAs (the card's SMs, CTAS_PER_SM of
# the kernel's CTAs an SM), each slice at least MIN_SLICE scores.  Every
# slice fills its own queues before its threshold filters, so a second wave
# costs more than it balances: on an H100 (132 SMs) one slice a row beat
# 2-6 at 512 x 1M and 1,024 x 262,728, two beat one at 256 x 262,728.
CTAS_PER_SM = 4                  # the kernel's launch bound, kMinBlocks
MIN_SLICE = 65536


def chunks_for(rows: int, cols: int, sms: int) -> int:
    """How many slices each row is cut into, from the shape and the card's
    SM count alone."""
    return max(1, min(sms * CTAS_PER_SM // max(rows, 1), cols // MIN_SLICE))


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def shape_error(scores: torch.Tensor, k: int) -> Optional[str]:
    """Why the kernel does not take ``scores`` and ``k``, or None."""
    if scores.dtype != torch.float32:
        return f"scores must be fp32, got {scores.dtype}"
    if scores.dim() != 2 or not scores.is_contiguous():
        return (f"scores must be a 2-D row-major contiguous tensor; got "
                f"shape {tuple(scores.shape)}, strides {scores.stride()}")
    rows, cols = scores.shape
    if not 1 <= k <= MAX_K:
        return f"k = {k} is outside the kernel's 1..{MAX_K}"
    if k > cols:
        return f"k = {k} is more than the {cols} columns"
    if cols > MAX_COLS:
        return f"{cols} columns: the kernel takes fewer than 2**31"
    if rows > MAX_COLS:          # more than one slice a row only below a wave
        return f"{rows} rows: more CTAs than a grid holds"
    return None


class TopkSelectKernel(CudaKernel):
    """The compiled kernel pair and its call counter (``launches``)."""

    def __init__(self):
        super().__init__(SOURCE, "topk_select",
                         [ctypes.c_void_p, ctypes.c_longlong,
                          ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
                         + [ctypes.c_void_p] * 4
                         + [ctypes.c_int, ctypes.c_void_p])

    def __call__(self, scores: torch.Tensor, k: int, count: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor,
                            Optional[torch.Tensor]]:
        """(values (B, k) fp32, ids (B, k) int64, insertions): the last a
        one-element int64 tensor on the card with ``count``, else None."""
        err = shape_error(scores, k)
        if err:
            raise ValueError(err)
        dev = scores.device
        if dev.type != "cuda":
            raise ValueError(f"topk_select kernel needs a CUDA tensor, got "
                             f"{dev}")
        rows, cols = scores.shape
        chunks = chunks_for(rows, cols, sm_count(dev.index))
        values = torch.empty(rows, k, dtype=torch.float32, device=dev)
        ids = torch.empty(rows, k, dtype=torch.int64, device=dev)
        counter = torch.zeros(1, dtype=torch.int64, device=dev) \
            if count else None
        if rows == 0:
            return values, ids, counter
        cand = torch.empty(rows * chunks * k, dtype=torch.int64, device=dev)
        self._launch(scores.data_ptr(), rows, cols, k, chunks,
                     cand.data_ptr(), values.data_ptr(), ids.data_ptr(),
                     counter.data_ptr() if count else None, dev.index,
                     torch._C._cuda_getCurrentRawStream(dev.index))
        return values, ids, counter


KERNEL = TopkSelectKernel()
