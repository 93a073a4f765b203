"""Exact top-k of every row of a score matrix, in ``lax.top_k``'s order.

:func:`topk_select_reference` is the plain version: a stable descending sort
cut to k, so equal scores come back in ascending id (``lax.top_k``'s rule,
and ``ops/sampling.py``'s plain ``gumbel_topk``'s); -0.0 ties +0.0 and NaN
ranks above +inf, as ``torch.sort`` orders them.  :func:`topk_select` takes
it for a CPU tensor; for a CUDA tensor it launches
``ops/topk_select_cuda.KERNEL``, which returns the same ids and the same
value bits, or raises on what the kernel does not take (not fp32, not 2-D
row-major contiguous, k outside 1..256 or above the columns, 2**31 columns or
more).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .topk_select_cuda import KERNEL


def topk_select_reference(scores: torch.Tensor, k: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel (any device)."""
    values, ids = torch.sort(scores, dim=1, descending=True, stable=True)
    return values[:, :k], ids[:, :k]


def topk_select(scores: torch.Tensor, k: int, count: bool = False):
    """(values (B, k), ids (B, k) int64) of the k largest scores of each
    row, in descending order and equal scores in ascending id: the pair
    ``torch.topk(scores, k, dim=1)`` returns, with ``lax.top_k``'s order for
    ties.  ``count=True`` adds a third item, the kernel's thread-queue
    insertions (scores that got past its running threshold) as an int, or
    None for the plain version, which has no threshold."""
    if scores.device.type == "cpu":
        values, ids = topk_select_reference(scores, k)
        return (values, ids, None) if count else (values, ids)
    values, ids, inserted = KERNEL(scores, k, count=count)
    return (values, ids, int(inserted.item())) if count else (values, ids)
