"""Row gather from a small slab: ``out[i] = x[idx[i]]`` (probe kernel P4).

:func:`row_gather_reference` is the plain version (``index_select``; a copy,
so kernel and plain version agree bit for bit).  :func:`row_gather` takes it
for a CPU tensor or ``backend="torch"``; for a CUDA tensor under
``backend="auto"`` it launches ``ops/row_gather_cuda.KERNEL`` (the L2 route
unless ``route="smem"`` asks for the shared-memory one, in clusters of
``cluster`` CTAs) or raises.  ``idx``
must lie in ``[0, S)``: the plain version raises otherwise, the kernel does
not check.
"""

from __future__ import annotations

import torch

from .row_gather_cuda import DEFAULT_CLUSTER, KERNEL


def row_gather_reference(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device)."""
    return x.index_select(0, idx)


def row_gather(x: torch.Tensor, idx: torch.Tensor, backend: str = "auto",
               route: str = "l2", cluster: int = DEFAULT_CLUSTER) -> torch.Tensor:
    """``(len(idx), D)`` rows of the ``(S, D)`` fp32 slab ``x``."""
    if backend not in ("auto", "torch"):
        raise ValueError(f"unknown row_gather backend {backend!r}")
    if backend == "torch" or x.device.type == "cpu":
        return row_gather_reference(x, idx)
    return KERNEL(x, idx, route, cluster)
