"""The slab row-gather kernel: build, bind, launch.

``csrc/row_gather.cu`` replaces the Pallas probe kernel P4 (``probe.call``,
``scripts/probe_vmem_gather.py:34``).  It has two routes: ``"l2"`` (the
default) reads each source row where it is, through the cache; ``"smem"``
holds the whole slab in each CTA's shared memory, for slabs up to
:data:`SMEM_SLAB_BYTES`, the CTAs running as thread-block clusters of
``cluster`` (one of :data:`CLUSTERS`) that share each slab read by
multicast bulk copies (a slab that is not 16-byte aligned is loaded by each
CTA's threads: :func:`smem_load`).  Both take a persistent grid, float4
rows and streaming stores.  The H100 measured the L2 route faster at every
probe size (``PERF.md``), so only the probe asks for shared memory.
:data:`KERNEL` counts its launches.  The plain version
and the wrapper are in ``ops/row_gather.py``.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CSRC, CudaKernel

SOURCE = CSRC / "row_gather.cu"
SMEM_SLAB_BYTES = 192 * 1024     # S <= 768 at D = 64 fp32
ROUTES = {"smem": 0, "l2": 1}
CLUSTERS = (1, 2, 4, 8)          # CTAs per cluster on the shared-memory route
DEFAULT_CLUSTER = 2


def smem_fits(S: int, D: int) -> bool:
    """Whether an (S, D) fp32 slab fits the shared-memory route."""
    return S * D * 4 <= SMEM_SLAB_BYTES


def smem_load(x: torch.Tensor) -> str:
    """How the shared-memory route brings the slab ``x`` in: ``"bulk"``
    (multicast bulk copies, which need its address and size 16-byte
    aligned) or ``"threads"`` (each CTA's threads, any alignment)."""
    aligned = x.data_ptr() % 16 == 0 and x.numel() * 4 % 16 == 0
    return "bulk" if aligned else "threads"


class RowGatherKernel(CudaKernel):
    """The compiled kernel and its launch counter (``launches``)."""

    def __init__(self):
        super().__init__(SOURCE, "row_gather",
                         [ctypes.c_void_p] * 3
                         + [ctypes.c_longlong] + [ctypes.c_int] * 6
                         + [ctypes.c_void_p])

    def __call__(self, x: torch.Tensor, idx: torch.Tensor, route: str = "l2",
                 cluster: int = DEFAULT_CLUSTER) -> torch.Tensor:
        if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
            raise ValueError(f"x must be a contiguous 2-D fp32 tensor; got "
                             f"{x.dtype} {tuple(x.shape)}")
        if route not in ROUTES:
            raise ValueError(f"unknown row_gather route {route!r}")
        if route == "smem" and not smem_fits(*x.shape):
            raise ValueError(f"a {tuple(x.shape)} fp32 slab does not fit the "
                             f"shared-memory route ({SMEM_SLAB_BYTES} bytes)")
        if cluster not in CLUSTERS:
            raise ValueError(f"cluster {cluster} is not one of {CLUSTERS}")
        dev = x.device
        if dev.type != "cuda":
            raise ValueError(f"row_gather kernel needs CUDA tensors, got {dev}")
        if idx.device != dev or idx.dtype != torch.int32 or idx.dim() != 1 \
                or not idx.is_contiguous():
            raise ValueError(f"idx must be a contiguous 1-D int32 tensor on "
                             f"{dev}; got {idx.dtype} {tuple(idx.shape)} on "
                             f"{idx.device}")
        S, D = x.shape
        out = torch.empty(idx.numel(), D, dtype=torch.float32, device=dev)
        if idx.numel() == 0:
            return out
        self._launch(x.data_ptr(), idx.data_ptr(), out.data_ptr(),
                     idx.numel(), S, D, ROUTES[route], cluster,
                     int(route == "smem" and smem_load(x) == "bulk"), dev.index,
                     torch._C._cuda_getCurrentRawStream(dev.index))
        return out


KERNEL = RowGatherKernel()
