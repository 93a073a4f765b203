"""The fused Adam kernel: build, bind, launch, plain version.

One pass over fp32 parameter leaves ``p`` with their gradients ``g`` and
Adam moments ``m`` and ``v``, updating ``p``, ``m`` and ``v`` in place::

    m2 = B1*m + (1-B1)*g;  v2 = B2*v + (1-B2)*g*g;  p -= a*m2 / (sqrt(v2)*b + EPS)

with the bias corrections folded into ``a = lr/(1-B1^t)`` and
``b = 1/sqrt(1-B2^t)`` (``ops/adam.py``).  The CUDA source is
``csrc/fused_adam.cu``; it replaces the Pallas kernel behind
``pallas_adam_leaf`` (``scripts/probe_fused_adam.py:60-86``) and says there
what bounds it on an H100 and what its design does about that.  One launch
updates up to :data:`MAX_LEAVES` leaves (a list of ``(p, g, m, v)``
tuples), so a training step's Adam is one launch.  :data:`KERNEL` counts
its launches.

:func:`fused_adam_reference` is the plain PyTorch version of one leaf, one
correctly rounded op at a time, as the kernel computes it (no FMA): the two
agree bit for bit; :func:`fused_adam_leaves_reference` is the plain version
of a list.  :func:`fused_adam_leaves` takes it for CPU tensors and for
``backend="torch"``; for CUDA tensors under ``"auto"`` it launches the
kernel or raises.  :func:`fused_adam` is the one-leaf call.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .cuda_build import CSRC, CudaKernel

SOURCE = CSRC / "fused_adam.cu"
# optax.adam's defaults; the kernel holds the same values as fp32 constants
B1, B2, EPS = 0.9, 0.999, 1e-8
OMB1 = float(np.float32(1.0 - B1))   # 0.1f, as JAX rounds the Python double
OMB2 = float(np.float32(1.0 - B2))   # 0.001f
MAX_LEAVES = 32                      # kMaxLeaves: leaves in one launch

Leaf = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def fused_adam_reference(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                         v: torch.Tensor, a: float, b: float) -> None:
    """Plain PyTorch version of the kernel on one leaf (in place, any
    device).

    The square root is taken in fp64 and rounded to fp32: that is the
    correctly rounded fp32 square root (``__fsqrt_rn``; rounding twice is
    exact for sqrt), whereas the CPU's vectorized fp32 ``sqrt`` may be off
    by an ulp, differently from call to call."""
    m.mul_(B1).add_(OMB1 * g)
    v.mul_(B2).add_(OMB2 * g * g)
    p.sub_(a * m / (v.double().sqrt().float() * b + EPS))


def fused_adam_leaves_reference(leaves: Sequence[Leaf], a: float,
                                b: float) -> None:
    """Plain version of one multi-leaf launch: each leaf in turn."""
    for leaf in leaves:
        fused_adam_reference(*leaf, a, b)


def check_leaves(leaves: Sequence[Leaf]) -> torch.device:
    """Every array of every leaf a contiguous fp32 tensor of its ``p``'s
    shape on one device, which is returned; raises ``ValueError``."""
    if not leaves:
        raise ValueError("no leaves")
    dev = leaves[0][0].device
    for j, leaf in enumerate(leaves):
        if len(leaf) != 4:
            raise ValueError(f"leaf {j} is not a (p, g, m, v) tuple")
        shape = leaf[0].shape
        for name, t in zip("pgmv", leaf):
            if t.device != dev or t.dtype != torch.float32 \
                    or t.shape != shape or not t.is_contiguous():
                raise ValueError(
                    f"leaf {j}: {name} must be a contiguous fp32 tensor of "
                    f"shape {tuple(shape)} on {dev}; got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")
    return dev


class _LeafArg(ctypes.Structure):
    """``LeafArg`` of ``csrc/fused_adam.cu``."""
    _fields_ = [("p", ctypes.c_void_p), ("g", ctypes.c_void_p),
                ("m", ctypes.c_void_p), ("v", ctypes.c_void_p),
                ("n", ctypes.c_longlong)]


class LeafTable:
    """The kernel's argument arrays for one list of leaves, checked once
    when built: one ``ctypes`` array of ``LeafArg``s per launch of at most
    :data:`MAX_LEAVES` leaves (empty leaves left out).  ``p``, ``m`` and
    ``v`` stay where they are between steps (the update is in place), so a
    later step with the same leaves only writes the gradients' pointers
    (:meth:`bind`)."""

    def __init__(self, leaves: Sequence[Leaf]):
        self.device = check_leaves(leaves)
        live = [leaf for leaf in leaves if leaf[0].numel()]
        self.key = self._key(leaves)
        self.groups: List[ctypes.Array] = []
        self._slots = []     # (group, index in group) of each live leaf
        for s in range(0, len(live), MAX_LEAVES):
            part = live[s:s + MAX_LEAVES]
            arr = (_LeafArg * len(part))()
            for i, (p, g, m, v) in enumerate(part):
                arr[i] = _LeafArg(p.data_ptr(), g.data_ptr(), m.data_ptr(),
                                  v.data_ptr(), p.numel())
                self._slots.append((arr, i))
            self.groups.append(arr)
        self._live = [i for i, leaf in enumerate(leaves) if leaf[0].numel()]

    @staticmethod
    def _key(leaves: Sequence[Leaf]) -> tuple:
        return tuple((p.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel())
                     for p, _, m, v in leaves)

    def bind(self, leaves: Sequence[Leaf]) -> bool:
        """Take this step's gradients if ``leaves`` have this table's
        ``p``, ``m`` and ``v`` (same pointers and sizes); ``False``
        otherwise.  Each gradient is checked against its ``p``."""
        if len(leaves) != len(self.key) or self._key(leaves) != self.key:
            return False
        for (arr, i), j in zip(self._slots, self._live):
            p, g = leaves[j][0], leaves[j][1]
            if g.device != self.device or g.dtype != torch.float32 \
                    or g.shape != p.shape or not g.is_contiguous():
                raise ValueError(
                    f"leaf {j}: g must be a contiguous fp32 tensor of shape "
                    f"{tuple(p.shape)} on {self.device}; got {g.dtype} "
                    f"{tuple(g.shape)} on {g.device}")
            arr[i].g = g.data_ptr()
        return True


class FusedAdamKernel(CudaKernel):
    """The compiled kernel and its launch counter (``launches``: one per
    launch, a launch covering up to :data:`MAX_LEAVES` leaves).  The last
    leaf list's :class:`LeafTable` is kept and reused while its leaves
    stay."""

    def __init__(self):
        super().__init__(SOURCE, "fused_adam_multi",
                         [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                          ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
                         name="fused_adam")
        self._table = None

    def table(self, leaves: Sequence[Leaf]) -> LeafTable:
        """The argument table for ``leaves``: the kept one with this step's
        gradients bound, else a new one (checked in full)."""
        if self._table is None or not self._table.bind(leaves):
            self._table = LeafTable(leaves)
        return self._table

    def launch_table(self, table: LeafTable, a: float, b: float,
                     stream: int) -> None:
        """One launch (and one count) per group of the table."""
        for arr in table.groups:
            self._launch(arr, len(arr), a, b, table.device.index or 0,
                         stream)

    def __call__(self, leaves: Sequence[Leaf], a: float, b: float) -> None:
        dev = leaves[0][0].device if leaves else None
        if dev is None or dev.type != "cuda":
            raise ValueError(f"fused_adam kernel needs CUDA tensors, got {dev}")
        table = self.table(leaves)
        self.launch_table(table, float(a), float(b),
                          torch._C._cuda_getCurrentRawStream(dev.index))


KERNEL = FusedAdamKernel()


def fused_adam_leaves(leaves: Sequence[Leaf], a: float, b: float,
                      backend: str = "auto") -> None:
    """Kernel for CUDA tensors under ``"auto"`` (one launch per
    :data:`MAX_LEAVES` leaves); plain version for CPU tensors or
    ``backend="torch"``."""
    if backend not in ("auto", "torch"):
        raise ValueError(f"unknown adam backend {backend!r}")
    if not leaves:
        return
    if backend == "torch" or leaves[0][0].device.type == "cpu":
        check_leaves(leaves)
        fused_adam_leaves_reference(leaves, a, b)
    else:
        KERNEL(leaves, a, b)


def fused_adam(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
               v: torch.Tensor, a: float, b: float,
               backend: str = "auto") -> None:
    """One leaf: :func:`fused_adam_leaves` of a one-entry list."""
    fused_adam_leaves([(p, g, m, v)], a, b, backend)
