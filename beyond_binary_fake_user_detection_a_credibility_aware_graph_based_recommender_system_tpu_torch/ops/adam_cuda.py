"""The fused Adam kernel: build, bind, launch, plain version.

One pass over an fp32 parameter leaf ``p`` with its gradient ``g`` and Adam
moments ``m`` and ``v``, updating ``p``, ``m`` and ``v`` in place::

    m2 = B1*m + (1-B1)*g;  v2 = B2*v + (1-B2)*g*g;  p -= a*m2 / (sqrt(v2)*b + EPS)

with the bias corrections folded into ``a = lr/(1-B1^t)`` and
``b = 1/sqrt(1-B2^t)`` (``ops/adam.py``).  The CUDA source is
``csrc/fused_adam.cu``; it replaces the Pallas kernel behind
``pallas_adam_leaf`` (``scripts/probe_fused_adam.py:60-86``) and says there
what bounds it on an H100 (bytes) and what its design does about that.
:data:`KERNEL` counts its launches.

:func:`fused_adam_reference` is the plain PyTorch version, one correctly
rounded op at a time, as the kernel computes it (no FMA): the two agree bit
for bit.
:func:`fused_adam` takes it for CPU tensors and for ``backend="torch"``; for
a CUDA tensor under ``"auto"`` it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .cuda_build import CSRC, CudaKernel

SOURCE = CSRC / "fused_adam.cu"
# optax.adam's defaults; the kernel holds the same values as fp32 constants
B1, B2, EPS = 0.9, 0.999, 1e-8
OMB1 = float(np.float32(1.0 - B1))   # 0.1f, as JAX rounds the Python double
OMB2 = float(np.float32(1.0 - B2))   # 0.001f


def fused_adam_reference(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                         v: torch.Tensor, a: float, b: float) -> None:
    """Plain PyTorch version of the kernel (in place, any device).

    The square root is taken in fp64 and rounded to fp32: that is the
    correctly rounded fp32 square root (``__fsqrt_rn``; rounding twice is
    exact for sqrt), whereas the CPU's vectorized fp32 ``sqrt`` may be off
    by an ulp, differently from call to call."""
    m.mul_(B1).add_(OMB1 * g)
    v.mul_(B2).add_(OMB2 * g * g)
    p.sub_(a * m / (v.double().sqrt().float() * b + EPS))


class FusedAdamKernel(CudaKernel):
    """The compiled kernel and its launch counter (``launches``)."""

    def __init__(self):
        super().__init__(SOURCE, "fused_adam",
                         [ctypes.c_void_p] * 4
                         + [ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
                            ctypes.c_void_p])

    def __call__(self, p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                 v: torch.Tensor, a: float, b: float) -> None:
        dev = p.device
        if dev.type != "cuda":
            raise ValueError(f"fused_adam kernel needs CUDA tensors, got {dev}")
        for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
            if t.device != dev or t.dtype != torch.float32 \
                    or t.shape != p.shape or not t.is_contiguous():
                raise ValueError(
                    f"{name} must be a contiguous fp32 tensor of shape "
                    f"{tuple(p.shape)} on {dev}; got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")
        if p.numel() == 0:
            return
        with torch.cuda.device(dev):
            self._launch(p.data_ptr(), g.data_ptr(), m.data_ptr(),
                         v.data_ptr(), p.numel(), float(a), float(b),
                         torch.cuda.current_stream(dev).cuda_stream)


KERNEL = FusedAdamKernel()


def fused_adam(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
               v: torch.Tensor, a: float, b: float,
               backend: str = "auto") -> None:
    """Kernel for a CUDA tensor under ``"auto"``; plain version for a CPU
    tensor or ``backend="torch"``."""
    if backend not in ("auto", "torch"):
        raise ValueError(f"unknown adam backend {backend!r}")
    if backend == "torch" or p.device.type == "cpu":
        fused_adam_reference(p, g, m, v, a, b)
    else:
        KERNEL(p, g, m, v, a, b)
