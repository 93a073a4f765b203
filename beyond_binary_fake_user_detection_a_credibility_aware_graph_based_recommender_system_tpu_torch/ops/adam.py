"""Adam with optax's defaults, one fused kernel launch over every leaf.

The JAX package trains with ``optax.adam(lr)`` (``train/trainer.py:128``):
b1 0.9, b2 0.999, eps 1e-8, eps_root 0, the step count starting at 0 and
the first update using t = 1.  Here every leaf is updated in place by one
call of ``ops/adam_cuda.fused_adam_leaves`` (one kernel launch a step), with
the bias corrections folded into two fp32 scalars as the probe kernel does
(``scripts/probe_fused_adam.py:91-94``)::

    a = lr / (1 - b1^t),   b = 1 / sqrt(1 - b2^t)
    p -= a * m / (sqrt(v) * b + eps)

which equals optax's ``lr * m_hat / (sqrt(v_hat) + eps)`` in exact
arithmetic and differs from it by rounding only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from .adam_cuda import B1, B2, fused_adam_leaves


@dataclass
class AdamState:
    """Per-leaf first and second moments and the step count."""
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    count: int = 0


def adam_init(params: Dict[str, torch.Tensor]) -> AdamState:
    return AdamState(m={k: torch.zeros_like(p) for k, p in params.items()},
                     v={k: torch.zeros_like(p) for k, p in params.items()})


def adam_scalars(t: int, lr: float) -> Tuple[float, float]:
    """``(a, b)`` of step ``t`` in fp32, the probe's formula."""
    t32 = np.float32(t)
    one = np.float32(1.0)
    a = np.float32(lr) / (one - np.float32(B1) ** t32)
    b = one / np.sqrt(one - np.float32(B2) ** t32)
    return float(np.float32(a)), float(np.float32(b))


def adam_step(params: Dict[str, torch.Tensor],
              grads: Dict[str, torch.Tensor], state: AdamState, lr: float,
              backend: str = "auto") -> None:
    """One Adam update of every leaf, in place (params, ``state.m``,
    ``state.v``), in one call over the leaves in ``params`` order;
    ``state.count`` goes up by one first."""
    state.count += 1
    a, b = adam_scalars(state.count, lr)
    with torch.no_grad():
        fused_adam_leaves([(p, grads[k].contiguous(), state.m[k], state.v[k])
                           for k, p in params.items()], a, b, backend=backend)
