"""Stage-B losses (``JAX: models/losses.py:27-53``).

  * BPR        -log(sigmoid(pos - neg) + 1e-12), mean       lightgcn.py:333-340
  * ego L2     mean over batch of ||e^0_u||^2+||e^0_p||^2+||e^0_n||^2
                                                            lightgcn.py:341-348
  * fairness   Eq 3.27 minibatch form: mean(pop_norm[pos] * y_hat_pos)
                                                            lightgcn_cu.py:639-641

Every loss takes a validity mask, so fixed-shape padded batches reproduce
the reference's variable-length final batch exactly (masked mean).  The
Stage-A losses come with Stage A.
"""

from __future__ import annotations

from typing import Optional

import torch


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    if mask is None:
        return x.mean()
    m = mask.to(x.dtype)
    return (x * m).sum() / m.sum().clamp(min=1.0)


def bpr_loss(pos_scores: torch.Tensor, neg_scores: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _masked_mean(
        -torch.log(torch.sigmoid(pos_scores - neg_scores) + 1e-12), mask)


def ego_l2(ego_u: torch.Tensor, ego_p: torch.Tensor, ego_n: torch.Tensor,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over batch of summed squared ego-embedding norms
    (lightgcn.py:341-348 — layer-0 embeddings only, NOT propagated ones)."""
    reg = ((ego_u ** 2).sum(-1) + (ego_p ** 2).sum(-1)
           + (ego_n ** 2).sum(-1))
    return _masked_mean(reg, mask)


def fairness_loss(pop_norm_pos: torch.Tensor, pos_scores: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq 3.27 over observed positives (lightgcn_cu.py:639-641);
    pop_norm = deg_i / max(deg) (lightgcn_cu.py:583-584)."""
    return _masked_mean(pop_norm_pos * pos_scores, mask)
