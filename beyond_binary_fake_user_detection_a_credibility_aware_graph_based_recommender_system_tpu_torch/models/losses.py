"""Losses of both stages (``JAX: models/losses.py``).

Stage B:
  * BPR        -log(sigmoid(pos - neg) + 1e-12), mean       lightgcn.py:333-340
  * ego L2     mean over batch of ||e^0_u||^2+||e^0_p||^2+||e^0_n||^2
                                                            lightgcn.py:341-348
  * fairness   Eq 3.27 minibatch form: mean(pop_norm[pos] * y_hat_pos)
                                                            lightgcn_cu.py:639-641

Stage A:
  * masked BCE on labeled users                             main.py:945-951
  * smoothness sum_e w_e ||h_u - h_i||^2 (mean over edges)  main.py:894-907
  * temporal-contrastive InfoNCE, tau=0.2                   main.py:653-658

Every loss takes a validity mask, so fixed-shape padded batches reproduce
the reference's variable-length final batch exactly (masked mean).  Stage
B's take ``count`` too: the mask count of the whole batch when ``mask`` is
one data replica's columns of it (``parallel/sharding.py``), so the replicas'
shares sum to the masked mean over the whole batch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.gather import GatherPlan, gather_rows


Count = Optional[torch.Tensor]


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor],
                 count: Count = None) -> torch.Tensor:
    """The masked sum of ``x`` over ``count`` (default: ``mask``'s own
    count, or the plain mean without a mask), at least 1."""
    if count is None:
        if mask is None:
            return x.mean()
        count = mask.to(x.dtype).sum()
    if mask is not None:
        x = x * mask.to(x.dtype)
    return x.sum() / count.to(x.dtype).clamp(min=1.0)


def bpr_loss(pos_scores: torch.Tensor, neg_scores: torch.Tensor,
             mask: Optional[torch.Tensor] = None,
             count: Count = None) -> torch.Tensor:
    return _masked_mean(
        -torch.log(torch.sigmoid(pos_scores - neg_scores) + 1e-12), mask,
        count)


def ego_l2(ego_u: torch.Tensor, ego_p: torch.Tensor, ego_n: torch.Tensor,
           mask: Optional[torch.Tensor] = None,
           count: Count = None) -> torch.Tensor:
    """Mean over batch of summed squared ego-embedding norms
    (lightgcn.py:341-348 — layer-0 embeddings only, NOT propagated ones)."""
    reg = ((ego_u ** 2).sum(-1) + (ego_p ** 2).sum(-1)
           + (ego_n ** 2).sum(-1))
    return _masked_mean(reg, mask, count)


def fairness_loss(pop_norm_pos: torch.Tensor, pos_scores: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  count: Count = None) -> torch.Tensor:
    """Eq 3.27 over observed positives (lightgcn_cu.py:639-641);
    pop_norm = deg_i / max(deg) (lightgcn_cu.py:583-584)."""
    return _masked_mean(pop_norm_pos * pos_scores, mask, count)


# ---------------------------------------------------------------------------
# Stage A
# ---------------------------------------------------------------------------

def masked_bce(pred: torch.Tensor, labels: torch.Tensor,
               label_mask: torch.Tensor) -> torch.Tensor:
    """BCE over labeled users only; 0 if none labeled (main.py:945-951).
    ``pred`` are probabilities in (0,1) (post-sigmoid, as in the reference)."""
    p = pred.clamp(1e-7, 1.0 - 1e-7)
    per = -(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p))
    m = label_mask.to(pred.dtype)
    denom = m.sum()
    return torch.where(denom > 0, (per * m).sum() / denom.clamp(min=1.0),
                       0.0)


def smoothness_loss(h_src: torch.Tensor, h_dst: torch.Tensor,
                    src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                    min_w: float = 0.0,
                    plans: Optional[Tuple[GatherPlan, GatherPlan]] = None,
                    backend: str = "auto") -> torch.Tensor:
    """mean_e w_e ||h_src[src_e] - h_dst[dst_e]||^2 over edges with w>min_w
    (main.py:894-907).  ``plans`` (of ``src`` and ``dst``) give the two
    gathers the segment-sum backward of ``ops/gather.py``; without them
    they are the plain ``h[idx]``."""
    p_src, p_dst = plans or (None, None)
    diff = (gather_rows(h_src, src, p_src, backend)
            - gather_rows(h_dst, dst, p_dst, backend))
    sq = (diff * diff).sum(-1)
    keep = (w > min_w).to(sq.dtype)
    denom = keep.sum()
    return torch.where(denom > 0,
                       (w * sq * keep).sum() / denom.clamp(min=1.0), 0.0)


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """``x / (||x|| + eps)`` with the norm as the square root of the sum of
    squares: its gradient at an all-zero row is NaN, as ``jnp.linalg.norm``'s
    is (``torch.linalg.norm`` defines one there)."""
    return x / (torch.sqrt((x * x).sum(-1, keepdim=True)) + eps)


def info_nce(z1: torch.Tensor, z2: torch.Tensor, tau: float = 0.2,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Temporal-contrastive InfoNCE between two views (main.py:653-658):
    cross-entropy of the cosine-similarity logits against the diagonal.

    ``mask`` marks valid rows of a fixed-shape padded batch: masked slots
    are excluded both as anchors and as negatives, reproducing the
    reference's exact ragged-batch semantics.  A masked slot's diagonal is
    ``-inf``; the mean over valid anchors selects them out (``where``)
    rather than multiplying the ``-inf`` by 0, which is NaN.  That is the
    value the JAX package's jitted trainer computes; its eager formula gives
    NaN on a padded batch."""
    z1 = _l2_normalize(z1)
    z2 = _l2_normalize(z2)
    logits = (z1 @ z2.T) / tau
    if mask is not None:
        logits = torch.where(mask[None, :], logits, float("-inf"))
    diag = torch.log_softmax(logits, dim=-1).diagonal()
    if mask is None:
        return -diag.mean()
    return -(torch.where(mask, diag, 0.0).sum()
             / mask.to(diag.dtype).sum().clamp(min=1.0))
