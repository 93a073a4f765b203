"""Ranking metrics, vectorized.

Reference semantics (``metrics_at_k``, reference lightgcn.py:378-394):
  precision@K = hits/K; recall@K = hits/max(|gt|,1);
  ndcg@K = dcg/idcg with dcg = sum over hit positions of 1/log2(pos+2) and
  idcg = sum_{i<min(|gt|,K)} 1/log2(i+2).

Beyond-accuracy metrics (Version-2/lighgcn_cu_pop.py:382-423):
  item coverage, avg log popularity, avg self-information (Laplace-smoothed),
  credibility utility (mean cred of evaluated users), high/low-cred group
  recall over top/bottom ``pct`` by credibility.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch


def idcg_table(k_max: int, device=None) -> torch.Tensor:
    """table[m] = sum_{i<m} 1/log2(i+2), m in [0, k_max]."""
    gains = 1.0 / np.log2(np.arange(k_max) + 2.0)
    return torch.as_tensor(np.concatenate([[0.0], np.cumsum(gains)]),
                           dtype=torch.float32, device=device)


def topk_metrics(hits: torch.Tensor, gt_len: torch.Tensor,
                 Ks: Sequence[int]) -> Dict[int, Dict[str, torch.Tensor]]:
    """Per-user metrics from a (B, Kmax) 0/1 hit matrix and gt sizes.

    Returns {K: {"precision": (B,), "recall": (B,), "ndcg": (B,)}}.
    """
    k_max = hits.shape[1]
    dev = hits.device
    table = idcg_table(k_max, dev)
    pos_gain = 1.0 / torch.log2(torch.arange(k_max, device=dev,
                                             dtype=torch.float32) + 2.0)
    gt_len = gt_len.to(torch.float32)
    out = {}
    for K in Ks:
        h = hits[:, :K].to(torch.float32)
        hit_count = h.sum(dim=1)
        precision = hit_count / float(K)
        recall = hit_count / gt_len.clamp(min=1.0)
        dcg = (h * pos_gain[:K]).sum(dim=1)
        idcg = table[gt_len.to(torch.int64).clamp(max=K)]
        ndcg = torch.where(idcg > 0, dcg / idcg.clamp(min=1e-12),
                           torch.zeros_like(dcg))
        out[K] = {"precision": precision, "recall": recall, "ndcg": ndcg}
    return out


def sampled_rank_metrics(rank_of_pos: torch.Tensor, Ks: Sequence[int]
                         ) -> Dict[int, Dict[str, torch.Tensor]]:
    """Sampled protocol (1 pos + N negs; lightgcn.py:397-456): with gt={pos},
    metrics collapse to functions of the positive's rank.  Stable argsort of
    -scores puts the positive before equal-scored negatives (it is candidate
    0), so rank = #(neg_scores > pos_score)."""
    out = {}
    for K in Ks:
        hit = (rank_of_pos < K).to(torch.float32)
        out[K] = {
            "precision": hit / float(K),
            "recall": hit,
            "ndcg": hit / torch.log2(rank_of_pos.to(torch.float32) + 2.0),
        }
    return out


# ---------------------------------------------------------------------------
# Beyond-accuracy metrics (Version-2)
# ---------------------------------------------------------------------------

def novelty_stats(topk_items: torch.Tensor, item_pop: torch.Tensor,
                  total_train: int, num_items: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-user (avg_log_popularity, avg_self_information) of the top-k list
    (Version-2/lighgcn_cu_pop.py:390-404)."""
    pops = item_pop[topk_items].to(torch.float32)
    avg_log_pop = torch.log(pops + 1.0).mean(dim=-1)
    p = (pops + 1.0) / float(total_train + num_items)  # Laplace smoothing
    avg_self_info = (-torch.log2(p)).mean(dim=-1)
    return avg_log_pop, avg_self_info


def cred_groups(users: np.ndarray, cred: np.ndarray,
                pct: float = 0.20) -> Tuple[np.ndarray, np.ndarray]:
    """(high_users, low_users): top/bottom ``pct`` of the evaluated users by
    credibility (Version-2/lighgcn_cu_pop.py:407-423). Host-side (tiny)."""
    if users.size == 0:
        return (np.array([], np.int64),) * 2
    c = cred[users]
    k = max(int(round(users.size * pct)), 1)
    order = np.argsort(c, kind="stable")
    return users[order[-k:]].astype(np.int64), users[order[:k]].astype(np.int64)


def item_popularity(train_edges: np.ndarray, num_items: int
                    ) -> Tuple[np.ndarray, int]:
    """pop[i] = train-interaction count (Version-2/lighgcn_cu_pop.py:382-387)."""
    pop = np.bincount(train_edges[1].astype(np.int64), minlength=num_items)
    return pop.astype(np.int64), int(pop.sum())
