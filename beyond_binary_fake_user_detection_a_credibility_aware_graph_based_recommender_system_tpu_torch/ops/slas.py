"""SLAS: similarity-aware neighbor sampling, on the device.

Reference: ``slas_sample_items_for_user`` / ``slas_sample_users_for_item``
(main.py:758-807), per-user Python loops with
``rng.choice(replace=False, p=exp(kappa*sim))``; the JAX package's
``ops/slas.py``.

For a whole batch at once: gather each node's padded neighbor list,
compute similarity logits against the precomputed profiles, and draw k
neighbors WITHOUT replacement via Gumbel top-k (``ops/sampling.gumbel_topk``)
— the batched equivalent of the reference's weighted choice (exact for the
Plackett-Luce sampling scheme).

Profile construction parity (main.py:709-737):
  * item_feat_norm = L2-normalized item features;
  * user profile mu_u = degree-mean of the user's items' normalized
    features, then L2-normalized;
  * p(item|u) ∝ exp(kappa * <item_feat_norm[i], mu_u>);
  * p(user|i) ∝ exp(kappa * <mu_u, item_feat_norm[i]>) with labeled users
    upweighted ×(1 + slas_upweight_labeled);
  * temporal views filter edges by normalized timestamp (NaN in neither).

The tables are built in numpy on the host, exactly as the JAX package
builds them, and live on the device.  A pad slot holds ``num_items`` (or
``num_users``) and edge id -1; every gather clips pad ids first, where JAX
relies on its clamping of out-of-range gathers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..graph.csr import edges_to_csr
from ..graph.hetero import HeteroGraph
from ..models.cred_model import temporal_edge_mask
from ..utils.config import CredConfig
from .sampling import gumbel_topk


def _l2n(x: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + eps)


def _padded_rows(indptr: np.ndarray, indices: np.ndarray, edge_ids,
                 pad_deg: int, pad_value: int):
    """(N, pad_deg) neighbor table + matching int32 edge-id table (host,
    once), filled by one vectorized gather: the first ``pad_deg`` neighbors
    of each row, ``pad_value`` / -1 beyond its degree."""
    N = indptr.shape[0] - 1
    assert indices.shape[0] < 2 ** 31
    if indices.shape[0] == 0:
        return (np.full((N, pad_deg), pad_value, np.int32),
                np.full((N, pad_deg), -1, np.int32))
    deg = np.diff(indptr)
    offs = np.arange(pad_deg, dtype=np.int64)[None, :]        # (1, P)
    valid = offs < np.minimum(deg, pad_deg)[:, None]          # (N, P)
    flat = np.minimum(indptr[:-1, None] + offs,
                      max(indices.shape[0] - 1, 0))
    out = np.where(valid, indices[flat], pad_value).astype(np.int32)
    if edge_ids is not None:
        eid = np.where(valid, edge_ids[flat], -1).astype(np.int32)
    else:
        eid = np.full((N, pad_deg), -1, np.int32)
    return out, eid


@dataclass(frozen=True)
class SlasSampler:
    item_feat_norm: torch.Tensor  # (I, Fi) fp32
    user_mu: torch.Tensor         # (U, Fi) fp32
    user_labeled: torch.Tensor    # (U,) bool
    u_items: torch.Tensor         # (U, Pu) int32 padded item neighbors
    u_eids: torch.Tensor          # (U, Pu) int32 edge id per slot (-1 pad)
    i_users: torch.Tensor         # (I, Pi) int32 padded user neighbors
    i_eids: torch.Tensor          # (I, Pi) int32
    edge_view_early: torch.Tensor  # (E,) bool
    edge_view_late: torch.Tensor   # (E,) bool
    kappa: float
    upweight_labeled: float

    @classmethod
    def build(cls, hg: HeteroGraph, cfg: Optional[CredConfig] = None,
              pad_deg: Optional[int] = None, device="cpu") -> "SlasSampler":
        """``pad_deg`` (or ``cfg.slas_pad_deg``): candidate-pool width per
        node.  Default None = the graph's max degree — exact reference
        candidate sets (every neighbor is a candidate, main.py:758-807).
        A cap keeps the FIRST ``pad_deg`` CSR neighbors (id order) as the
        Gumbel top-k candidate pool: a documented scale deviation, required
        where the zipf head item's degree makes a max-degree (I, P) table
        larger than the device."""
        cfg = cfg or CredConfig()
        if pad_deg is None:
            pad_deg = cfg.slas_pad_deg
        u = hg.edges[0].astype(np.int64)
        i = hg.edges[1].astype(np.int64)

        item_feat_norm = _l2n(np.nan_to_num(hg.item_x, nan=0.0))
        mu = np.zeros((hg.num_users, item_feat_norm.shape[1]))
        np.add.at(mu, u, item_feat_norm[i])
        deg_u = np.bincount(u, minlength=hg.num_users).astype(np.float64)
        mu = _l2n(mu / np.maximum(deg_u, 1.0)[:, None])

        u_csr = edges_to_csr(u, i, hg.num_users, keep_edge_ids=True)
        i_csr = edges_to_csr(i, u, hg.num_items, keep_edge_ids=True)
        max_deg = int(max(u_csr.degrees().max(initial=1),
                          i_csr.degrees().max(initial=1)))
        P = int(pad_deg or max_deg)

        u_items, u_eids = _padded_rows(u_csr.indptr, u_csr.indices,
                                       u_csr.edge_ids, P, hg.num_items)
        i_users, i_eids = _padded_rows(i_csr.indptr, i_csr.indices,
                                       i_csr.edge_ids, P, hg.num_users)

        def dev(a, dtype=None):
            return torch.as_tensor(a if dtype is None else a.astype(dtype),
                                   device=device)

        return cls(
            item_feat_norm=dev(item_feat_norm, np.float32),
            user_mu=dev(mu, np.float32),
            user_labeled=dev(hg.user_y >= 0),
            u_items=dev(u_items), u_eids=dev(u_eids),
            i_users=dev(i_users), i_eids=dev(i_eids),
            edge_view_early=dev(
                temporal_edge_mask(hg.edge_attr, "early", cfg.temp_split)),
            edge_view_late=dev(
                temporal_edge_mask(hg.edge_attr, "late", cfg.temp_split)),
            kappa=float(cfg.slas_kappa),
            upweight_labeled=float(cfg.slas_upweight_labeled),
        )

    @property
    def num_users(self) -> int:
        return self.user_mu.shape[0]

    @property
    def num_items(self) -> int:
        return self.item_feat_norm.shape[0]

    def _view_mask(self, eids: torch.Tensor, view: Optional[str]
                   ) -> torch.Tensor:
        valid = eids >= 0
        if view is None:
            return valid
        table = self.edge_view_early if view == "early" else self.edge_view_late
        return valid & table[eids.clamp(min=0)]

    def sample_items_for_users(self, gen: Optional[torch.Generator],
                               users: torch.Tensor, k: int,
                               view: Optional[str] = None,
                               uniforms: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, k) item ids + validity mask; p ∝ exp(kappa*sim)
        (main.py:758-784).  ``uniforms`` (B, P) replaces the draw."""
        nbrs = self.u_items[users]                       # (B, P)
        mask = self._view_mask(self.u_eids[users], view)
        feat = self.item_feat_norm[nbrs.clamp(0, self.num_items - 1)]
        sim = torch.einsum("bpf,bf->bp", feat, self.user_mu[users])
        logits = self.kappa * sim
        slot, scores = gumbel_topk(gen, logits, k, mask, uniforms)
        items = torch.gather(nbrs, 1, slot)
        return items, torch.isfinite(scores)

    def sample_users_for_items(self, gen: Optional[torch.Generator],
                               items: torch.Tensor, k: int,
                               uniforms: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, k) user ids + mask; labeled users upweighted
        (main.py:786-807).  ``items`` may hold the pad id ``num_items``
        (an invalid item slot); its row is read clipped, as JAX clamps."""
        it = items.clamp(0, self.num_items - 1)
        nbrs = self.i_users[it]                          # (B, P)
        mask = self._view_mask(self.i_eids[it], None)
        nb = nbrs.clamp(0, self.num_users - 1)
        sim = torch.einsum("bpf,bf->bp", self.user_mu[nb],
                           self.item_feat_norm[it])
        logits = self.kappa * sim
        up = torch.where(self.user_labeled[nb],
                         float(np.log1p(self.upweight_labeled)), 0.0)
        slot, scores = gumbel_topk(gen, logits + up, k, mask, uniforms)
        users = torch.gather(nbrs, 1, slot)
        return users, torch.isfinite(scores)
