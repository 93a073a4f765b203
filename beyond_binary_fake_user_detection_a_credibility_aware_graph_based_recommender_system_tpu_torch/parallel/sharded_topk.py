"""Distributed full-catalogue top-k retrieval over the model axis.

The port of ``JAX: parallel/sharded_topk.py``.  The item table is cut into
P contiguous row blocks, one a model rank.  Each rank scores the user batch
against its block (a plain ``torch.matmul``, as the JAX package leaves it
to XLA), sets excluded and pad columns to ``-inf`` before its local top-k,
demotes non-finite survivors to the out-of-range id ``num_items``, and the
(B, P*k) candidates are gathered over the model group and merged by an
exact fp32 top-k.  Communication is O(B*k*P) instead of O(B*I).

``method="approx"`` ranks exactly (``torch.topk``; the TPU's
``approx_max_k`` has no counterpart here, as on one device).
``score_dtype="bf16"`` scores each block on bf16 tables with fp32 sums
(``eval/retrieval.score_product``: the product the TPU kept) and ranks and
merges in fp32; JAX's mesh path rounds each block score to bf16.  Every
rank of the group returns the same result.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..eval.retrieval import SCORE_DTYPES, score_product
from .mesh import model_axis, pad_rows, padded_row_count, row_shard
from .sharded_spmm import _all_gather_into, _need_group


class ShardedTopK:
    """Row-sharded dot-product retrieval over a device mesh."""

    def __init__(self, mesh, num_items: int):
        self.axis = model_axis(mesh)
        self.num_items = num_items
        self.n_dev = self.axis.size
        self.padded_items = padded_row_count(num_items, self.n_dev)
        self.rows_per = self.padded_items // self.n_dev

    def pad_items(self, item_emb: torch.Tensor) -> torch.Tensor:
        """The item table padded with zero rows to a shardable row count
        (pad columns score ``-inf`` at query time)."""
        return pad_rows(item_emb, self.n_dev)

    def topk(self, user_emb_batch: torch.Tensor,
             item_emb_padded: torch.Tensor, k: int,
             exclude: Optional[torch.Tensor] = None,
             method: str = "exact", score_dtype: str = "fp32"
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(values (B,k) fp32, item ids (B,k)).

        ``exclude``: optional (B, Pmax) per-user item ids to exclude (pad
        with num_items); ``method``: "exact" | "approx" (both exact here);
        ``score_dtype``: "fp32" | "bf16" (the block's tables; scores are
        fp32 either way).
        """
        if method not in ("exact", "approx"):
            raise ValueError(f"unknown top-k method {method!r}")
        if score_dtype not in SCORE_DTYPES:
            raise ValueError(f"unknown score dtype {score_dtype!r}")
        if item_emb_padded.shape[0] != self.padded_items:
            raise ValueError(f"item table has {item_emb_padded.shape[0]} "
                             f"rows, expected {self.padded_items} (pad_items)")
        _need_group(self.axis)
        rows_per = self.rows_per
        base = self.axis.coord * rows_per
        u = user_emb_batch
        items = row_shard(item_emb_padded, self.axis)
        scores = score_product(u, items, score_dtype)          # (B, rows_per)
        B = scores.shape[0]
        gids = base + torch.arange(rows_per, device=scores.device)
        real = min(max(self.num_items - base, 0), rows_per)
        if real < rows_per:                  # pad columns of the last block
            scores[:, real:] = float("-inf")
        if exclude is not None:
            # mask BEFORE the local top-k: a user whose seen items fill one
            # block must not crowd out valid candidates
            loc = exclude.to(torch.int64) - base
            keep = (loc >= 0) & (loc < rows_per)
            rows = torch.arange(B, device=scores.device)[:, None]
            scores[rows.expand_as(loc)[keep], loc[keep]] = float("-inf")
        k_local = min(k, rows_per)
        loc_v, loc_i = torch.topk(scores, k_local, dim=1)
        # pad or excluded survivors (-inf) become the out-of-range sentinel
        # so they never count downstream
        loc_g = torch.where(torch.isfinite(loc_v), gids[loc_i],
                            torch.full_like(loc_i, self.num_items))
        P = self.n_dev
        all_v = loc_v.new_empty((P * B, k_local))
        all_g = loc_g.new_empty((P * B, k_local))
        _all_gather_into(all_v, loc_v.contiguous(), self.axis.group)
        _all_gather_into(all_g, loc_g.contiguous(), self.axis.group)
        # (P, B, k_local) -> (B, P * k_local), shard-major as JAX's tiled
        # all_gather along axis 1
        all_v = all_v.view(P, B, k_local).permute(1, 0, 2).reshape(B, -1)
        all_g = all_g.view(P, B, k_local).permute(1, 0, 2).reshape(B, -1)
        v, idx = torch.topk(all_v, min(k, all_v.shape[1]), dim=1)
        return v, torch.gather(all_g, 1, idx)
