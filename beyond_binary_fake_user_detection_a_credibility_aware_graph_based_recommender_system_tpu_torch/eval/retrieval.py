"""Retrieval / serving API: top-k items for users from trained embeddings.

The production-facing counterpart of the full-catalog evaluator
(reference lightgcn.py:459-509): dense dot-product scoring with optional
seen-item exclusion, on one device or row-sharded over a mesh's model axis
with a distributed top-k merge (``parallel/sharded_topk.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..graph.build import BipartiteGraph
from ..ops.topk_select import topk_select
from ..utils.profiling import span


def exact_fp32_matmul() -> None:
    """Score in full fp32: TF32 keeps about three decimal digits, enough to
    reorder near-tied scores against the reference ranking."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


SCORE_DTYPES = ("fp32", "bf16")


def score_product(user_rows: torch.Tensor, item_emb: torch.Tensor,
                  score_dtype: str = "fp32") -> torch.Tensor:
    """(B, I) fp32 dot-product scores of ``user_rows`` against every item.

    ``score_dtype="bf16"`` rounds both tables to bf16 and sums their
    products in fp32, rounding no score to bf16: the product the JAX
    package's bf16 evaluation kept on the TPU (a bf16 dot with fp32
    accumulation, ``preferred_element_type=float32``).  On the card it is
    one bf16 GEMM with an fp32 output; elsewhere the bf16 tables upcast to
    fp32 (a product of two bf16 values is exact in fp32, so the two differ
    by summation order only)."""
    if score_dtype == "fp32":
        return user_rows @ item_emb.T
    if score_dtype != "bf16":
        raise ValueError(f"unknown score dtype {score_dtype!r}")
    u = user_rows.to(torch.bfloat16)
    items = item_emb.to(torch.bfloat16)
    if u.is_cuda:
        return torch.mm(u, items.T, out_dtype=torch.float32)
    return u.float() @ items.float().T


def build_exclusion_rows(graph: BipartiteGraph, split: str = "train"
                         ) -> np.ndarray:
    """(U, Pmax) per-user seen-item lists padded with num_items.

    O(U*Pmax) memory — evaluation uses :func:`exclusion_rows_for_users` per
    batch instead; this full-table form is a serving convenience for
    repeated small-batch queries over the same table."""
    csr = graph.user_csr(split)
    deg = csr.degrees()
    pmax = max(int(deg.max()) if deg.size else 1, 1)
    if csr.indices.shape[0] == 0:
        return np.full((graph.num_users, pmax), graph.num_items, np.int32)
    offs = np.arange(pmax, dtype=np.int64)[None, :]
    valid = offs < deg[:, None]
    flat = np.minimum(csr.indptr[:-1, None] + offs, csr.indices.shape[0] - 1)
    return np.where(valid, csr.indices[flat],
                    graph.num_items).astype(np.int32)


def exclusion_rows_for_users(graph: BipartiteGraph, users: np.ndarray,
                             split: str = "train") -> np.ndarray:
    """(B, Pb) seen-item rows for ONE user batch, padded with num_items;
    the width is the batch's max degree rounded up to a power of two."""
    with span("rec.rank.exclusions"):
        csr = graph.user_csr(split)
        users = np.asarray(users, np.int64)
        deg = (csr.indptr[users + 1] - csr.indptr[users]).astype(np.int64)
        pmax = int(deg.max()) if deg.size else 1
        pb = 1 << max(int(np.ceil(np.log2(max(pmax, 1)))), 0)
        if csr.indices.shape[0] == 0:
            return np.full((users.shape[0], pb), graph.num_items, np.int32)
        offs = np.arange(pb, dtype=np.int64)[None, :]
        valid = offs < deg[:, None]
        flat = np.minimum(csr.indptr[users][:, None] + offs,
                          csr.indices.shape[0] - 1)
        return np.where(valid, csr.indices[flat],
                        graph.num_items).astype(np.int32)


def mask_excluded(scores: torch.Tensor, excl: torch.Tensor,
                  value: float) -> torch.Tensor:
    """Set ``scores[b, excl[b, j]] = value`` in place, skipping the pad id
    ``num_items`` (the JAX package drops it with ``mode="drop"``)."""
    excl = excl.to(torch.int64)
    keep = excl < scores.shape[1]
    rows = torch.arange(scores.shape[0], device=scores.device)[:, None]
    scores[rows.expand_as(excl)[keep], excl[keep]] = value
    return scores


def topk_for_users(user_emb: torch.Tensor, item_emb: torch.Tensor,
                   users: torch.Tensor, k: int,
                   exclude_rows: Optional[torch.Tensor] = None,
                   exclude_batch_rows: Optional[torch.Tensor] = None,
                   mesh=None, topk_method: str = "exact",
                   score_dtype: str = "fp32"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores (B,k), item ids (B,k)), excluded items scored ``-inf``.

    ``exclude_rows``: (U, Pmax) padded exclusion table (pad = num_items);
    ``exclude_batch_rows``: pre-gathered (B, Pb) rows for THIS batch
    (:func:`exclusion_rows_for_users`).  With ``mesh`` (a ``DeviceMesh``),
    scoring runs row-sharded over the model axis with a distributed top-k
    merge (a ``ShardedTopK`` on the mesh's live model group, made for the
    call: it holds no more than the group and the block size, and a cached
    one could outlive its group when a process makes meshes in turn);
    ``topk_method`` / ``score_dtype`` are its per-shard modes, which the
    single-device branch ignores.  On one device the top-k is
    ``topk_select``'s, equal scores in ``lax.top_k``'s order (the lower id
    first); on a mesh ties may come back in another order.
    """
    exact_fp32_matmul()
    if exclude_batch_rows is not None:
        excl = exclude_batch_rows
    else:
        excl = exclude_rows[users] if exclude_rows is not None else None
    if mesh is not None:
        from ..parallel.sharded_topk import ShardedTopK
        st = ShardedTopK(mesh, item_emb.shape[0])
        return st.topk(user_emb[users], st.pad_items(item_emb), k,
                       exclude=excl, method=topk_method,
                       score_dtype=score_dtype)
    with span("rec.rank.topk_for_users"):
        with span("rec.rank.score"):
            scores = user_emb[users] @ item_emb.T             # (B, I)
        if excl is not None:
            with span("rec.rank.mask"):
                scores = mask_excluded(scores, excl, float("-inf"))
        with span("rec.rank.topk"):
            return topk_select(scores, k)
