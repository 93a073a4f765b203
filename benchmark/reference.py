"""The plain reference's shared parts: a weighted segment-sum with its
transpose backward, BPR with ego L2, Adam, the full-catalogue evaluation
and the top-k of a served request, in plain PyTorch.  Each propagation
(a model's layers and edge weights) is a file of ``references/``, named by
a configuration's ``reference``.

It imports nothing of the port and takes nothing the port made: a model
works the edge weights out again from the train edges, propagates the
tables the benchmark made, and the port's outputs are read only to judge
them.  It runs
in float64 unless a lower precision is asked for (the controls).  Sums are
``index_add_`` over edges in chunks, so a propagation fits beside nothing
else on the card."""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

CHUNK_EDGES = 1 << 21
B1, B2, EPS = 0.9, 0.999, 1e-8


def spmm(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
         w: torch.Tensor, num_dst: int) -> torch.Tensor:
    """``y[d] = sum_{e: dst[e] = d} w[e] x[src[e]]``."""
    y = x.new_zeros(num_dst, x.shape[1])
    for s in range(0, src.numel(), CHUNK_EDGES):
        sl = slice(s, s + CHUNK_EDGES)
        y.index_add_(0, dst[sl], x[src[sl]] * w[sl, None])
    return y


class SpmmOp(torch.autograd.Function):
    """:func:`spmm` whose backward is the transposed segment-sum."""

    @staticmethod
    def forward(ctx, x, src, dst, w, num_dst):
        ctx.save_for_backward(src, dst, w)
        ctx.num_src = x.shape[0]
        return spmm(x, src, dst, w, num_dst)

    @staticmethod
    def backward(ctx, g):
        src, dst, w = ctx.saved_tensors
        return spmm(g, dst, src, w, ctx.num_src), None, None, None, None


def round_to(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` rounded to ``precision`` and back to its dtype: "bf16", "tf32"
    (10 mantissa bits, round to nearest even), "fp8" (e4m3 with one scale
    for the tensor, its largest magnitude at 448) or "exact"."""
    if precision == "exact":
        return x
    if precision == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    if precision == "tf32":
        b = x.float().contiguous().view(torch.int32)
        b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
        return b.view(torch.float32).to(x.dtype)
    if precision == "fp8":
        scale = 448.0 / x.abs().max().clamp(min=1e-30)
        return ((x * scale).to(torch.float8_e4m3fn).to(x.dtype)) / scale
    raise ValueError(f"unknown precision {precision!r}")


# -- training ---------------------------------------------------------------

def bpr_l2_loss(model, eu, ei, users, pos, neg, mask, reg: float,
                rest=None) -> torch.Tensor:
    """BPR on the layer-mean rows plus ``reg`` times the squared norms of
    the ego rows, each a mean over the rows ``mask`` keeps.  With ``rest``
    (the cached propagation minus its ego term) the rows are ``rest +
    ego / (K + 1)``, else a whole propagation."""
    if rest is None:
        tu, ti = model.propagate(eu, ei)
    else:
        s = 1.0 / (model.K + 1)
        tu, ti = rest[0] + s * eu, rest[1] + s * ei
    ur = tu[users]
    ps = (ur * ti[pos]).sum(-1)
    ns = (ur * ti[neg]).sum(-1)
    m = mask.to(eu.dtype)
    n = m.sum().clamp(min=1.0)
    bpr = (-torch.log(torch.sigmoid(ps - ns) + 1e-12) * m).sum() / n
    l2 = ((eu[users] ** 2).sum(-1) + (ei[pos] ** 2).sum(-1)
          + (ei[neg] ** 2).sum(-1))
    return bpr + reg * (l2 * m).sum() / n


def train_steps(model, tables: Dict[str, torch.Tensor],
                batches: Sequence[Tuple], lr: float, reg: float,
                schedule: str, cache_at: Sequence[int] = (0,)) -> dict:
    """Adam (optax's defaults) over ``batches`` from ``tables`` (user_emb,
    item_emb).  Under "per_epoch" the propagation is cached at the steps in
    ``cache_at``, as a call of the trainer's epoch caches it at its start.
    Returns each step's loss, the first step's gradient and the tables
    after the last step."""
    p = {k: v.to(model.dtype).clone() for k, v in tables.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first_grad, rest = [], None, None
    for t, (users, pos, neg, mask) in enumerate(batches, start=1):
        if schedule == "per_epoch" and (t - 1) in cache_at:
            with torch.no_grad():
                tu, ti = model.propagate(p["user_emb"], p["item_emb"])
                s = 1.0 / (model.K + 1)
                rest = (tu - s * p["user_emb"], ti - s * p["item_emb"])
        leaves = {k: x.detach().requires_grad_() for k, x in p.items()}
        loss = bpr_l2_loss(model, leaves["user_emb"], leaves["item_emb"],
                           users, pos, neg, mask, reg, rest)
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        if first_grad is None:
            first_grad = {k: g.detach().clone() for k, g in grads.items()}
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for k in p:
                g = grads[k]
                m[k] = B1 * m[k] + (1 - B1) * g
                v2[k] = B2 * v2[k] + (1 - B2) * g * g
                mh = m[k] / (1 - B1 ** t)
                vh = v2[k] / (1 - B2 ** t)
                p[k] = p[k] - lr * mh / (vh.sqrt() + EPS)
    return {"losses": losses, "grad": first_grad, "tables": p}


def norm_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             ref_grad: Dict[str, torch.Tensor]) -> float:
    """The worst leaf's gap between the norms, ``| |prog| - |ref| |``, over
    the larger of the reference leaf's norm and the median leaf's.  Leaves
    whose reference gradient is under a thousandth of the median leaf's
    move by round-off alone and are left out."""
    norms = {k: float(ref[k].double().norm()) for k in ref}
    gnorm = {k: float(ref_grad[k].double().norm()) for k in ref_grad}
    med, gmed = float(np.median(list(norms.values()))), \
        float(np.median(list(gnorm.values())))
    worst = 0.0
    for k in ref:
        if gnorm[k] < 1e-3 * gmed:
            continue
        gap = abs(float(prog[k].double().norm()) - norms[k])
        worst = max(worst, gap / max(norms[k], med, 1e-300))
    return worst


# -- ranking ----------------------------------------------------------------

def csr_on(indptr: np.ndarray, indices: np.ndarray, device):
    return (torch.as_tensor(indptr, dtype=torch.int64, device=device),
            torch.as_tensor(indices, dtype=torch.int64, device=device))


def user_csr(edges: np.ndarray, users: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-user sorted item lists of ``edges`` (2, E)."""
    order = np.lexsort((edges[1], edges[0]))
    indptr = np.zeros(users + 1, np.int64)
    np.cumsum(np.bincount(edges[0], minlength=users), out=indptr[1:])
    return indptr, edges[1][order].astype(np.int64)


def rows_of(csr, users: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(batch position, item) of every edge of ``users`` in ``csr``."""
    indptr, indices = csr
    lo, hi = indptr[users], indptr[users + 1]
    deg = hi - lo
    pos = torch.repeat_interleave(torch.arange(users.numel(),
                                               device=users.device), deg)
    start = torch.repeat_interleave(lo - torch.cumsum(deg, 0) + deg, deg)
    return pos, indices[start + torch.arange(pos.numel(), device=users.device)]


def masked_scores(tu: torch.Tensor, ti: torch.Tensor, users: torch.Tensor,
                  train_csr) -> torch.Tensor:
    """Every item's score for ``users``, their train items at ``-inf``."""
    s = tu[users] @ ti.T
    b, it = rows_of(train_csr, users)
    s[b, it] = float("-inf")
    return s


def full_eval(tu: torch.Tensor, ti: torch.Tensor, users: np.ndarray,
              train_csr, test_csr, Ks: Sequence[int], batch: int = 512
              ) -> Dict[int, Dict[str, float]]:
    """Precision, recall and NDCG at each K of the exact top-max(K) of every
    user in ``users`` over the catalogue without their train items, means
    over the users; ``tu`` and ``ti`` are the scoring tables."""
    kmax = max(Ks)
    dev = tu.device
    I = ti.shape[0]
    t_ptr, t_idx = test_csr
    keys = torch.sort(torch.repeat_interleave(
        torch.arange(t_ptr.numel() - 1, device=dev), t_ptr[1:] - t_ptr[:-1])
        * I + t_idx).values
    gains = 1.0 / torch.log2(torch.arange(kmax, device=dev,
                                          dtype=torch.float64) + 2.0)
    idcg = torch.cat([gains.new_zeros(1), gains.cumsum(0)])
    sums = {K: {"precision": 0.0, "recall": 0.0, "ndcg": 0.0} for K in Ks}
    for s in range(0, users.size, batch):
        bu = torch.as_tensor(users[s:s + batch], device=dev)
        top = torch.topk(masked_scores(tu, ti, bu, train_csr), kmax,
                         dim=1).indices
        q = bu[:, None] * I + top
        at = torch.searchsorted(keys, q).clamp(max=keys.numel() - 1)
        hits = (keys[at] == q).double()
        gt = (t_ptr[bu + 1] - t_ptr[bu]).double()
        for K in Ks:
            h = hits[:, :K]
            n = h.sum(1)
            sums[K]["precision"] += float((n / K).sum())
            sums[K]["recall"] += float((n / gt.clamp(min=1.0)).sum())
            ideal = idcg[gt.long().clamp(max=K)]
            dcg = (h * gains[:K]).sum(1)
            sums[K]["ndcg"] += float(torch.where(
                ideal > 0, dcg / ideal.clamp(min=1e-12), 0.0).sum())
    n = max(users.size, 1)
    return {K: {k: v / n for k, v in sums[K].items()} for K in Ks}


def metric_gap(prog: Dict[int, Dict[str, float]],
               ref: Dict[int, Dict[str, float]]) -> float:
    """The largest relative gap of precision, recall and NDCG at any K."""
    worst = 0.0
    for K, r in ref.items():
        for name, v in r.items():
            got = prog.get(K, {}).get(name)
            if got is None or not math.isfinite(got):
                return float("inf")
            worst = max(worst, abs(got - v) / max(abs(v), 1e-12))
    return worst


def served_gaps(ref_scores: torch.Tensor, ids: torch.Tensor,
                scores: torch.Tensor) -> Tuple[float, float]:
    """``(rank_gap, score_gap)`` of one served request: how far each served
    item's reference score lies below the reference's score at its rank,
    and how far its served score lies from its reference score, over the
    spread (standard deviation) of the user's reference scores.  An
    excluded or repeated item reads infinite."""
    ids = ids.to(ref_scores.device).long()
    scores = scores.to(ref_scores.device).double()
    k = ids.shape[1]
    got = torch.gather(ref_scores, 1, ids)
    if not torch.isfinite(got).all() or not torch.isfinite(scores).all():
        return float("inf"), float("inf")
    srt = torch.sort(ids, 1).values
    if (srt[:, 1:] == srt[:, :-1]).any():
        return float("inf"), float("inf")
    best = torch.topk(ref_scores, k, dim=1).values
    finite = torch.where(torch.isfinite(ref_scores), ref_scores, 0.0)
    cnt = torch.isfinite(ref_scores).sum(1, keepdim=True).double()
    mean = finite.sum(1, keepdim=True) / cnt
    var = (torch.where(torch.isfinite(ref_scores), ref_scores - mean, 0.0)
           ** 2).sum(1, keepdim=True) / cnt
    spread = var.sqrt().clamp(min=1e-300)
    rank_gap = float(((best - got) / spread).max())
    score_gap = float(((scores - got).abs() / spread).max())
    return rank_gap, score_gap
