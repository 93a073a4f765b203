"""Ranking evaluators (sampled and full-catalog), batched on the device.

Evaluation runs in fixed-size user batches: candidate rejection sampling,
scoring, ranking and the per-user metrics run on the device; the host
accumulates sums after ONE device-to-host copy per evaluation.

Protocol parity:
  * eval users = users with >=1 interaction in the eval split
    (reference lightgcn.py:408).
  * sampled mode: 1 random positive from the user's eval row + 99 uniform
    negatives rejected against the user's full eval ground-truth set AND
    train items (lightgcn.py:415-430), drawn from a dedicated eval
    generator (the reference's ``seed+999`` stream, lightgcn.py:406).
  * full mode: all-item scores with the user's train items masked to -1e9
    (lightgcn.py:477-490), top-K ranking with the exact
    ``ops/topk_select.topk_select`` (``lax.top_k``'s order for equal scores;
    ``topk="approx"`` ranks exactly too: the TPU's approx_max_k has no
    counterpart here); ``score_dtype="bf16"`` scores bf16 tables with fp32
    sums, as the TPU kept them, and ranks in fp32.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..graph.build import BipartiteGraph
from ..ops.sampling import (DeviceCSR, row_contains, sample_candidate_set,
                            sample_positives)
from ..ops.topk_select import topk_select
from ..utils.profiling import span
from .metrics import (cred_groups, item_popularity, novelty_stats,
                      sampled_rank_metrics, topk_metrics)
from .retrieval import (exact_fp32_matmul, exclusion_rows_for_users,
                        mask_excluded, score_product, topk_for_users)

_METRICS = ("precision", "recall", "ndcg")


@dataclass
class EvalContext:
    """Device-resident evaluation state for one graph.

    Full-catalog masking builds (B, Pb) exclusion rows PER BATCH from the
    host CSR — a global (U, Pmax) table grows with the degree skew."""
    graph: BipartiteGraph
    device: torch.device
    train_csr: DeviceCSR
    val_csr: DeviceCSR
    test_csr: DeviceCSR
    item_pop: np.ndarray              # (I,) int64 train popularity
    total_train: int
    eval_users: Dict[str, np.ndarray] = field(default_factory=dict)
    _item_pop_dev: Optional[torch.Tensor] = field(default=None, repr=False)

    @classmethod
    def build(cls, graph: BipartiteGraph, device,
              membership: str = "hash") -> "EvalContext":
        device = torch.device(device)
        I = graph.num_items
        tr = graph.user_csr("train")
        va = graph.user_csr("val")
        te = graph.user_csr("test")
        pop, total = item_popularity(graph.train_edges, I)
        ctx = cls(
            graph=graph,
            device=device,
            train_csr=DeviceCSR.from_host(tr, I, device, membership),
            val_csr=DeviceCSR.from_host(va, I, device, membership),
            test_csr=DeviceCSR.from_host(te, I, device, membership),
            item_pop=pop,
            total_train=total,
        )
        ctx.eval_users = {
            "val": np.nonzero(va.degrees() > 0)[0].astype(np.int64),
            "test": np.nonzero(te.degrees() > 0)[0].astype(np.int64),
        }
        return ctx

    def train_exclusion_rows(self, users: np.ndarray) -> np.ndarray:
        """(B, Pb) per-batch train-item exclusion rows."""
        return exclusion_rows_for_users(self.graph, users, "train")

    @property
    def item_pop_dev(self) -> torch.Tensor:
        if self._item_pop_dev is None:
            self._item_pop_dev = torch.as_tensor(self.item_pop,
                                                 device=self.device)
        return self._item_pop_dev

    def split_csr(self, split: str) -> DeviceCSR:
        return {"train": self.train_csr, "val": self.val_csr,
                "test": self.test_csr}[split]

    def users_of(self, split: str) -> np.ndarray:
        users = self.eval_users[split] if split in self.eval_users else \
            np.nonzero(self.graph.user_csr(split).degrees() > 0)[0]
        if users.size == 0:
            raise RuntimeError(f"No users with {split} interactions.")
        return users


def _batch_at(users: np.ndarray, s: int, batch: int, device):
    """(padded_batch_device, padded_batch_host, num_valid) of the batch of
    ``users`` that starts at ``s``."""
    chunk = users[s:s + batch]
    n = chunk.size
    if n < batch:
        chunk = np.concatenate([chunk, np.zeros(batch - n, np.int64)])
    return torch.as_tensor(chunk, dtype=torch.int64, device=device), chunk, n


def _batched(users: np.ndarray, batch: int, device):
    """Yield (padded_batch_device, padded_batch_host, num_valid)."""
    for s in range(0, users.size, batch):
        yield _batch_at(users, s, batch, device)


def rejection_rounds(max_degree: int, num_items: int) -> int:
    """Redraw rounds so residual collision probability is negligible.

    Per-candidate collision prob p <= max_degree/num_items; after r rounds
    the residual is p^(r+1).  Pick the smallest r with p^(r+1) < 1e-9."""
    p = min(max(max_degree, 1) / max(num_items, 2), 0.9)
    r = int(np.ceil(-9.0 / np.log10(p))) - 1
    return int(np.clip(r, 2, 30))


def _novelty(ranked, item_pop, Ks, total_train, num_items):
    logpop, selfinfo = {}, {}
    for K in Ks:
        logpop[K], selfinfo[K] = novelty_stats(
            ranked[:, :K], item_pop, total_train, num_items)
    return logpop, selfinfo


def _sampled_metrics(user_emb, item_emb, users, cand, item_pop, Ks: tuple,
                     extended: bool, total_train: int, num_items: int):
    """Metrics of one batch of (B, 1+n) candidates, the positive first."""
    scores = torch.einsum("bd,bkd->bk", user_emb[users], item_emb[cand])
    rank = (scores[:, 1:] > scores[:, :1]).sum(dim=1)
    order = torch.argsort(-scores, dim=1, stable=True)
    ranked = torch.gather(cand, 1, order)
    per_user = sampled_rank_metrics(rank, Ks)
    logpop = selfinfo = None
    if extended:
        logpop, selfinfo = _novelty(ranked, item_pop, Ks, total_train,
                                    num_items)
    return per_user, ranked, logpop, selfinfo


def _sampled_batch(gen, user_emb, item_emb, users, eval_csr: DeviceCSR,
                   train_csr: DeviceCSR, item_pop, num_items: int, n_neg: int,
                   rounds: int, Ks: tuple, extended: bool, total_train: int):
    pos = sample_positives(gen, eval_csr, users)
    negs = sample_candidate_set(gen, (eval_csr, train_csr), users,
                                num_items, n_neg, rounds=rounds)
    cand = torch.cat([pos[:, None], negs], dim=1)               # (B, 1+n)
    return _sampled_metrics(user_emb, item_emb, users, cand, item_pop, Ks,
                            extended, total_train, num_items)


def _full_metrics_from_topk(topk_items, users, test_csr: DeviceCSR, item_pop,
                            Ks: tuple, extended: bool, total_train: int,
                            num_items: int):
    hits = row_contains(test_csr, users, topk_items)
    gt_len = test_csr.indptr[users + 1] - test_csr.indptr[users]
    per_user = topk_metrics(hits, gt_len, Ks)
    logpop = selfinfo = None
    if extended:
        logpop, selfinfo = _novelty(topk_items, item_pop, Ks, total_train,
                                    num_items)
    return per_user, topk_items, logpop, selfinfo


def _full_batch(user_emb, item_emb, users, excl_rows, test_csr: DeviceCSR,
                item_pop, Ks: tuple, extended: bool, total_train: int,
                num_items: int, score_dtype: str = "fp32"):
    """``excl_rows``: (B, Pb) per-batch train-item rows (pad = num_items).
    ``score_dtype="bf16"``: bf16 tables, scores summed, masked and ranked
    in fp32 (``retrieval.score_product``)."""
    with span("rec.rank.score"):
        scores = score_product(user_emb[users], item_emb,
                               score_dtype)                     # (B, I)
    with span("rec.rank.mask"):
        scores = mask_excluded(scores, excl_rows, -1e9)
    with span("rec.rank.topk"):
        _, topk_items = topk_select(scores, max(Ks))
    with span("rec.eval.metrics"):
        return _full_metrics_from_topk(topk_items, users, test_csr, item_pop,
                                       Ks, extended, total_train, num_items)


class _Accumulator:
    """Metric accumulation over user batches.

    Batch results stay ON THE DEVICE during the loop; ``_finalize`` moves
    all of them to the host in a single copy (float64 holds the fp32
    metrics and the int item ids exactly), then sums each metric in float32
    as the JAX package does."""

    def __init__(self, Ks: Sequence[int], extended: bool,
                 num_items: Optional[int] = None):
        self.Ks = list(Ks)
        self.extended = extended
        self.num_items = num_items   # coverage filters sentinel ids >= this
        self.sums = {K: {} for K in self.Ks}
        self.rec_items = {K: set() for K in self.Ks} if extended else None
        self.per_user_recall = {K: [] for K in self.Ks}
        self.n_users = 0
        self._pending = []

    def add(self, per_user: Dict[int, Dict[str, torch.Tensor]], n_valid: int,
            ranked_items=None, logpop=None, selfinfo=None):
        self._pending.append((per_user, n_valid, ranked_items, logpop,
                              selfinfo))

    def _leaves(self, entry):
        per_user, _, ranked, logpop, selfinfo = entry
        out = [per_user[K][m] for K in self.Ks for m in _METRICS]
        if self.extended and ranked is not None:
            out.append(ranked)
            out += [logpop[K] for K in self.Ks] + [selfinfo[K] for K in self.Ks]
        return out

    def _finalize(self):
        pending, self._pending = self._pending, []
        if not pending:
            return
        leaves = [self._leaves(e) for e in pending]
        flat = [t for ls in leaves for t in ls]
        host = torch.cat([t.reshape(-1).to(torch.float64)
                          for t in flat]).cpu().numpy()
        pos = 0
        for entry, ls in zip(pending, leaves):
            arrs = []
            for t in ls:
                arrs.append(host[pos:pos + t.numel()].reshape(tuple(t.shape)))
                pos += t.numel()
            self._absorb(entry[1], arrs)

    def _absorb(self, n_valid: int, arrs):
        self.n_users += n_valid
        nK = len(self.Ks)
        for k, K in enumerate(self.Ks):
            for m, name in enumerate(_METRICS):
                a = arrs[k * len(_METRICS) + m].astype(np.float32)[:n_valid]
                self.sums[K][name] = self.sums[K].get(name, 0.0) + float(a.sum())
            self.per_user_recall[K].append(
                arrs[k * len(_METRICS) + 1].astype(np.float32)[:n_valid])
        if len(arrs) == nK * len(_METRICS):
            return
        base = nK * len(_METRICS)
        ranked = arrs[base].astype(np.int64)
        for k, K in enumerate(self.Ks):
            ids = np.unique(ranked[:n_valid, :K])
            if self.num_items is not None:
                ids = ids[ids < self.num_items]
            self.rec_items[K].update(ids.tolist())
            lp = arrs[base + 1 + k].astype(np.float32)
            si = arrs[base + 1 + nK + k].astype(np.float32)
            self.sums[K]["logpop"] = self.sums[K].get(
                "logpop", 0.0) + float(lp[:n_valid].sum())
            self.sums[K]["selfinfo"] = self.sums[K].get(
                "selfinfo", 0.0) + float(si[:n_valid].sum())

    def results(self, mode: str, num_items: int, users: np.ndarray,
                cred: Optional[np.ndarray], cred_group_pct: float,
                n_negatives: Optional[int]) -> Dict[int, Dict[str, float]]:
        self._finalize()
        n = max(self.n_users, 1)
        out = {}
        high = low = None
        if self.extended and cred is not None:
            high, low = cred_groups(users, cred, cred_group_pct)
        for K in self.Ks:
            r = {name: s / n for name, s in self.sums[K].items()
                 if name not in ("logpop", "selfinfo")}
            r["users_eval"] = self.n_users
            r["mode"] = mode
            if n_negatives is not None:
                r["negatives"] = n_negatives
            if self.extended:
                recall_u = np.concatenate(self.per_user_recall[K]) \
                    if self.per_user_recall[K] else np.zeros(0)
                r["item_coverage"] = len(self.rec_items[K]) / max(num_items, 1)
                r["avg_log_popularity"] = self.sums[K].get("logpop", 0.0) / n
                r["avg_self_information"] = self.sums[K].get("selfinfo", 0.0) / n
                if cred is not None:
                    r["cred_utility"] = float(np.mean(cred[users])) if users.size else 0.0
                    pos_of = {int(u): k for k, u in enumerate(users)}
                    hi_idx = [pos_of[int(u)] for u in high]
                    lo_idx = [pos_of[int(u)] for u in low]
                    r["high_cred_recall"] = float(recall_u[hi_idx].mean()) if hi_idx else 0.0
                    r["low_cred_recall"] = float(recall_u[lo_idx].mean()) if lo_idx else 0.0
                    r["high_users"] = len(hi_idx)
                    r["low_users"] = len(lo_idx)
            out[K] = r
        return out


def evaluate_sampled(gen: torch.Generator, user_emb: torch.Tensor,
                     item_emb: torch.Tensor, ctx: EvalContext, split: str,
                     Ks: Sequence[int] = (10, 20), n_negatives: int = 99,
                     batch: int = 4096, extended: bool = False,
                     cred: Optional[np.ndarray] = None,
                     cred_group_pct: float = 0.20
                     ) -> Dict[int, Dict[str, float]]:
    """Sampled 1+n ranking; ``gen`` lives on ``ctx.device``."""
    exact_fp32_matmul()
    users = ctx.users_of(split)
    eval_csr = ctx.split_csr(split)
    acc = _Accumulator(Ks, extended, num_items=ctx.graph.num_items)
    max_deg = int(max(ctx.graph.user_csr("train").degrees().max(initial=1),
                      ctx.graph.user_csr(split).degrees().max(initial=1)))
    rounds = rejection_rounds(max_deg, ctx.graph.num_items)
    item_pop = ctx.item_pop_dev if extended else None
    for bu, _, n_valid in _batched(users, batch, ctx.device):
        per_user, ranked, logpop, selfinfo = _sampled_batch(
            gen, user_emb, item_emb, bu, eval_csr, ctx.train_csr, item_pop,
            ctx.graph.num_items, n_negatives, rounds, tuple(Ks), extended,
            ctx.total_train)
        acc.add(per_user, n_valid, ranked if extended else None, logpop,
                selfinfo)
    return acc.results("sampled(1pos+neg)", ctx.graph.num_items, users, cred,
                       cred_group_pct, n_negatives)


def evaluate_full(user_emb: torch.Tensor, item_emb: torch.Tensor,
                  ctx: EvalContext, split: str, Ks: Sequence[int] = (10, 20),
                  batch: int = 512, extended: bool = False,
                  cred: Optional[np.ndarray] = None,
                  cred_group_pct: float = 0.20, mesh=None,
                  topk: str = "exact",
                  score_dtype: str = "fp32") -> Dict[int, Dict[str, float]]:
    """Full-catalog masked ranking (reference lightgcn.py:459-509).
    ``topk`` "exact" and "approx" both rank exactly: on one device with
    ``topk_select`` (equal scores in ``lax.top_k``'s order).  With ``mesh``
    (a ``DeviceMesh``) the ranking runs row-sharded over its model axis with
    a distributed merge, in its own order for equal scores; every rank
    returns the same metrics."""
    if topk not in ("exact", "approx"):
        raise ValueError(f"unknown topk {topk!r}")
    exact_fp32_matmul()
    users = ctx.users_of(split)
    # clamp large configured batches on small graphs: padding 100 eval
    # users to 4096 would pay a (4096, I) score matrix for nothing
    batch = min(batch, 1 << max(int(users.size - 1).bit_length(), 0))
    eval_csr = ctx.split_csr(split)
    acc = _Accumulator(Ks, extended, num_items=ctx.graph.num_items)
    item_pop = ctx.item_pop_dev if extended else None
    for s in range(0, users.size, batch):
        with span("rec.eval.batch"):
            bu, bu_host, n_valid = _batch_at(users, s, batch, ctx.device)
            excl = torch.as_tensor(ctx.train_exclusion_rows(bu_host),
                                   device=ctx.device)
            if mesh is not None:
                _, top = topk_for_users(user_emb, item_emb, bu, max(Ks),
                                        exclude_batch_rows=excl, mesh=mesh,
                                        topk_method=topk,
                                        score_dtype=score_dtype)
                per_user, topk_items, logpop, selfinfo = \
                    _full_metrics_from_topk(top, bu, eval_csr, item_pop,
                                            tuple(Ks), extended,
                                            ctx.total_train,
                                            ctx.graph.num_items)
            else:
                per_user, topk_items, logpop, selfinfo = _full_batch(
                    user_emb, item_emb, bu, excl, eval_csr, item_pop,
                    tuple(Ks), extended, ctx.total_train,
                    ctx.graph.num_items, score_dtype=score_dtype)
            acc.add(per_user, n_valid, topk_items if extended else None,
                    logpop, selfinfo)
    with span("rec.eval.finalize"):
        return acc.results("full", ctx.graph.num_items, users, cred,
                           cred_group_pct, None)
