"""Vectorized on-device samplers of training and evaluation.

The reference samples in per-user Python rejection loops
(reference lightgcn.py:289-300, :415-430).  Here sampling runs on the
device, whole batch at once:

  * membership tests are an exact hash-table probe (ops/membership.py) or a
    fixed-depth binary search over the per-user *sorted* CSR rows;
  * rejection loops become a bounded number of batched redraw rounds —
    distribution-equivalent to the reference's sequential rejection, not
    bit-equivalent;
  * the popularity mixture draws from pop^gamma via a Walker/Vose alias
    table built in float64 on the host (O(1) per draw; a float32
    inverse-CDF would make tail items unsamplable at 10M-item catalogs).

  * weighted sampling without replacement (Stage A's SLAS draws) is a
    Gumbel top-k over the candidates' logits.

Random numbers come from an explicit ``torch.Generator`` on the device the
draws are made on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..graph.csr import CSR
from .membership import HashMembership


@dataclass(frozen=True)
class DeviceCSR:
    """Device-resident CSR with sorted rows (see graph/csr.py)."""
    indptr: torch.Tensor       # (N+1,) int64
    indices: torch.Tensor      # (nnz,) int64, sorted within each row
    hashmem: Optional[HashMembership]
    num_rows: int
    num_cols: int
    search_iters: int          # binary-search depth >= ceil(log2(max_deg))

    @classmethod
    def from_host(cls, csr: CSR, num_cols: int, device,
                  membership: str = "hash") -> "DeviceCSR":
        max_deg = int(csr.degrees().max()) if csr.nnz else 1
        iters = max(1, int(np.ceil(np.log2(max(max_deg, 2)))) + 1)
        hashmem = None
        if membership == "hash":
            deg = np.diff(csr.indptr)
            rows = np.repeat(np.arange(csr.num_rows, dtype=np.int64), deg)
            hashmem = HashMembership.build(rows, csr.indices, device)
        indices = csr.indices if csr.nnz else np.zeros(1, np.int32)
        return cls(
            indptr=torch.as_tensor(np.asarray(csr.indptr, np.int64),
                                   device=device),
            indices=torch.as_tensor(np.asarray(indices, np.int64),
                                    device=device),
            hashmem=hashmem,
            num_rows=csr.num_rows,
            num_cols=num_cols,
            search_iters=iters,
        )


def row_contains(csr: DeviceCSR, rows: torch.Tensor,
                 cands: torch.Tensor) -> torch.Tensor:
    """Vectorized ``user_has_item`` (reference lightgcn.py:280-287).

    rows: (B,) int; cands: (B, ...) int -> bool of cands.shape.
    """
    shape = cands.shape
    cands2 = cands.reshape(shape[0], -1)
    if csr.hashmem is not None:
        return csr.hashmem.contains(rows[:, None], cands2).reshape(shape)
    rows = rows.to(torch.int64)
    hi0 = csr.indptr[rows + 1][:, None].expand_as(cands2)
    lo = csr.indptr[rows][:, None].expand_as(cands2).clone()
    hi = hi0.clone()
    nmax = csr.indices.shape[0] - 1
    for _ in range(csr.search_iters):
        mid = (lo + hi) >> 1
        go_right = csr.indices[mid.clamp(0, nmax)] < cands2
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    found = (lo < hi0) & (csr.indices[lo.clamp(0, nmax)] == cands2)
    return found.reshape(shape)


def sample_positives(gen: torch.Generator, csr: DeviceCSR,
                     rows: torch.Tensor) -> torch.Tensor:
    """Uniform positive per row (reference lightgcn.py:289-293).  Rows with
    zero degree return the (meaningless) first slot — callers mask them."""
    rows = rows.to(torch.int64)
    lo = csr.indptr[rows]
    deg = (csr.indptr[rows + 1] - lo).clamp(min=1)
    u = torch.rand(rows.shape, generator=gen, device=rows.device,
                   dtype=torch.float64)
    off = torch.minimum((u * deg).to(torch.int64), deg - 1)
    return csr.indices[(lo + off).clamp(0, csr.indices.shape[0] - 1)]


def _first_good(cand: torch.Tensor, good: torch.Tensor) -> torch.Tensor:
    """Per leading slot, the first candidate whose ``good`` flag is set;
    the LAST candidate when none is (the unchecked final redraw, mirroring
    the reference's bounded rejection loop)."""
    pad = torch.ones(good.shape[:-1] + (1,), dtype=torch.bool,
                     device=good.device)
    pick = torch.cat([good, pad], dim=-1).to(torch.int8).argmax(dim=-1)
    pick = pick.clamp(max=cand.shape[-1] - 1)
    return torch.gather(cand, -1, pick[..., None])[..., 0]


def sample_candidate_set(gen: torch.Generator, reject_csrs,
                         rows: torch.Tensor, num_items: int, k: int,
                         rounds: int = 8) -> torch.Tensor:
    """(B, k) uniform candidates rejecting membership in ANY of the given
    CSRs — the sampled-evaluation negative draw (reference
    lightgcn.py:422-430 rejects the user's whole eval ground-truth set and
    their train items)."""
    B = rows.shape[0]
    cand = torch.randint(0, num_items, (B, k, rounds + 1), generator=gen,
                         device=rows.device)
    bad = torch.zeros((B, k * (rounds + 1)), dtype=torch.bool,
                      device=rows.device)
    for csr in reject_csrs:
        bad = bad | row_contains(csr, rows, cand.reshape(B, -1))
    good = ~bad.reshape(cand.shape)[..., :rounds]
    return _first_good(cand, good)


def sample_negatives_uniform(gen: torch.Generator, csr: DeviceCSR,
                             rows: torch.Tensor, num_items: int,
                             rounds: int = 8) -> torch.Tensor:
    """Batched-rejection uniform negatives (reference lightgcn.py:296-300).

    ``rounds`` bounded redraw rounds; the residual collision probability
    after r rounds is (deg/I)^r.  All rounds are drawn up front and share
    ONE fused membership test: the selected item is the first non-member
    among iid draws, the same distribution as check-and-redraw."""
    cand = torch.randint(0, num_items, rows.shape + (rounds + 1,),
                         generator=gen, device=rows.device)
    good = ~row_contains(csr, rows, cand[..., :rounds])
    return _first_good(cand, good)


def build_alias_table(prob: np.ndarray):
    """Exact Walker/Vose alias table in float64 (``JAX: ops/sampling.py``).

    Returns ``(accept, alias)``: draw bucket j uniformly, keep j with
    probability ``accept[j]`` else emit ``alias[j]``.  Each round pairs
    every remaining deficit bucket ("small", scaled < 1) with one surplus
    bucket ("large"); a large that dips below 1 rejoins the smalls.  When a
    handful of heavy buckets remain against many smalls, each large absorbs
    a contiguous run of smalls found by searchsorted over the cumulative
    deficits (the same arithmetic as running the rounds out).
    """
    prob = np.asarray(prob, np.float64)
    n = prob.shape[0]
    scaled = prob * (n / prob.sum())
    accept = np.ones(n, np.float64)
    alias = np.arange(n, dtype=np.int64)

    small = np.nonzero(scaled < 1.0)[0]
    large = np.nonzero(scaled >= 1.0)[0]
    while small.size and large.size:
        if large.size <= 8 < small.size:
            # chunked endgame: absorb runs of smalls per large
            deficits = 1.0 - scaled[small]
            pos = 0
            li = 0
            while li < large.size and pos < small.size:
                j = large[li]
                cum = np.cumsum(deficits[pos:])
                k = int(np.searchsorted(cum, scaled[j] - 1.0, side="left"))
                k = min(k, cum.shape[0] - 1)
                run = small[pos:pos + k + 1]
                accept[run] = scaled[run]
                alias[run] = j
                scaled[j] -= cum[k]
                if scaled[j] < 1.0 and li + 1 < large.size:
                    # j became a small: hand its deficit to the next large
                    small = np.append(small, j)
                    deficits = np.append(deficits, 1.0 - scaled[j])
                pos += k + 1
                li += 1
            # float residue: any leftovers keep accept=1 (self-alias)
            break
        k = min(small.size, large.size)
        s, l = small[:k], large[:k]
        accept[s] = scaled[s]
        alias[s] = l
        scaled[l] -= 1.0 - scaled[s]
        still_large = scaled[l] >= 1.0
        small = np.concatenate([small[k:], l[~still_large]])
        large = np.concatenate([large[k:], l[still_large]])
    return accept, alias


@dataclass(frozen=True)
class PopMixSampler:
    """Method E popularity-mixture negative sampler
    (Version-2/lighgcn_cu_pop.py:349-376; dist built :805-814).

    With probability ``mix_pop`` draw from p(i) ∝ (deg_i+1)^gamma via an
    alias table, else uniform; reject interacted items with bounded redraws
    and a final uniform fallback round."""
    accept: torch.Tensor      # (I,) float32 alias accept thresholds
    alias: torch.Tensor       # (I,) int64 alias targets
    mix_pop: float
    num_items: int

    @classmethod
    def build(cls, item_train_degrees: np.ndarray, device,
              mix_pop: float = 0.7, gamma: float = 0.75) -> "PopMixSampler":
        pop = np.power(np.asarray(item_train_degrees, np.float64) + 1.0, gamma)
        accept, alias = build_alias_table(pop)
        return cls(accept=torch.as_tensor(accept.astype(np.float32),
                                          device=device),
                   alias=torch.as_tensor(alias, device=device),
                   mix_pop=float(mix_pop),
                   num_items=int(item_train_degrees.shape[0]))

    def draw(self, gen: torch.Generator, shape, device) -> torch.Tensor:
        use_pop = torch.rand(shape, generator=gen, device=device) < self.mix_pop
        bucket = torch.randint(0, self.num_items, shape, generator=gen,
                               device=device)
        keep = torch.rand(shape, generator=gen, device=device) \
            < self.accept[bucket]
        pop_draw = torch.where(keep, bucket, self.alias[bucket])
        uni_draw = torch.randint(0, self.num_items, shape, generator=gen,
                                 device=device)
        return torch.where(use_pop, pop_draw, uni_draw)


def sample_negatives_popmix(gen: torch.Generator, csr: DeviceCSR,
                            rows: torch.Tensor, sampler: PopMixSampler,
                            rounds: int = 8) -> torch.Tensor:
    """Pop-mix negatives with bounded redraws and a final uniform fallback
    for residual collisions (reference Version-2/lighgcn_cu_pop.py:372-376):
    the first non-member among iid mixture draws, else an unchecked
    uniform draw."""
    cand = sampler.draw(gen, rows.shape + (rounds + 1,), rows.device)
    good = ~row_contains(csr, rows, cand)
    chosen = _first_good(cand, good)
    fallback = torch.randint(0, sampler.num_items, rows.shape, generator=gen,
                             device=rows.device)
    return torch.where(good.any(dim=-1), chosen, fallback)


def gumbel_topk(gen: Optional[torch.Generator], logits: torch.Tensor, k: int,
                mask: Optional[torch.Tensor] = None,
                uniforms: Optional[torch.Tensor] = None):
    """Weighted sampling WITHOUT replacement via Gumbel top-k
    (``JAX: ops/sampling.py:280-303``).

    Exactly k indices along the last axis with inclusion probabilities
    following the softmax of ``logits`` (the reference's
    ``rng.choice(..., replace=False, p=w)`` SLAS draw, main.py:758-807).
    Masked slots are excluded (score ``-inf``).  Returns ``(indices,
    gumbel_scores)``.  ``uniforms`` (the shape of ``logits``) replaces the
    draw from ``gen``, so a test can feed the JAX package's uniforms.

    Tied scores come out lowest index first, as ``lax.top_k`` orders them
    (a stable descending sort cut to k; ``torch.topk`` orders ties
    otherwise).  When k exceeds the candidate width the whole pool is
    taken and padded to k with index 0 and score ``-inf``."""
    if uniforms is None:
        uniforms = torch.rand(logits.shape, generator=gen,
                              device=logits.device, dtype=logits.dtype)
    g = -torch.log(-torch.log(uniforms + 1e-20) + 1e-20)
    scored = logits + g
    if mask is not None:
        scored = torch.where(mask, scored, float("-inf"))
    P = scored.shape[-1]
    vals, idx = torch.sort(scored, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    if k > P:
        pad = scored.shape[:-1] + (k - P,)
        vals = torch.cat([vals, vals.new_full(pad, float("-inf"))], dim=-1)
        idx = torch.cat([idx, idx.new_zeros(pad)], dim=-1)
    return idx, vals
