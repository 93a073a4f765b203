"""Vectorized on-device samplers used by evaluation.

The reference samples in per-user Python rejection loops
(reference lightgcn.py:289-300, :415-430).  Here sampling runs on the
device, whole batch at once:

  * membership tests are an exact hash-table probe (ops/membership.py) or a
    fixed-depth binary search over the per-user *sorted* CSR rows;
  * rejection loops become a bounded number of batched redraw rounds —
    distribution-equivalent to the reference's sequential rejection, not
    bit-equivalent.

Random numbers come from an explicit ``torch.Generator`` on the device the
draws are made on.  The negative samplers of training, the popularity
mixture and Gumbel top-k come with the training slice.
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
