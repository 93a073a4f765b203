"""CSR adjacency structures.

Replaces the reference's per-user Python-loop CSR construction
(``reference lightgcn.py:259-277`` sorts each user's neighbor list in a
``for user in range(num_users)`` loop) with a single vectorized
``np.lexsort`` — identical output: rows grouped by source, neighbor ids
sorted ascending within each row (the sorted order is what enables the
vectorized per-row binary-search membership test used by the on-device
negative samplers, cf. ``lightgcn.py:280-287``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class CSR:
    """Compressed sparse rows: ``indices[indptr[r]:indptr[r+1]]`` are row
    ``r``'s neighbors, sorted ascending.  ``edge_ids`` (optional) maps each
    CSR slot back to the original edge index (reference
    ``main.py:739-754`` keeps edge ids for edge-attribute lookup)."""

    indptr: np.ndarray            # (num_rows+1,) int64
    indices: np.ndarray           # (nnz,) int32
    edge_ids: Optional[np.ndarray] = None  # (nnz,) int64

    @property
    def num_rows(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def row(self, r: int) -> np.ndarray:
        return self.indices[self.indptr[r]:self.indptr[r + 1]]

    def has(self, r: int, c: int) -> bool:
        """Binary-search membership (host-side oracle for the device kernel;
        reference ``user_has_item`` lightgcn.py:280-287)."""
        row = self.row(r)
        if row.size == 0:
            return False
        j = np.searchsorted(row, c)
        return j < row.size and row[j] == c


def edges_to_csr(src: np.ndarray, dst: np.ndarray, num_rows: int,
                 keep_edge_ids: bool = False) -> CSR:
    """Build a CSR over ``src`` rows with sorted neighbor lists.

    Vectorized equivalent of ``edges_to_user_csr`` (lightgcn.py:259-277) and
    ``build_csr_from_src`` (main.py:739-754): one lexsort replaces the
    mergesort + per-row sort loop.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    # Primary key src, secondary key dst -> rows grouped AND sorted within row.
    order = np.lexsort((dst, src))
    counts = np.bincount(src, minlength=num_rows)
    indptr = np.zeros(num_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSR(
        indptr=indptr,
        indices=dst[order].astype(np.int32),
        edge_ids=order.astype(np.int64) if keep_edge_ids else None,
    )


def degrees_from_edges(ids: np.ndarray, n: int) -> np.ndarray:
    return np.bincount(np.asarray(ids, dtype=np.int64), minlength=n).astype(np.float32)
