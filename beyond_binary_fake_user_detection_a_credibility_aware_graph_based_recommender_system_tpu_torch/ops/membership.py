"""Exact set-membership for (row, col) pairs via a bucketized hash table.

Every present pair is packed into a bucket of ``SLOTS`` slots chosen by a
32-bit mix of (row, col); buckets are rows of a ``(nbuckets, 2*SLOTS)``
int32 table with the row keys in lanes [0:SLOTS) and the col keys in
[SLOTS:2*SLOTS).  Lookup gathers the bucket row and tests
``any((slab_rows == row) & (slab_cols == col))``.  The host-side build doubles
``nbuckets`` until no bucket overflows, so lookups are exact.

The JAX package mixes in uint32.  PyTorch on the CPU cannot shift uint32,
so the device mix here computes in int64 masked to the low 32 bits after
every multiply: the bucket ids equal the numpy mix bit for bit (a wrapped
int64 product keeps its low 32 bits).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

SLOTS = 16          # bucket width: 16 (row,col) pairs = one 128-byte slab
_EMPTY = np.int32(-1)
_MASK32 = 0xFFFFFFFF

_M1 = np.uint32(0x9E3779B9)
_M2 = np.uint32(0x85EBCA6B)
_M3 = np.uint32(0xC2B2AE35)


def _mix_np(rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """32-bit avalanche mix of a (row, col) pair — numpy (host) version."""
    with np.errstate(over="ignore"):
        h = rows.astype(np.uint32) * _M1 ^ cols.astype(np.uint32) * _M2
        h ^= h >> np.uint32(16)
        h *= _M3
        h ^= h >> np.uint32(13)
    return h


def _mix_torch(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """The same mix on int64 tensors; returns values in [0, 2**32)."""
    r = rows.to(torch.int64) & _MASK32
    c = cols.to(torch.int64) & _MASK32
    h = ((r * int(_M1)) & _MASK32) ^ ((c * int(_M2)) & _MASK32)
    h = h ^ (h >> 16)
    h = (h * int(_M3)) & _MASK32
    return h ^ (h >> 13)


@dataclass(frozen=True)
class HashMembership:
    """Device-resident exact-membership table for a fixed pair set."""
    buckets: torch.Tensor     # (nbuckets, 2*SLOTS) int32; -1 = empty
    nbuckets: int             # power of two

    # Max candidates per slab gather: the (N, 2*SLOTS) int32 transient is
    # 128 B/candidate, so one chunk tops out at 512 MB.
    _CHUNK = 1 << 22

    @classmethod
    def build(cls, rows: np.ndarray, cols: np.ndarray, device,
              target_load: float = 0.35) -> "HashMembership":
        """Host build: ``nbuckets`` doubles until the fullest bucket fits
        ``SLOTS`` pairs.  Pairs are deduplicated first (membership is a set
        question)."""
        pairs = np.stack([np.asarray(rows, np.int64),
                          np.asarray(cols, np.int64)], axis=1)
        if pairs.shape[0]:
            pairs = np.unique(pairs, axis=0)
        rows, cols = pairs[:, 0], pairs[:, 1]
        E = rows.shape[0]
        nb = 1
        while nb * SLOTS * target_load < max(E, 1):
            nb *= 2
        h = _mix_np(rows, cols)
        while True:
            b = (h & np.uint32(nb - 1)).astype(np.int64)
            counts = np.bincount(b, minlength=nb)
            if E == 0 or counts.max() <= SLOTS:
                break
            if nb > 64 * max(E, 1):
                raise RuntimeError(
                    f"hash table failed to settle at nb={nb} for E={E}")
            nb *= 2
        table = np.full((nb, 2 * SLOTS), _EMPTY, np.int32)
        if E:
            order = np.argsort(b, kind="stable")
            slot = np.arange(E) - np.cumsum(
                np.concatenate([[0], counts[:-1]]))[b[order]]
            table[b[order], slot] = rows[order].astype(np.int32)
            table[b[order], SLOTS + slot] = cols[order].astype(np.int32)
        return cls(buckets=torch.as_tensor(table, device=device), nbuckets=nb)

    def contains(self, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
        """Elementwise membership; ``rows`` and ``cols`` broadcast."""
        rows, cols = torch.broadcast_tensors(rows, cols)
        shape = rows.shape
        r = rows.reshape(-1).to(torch.int32)
        c = cols.reshape(-1).to(torch.int32)
        out = []
        for s in range(0, max(r.numel(), 1), self._CHUNK):
            rc, cc = r[s:s + self._CHUNK], c[s:s + self._CHUNK]
            b = _mix_torch(rc, cc) & (self.nbuckets - 1)
            slab = self.buckets[b]                   # (n, 2*SLOTS) one gather
            hit = (slab[:, :SLOTS] == rc[:, None]) & (
                slab[:, SLOTS:] == cc[:, None])
            out.append(hit.any(dim=-1))
        return torch.cat(out).reshape(shape)
