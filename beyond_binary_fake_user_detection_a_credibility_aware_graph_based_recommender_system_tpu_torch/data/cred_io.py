"""Credibility-score I/O: the Stage-A -> Stage-B contract.

The CSV schema ``user_id,user_idx,credibility`` (written by Stage A,
reference main.py:1014-1019) is consumed by Stage B with a
dual-schema loader (``user_id`` or ``user_idx`` keyed), values clipped to
[0,1], missing users defaulting to credibility 1.0
(reference lightgcn_cu.py:305-362).
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np


def load_credibility_vector(path, num_users: int,
                            user2idx: Optional[Dict[str, int]] = None,
                            verbose: bool = True) -> np.ndarray:
    """cred[num_users] float32 in [0,1]; missing file/users -> 1.0."""
    cred = np.ones((num_users,), dtype=np.float32)
    p = Path(path) if path else None
    if p is None or not p.exists():
        if verbose:
            print(f"[CRED] Cred CSV not found: {p}. Using all-ones credibility.")
        return cred

    with open(p, "r", encoding="utf-8") as f:
        reader = csv.DictReader(f)
        cols = {c.strip() for c in (reader.fieldnames or [])}
        used = skipped = 0
        if "user_id" in cols and "credibility" in cols:
            if user2idx is None:
                raise ValueError("user_id-keyed cred CSV requires user2idx")
            for row in reader:
                uid = row.get("user_id")
                if not uid:
                    continue
                idx = user2idx.get(uid)
                if idx is None:
                    skipped += 1
                    continue
                try:
                    cred[idx] = float(row["credibility"])
                    used += 1
                except Exception:
                    continue
            if verbose:
                print(f"[CRED] Loaded by user_id. used={used:,} "
                      f"skipped_not_in_graph={skipped:,}")
        elif "user_idx" in cols and "credibility" in cols:
            for row in reader:
                try:
                    u = int(row["user_idx"])
                    if 0 <= u < num_users:
                        cred[u] = float(row["credibility"])
                        used += 1
                except Exception:
                    continue
            if verbose:
                print(f"[CRED] Loaded by user_idx. used={used:,}")
        else:
            raise ValueError(
                f"[CRED] Unsupported cred CSV header: {sorted(cols)}. "
                f"Expected (user_id,credibility) OR (user_idx,credibility).")

    cred = np.clip(cred, 0.0, 1.0).astype(np.float32)
    if verbose:
        p10, p50, p90 = np.percentile(cred, [10, 50, 90])
        print(f"[CRED] stats: min={cred.min():.4f} p10={p10:.4f} "
              f"p50={p50:.4f} p90={p90:.4f} max={cred.max():.4f}")
    return cred


def save_credibility_csv(path, cred: np.ndarray,
                         user_ids: Optional[Sequence[str]] = None) -> None:
    """Write the Stage-A export schema (main.py:1014-1019)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8", newline="") as f:
        w = csv.writer(f)
        w.writerow(["user_id", "user_idx", "credibility"])
        for idx, score in enumerate(np.asarray(cred)):
            uid = user_ids[idx] if user_ids is not None and idx < len(user_ids) else None
            w.writerow([uid, idx, f"{float(score):.6f}"])


def merge_user_ids(cred_npy_path, user2idx: Dict[str, int]) -> "list[tuple]":
    """Join a raw credibility ``.npy`` with an id mapping — the reference's
    standalone ``merge_user_id.py:8-24`` utility."""
    cred = np.load(cred_npy_path)
    idx2user = {v: k for k, v in user2idx.items()}
    return [(idx2user.get(i), i, float(c)) for i, c in enumerate(cred)]
