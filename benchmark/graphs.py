"""The graph cache and what the frozen generators share.

The generators (``generators/<name>.py``) are copies of the port's
``graph/build.py`` ``synthetic_bipartite_graph`` and
``synthetic_bipartite_graph_planted``, with the content-hash split of
``data/ingest.md5_split_bucket`` (:func:`dedup_split`), so that a change to
the port cannot change the benchmark's data.  A configuration names one of
them and its parameters; :func:`load_edges` builds the graph once per
checkout into ``benchmark/cache/`` (a fixed path per parameter set) and
loads it after.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np

from . import registry

CACHE_DIR = Path(__file__).resolve().parent / "cache"
TRAIN, VAL, TEST = 0, 1, 2


def _md5_bucket(uid: str, iid: str) -> int:
    h = hashlib.md5(f"{uid}|{iid}".encode("utf-8")).hexdigest()
    x = int(h[:8], 16) / 0xFFFFFFFF
    return TRAIN if x < 0.80 else VAL if x < 0.90 else TEST


def dedup_split(users, items, hash_split: str):
    """The distinct (user, item) pairs split 80/10/10 into train, val and
    test edges by a hash of each pair (md5 of the ids' strings, or a
    64-bit mix above a million pairs under "auto")."""
    pairs = np.unique(np.stack([users, items], axis=1), axis=0)
    users, items = pairs[:, 0], pairs[:, 1]
    if hash_split == "auto":
        hash_split = "md5" if users.size <= 1_000_000 else "fast"
    if hash_split == "md5":
        buckets = np.array([_md5_bucket(f"u{u}", f"i{i}")
                            for u, i in zip(users, items)], dtype=np.int8)
    else:
        h = (users.astype(np.uint64) << np.uint64(32)) ^ items.astype(np.uint64)
        h = (h ^ (h >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        h = (h ^ (h >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        h = h ^ (h >> np.uint64(31))
        x = (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)
        buckets = np.where(x < 0.8, 0, np.where(x < 0.9, 1, 2)).astype(np.int8)
    return tuple(np.stack([users[buckets == b], items[buckets == b]])
                 .astype(np.int32) for b in (TRAIN, VAL, TEST))


def generator(name: str):
    """``generate`` of ``generators/<name>.py``."""
    return registry.load("generators", name).generate


def cache_path(spec: dict) -> Path:
    key = hashlib.sha256(json.dumps(spec, sort_keys=True).encode()).hexdigest()
    return CACHE_DIR / f"graph_{spec['generator']}_{key[:16]}.npz"


def load_edges(spec: dict):
    """``(users, items, train, val, test)`` of the graph ``spec`` (a
    configuration's ``graph``): loaded from the cache, or built and cached."""
    path = cache_path(spec)
    if path.exists():
        z = np.load(path)
        return (int(z["users"]), int(z["items"]), z["train"], z["val"],
                z["test"])
    args = {k: v for k, v in spec.items() if k != "generator"}
    train, val, test = generator(spec["generator"])(**args)
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez(tmp, users=spec["users"], items=spec["items"], train=train,
             val=val, test=test)
    os.replace(tmp, path)
    return spec["users"], spec["items"], train, val, test
