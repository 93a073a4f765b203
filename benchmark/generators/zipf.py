"""A frozen copy of the port's ``graph/build.py``
``synthetic_bipartite_graph``: users uniform, items Zipf(``power``),
deduplicated and split 80/10/10 by a hash of the pair."""

import numpy as np

from benchmark.graphs import dedup_split


def generate(users: int, items: int, edges_per_user: float, seed: int = 0,
             power: float = 1.0, hash_split: str = "auto"):
    rng = np.random.default_rng(seed)
    n = int(users * edges_per_user)
    u = rng.integers(0, users, size=n)
    p = 1.0 / np.arange(1, items + 1, dtype=np.float64) ** power
    p /= p.sum()
    i = rng.choice(items, size=n, p=p)
    return dedup_split(u, i, hash_split)
